"""One rank of a gloo mesh for tests/test_torch_mesh_engine.py and
tests/test_torch_mesh_features.py.

Run as ``python tests/torch_mesh_rank.py <spec.json> <rank>``: joins the
process group (a FileStore, or ``initialize_multihost`` over tcp on
localhost), builds the spec's mesh, runs every case of the spec's suite
(``"engine"``, the default: the mesh engine's paths; ``"features"``: spec
verify, chunked prefill, the paged prefix tries, piggyback, the journal
and skewed clocks) on ``tiny`` at f32 on the CPU and writes what each
gave to ``<out>.<rank>.json``. Imports nothing of JAX; torch runs one
thread.
"""

from __future__ import annotations

import datetime
import json
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine import generation
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.sampling import SamplingConfig
from copilot_for_consensus_tpu_torch.engine.scheduler import SchedulerConfig
from copilot_for_consensus_tpu_torch.engine.telemetry import RequestTrace
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.parallel.mesh import (
    MeshConfig,
    build_mesh,
)
from copilot_for_consensus_tpu_torch.parallel.multihost import (
    initialize_multihost,
)

#: the engines' geometry and traffic, shared with the test module
ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
                 decode_window=4, dtype="float32", device="cpu",
                 telemetry=False)
PAGED_KW = dict(prefill_chunk=8, kv_pool_blocks=32)
PROMPTS = [[5, 9, 13], list(range(40, 61)), [7] * 9,
           list(range(100, 130)), [3, 4], list(range(200, 214))]
NEW = 10
SAMPLED = SamplingConfig(temperature=0.8, top_k=40, top_p=0.9)


def load_tree(path: str) -> dict:
    """A param tree saved flat by the test module (``a/b`` keys)."""
    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    return tree


def tokens(comps) -> list:
    return [[c.tokens, c.finish_reason, c.prompt_len] for c in comps]


def record_first_logits():
    """Wrap the engine's ``sample`` so the first call's logits (the first
    wave's, whole rows on every rank) are kept."""
    seen: list = []
    real = generation.sample

    def recording(logits, gen, cfg):
        if not seen:
            seen.append(logits.detach().clone())
        return real(logits, gen, cfg)

    generation.sample = recording
    return seen, real


def run_cases(spec: dict, rank: int, mesh) -> dict:
    cfg = decoder_config("tiny")
    tree = load_tree(spec["tiny"])
    out: dict = {}

    def engine(**kw):
        return GenerationEngine(cfg, params_from_numpy(tree, "cpu",
                                                       "float32"),
                                mesh=mesh, **{**ENGINE_KW, **kw})

    seen, real = record_first_logits()
    try:
        out["greedy"] = tokens(engine().generate(PROMPTS, NEW))
    finally:
        generation.sample = real
    out["first_logits"] = seen[0].tolist()
    paged = engine(**PAGED_KW)
    out["paged"] = tokens(paged.generate(PROMPTS, NEW))
    out["paged_free"] = [paged._pool.free_blocks, paged._pool.num_blocks]
    out["dp_shards"] = paged.kv_pool_stats()["dp_shards"]
    out["sampled"] = tokens(engine(sampling=SAMPLED, seed=3).generate(
        PROMPTS, NEW))
    out["sampled_paged"] = tokens(engine(sampling=SAMPLED, seed=3,
                                         **PAGED_KW).generate(PROMPTS, NEW))

    # blocks stay in their slot's dp shard while the slots decode
    eng = engine(**PAGED_KW)
    for p in PROMPTS[:4]:
        eng.submit(p, max_new_tokens=40)
    eng.step()
    eng.step()
    out["shard_checks"] = [
        eng._pool.shard_of(b) == eng._slot_shard(s)
        for s in eng._active for b in eng._tables[s]]
    while eng._active or eng.queue_depth:
        eng.step()
    out["shard_drained_free"] = eng._pool.free_blocks

    # a skewed clock on rank 1 with the admission holds and a deadline
    real_clock = time.monotonic
    if rank == 1:
        time.monotonic = lambda: real_clock() + 1.0
    try:
        eng = engine(admit_min_rows=3, admit_hold_strict=True,
                     admit_max_wait_s=0.3)
        ids = [eng.submit(p, NEW) for p in PROMPTS[:2]]
        held = 0
        for _ in range(3):
            eng.step()
            held += eng.queue_depth == 2
        ids += [eng.submit(p, NEW) for p in PROMPTS[2:]]
        late = eng.submit(PROMPTS[0], NEW, deadline_s=0.0)
        done = {}
        while len(done) < len(ids) + 1:
            for c in eng.step():
                done[c.request_id] = c
        out["skew"] = tokens([done[i] for i in ids])
        out["skew_held_steps"] = held
        out["skew_late"] = done[late].finish_reason
    finally:
        time.monotonic = real_clock

    # loading: the checkpoint's shards, the int8 and MoE engines
    ck = GenerationEngine.from_checkpoint(
        spec["ckpt"], mesh=mesh, device="cpu", dtype="float32",
        **{k: v for k, v in ENGINE_KW.items()
           if k not in ("dtype", "device")})
    out["ckpt"] = tokens(ck.generate(PROMPTS, NEW))
    out["ckpt_leaves"] = leaf_numels(ck.params)
    out["int8"] = tokens(engine(quantize="int8").generate(PROMPTS, NEW))
    moe_refusal = None
    try:
        moe = GenerationEngine(decoder_config("tiny-moe"),
                               params_from_numpy(load_tree(spec["moe"]),
                                                 "cpu", "float32"),
                               mesh=mesh, **ENGINE_KW)
        out["moe"] = tokens(moe.generate(PROMPTS, NEW))
    except NotImplementedError as exc:              # an MoE config over dp
        moe_refusal = [type(exc).__name__, str(exc)]
    out["paged_gather"] = tokens(engine(kv_kernel="reference", **PAGED_KW)
                                 .generate(PROMPTS, NEW))
    # 3 slots: dp does not divide them, and the contiguous batch is
    # replicated over dp
    out["replicated"] = tokens(engine(num_slots=3).generate(PROMPTS, NEW))
    if spec.get("summarizer"):
        from copilot_for_consensus_tpu_torch.summarization.summarizer import (
            CUDASummarizer,
        )
        summ = CUDASummarizer(
            "tiny", params=params_from_numpy(tree, "cpu", "float32"),
            quantize=False, dtype="float32", device="cpu", num_slots=4,
            max_len=256, max_new_tokens=8, mesh=mesh)
        out["summaries"] = [s.summary_text for s in summ.summarize_batch(
            threads())]
    out["refusals"] = {**refusals(cfg, tree, mesh), "moe_dp": moe_refusal}
    out["served"] = served(cfg, tree, mesh)
    out["no_device"] = no_device(cfg, tree, spec, mesh)
    return out


def no_device(cfg, tree, spec, mesh) -> dict:
    """Each entry point given the gloo mesh and no ``device``: the
    exception it raised (None: it built on some device)."""
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )
    kw = {k: v for k, v in ENGINE_KW.items() if k != "device"}
    out = {}
    for name, fn in (
            ("engine", lambda: GenerationEngine(
                cfg, params_from_numpy(tree, "cpu", "float32"), mesh=mesh,
                **kw)),
            ("from_checkpoint", lambda: GenerationEngine.from_checkpoint(
                spec["ckpt"], mesh=mesh,
                **{k: v for k, v in kw.items() if k != "dtype"})),
            ("summarizer", lambda: CUDASummarizer(
                "tiny", params=params_from_numpy(tree, "cpu", "float32"),
                quantize=False, dtype="float32", num_slots=4, max_len=256,
                mesh=mesh))):
        try:
            fn()
            out[name] = None
        except Exception as exc:                     # recorded, then held
            out[name] = [type(exc).__name__, str(exc)]
    return out


def threads():
    from copilot_for_consensus_tpu_torch.summarization.base import (
        ThreadContext,
    )

    return [ThreadContext(
        thread_id=f"t{i}", subject=f"Topic {i}",
        participants=["alice@example.org", "bob@example.org"],
        message_count=2 + i,
        chunks=[{"chunk_id": f"c{i}", "text": f"Point {i}: ship the "
                 f"draft by Friday."}]) for i in range(5)]


def leaf_numels(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_numels(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = [list(v.shape), v.numel() * v.element_size(),
                                   str(v.device)]
    return out


#: what a mesh above one rank refuses: name → engine keywords (the
#: contiguous prefix cache on any mesh, in the JAX engine's words)
REFUSED = {
    "prefix_cache": dict(prefix_cache_blocks=8),
    "role": dict(role="prefill", **PAGED_KW),
}

#: what a mesh above one rank refused until the mesh engine served it:
#: name → engine keywords, served on PROMPTS
SERVED = {
    "spec_decode": dict(spec_decode=True),
    "scheduler": dict(scheduler=SchedulerConfig(chunk_tokens=8)),
    "paged_prefix_cache": dict(prefix_cache_blocks=1, **PAGED_KW),
    "piggyback": dict(piggyback_min_prompt=4),
    "journal": dict(journal=":memory:"),
}


def served(cfg, tree, mesh) -> dict:
    """Each of SERVED's engines on PROMPTS: its completions (or the
    exception it raised)."""
    out = {}
    for name, kw in SERVED.items():
        try:
            eng = GenerationEngine(cfg, params_from_numpy(tree, "cpu",
                                                          "float32"),
                                   mesh=mesh, **{**ENGINE_KW, **kw})
            out[name] = tokens(eng.generate(PROMPTS, NEW))
        except Exception as exc:                     # recorded, then held
            out[name] = [type(exc).__name__, str(exc)]
    return out


def refusals(cfg, tree, mesh) -> dict:
    """Each refusal's exception type and message (None: it did not
    raise)."""
    out = {}
    for name, kw in REFUSED.items():
        try:
            GenerationEngine(cfg, params_from_numpy(tree, "cpu", "float32"),
                             mesh=mesh, **{**ENGINE_KW, **kw})
            out[name] = None
        except Exception as exc:                     # recorded, then held
            out[name] = [type(exc).__name__, str(exc)]
    from copilot_for_consensus_tpu_torch.engine.async_runner import (
        AsyncEngineRunner,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )
    eng = GenerationEngine(cfg, params_from_numpy(tree, "cpu", "float32"),
                           mesh=mesh, **ENGINE_KW)
    for name, fn in (
            ("async_runner", lambda: AsyncEngineRunner(eng)),
            ("summarize_async", lambda: CUDASummarizer(
                "tiny", engine=eng).summarize_async(threads()[0])),
            ("long_context", lambda: CUDASummarizer(
                "tiny", engine=eng, long_context=True))):
        try:
            fn()
            out[name] = None
        except Exception as exc:                     # recorded, then held
            out[name] = [type(exc).__name__, str(exc)]
    return out


# ---------------------------------------------------------------------------
# the feature suite: each case is the port's counterpart of one of the
# reference's tests/test_engine_multichip.py oracles
# ---------------------------------------------------------------------------

#: the feature suite's geometry (the reference's: 4 slots, max_len 64,
#: buckets 16/32, block 8)
FEAT_KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
               decode_window=4, prefill_chunk=8, dtype="float32",
               device="cpu", telemetry=False)
FEAT_PAGED = dict(kv_pool_blocks=32)
#: the copy-cycle weights' period: greedy generation is a token cycle, so
#: prompt-lookup drafts always hit
CYCLE = 7
SPEC_KW = dict(spec_decode=True, spec_draft_lens=(0, 2, 4))
SPEC_PROMPTS = [[3 + (i + j) % CYCLE for j in range(2 * CYCLE)]
                for i in range(4)]
SPEC_NEW = 24
CHUNK_KW = dict(scheduler=SchedulerConfig(chunk_tokens=8,
                                          prefill_wave_tokens=64))
CHUNK_PROMPTS = np.random.default_rng(1).integers(
    3, 512, size=(4, 30)).tolist()
CHUNK_NEW = 5
PREFIX_KW = dict(kv_pool_blocks=32, prefix_cache_blocks=8)
_common = np.random.default_rng(0).integers(3, 512, size=16).tolist()
PREFIX_PROMPTS = [_common + np.random.default_rng(10 + i).integers(
    3, 512, size=6).tolist() for i in range(4)]
PREFIX_NEW = 5
PIGGY_KW = dict(piggyback_min_prompt=4, prefill_rows=2)
#: the journal's traffic: short prompts, so a continuation stays under
#: prompt_limit
JOURNAL_PROMPTS = [p[:12] for p in PROMPTS]
JOURNAL_NEW = 12
JOURNAL_STEPS = 3
#: the skewed-clock case's traffic: short prompts take waves (and the
#: admission hold), long ones chunk, and the batch lane comes last
SKEW_WAVES = [[5, 9, 13], [3, 4], [7, 8, 9, 10], [20, 21, 22]]
SKEW_CHUNKED = CHUNK_PROMPTS[:2]
SKEW_BATCH = [[11, 12, 13], [30, 31, 32, 33], [40, 41]]
#: long enough that the waves' slots are still decoding (occupancy 1)
#: when the batch lane arrives
SKEW_NEW = 16


def cycle_tree(tree: dict) -> dict:
    """The reference's copy-cycle weights over ``tree``: zero ``wo`` and
    ``w_down`` (every block adds nothing), the embedding one-hot on token
    3 + i and the lm_head mapping dimension i to token 3 + (i + 1) % 7."""
    out = {**tree, "layers": dict(tree["layers"])}
    out["layers"]["wo"] = np.zeros_like(tree["layers"]["wo"])
    out["layers"]["w_down"] = np.zeros_like(tree["layers"]["w_down"])
    emb = np.zeros_like(tree["tok_emb"])
    head = np.zeros_like(tree["lm_head"])
    for i in range(CYCLE):
        emb[3 + i, i] = 1.0
        head[i, 3 + (i + 1) % CYCLE] = 1.0
    out["tok_emb"], out["lm_head"] = emb, head
    return out


def feature_engines(tree) -> dict:
    """name → (params tree, engine keywords, prompts, new tokens) of the
    suite's stream cases, greedy and sampled."""
    cyc = cycle_tree(tree)
    cases = {
        "spec": (cyc, SPEC_KW, SPEC_PROMPTS, SPEC_NEW),
        "spec_paged": (cyc, {**SPEC_KW, **FEAT_PAGED}, SPEC_PROMPTS,
                       SPEC_NEW),
        "chunk": (tree, CHUNK_KW, CHUNK_PROMPTS, CHUNK_NEW),
        "chunk_paged": (tree, {**CHUNK_KW, **FEAT_PAGED}, CHUNK_PROMPTS,
                        CHUNK_NEW),
        "piggy": (tree, PIGGY_KW, PROMPTS, NEW),
    }
    for name in ("spec", "chunk", "piggy"):
        t, kw, prompts, new = cases[name]
        cases[f"{name}_sampled"] = (t, {**kw, "sampling": SAMPLED,
                                        "seed": 3}, prompts, new)
    return cases


def feature_counters(eng) -> dict:
    return {"spec_dispatches": eng.spec_dispatches,
            "accepted": eng.spec_stats()["accepted_tokens"],
            "chunk_dispatches": eng.chunk_dispatches,
            "piggy_dispatches": eng.piggy_dispatches}


def run_feature_cases(spec: dict, rank: int, mesh) -> dict:
    from copilot_for_consensus_tpu_torch.engine import journal as journal_mod

    cfg = decoder_config("tiny")
    tree = load_tree(spec["tiny"])
    out: dict = {}

    def engine(t=tree, **kw):
        return GenerationEngine(cfg, params_from_numpy(t, "cpu", "float32"),
                                mesh=mesh, **{**FEAT_KW, **kw})

    for name, (t, kw, prompts, new) in feature_engines(tree).items():
        eng = engine(t, **kw)
        out[name] = tokens(eng.generate(prompts, new))
        out[f"{name}_counters"] = feature_counters(eng)
        if eng.paged:
            out[f"{name}_pool_whole"] = \
                eng._pool.free_blocks == eng._pool.num_blocks

    # the paged prefix tries: two rounds of shared-prefix prompts; the
    # slots' blocks and every trie's nodes in their own dp shard
    eng = engine(**PREFIX_KW)
    out["prefix"] = [tokens(eng.generate(PREFIX_PROMPTS, PREFIX_NEW))
                     for _ in range(2)]
    out["prefix_stats"] = {k: eng.prefix_stats()[k]
                           for k in ("lookups", "hits", "tokens_matched")}
    out["prefix_zero_copy"] = eng.kv_pool_stats()["zero_copy_admits"]
    # a third round that stays active past its first step: every slot's
    # table, borrowed blocks included, lies in the slot's own shard
    ids = [eng.submit(p, 4 * PREFIX_NEW) for p in PREFIX_PROMPTS]
    done = {c.request_id: c for c in eng.step()}
    out["prefix_locality"] = [eng._pool.shard_of(b) == eng._slot_shard(s)
                              for s in eng._active for b in eng._tables[s]]
    while len(done) < len(ids):
        for c in eng.step():
            done[c.request_id] = c
    out["prefix_trie_shards"] = [
        [eng._pool.shard_of(n.block_id) for n in pc._nodes]
        for pc in eng._prefixes]
    nodes = sum(pc.node_count for pc in eng._prefixes)
    out["prefix_books"] = [eng._pool.free_blocks + nodes,
                           eng._pool.pinned_blocks == nodes]
    for pc in eng._prefixes:
        pc.flush()
    out["prefix_flushed_free"] = eng._pool.free_blocks

    out.update(supervised_verify(engine, tree, rank))
    out.update(skewed_clocks(engine, rank))
    out.update(journal_restart(engine, rank, spec, journal_mod))
    out.update(feature_summaries(cfg, tree, spec, mesh, rank))
    out["feature_refusals"] = feature_refusals(cfg, tree, mesh)
    return out


def supervised_verify(engine, tree: dict, rank: int) -> dict:
    """An ``EngineSupervisor`` built straight over the spec engine, its
    ``spec_verify`` breaker opened on rank 0 alone: every rank takes rank
    0's verdict and serves plain decode (a rank that verified alone would
    hang in the verify pass's collectives)."""
    from copilot_for_consensus_tpu_torch.engine.supervisor import (
        EngineSupervisor,
    )

    t, kw, prompts, new = feature_engines(tree)["spec"]
    eng = engine(t, **kw)
    sup = EngineSupervisor(eng)
    if rank == 0:
        for _ in range(sup.cfg.verify_breaker_threshold):
            sup.verify_breaker.record_failure()
    return {"supervised": tokens(eng.generate(prompts, new)),
            "supervised_spec_dispatches": eng.spec_dispatches,
            "supervised_breaker": sup.verify_breaker.state}


def skewed_clocks(engine, rank: int) -> dict:
    """The scheduler (chunked prefill), the admission holds and a
    deadline, with ``time.monotonic`` 1000 s ahead on every rank but 0 and
    their telemetry fed TTFTs far over the SLO: alone such a rank would
    shed the batch lane at the door while rank 0 admits it."""
    real_clock = time.monotonic
    if rank:
        time.monotonic = lambda: real_clock() + 1000.0
    try:
        eng = engine(telemetry=True, admit_min_rows=3, admit_hold_strict=True,
                     admit_max_wait_s=0.3, **CHUNK_KW)
        if rank:
            now = time.monotonic()
            for i in range(64):
                eng.telemetry.completed.append(RequestTrace(
                    request_id=-1 - i, ttft_s=1e4, queue_wait_s=1e4,
                    finished_at=now - i))
        done: dict = {}

        def step():
            for c in eng.step():
                done[c.request_id] = c

        ids = [eng.submit(p, SKEW_NEW) for p in SKEW_WAVES[:2]]
        held = 0
        for _ in range(3):
            step()
            held += eng.queue_depth == 2
        ids += [eng.submit(p, SKEW_NEW)
                for p in SKEW_WAVES[2:] + SKEW_CHUNKED]
        late = eng.submit(SKEW_WAVES[0], SKEW_NEW, deadline_s=0.0)
        step()
        step()
        shed = []
        for p in SKEW_BATCH:
            try:
                ids.append(eng.submit(p, SKEW_NEW, priority="batch"))
                shed.append(False)
            except Exception as exc:                 # EngineOverloaded
                shed.append(type(exc).__name__)
        while len(done) < len(ids) + 1:
            step()
        return {"skew": tokens([done[i] for i in ids]),
                "skew_held_steps": held, "skew_shed": shed,
                "skew_late": done[late].finish_reason,
                "skew_level": eng._sched.overload_level,
                "skew_chunks": eng.chunk_dispatches}
    finally:
        time.monotonic = real_clock


def journal_restart(engine, rank: int, spec: dict, journal_mod) -> dict:
    """Rank 0 journals into a SQLite file; the run stops after a few
    steps without retiring, and new engines on the same mesh recover from
    it. Every journal opened on this rank is recorded."""
    opened: list = []
    real_init = journal_mod.EngineJournal.__init__

    def recording(self, path=":memory:", *a, **kw):
        opened.append(str(path))
        real_init(self, path, *a, **kw)

    journal_mod.EngineJournal.__init__ = recording
    try:
        path = spec["journal"]
        eng = engine(journal=path)
        ids = [eng.submit(p, JOURNAL_NEW) for p in JOURNAL_PROMPTS]
        done = {}
        for _ in range(JOURNAL_STEPS):
            for c in eng.step():
                done[c.request_id] = c
        first = {ids.index(r): c for r, c in done.items()}
        has_store = eng.journal is not None
        del eng                                  # the process "dies"
        back = engine(journal=path)
        rec = {rid: i for i, (rid, _c) in enumerate(back.journal_recovered)}
        unfinished = [i for i in range(len(ids)) if i not in first]
        got = {}
        while len(got) < len(rec):
            for c in back.step():
                got[c.request_id] = c
        comps = dict(first)
        for rid, c in got.items():
            comps[unfinished[rec[rid]]] = c
        return {"journal": [[comps[i].tokens, comps[i].finish_reason]
                            for i in range(len(ids))],
                "journal_counts": [back.journal_replayed,
                                   back.journal_abandoned,
                                   [r for r, _ in back.journal_recovered]],
                "journal_opened": opened,
                "journal_store": [has_store, back.journal is not None],
                "journal_stats_enabled": back.journal_stats()["enabled"]}
    finally:
        journal_mod.EngineJournal.__init__ = real_init


def summarizer_engine_kw() -> dict:
    """The summarizer case's engine: spec, the scheduler and the paged
    prefix tries together."""
    return dict(num_slots=4, max_len=256, prefill_chunk=16,
                kv_pool_blocks=80, prefix_cache_blocks=1,
                spec_decode=True, dtype="float32", device="cpu",
                scheduler=SchedulerConfig(chunk_tokens=32))


def feature_summaries(cfg, tree, spec, mesh, rank) -> dict:
    """``CUDASummarizer(mesh=)`` with the deployed llm block's options
    (deadline_s, journal; its ``supervisor`` attaches only to the async
    runner, which a mesh refuses), and over a mesh engine that brings
    spec, the scheduler and the paged prefix cache."""
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )
    deployed = CUDASummarizer(
        "tiny", params=params_from_numpy(tree, "cpu", "float32"),
        quantize=False, dtype="float32", device="cpu", num_slots=4,
        max_len=256, max_new_tokens=8, mesh=mesh, supervisor=True,
        deadline_s=300, journal={"path": spec["summ_journal"],
                                 "checkpoint_every": 8})
    eng = GenerationEngine(cfg, params_from_numpy(tree, "cpu", "float32"),
                           mesh=mesh, **summarizer_engine_kw())
    featured = CUDASummarizer("tiny", engine=eng, max_new_tokens=8)
    return {"summaries_deployed": [s.summary_text for s in
                                   deployed.summarize_batch(threads())],
            "summaries_featured": [s.summary_text for s in
                                   featured.summarize_batch(threads())],
            "summaries_journal_store": deployed.engine.journal is not None}


def feature_refusals(cfg, tree, mesh) -> dict:
    """What the mesh still refuses, each exception's type and message."""
    from copilot_for_consensus_tpu_torch.engine.async_runner import (
        AsyncEngineRunner,
    )
    from copilot_for_consensus_tpu_torch.parallel.mesh import Mesh
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    def params():
        return params_from_numpy(tree, "cpu", "float32")

    def view(**axes):
        # another 5-axis shape over the same ranks: refused before any
        # group is needed
        return Mesh(MeshConfig(**axes).resolve(mesh.size), coords=dict(
            mesh.coords), device="cpu")

    eng = GenerationEngine(cfg, params(), mesh=mesh, **FEAT_KW)
    half = mesh.size // 2
    cases = {
        "async_runner": lambda: AsyncEngineRunner(eng),
        "summarize_async": lambda: CUDASummarizer(
            "tiny", engine=eng).summarize_async(threads()[0]),
        "role": lambda: GenerationEngine(cfg, params(), mesh=mesh,
                                         role="decode", **FEAT_KW,
                                         **FEAT_PAGED),
        "attn_impl": lambda: GenerationEngine(
            cfg, params(), mesh=mesh, attn_impl=lambda *a: None, **FEAT_KW),
    }
    for axis in ("sp", "ep", "pp"):
        cases[axis] = (lambda ax: lambda: GenerationEngine(
            cfg, params(), mesh=view(**{ax: 2, "tp": half}),
            **FEAT_KW))(axis)
    out = {}
    for name, fn in cases.items():
        try:
            fn()
            out[name] = None
        except Exception as exc:                     # recorded, then held
            out[name] = [type(exc).__name__, str(exc)]
    return out


def main(spec_path: str, rank: int) -> int:
    torch.set_num_threads(1)
    spec = json.loads(open(spec_path).read())
    world = spec["world"]
    timeout = spec.get("timeout_s", 60)
    if spec.get("tcp"):
        initialize_multihost({"coordinator_address": spec["tcp"],
                              "num_processes": world, "process_id": rank},
                             backend="gloo", timeout_s=timeout)
    else:
        dist.init_process_group(
            "gloo", store=dist.FileStore(spec["store"], world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
    mesh = build_mesh(MeshConfig(dp=spec["dp"], tp=spec["tp"]),
                      timeout_s=timeout)
    result: dict = {"coords": mesh.coords}
    suite = run_feature_cases if spec.get("suite") == "features" \
        else run_cases
    try:
        result.update(suite(spec, rank, mesh))
    except Exception:
        result["error"] = traceback.format_exc()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
