"""One rank of a gloo mesh for tests/test_torch_mesh_engine.py.

Run as ``python tests/torch_mesh_rank.py <spec.json> <rank>``: joins the
process group (a FileStore, or ``initialize_multihost`` over tcp on
localhost), builds the spec's mesh, runs every case of the port's mesh
engine on ``tiny`` at f32 on the CPU and writes what each gave to
``<out>.<rank>.json``. Imports nothing of JAX; torch runs one thread.
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


#: what a mesh above one rank refuses: name → engine keywords
REFUSED = {
    "spec_decode": dict(spec_decode=True),
    "scheduler": dict(scheduler={}),
    "prefix_cache": dict(prefix_cache_blocks=8),
    "paged_prefix_cache": dict(prefix_cache_blocks=1, **PAGED_KW),
    "piggyback": dict(piggyback_min_prompt=4),
    "role": dict(role="prefill", **PAGED_KW),
    "journal": dict(journal=":memory:"),
}


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
    try:
        result.update(run_cases(spec, rank, mesh))
    except Exception:
        result["error"] = traceback.format_exc()
    with open(f"{spec['out']}.{rank}.json", "w") as f:
        json.dump(result, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
