# The port's GenerationEngine served over dp×tp meshes of gloo ranks on the
# CPU (tiny, float32): tp2 and dp2 (two ranks), dp2×tp2 and tp4 (four;
# tiny's two kv heads are replicated at tp4). Each mesh is one set of
# spawned processes (tests/torch_mesh_rank.py) that runs every case; the
# tests below read what each rank gave. Greedy streams must equal the JAX
# package's single-device engine token for token (the reference's own
# oracle for a mesh) and the port's un-meshed engine's; sampled streams,
# the int8 and MoE engines and the summarizer must equal the un-meshed
# port's; every rank must return the same completions.
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.checkpoint.native import (
    quantize_tree,
    save_native,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.kv_pool import (
    BlockPool,
    KVPoolExhausted,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.parallel.mesh import (
    Mesh,
    MeshConfig,
    build_mesh,
)
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_mesh_rank as R  # noqa: E402

#: (dp, tp) of each mesh; dp2 joins through initialize_multihost over tcp
MESHES = {"tp2": (1, 2), "dp2": (2, 1), "dp2tp2": (2, 2), "tp4": (1, 4)}
#: seconds the spawned ranks of all meshes may take together
SPAWN_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's tiny and tiny-moe weights (f32, key 7) as numpy
    trees, saved for the ranks, and an int8 native checkpoint of tiny."""
    d = tmp_path_factory.mktemp("mesh")
    out = {"dir": d}
    for name in ("tiny", "tiny-moe"):
        jcfg = jax_config(name)
        jp = jdec.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
        tree = jax.tree.map(np.asarray, jp)
        np.savez(d / f"{name}.npz", **_flat(tree))
        out[name] = (jcfg, jp, tree)
    save_native(d / "ckpt", decoder_config("tiny"),
                quantize_tree(params_from_numpy(out["tiny"][2], "cpu",
                                                "float32")))
    return out


@pytest.fixture(scope="module")
def spawned(weights):
    """Every mesh's ranks, started together (the references below are
    computed while they run)."""
    d = weights["dir"]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(HERE.parent)}
    procs = []
    for tag, (dp, tp) in MESHES.items():
        spec = dict(world=dp * tp, dp=dp, tp=tp, out=str(d / tag),
                    tiny=str(d / "tiny.npz"), moe=str(d / "tiny-moe.npz"),
                    ckpt=str(d / "ckpt"), timeout_s=90,
                    summarizer=tag == "dp2tp2")
        if tag == "dp2":
            spec["tcp"] = f"127.0.0.1:{_free_port()}"
        else:
            spec["store"] = str(d / f"store_{tag}")
        (d / f"{tag}.json").write_text(json.dumps(spec))
        for rank in range(dp * tp):
            procs.append(subprocess.Popen(
                [sys.executable, str(HERE / "torch_mesh_rank.py"),
                 str(d / f"{tag}.json"), str(rank)], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def mesh_runs(spawned, weights, jax_ref, port_ref):
    """Each rank's results, once every rank has ended."""
    d = weights["dir"]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    errs = []
    for p in spawned:
        try:
            _, err = p.communicate(timeout=max(1.0,
                                               deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pytest.fail(f"mesh ranks did not finish in {SPAWN_TIMEOUT_S} s "
                        f"(a divergence hangs in a collective)")
        if p.returncode:
            errs.append(err.decode()[-2000:])
    assert not errs, errs
    runs = {}
    for tag, (dp, tp) in MESHES.items():
        runs[tag] = [json.loads((d / f"{tag}.{r}.json").read_text())
                     for r in range(dp * tp)]
        for r, res in enumerate(runs[tag]):
            assert "error" not in res, f"{tag} rank {r}:\n{res['error']}"
    return runs


@pytest.fixture(scope="module")
def jax_ref(weights, spawned):
    """The JAX single-device engine's greedy streams and the first
    wave's last-position logits."""
    jcfg, jp, _ = weights["tiny"]
    kw = {k: v for k, v in R.ENGINE_KW.items()
          if k not in ("dtype", "device", "telemetry")}
    jeng = JaxEngine(jcfg, jp, dtype=jnp.float32, telemetry=False, **kw)
    comps = jeng.generate(R.PROMPTS, max_new_tokens=R.NEW)
    logits = [np.asarray(jdec.forward(jp, jnp.asarray([p]), jcfg))[0, -1]
              for p in R.PROMPTS[:R.ENGINE_KW["num_slots"]]]
    return {"greedy": [[c.tokens, c.finish_reason, c.prompt_len]
                       for c in comps],
            "first_logits": np.stack(logits)}


def _engine(tree, **kw):
    return GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            **{**R.ENGINE_KW, **kw})


@pytest.fixture(scope="module")
def port_ref(weights, spawned):
    """The port's un-meshed engines on the same weights and traffic."""
    torch.set_num_threads(1)
    tree = weights["tiny"][2]
    d = weights["dir"]
    out = {
        "greedy": R.tokens(_engine(tree).generate(R.PROMPTS, R.NEW)),
        "sampled": R.tokens(_engine(tree, sampling=R.SAMPLED, seed=3)
                            .generate(R.PROMPTS, R.NEW)),
        "sampled_paged": R.tokens(_engine(tree, sampling=R.SAMPLED, seed=3,
                                          **R.PAGED_KW)
                                  .generate(R.PROMPTS, R.NEW)),
        "int8": R.tokens(_engine(tree, quantize="int8")
                         .generate(R.PROMPTS, R.NEW)),
        "replicated": R.tokens(_engine(tree, num_slots=3)
                               .generate(R.PROMPTS, R.NEW)),
        "ckpt": R.tokens(GenerationEngine.from_checkpoint(
            d / "ckpt", device="cpu", dtype="float32",
            **{k: v for k, v in R.ENGINE_KW.items()
               if k not in ("dtype", "device")}).generate(R.PROMPTS, R.NEW)),
        "moe": R.tokens(GenerationEngine(
            decoder_config("tiny-moe"),
            params_from_numpy(weights["tiny-moe"][2], "cpu", "float32"),
            **R.ENGINE_KW).generate(R.PROMPTS, R.NEW)),
        "summaries": [s.summary_text for s in CUDASummarizer(
            "tiny", params=params_from_numpy(tree, "cpu", "float32"),
            quantize=False, dtype="float32", device="cpu", num_slots=4,
            max_len=256, max_new_tokens=8).summarize_batch(R.threads())],
        "served": {name: R.tokens(_engine(tree, **kw).generate(R.PROMPTS,
                                                               R.NEW))
                   for name, kw in R.SERVED.items()},
    }
    return out


def _flip_report(tree, want, got) -> str:
    """Where two stream sets first differ, the top-2 logit gap of the
    reference's next token (a near tie there is rounding, not a bug)."""
    cfg = decoder_config("tiny")
    params = params_from_numpy(tree, "cpu", "float32")
    for prompt, w, g in zip(R.PROMPTS, want, got):
        w, g = w[0], g[0]
        for i, (a, b) in enumerate(zip(w, g)):
            if a != b:
                seq = torch.tensor([prompt + w[:i]])
                top = tdec.forward(params, seq, cfg)[0, -1].topk(2).values
                return (f"prompt {prompt[:4]}.. token {i}: {a} != {b}, "
                        f"top-2 gap {float(top[0] - top[1]):.3e}")
    return "streams differ in length or finish"


def _assert_streams(tree, want, got):
    assert got == want, _flip_report(tree, want, got)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_greedy_streams_equal_jax_engine(mesh, mesh_runs, jax_ref,
                                              port_ref, weights):
    tree = weights["tiny"][2]
    for res in mesh_runs[mesh]:
        _assert_streams(tree, jax_ref["greedy"], res["greedy"])
        _assert_streams(tree, port_ref["greedy"], res["greedy"])


@pytest.mark.parametrize("route", ["paged", "paged_gather"])
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_paged_streams_equal_jax_engine(mesh, route, mesh_runs, jax_ref,
                                             weights):
    # K3's route and the gather route, over the dp shards of the pool
    for res in mesh_runs[mesh]:
        _assert_streams(weights["tiny"][2], jax_ref["greedy"], res[route])


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_step0_logits_match_jax(mesh, mesh_runs, jax_ref):
    want = jax_ref["first_logits"]
    for res in mesh_runs[mesh]:
        got = np.asarray(res["first_logits"])
        assert got.shape == want.shape
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel <= 1e-5, rel


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_returns_the_same_completions(mesh, mesh_runs):
    keys = ("greedy", "paged", "paged_gather", "sampled", "sampled_paged",
            "skew", "ckpt", "int8", "moe", "summaries", "replicated",
            "served")
    first = mesh_runs[mesh][0]
    for res in mesh_runs[mesh][1:]:
        for k in keys:
            assert res.get(k) == first.get(k), k


@pytest.mark.parametrize("route", ["sampled", "sampled_paged"])
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_sampled_streams_equal_unmeshed(mesh, route, mesh_runs,
                                             port_ref):
    # every rank draws the whole batch from a generator seeded alike: the
    # un-meshed engine's draws
    for res in mesh_runs[mesh]:
        assert res[route] == port_ref[route]


@pytest.mark.parametrize("mesh", MESHES)
def test_skewed_clock_on_one_rank_changes_nothing(mesh, mesh_runs,
                                                  port_ref):
    # rank 1's clock runs 1 s ahead: alone it would never hold the wave
    # (its requests look 1 s old) while rank 0 holds; rank 0 decides
    for res in mesh_runs[mesh]:
        assert res["skew_held_steps"] == 3
        assert res["skew"] == port_ref["greedy"]
        assert res["skew_late"] == "deadline"


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_checkpoint_puts_only_the_shard_on_the_device(
        mesh, mesh_runs, port_ref, weights):
    dp, tp = MESHES[mesh]
    whole_tree = quantize_tree(params_from_numpy(weights["tiny"][2], "cpu",
                                                 "float32"))
    whole = tdec.param_logical_axes(decoder_config("tiny"), whole_tree)
    for res in mesh_runs[mesh]:
        assert res["ckpt"] == port_ref["ckpt"]
        leaves = res["ckpt_leaves"]
        q = leaves["layers/wq/q"]
        assert q[0] == [2, 128, 128 // tp] and q[2] == "cpu"
        assert leaves["layers/wo/q"][0] == [2, 128 // tp, 128]
        assert leaves["layers/wo/scale"][0] == [2, 1, 128]     # whole
        assert leaves["layers/wq/scale"][0] == [2, 1, 128 // tp]
        assert leaves["layers/w_down/q"][0] == [2, 256 // tp, 128]
        assert leaves["lm_head/q"][0] == [128, 512 // tp]
        assert leaves["tok_emb"][0] == [512 // tp, 128]
        # kv heads: 2 over tp — replicated at tp4, where each rank keeps
        # the one its q head groups to
        kv = {1: 64, 2: 32, 4: 32}[tp]
        assert leaves["layers/wk/q"][0] == [2, 128, kv]
        assert set(leaves) == {
            "/".join(p) for p in _paths(whole)}
        # a sharded leaf's bytes on the rank's device are 1/tp of the
        # whole leaf's; a replicated one's are the whole
        for path in ("tok_emb", "layers/wq/q", "layers/wq/scale",
                     "layers/wo/q", "layers/w_gate/q", "layers/w_down/q",
                     "lm_head/q", "lm_head/scale"):
            assert leaves[path][1] * tp == _bytes(whole_tree, path), path
        for path in ("layers/wo/scale", "layers/attn_norm", "final_norm"):
            assert leaves[path][1] == _bytes(whole_tree, path), path


def _bytes(tree, path: str) -> int:
    leaf = tree
    for p in path.split("/"):
        leaf = leaf[p]
    return leaf.numel() * leaf.element_size()


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize("mesh", MESHES)
def test_contiguous_batch_replicates_where_dp_does_not_divide_slots(
        mesh, mesh_runs, port_ref):
    # 3 slots over dp 2: every dp group runs the whole batch, as the JAX
    # engine's cache rules replicate it
    for res in mesh_runs[mesh]:
        assert res["replicated"] == port_ref["replicated"]


@pytest.mark.parametrize("mesh", MESHES)
def test_int8_mesh_streams_equal_unmeshed(mesh, mesh_runs, port_ref):
    for res in mesh_runs[mesh]:
        assert res["int8"] == port_ref["int8"]


@pytest.mark.parametrize("mesh", MESHES)
def test_moe_mesh_streams_equal_unmeshed(mesh, mesh_runs, port_ref):
    # experts shard expert_ffn over tp, the reduce after the combine; over
    # dp the expert capacity would split, so an MoE config refuses dp
    for res in mesh_runs[mesh]:
        if MESHES[mesh][0] == 1:
            assert res["moe"] == port_ref["moe"]
        else:
            kind, msg = res["refusals"]["moe_dp"]
            assert kind == "NotImplementedError" and "6c.3" in msg


def test_mesh_summaries_equal_unmeshed(mesh_runs, port_ref):
    # CUDASummarizer(mesh=).summarize_batch at dp2×tp2, every rank alike
    for res in mesh_runs["dp2tp2"]:
        assert res["summaries"] == port_ref["summaries"]


@pytest.mark.parametrize("mesh", MESHES)
def test_paged_blocks_stay_in_their_dp_shard(mesh, mesh_runs):
    dp, _ = MESHES[mesh]
    for res in mesh_runs[mesh]:
        assert res["shard_checks"] and all(res["shard_checks"])
        assert res["shard_drained_free"] == R.PAGED_KW["kv_pool_blocks"]
        assert res["paged_free"] == [R.PAGED_KW["kv_pool_blocks"]] * 2
        assert res["dp_shards"] == dp


#: each refusal and the ROADMAP item it names (the contiguous prefix
#: cache: the JAX engine's ValueError, on any mesh)
REFUSAL_ITEMS = {"prefix_cache": None, "role": "6d",
                 "async_runner": "6c.1b", "summarize_async": "6c.1b",
                 "long_context": "6c.2"}


@pytest.mark.parametrize("name", sorted(REFUSAL_ITEMS))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_refuses_what_it_does_not_serve(mesh, name, mesh_runs):
    for res in mesh_runs[mesh]:
        kind, msg = res["refusals"][name]
        if REFUSAL_ITEMS[name] is None:
            assert kind == "ValueError", msg
            assert "requires the paged engine" in msg, msg
            continue
        assert kind == "NotImplementedError", msg
        assert f"item {REFUSAL_ITEMS[name]}" in msg, msg


@pytest.mark.parametrize("name", sorted(R.SERVED))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_serves_what_it_refused_before(mesh, name, mesh_runs,
                                            port_ref, weights):
    # spec verify, the scheduler's chunked prefill, the paged prefix
    # tries, piggyback and the journal, on this module's traffic: the
    # un-meshed port's streams on every rank
    for res in mesh_runs[mesh]:
        _assert_streams(weights["tiny"][2], port_ref["served"][name],
                        res["served"][name])


@pytest.mark.parametrize("entry", ["engine", "from_checkpoint",
                                   "summarizer"])
@pytest.mark.parametrize("mesh", MESHES)
def test_gloo_mesh_with_no_device_asks_for_the_card(mesh, entry,
                                                     mesh_runs):
    # a gloo mesh gives no device: an entry point given none still means
    # the card, and raises where there is none (the CPU only when asked)
    for res in mesh_runs[mesh]:
        got = res["no_device"][entry]
        assert got is not None, f"{entry} built with no card and no device"
        kind, msg = got
        assert kind == "RuntimeError" and "no CUDA device" in msg, msg


# ---------------------------------------------------------------------------
# in-process: the mesh of one rank, and the dp geometry's host checks
# ---------------------------------------------------------------------------


def test_world_size_one_mesh_refuses_nothing(weights, tmp_path):
    # nothing but what the JAX engine refuses on any mesh: a contiguous
    # prefix cache
    from copilot_for_consensus_tpu_torch.engine.async_runner import (
        AsyncEngineRunner,
    )

    tree = weights["tiny"][2]
    mesh = build_mesh()                     # no process group: one rank
    assert mesh.size == 1 and mesh.group("tp") is None
    for name, kw in {**R.REFUSED, **R.SERVED}.items():
        if name == "journal":
            kw = dict(journal=str(tmp_path / "j.sqlite3"))
        if name == "prefix_cache":
            with pytest.raises(ValueError, match="requires the paged"):
                _engine(tree, mesh=mesh, **kw)
            continue
        _engine(tree, mesh=mesh, **kw)
    eng = _engine(tree, mesh=mesh)
    AsyncEngineRunner(eng)
    CUDASummarizer("tiny", engine=eng, long_context=True)


def test_contiguous_prefix_cache_on_a_mesh_raises_as_the_jax_engine(
        weights):
    # both packages refuse it on a one-device mesh, in the same words
    from copilot_for_consensus_tpu.parallel import MeshConfig as JaxMeshCfg
    from copilot_for_consensus_tpu.parallel import build_mesh as jax_mesh

    jcfg, jp, tree = weights["tiny"]
    kw = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
              prefix_cache_blocks=8)
    with pytest.raises(ValueError) as jax_err:
        JaxEngine(jcfg, jp, dtype=jnp.float32, telemetry=False,
                  mesh=jax_mesh(JaxMeshCfg(dp=1, tp=1),
                                devices=jax.devices()[:1]), **kw)
    with pytest.raises(ValueError) as port_err:
        _engine(tree, mesh=build_mesh(), **kw)
    assert str(port_err.value) == str(jax_err.value)
    assert "requires the paged engine" in str(port_err.value)


def test_world_size_one_mesh_engine_is_the_unmeshed_engine(weights):
    tree = weights["tiny"][2]
    params = params_from_numpy(tree, "cpu", "float32")
    for kw in ({}, R.PAGED_KW):
        eng = GenerationEngine(decoder_config("tiny"), params,
                               mesh=build_mesh(), **{**R.ENGINE_KW, **kw})
        # whole leaves already on the device: the same tensors, no copy
        assert eng.params["layers"]["wq"] is params["layers"]["wq"]
        assert eng._tp_shard is None and eng._dp_group is None
        got = R.tokens(eng.generate(R.PROMPTS, R.NEW))
        assert got == R.tokens(_engine(tree, **kw).generate(R.PROMPTS,
                                                            R.NEW))


def _view(dp: int, tp: int, **coords) -> Mesh:
    """A rank's view of a mesh, for host checks that need no group."""
    return Mesh(MeshConfig(dp=dp, tp=tp).resolve(dp * tp),
                coords={"dp": 0, "pp": 0, "sp": 0, "ep": 0, "tp": 0,
                        **coords}, device="cpu")


@pytest.mark.parametrize("axis,item", [("pp", "6e"), ("sp", "6c.2"),
                                       ("ep", "6c.3")])
def test_mesh_axes_the_engine_does_not_serve_raise(axis, item, weights):
    # refused before anything is built or any collective runs
    view = Mesh(MeshConfig(**{axis: 2, "tp": 1}).resolve(2),
                coords={"dp": 0, "pp": 0, "sp": 0, "ep": 0, "tp": 0},
                device="cpu")
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        _engine(weights["tiny"][2], mesh=view)


def test_sharded_pool_requires_divisible_geometry(weights):
    with pytest.raises(ValueError, match="divisible by dp"):
        _engine(weights["tiny"][2], mesh=_view(2, 1), num_slots=3,
                **R.PAGED_KW)
    with pytest.raises(ValueError, match="divide evenly"):
        BlockPool(decoder_config("tiny"), num_blocks=25, block_size=8,
                  device="cpu", num_shards=2)


def test_sharded_allocator_per_shard_ranges_and_exhaustion():
    pool = BlockPool(decoder_config("tiny"), num_blocks=24, block_size=8,
                     device="cpu", num_shards=2, shard=1)
    assert pool.num_shards == 2 and pool.blocks_per_shard == 12
    assert pool.k.shape[1] == 12              # this rank's shard only
    a = pool.alloc(3, shard=0)
    b = pool.alloc(3, shard=1)
    assert all(pool.shard_of(x) == 0 for x in a)
    assert all(pool.shard_of(x) == 1 for x in b)
    assert all(pool.local_id(x) < 12 for x in a + b)
    assert pool.free_blocks_shard(0) == 9
    # per-shard exhaustion: shard 0 running dry must not borrow from 1
    with pytest.raises(KVPoolExhausted, match="on shard 0"):
        pool.alloc(10, shard=0)
    assert pool.free_blocks_shard(1) == 9
    # frees route home by global id
    pool.free(a)
    assert pool.free_blocks_shard(0) == 12
    pool.free(b)
    assert pool.free_blocks == pool.num_blocks
