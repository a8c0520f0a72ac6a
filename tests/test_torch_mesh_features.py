# The mesh engine's remaining features over dp×tp meshes of gloo ranks on
# the CPU (tiny, float32): dp2×tp2 and tp4 (four ranks each; at tp4 tiny's
# two kv heads are replicated). Each case is the port's counterpart of the
# reference's tests/test_engine_multichip.py oracles: spec-decode verify
# with the copy-cycle weights and chunked prefill under the scheduler, on
# the contiguous cache and the paged pool; paged prefix hits over two
# rounds of shared-prefix prompts, with every slot's blocks and every
# trie node in its own dp shard; piggyback prefill on the contiguous
# cache. Greedy streams must equal the JAX package's single-device engine
# token for token (the reference's own oracle for a mesh) and the port's
# un-meshed engine's; sampled streams equal the un-meshed port's. With
# clocks and telemetry skewed on every rank but 0, the scheduler's turn,
# the admission hold and a deadline still go rank 0's way; a journal on
# rank 0 alone warm-restarts the mesh, and a supervisor's spec_verify
# breaker open on rank 0 alone keeps every rank off the verify pass. One
# spawn a mesh (tests/torch_mesh_rank.py, suite "features") runs every
# case.
import json
import os
import pathlib
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
from copilot_for_consensus_tpu.engine.scheduler import (
    SchedulerConfig as JaxSchedulerConfig,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.summarization.summarizer import (
    CUDASummarizer,
)

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_mesh_rank as R  # noqa: E402

#: (dp, tp) of each mesh
MESHES = {"dp2tp2": (2, 2), "tp4": (1, 4)}
#: seconds the spawned ranks of both meshes may take together
SPAWN_TIMEOUT_S = 240
#: the greedy stream cases, each with the counter that shows its feature
#: ran
GREEDY = {"spec": "spec_dispatches", "spec_paged": "spec_dispatches",
          "chunk": "chunk_dispatches", "chunk_paged": "chunk_dispatches",
          "piggy": "piggy_dispatches"}


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
    """The JAX package's tiny weights (f32, key 7) as a numpy tree, saved
    for the ranks."""
    d = tmp_path_factory.mktemp("mesh_features")
    jcfg = jax_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    np.savez(d / "tiny.npz", **_flat(tree))
    return {"dir": d, "jcfg": jcfg, "tree": tree}


@pytest.fixture(scope="module")
def spawned(weights):
    """Both meshes' ranks, started together (the references below are
    computed while they run)."""
    d = weights["dir"]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(HERE.parent)}
    procs = []
    for tag, (dp, tp) in MESHES.items():
        spec = dict(world=dp * tp, dp=dp, tp=tp, out=str(d / tag),
                    tiny=str(d / "tiny.npz"), suite="features",
                    store=str(d / f"store_{tag}"), timeout_s=90,
                    journal=str(d / f"journal_{tag}.sqlite3"),
                    summ_journal=str(d / f"summ_journal_{tag}.sqlite3"))
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


def _jax(weights, tree=None, **kw):
    params = weights["tree"] if tree is None else tree
    base = {k: v for k, v in R.FEAT_KW.items()
            if k not in ("dtype", "device", "telemetry")}
    return JaxEngine(weights["jcfg"], jax.tree.map(jnp.asarray, params),
                     dtype=jnp.float32, kv_dtype=jnp.float32,
                     attn_impl="xla", telemetry=False, **{**base, **kw})


def _jax_kw(kw: dict) -> dict:
    """A case's engine keywords for the JAX engine (its own scheduler
    config)."""
    out = dict(kw)
    if "scheduler" in out:
        c = out["scheduler"]
        out["scheduler"] = JaxSchedulerConfig(
            chunk_tokens=c.chunk_tokens,
            prefill_wave_tokens=c.prefill_wave_tokens)
    return out


@pytest.fixture(scope="module")
def jax_ref(weights, spawned):
    """The JAX single-device engine's greedy streams and prefix counts."""
    out = {}
    cases = R.feature_engines(weights["tree"])
    for name in GREEDY:
        tree, kw, prompts, new = cases[name]
        eng = _jax(weights, tree, **_jax_kw(kw))
        out[name] = R.tokens(eng.generate(prompts, max_new_tokens=new))
    eng = _jax(weights, **R.PREFIX_KW)
    out["prefix"] = [R.tokens(eng.generate(R.PREFIX_PROMPTS,
                                           max_new_tokens=R.PREFIX_NEW))
                     for _ in range(2)]
    out["prefix_stats"] = {k: eng.prefix_stats()[k]
                           for k in ("lookups", "hits", "tokens_matched")}
    return out


def _port(tree, **kw):
    return GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            **{**R.FEAT_KW, **kw})


@pytest.fixture(scope="module")
def port_ref(weights, spawned):
    """The port's un-meshed engines on the same weights and traffic."""
    torch.set_num_threads(1)
    tree = weights["tree"]
    out = {}
    for name, (t, kw, prompts, new) in R.feature_engines(tree).items():
        out[name] = R.tokens(_port(t, **kw).generate(prompts, new))
    eng = _port(tree, **R.PREFIX_KW)
    out["prefix"] = [R.tokens(eng.generate(R.PREFIX_PROMPTS, R.PREFIX_NEW))
                     for _ in range(2)]
    # the skewed case's traffic on one device, in its order
    eng = _port(tree, **R.CHUNK_KW)
    out["skew"] = R.tokens(eng.generate(
        R.SKEW_WAVES + R.SKEW_CHUNKED + R.SKEW_BATCH, R.SKEW_NEW))
    out["journal"] = [[c.tokens, c.finish_reason] for c in _port(
        tree).generate(R.JOURNAL_PROMPTS, R.JOURNAL_NEW)]
    params = params_from_numpy(tree, "cpu", "float32")
    out["summaries_deployed"] = [s.summary_text for s in CUDASummarizer(
        "tiny", params=params, quantize=False, dtype="float32",
        device="cpu", num_slots=4, max_len=256,
        max_new_tokens=8).summarize_batch(R.threads())]
    featured = GenerationEngine(decoder_config("tiny"), params,
                                **R.summarizer_engine_kw())
    out["summaries_featured"] = [s.summary_text for s in CUDASummarizer(
        "tiny", engine=featured, max_new_tokens=8).summarize_batch(
        R.threads())]
    return out


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


@pytest.mark.parametrize("case", sorted(GREEDY))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_feature_streams_equal_jax_engine(mesh, case, mesh_runs,
                                               jax_ref, port_ref):
    for res in mesh_runs[mesh]:
        assert res[case] == jax_ref[case]
        assert res[case] == port_ref[case]


@pytest.mark.parametrize("case", sorted(GREEDY))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_feature_ran_its_dispatches(mesh, case, mesh_runs):
    # the feature really ran on the mesh: its own dispatches (and, for
    # spec, accepted draft tokens); a paged run leaves the pool whole
    for res in mesh_runs[mesh]:
        counters = res[f"{case}_counters"]
        assert counters[GREEDY[case]] > 0, counters
        if case.startswith("spec"):
            assert counters["accepted"] > 0, counters
        if case.endswith("_paged"):
            assert res[f"{case}_pool_whole"]


@pytest.mark.parametrize("case", ["spec", "chunk", "piggy"])
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_feature_sampled_streams_equal_unmeshed(mesh, case, mesh_runs,
                                                     port_ref):
    # every rank draws the whole batch from a generator seeded alike
    for res in mesh_runs[mesh]:
        assert res[f"{case}_sampled"] == port_ref[f"{case}_sampled"]
        assert res[f"{case}_sampled_counters"][GREEDY[case]] > 0


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_prefix_hits_equal_jax_engine(mesh, mesh_runs, jax_ref,
                                           port_ref):
    for res in mesh_runs[mesh]:
        assert res["prefix"] == jax_ref["prefix"] == port_ref["prefix"]
        assert res["prefix_zero_copy"] > 0
        assert res["prefix_stats"]["hits"] > 0
        assert res["prefix_stats"] == jax_ref["prefix_stats"]


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_prefix_blocks_stay_in_their_dp_shard(mesh, mesh_runs):
    for res in mesh_runs[mesh]:
        assert res["prefix_locality"] and all(res["prefix_locality"])
        # each shard's trie holds only its own shard's blocks
        tries = res["prefix_trie_shards"]
        assert len(tries) == MESHES[mesh][0]
        for shard, owners in enumerate(tries):
            assert owners and set(owners) == {shard}
        # free + trie-held blocks make the pool whole, every trie node is
        # pinned once, and a flush returns every block
        assert res["prefix_books"] == [R.PREFIX_KW["kv_pool_blocks"], True]
        assert res["prefix_flushed_free"] == R.PREFIX_KW["kv_pool_blocks"]


@pytest.mark.parametrize("mesh", MESHES)
def test_every_rank_returns_the_same_feature_completions(mesh, mesh_runs):
    keys = [*GREEDY, "spec_sampled", "chunk_sampled", "piggy_sampled",
            "prefix",
            "prefix_stats", "skew", "skew_shed", "skew_level", "journal",
            "journal_counts", "summaries_deployed", "summaries_featured"]
    first = mesh_runs[mesh][0]
    for res in mesh_runs[mesh][1:]:
        for k in keys:
            assert res[k] == first[k], k


@pytest.mark.parametrize("mesh", MESHES)
def test_supervisor_breaker_open_on_rank_0_stands_on_every_rank(
        mesh, mesh_runs, port_ref):
    # rank 0 alone holds an open spec_verify breaker: no rank verifies,
    # and plain decode gives the greedy spec stream all the same
    for rank, res in enumerate(mesh_runs[mesh]):
        assert res["supervised_spec_dispatches"] == 0
        assert res["supervised"] == port_ref["spec"]
        assert res["supervised_breaker"] == ("open" if rank == 0
                                             else "closed")


@pytest.mark.parametrize("mesh", MESHES)
def test_skewed_clocks_and_telemetry_leave_rank_0_deciding(mesh, mesh_runs,
                                                           port_ref):
    # every rank but 0 runs 1000 s ahead and holds TTFTs far over the SLO:
    # deciding for itself, it would never hold the wave and would shed the
    # batch lane at the door; rank 0's turn stands everywhere
    for res in mesh_runs[mesh]:
        assert res["skew_held_steps"] == 3
        assert res["skew_shed"] == [False] * len(R.SKEW_BATCH)
        assert res["skew_level"] == 0
        assert res["skew_late"] == "deadline"
        assert res["skew_chunks"] > 0
        assert res["skew"] == port_ref["skew"]


@pytest.mark.parametrize("mesh", MESHES)
def test_journal_lives_on_rank_0_and_restarts_the_mesh(mesh, mesh_runs,
                                                       port_ref):
    runs = mesh_runs[mesh]
    for rank, res in enumerate(runs):
        # a warm restart finishes as the uninterrupted run does
        assert res["journal"] == port_ref["journal"]
        replayed, abandoned, _rids = res["journal_counts"]
        assert replayed > 0 and abandoned == 0
        assert res["journal_stats_enabled"]
        if rank == 0:
            assert res["journal_store"] == [True, True]
            assert res["journal_opened"] and all(
                p.endswith(f"journal_{mesh}.sqlite3")
                for p in res["journal_opened"])
        else:
            # the other ranks hold no store and never opened one
            assert res["journal_store"] == [False, False]
            assert res["journal_opened"] == []


@pytest.mark.parametrize("which", ["deployed", "featured"])
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_summaries_with_the_features_equal_unmeshed(mesh, which,
                                                         mesh_runs,
                                                         port_ref):
    # the deployed llm block's options (deadline_s, journal),
    # and a mesh engine bringing spec, the scheduler and the prefix tries
    for rank, res in enumerate(mesh_runs[mesh]):
        assert res[f"summaries_{which}"] == port_ref[f"summaries_{which}"]
        assert res["summaries_journal_store"] == (rank == 0)


#: what the mesh still refuses, and the ROADMAP item each names
STILL_REFUSED = {"role": "6d", "attn_impl": "6c.2", "sp": "6c.2",
                 "ep": "6c.3", "pp": "6e"}


@pytest.mark.parametrize("name", sorted(STILL_REFUSED))
@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_still_refuses_naming_its_item(mesh, name, mesh_runs):
    for res in mesh_runs[mesh]:
        kind, msg = res["feature_refusals"][name]
        assert kind == "NotImplementedError", msg
        assert f"item {STILL_REFUSED[name]}" in msg, msg


def test_mesh_first_rank_is_where_host_stores_live():
    # the journal opens where Mesh.is_first: a mesh of one rank, or, for a
    # view with no process group, the rank at every coordinate 0
    from copilot_for_consensus_tpu_torch.parallel.mesh import (
        Mesh,
        MeshConfig,
        build_mesh,
    )

    assert build_mesh().is_first
    cfg = MeshConfig(dp=2, tp=2).resolve(4)
    zero = dict.fromkeys(("dp", "pp", "sp", "ep", "tp"), 0)
    assert Mesh(cfg, coords=zero, device="cpu").is_first
    assert not Mesh(cfg, coords={**zero, "tp": 1}, device="cpu").is_first
