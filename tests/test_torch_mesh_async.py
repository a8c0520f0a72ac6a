# The async front end over dp×tp meshes of gloo ranks on the CPU (tiny,
# float32): dp2×tp2 and tp4, four ranks each, one spawn a mesh
# (tests/torch_mesh_rank.py, suite "async"). Rank 0 serves
# CUDASummarizer.summarize_async, a MeshEngineRunner and the pipelined
# SummarizationService; every other rank follows rank 0's operation log
# (CUDASummarizer.follow(), mesh_runner.follow). Greedy summaries from
# staggered arrivals on two threads, with an idle gap longer than the
# groups' timeout, equal the JAX package's TPUSummarizer.summarize_batch
# on one device token for token and the un-meshed port's summarize_async;
# sampled completions equal an un-meshed port engine that replays rank
# 0's kept log. A deterministic decode fault is contained and replayed
# alike on every rank, to the fault-free streams (the oracle of
# tests/test_engine_chaos.py); a watchdog trip on a hang fault leaves
# every rank's slots, queue and free blocks equal; the spec_verify and
# resource breakers follow rank 0's verdicts while the other ranks' clocks
# run 1000 s ahead; the journal stays on rank 0 and warm-restarts the mesh
# to the uninterrupted result; drain and close end every follower; and a
# follower killed with SIGKILL fails rank 0's handles with a structured
# error in bounded time while the other ranks exit non-zero.
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
from copilot_for_consensus_tpu.summarization.base import (
    ThreadContext as JaxThread,
)
from copilot_for_consensus_tpu.summarization.tpu_summarizer import (
    TPUSummarizer,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.mesh_runner import (
    MeshDivergence,
    replay,
)
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_mesh_rank as R  # noqa: E402

#: (dp, tp) of each mesh
MESHES = {"dp2tp2": (2, 2), "tp4": (1, 4)}
#: the rank of tp4 that kills itself mid-serve (its last case)
KILL_RANK = {"tp4": 3}
#: the groups' collective timeout in the spawns: the idle gap outlasts it
TIMEOUT_S = 10
#: seconds the spawned ranks of both meshes may take together
SPAWN_TIMEOUT_S = 240
#: how long past the groups' timeout a killed rank's peers may take to
#: fail rank 0's handles
KILL_MARGIN_S = 30


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's tiny weights (f32, key 7) as a numpy tree, saved
    for the ranks."""
    d = tmp_path_factory.mktemp("mesh_async")
    jcfg = jax_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    np.savez(d / "tiny.npz", **_flat(tree))
    return {"dir": d, "jcfg": jcfg, "jp": jp, "tree": tree}


@pytest.fixture(scope="module")
def spawned(weights):
    """Both meshes' ranks, joined over tcp on localhost (rank 0 serves the
    store), started together; the references below are computed while
    they run."""
    d = weights["dir"]
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(HERE.parent)}
    procs = {}
    for tag, (dp, tp) in MESHES.items():
        spec = dict(world=dp * tp, dp=dp, tp=tp, out=str(d / tag),
                    tiny=str(d / "tiny.npz"), suite="async",
                    tcp=f"127.0.0.1:{_free_port()}", timeout_s=TIMEOUT_S,
                    journal=str(d / f"journal_{tag}.sqlite3"),
                    kill_rank=KILL_RANK.get(tag, 0))
        (d / f"{tag}.json").write_text(json.dumps(spec))
        procs[tag] = [subprocess.Popen(
            [sys.executable, str(HERE / "torch_mesh_rank.py"),
             str(d / f"{tag}.json"), str(rank)], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
            for rank in range(dp * tp)]
    yield procs
    for ps in procs.values():
        for p in ps:
            if p.poll() is None:
                p.kill()


def _port_engine(tree, **kw):
    return GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            **{**R.ASYNC_KW, **kw})


@pytest.fixture(scope="module")
def jax_ref(weights, spawned):
    """TPUSummarizer.summarize_batch on one device, the async suite's
    engine geometry."""
    kw = {k: v for k, v in R.ASYNC_KW.items()
          if k not in ("dtype", "device", "telemetry")}
    jeng = JaxEngine(weights["jcfg"], weights["jp"], dtype=jnp.float32,
                     kv_dtype=jnp.float32, attn_impl="xla",
                     telemetry=False, **kw)
    threads = [JaxThread(**vars(t)) for t in R.async_threads()]
    got = TPUSummarizer("tiny", engine=jeng,
                        max_new_tokens=R.ASYNC_NEW).summarize_batch(threads)
    return [[s.summary_text, s.completion_tokens, s.prompt_tokens]
            for s in got]


@pytest.fixture(scope="module")
def port_ref(weights, spawned):
    """The un-meshed port on the same traffic: summarize_async staggered,
    the pipelined service, and the fault-free streams of the fault
    cases."""
    torch.set_num_threads(1)
    tree = weights["tree"]
    cfg = decoder_config("tiny")
    out = {"greedy": R.staggered(R.async_summarizer(cfg, tree, None),
                                 0.0)}
    summ = R.async_summarizer(cfg, tree, None)
    out["pipelined"] = R.async_pipelined(summ, R.async_threads())
    summ.close()
    out["fault"] = [c.tokens for c in _port_engine(tree).generate(
        R.PROMPTS, R.FAULT_NEW)]
    t, kw, prompts, new = R.feature_engines(tree)["spec"]
    out["breakers"] = [c.tokens for c in GenerationEngine(
        cfg, params_from_numpy(t, "cpu", "float32"),
        **{**R.FEAT_KW, **kw}).generate(prompts, new)]
    out["journal"] = [c.tokens for c in _port_engine(tree).generate(
        R.JOURNAL_PROMPTS, R.JOURNAL_NEW)]
    return out


@pytest.fixture(scope="module")
def mesh_runs(spawned, weights, jax_ref, port_ref):
    """Each rank's results and exit code, once every rank has ended."""
    d = weights["dir"]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    runs, codes = {}, {}
    for tag, procs in spawned.items():
        codes[tag] = []
        for p in procs:
            try:
                _, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"mesh ranks did not finish in "
                            f"{SPAWN_TIMEOUT_S} s: a rank hangs")
            codes[tag].append([p.returncode, err.decode()[-2000:]])
        dp, tp = MESHES[tag]
        runs[tag] = []
        for r in range(dp * tp):
            f = d / f"{tag}.{r}.json"
            runs[tag].append(json.loads(f.read_text()) if f.exists()
                             else None)
        for r, res in enumerate(runs[tag]):
            if r == KILL_RANK.get(tag):
                continue
            assert res is not None, f"{tag} rank {r}: {codes[tag][r]}"
            assert "error" not in res, f"{tag} rank {r}:\n{res['error']}"
    return {"runs": runs, "codes": codes}


def _followers(mesh_runs, mesh):
    runs = mesh_runs["runs"][mesh]
    return [res for r, res in enumerate(runs)
            if r and r != KILL_RANK.get(mesh)]


# ---------------------------------------------------------------------------
# greedy and sampled traffic
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
def test_summarize_async_greedy_equals_jax_summarizer(mesh, mesh_runs,
                                                      jax_ref):
    # staggered arrivals from two threads, then an idle gap
    got = mesh_runs["runs"][mesh][0]["greedy"]
    assert got["summaries"] == jax_ref
    assert got["drained"] is True


@pytest.mark.parametrize("mesh", MESHES)
def test_summarize_async_greedy_equals_unmeshed_async(mesh, mesh_runs,
                                                      port_ref):
    got = mesh_runs["runs"][mesh][0]["greedy"]
    assert got["summaries"] == port_ref["greedy"]["summaries"]


@pytest.mark.parametrize("mesh", MESHES)
def test_idle_gap_outlasts_the_groups_timeout(mesh, mesh_runs):
    # no collective was open while rank 0 idled past the timeout: the
    # followers waited on the store and served the late threads after it
    lead = mesh_runs["runs"][mesh][0]["greedy"]
    assert lead["idle_s"] > TIMEOUT_S
    assert lead["log"]["broken"] == ""
    for res in _followers(mesh_runs, mesh):
        f = res["greedy"]
        assert f["wait_s"] > TIMEOUT_S
        assert f["steps"] == lead["log"]["steps"]
        assert f["submits"] == len(R.async_threads())


CASES = ("greedy", "sampled", "pipelined", "fault", "watchdog",
         "breakers")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mesh", MESHES)
def test_followers_complete_what_rank_0_completes(mesh, case, mesh_runs):
    # each step's completions, request ids first, equal rank 0's
    lead = mesh_runs["runs"][mesh][0][case]["completions"]
    assert lead
    for res in _followers(mesh_runs, mesh):
        assert res[case]["completions"] == lead


@pytest.mark.parametrize("mesh", MESHES)
def test_sampled_completions_equal_a_replay_of_rank_0s_log(mesh, mesh_runs,
                                                           weights):
    lead = mesh_runs["runs"][mesh][0]["sampled"]
    eng = _port_engine(weights["tree"], sampling=R.SAMPLED, seed=3)
    assert replay(eng, lead["batches"]) == lead["completions"]
    assert all(r[0] == "ok" for r in lead["results"])


def test_replay_refuses_a_log_it_cannot_follow(mesh_runs, weights):
    # a request id rank 0 did not hand out is a divergence, not a hang
    batches = json.loads(json.dumps(
        mesh_runs["runs"]["tp4"][0]["sampled"]["batches"]))
    for batch in batches:
        for op in batch:
            if op[0] == "submit":
                op[1] += 1
                break
        else:
            continue
        break
    eng = _port_engine(weights["tree"], sampling=R.SAMPLED, seed=3)
    with pytest.raises(MeshDivergence, match="request id"):
        replay(eng, batches)


@pytest.mark.parametrize("mesh", MESHES)
def test_pipelined_service_reports_equal_unmeshed(mesh, mesh_runs,
                                                  port_ref):
    got = mesh_runs["runs"][mesh][0]["pipelined"]
    want = port_ref["pipelined"]
    assert got["pipelined"] is True
    assert got["summaries"] == want["summaries"]
    assert got["events"] == want["events"]
    assert len(got["summaries"]) == len(R.async_threads())


# ---------------------------------------------------------------------------
# supervision: faults, the watchdog, the breakers, the journal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
def test_decode_fault_is_contained_and_replayed_alike(mesh, mesh_runs,
                                                      port_ref, weights):
    lead = mesh_runs["runs"][mesh][0]["fault"]
    assert [r[1] for r in lead["results"]] == port_ref["fault"]
    assert lead["recovery"]["containments"] == 1
    assert lead["recovery"]["replayed"] > 0
    assert lead["recovery"]["failed"] == 0
    for res in _followers(mesh_runs, mesh):
        assert res["fault"]["contained"] == 1
        assert res["fault"]["state"] == lead["state"]
    # an un-meshed engine with the same plan follows rank 0's log too
    eng = _port_engine(weights["tree"],
                       faults=R.fault_plan(R.DECODE_FAULT))
    assert replay(eng, lead["batches"]) == lead["completions"]


@pytest.mark.parametrize("mesh", MESHES)
def test_watchdog_trip_on_a_hang_leaves_every_rank_alike(mesh, mesh_runs):
    lead = mesh_runs["runs"][mesh][0]["watchdog"]
    assert lead["recovery"]["watchdog_trips"] == 1
    assert lead["recovery"]["suspect_failures"] > 0
    kinds = [r[0] for r in lead["results"]]
    assert "EngineSuspect" in kinds
    # the submits made during the hang are served after it
    assert kinds[-2:] == ["ok", "ok"]
    assert lead["state"]["free_blocks"] == \
        R.FEAT_PAGED["kv_pool_blocks"]
    assert lead["state"]["queue"] == 0 and not lead["state"]["active"]
    for res in _followers(mesh_runs, mesh):
        assert res["watchdog"]["state"] == lead["state"]
        assert res["watchdog"]["contained"] == \
            lead["recovery"]["containments"]


@pytest.mark.parametrize("mesh", MESHES)
def test_breakers_follow_rank_0_while_other_clocks_skew(mesh, mesh_runs,
                                                        port_ref):
    lead = mesh_runs["runs"][mesh][0]["breakers"]
    # both breakers tripped on rank 0; the streams are the fault-free ones
    assert lead["breakers"]["spec_verify"] >= 1
    assert lead["breakers"]["resource"] >= 1
    assert [r[1] for r in lead["results"]] == port_ref["breakers"]
    caps = [op[1] for batch in lead["batches"] for op in batch
            if op[0] == "slot_cap"]
    assert caps and min(caps) < R.FEAT_KW["num_slots"]
    for res in _followers(mesh_runs, mesh):
        f = res["breakers"]
        assert f["spec_dispatches"] == lead["spec_dispatches"]
        assert f["state"] == lead["state"]


@pytest.mark.parametrize("mesh", MESHES)
def test_journal_on_rank_0_warm_restarts_the_mesh(mesh, mesh_runs,
                                                  port_ref):
    runs = mesh_runs["runs"][mesh]
    lead = runs[0]["journal"]
    assert lead["journal_store"] == [True, True]
    # the run stopped with work left; the restart resumed it
    assert lead["recovered"]
    # the first run's completions by id, the resumed ones by the
    # correlation id ("r<index>") their rows kept
    got = {rid: toks for rid, toks, *_ in lead["first"]}
    corr = dict(lead["recovered"])
    for rid, toks, *_ in lead["second"]:
        got[int(corr[rid][1:])] = toks
    assert [got[i] for i in range(len(R.JOURNAL_PROMPTS))] == \
        port_ref["journal"]
    for res in _followers(mesh_runs, mesh):
        j = res["journal"]
        assert j["journal_store"] == [False, False]
        assert j["recovered"] == lead["recovered"]
        assert j["first"] == lead["first"] and j["second"] == lead["second"]


# ---------------------------------------------------------------------------
# the ends: drain, close, a killed follower, the wrong entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
def test_drain_and_close_end_every_follower(mesh, mesh_runs):
    lead = mesh_runs["runs"][mesh][0]["sessions"]
    assert lead["drained"] is True
    # close with requests in flight fails them with "runner stopped"
    assert lead["closed"] and all(c[1] == "runner stopped"
                                  for c in lead["closed"])
    for res in _followers(mesh_runs, mesh):
        first, second, other = res["sessions"]["follows"]
        assert [first["closed"], second["closed"], other["closed"]] == \
            [False, True, True]
        assert first["completed"] == 2 and other["steps"] == 0
    codes = mesh_runs["codes"][mesh]
    if mesh not in KILL_RANK:
        assert [c[0] for c in codes] == [0] * len(codes), codes


@pytest.mark.parametrize("mesh", MESHES)
def test_summarize_async_on_a_follower_names_follow(mesh, mesh_runs):
    for rank, res in enumerate(mesh_runs["runs"][mesh]):
        if res is None:
            continue
        kind, msg = res["wrong_entry"]
        assert kind == "ValueError", msg
        if rank:
            assert "CUDASummarizer.follow()" in msg, msg
        else:
            assert "rank 0 serves" in msg, msg


def test_killed_follower_fails_rank_0_handles_in_bounded_time(mesh_runs):
    mesh = "tp4"
    runs, codes = mesh_runs["runs"][mesh], mesh_runs["codes"][mesh]
    lead = runs[0]["kill"]
    assert lead["handles"]
    for h in lead["handles"]:
        assert h[0] == "EngineFailed" and h[1] == "mesh-failed", h
        assert h[2] <= TIMEOUT_S + KILL_MARGIN_S, h
    assert lead["after"] == ["EngineFailed", "mesh-failed"]
    assert codes[0][0] == 0
    assert codes[KILL_RANK[mesh]][0] == -9
    for r, res in enumerate(runs):
        if r in (0, KILL_RANK[mesh]):
            continue
        # the dead rank's peers raise and exit non-zero
        assert res["kill"]["follow"] != "returned"
        assert codes[r][0] != 0


# ---------------------------------------------------------------------------
# in-process: one rank, the channel and the follower's supervisor
# ---------------------------------------------------------------------------


def test_world_size_one_publishes_nothing(weights):
    # a mesh of one rank: summarize_async runs the plain runner, the
    # engine has no operation log, and drain/close release no one
    from copilot_for_consensus_tpu_torch.engine.async_runner import (
        AsyncEngineRunner,
    )
    from copilot_for_consensus_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh()
    summ = R.async_summarizer(decoder_config("tiny"), weights["tree"], mesh)
    wait = summ.summarize_async(R.async_threads()[0])
    runner = summ._runner
    assert type(runner) is AsyncEngineRunner
    assert summ.engine._oplog is None and summ.engine._log_serial == 0
    assert wait(60).completion_tokens > 0
    assert summ.drain(30) is True
    with pytest.raises(ValueError, match="one rank"):
        summ.follow()


def test_control_channel_orders_and_reports_a_lost_publisher(tmp_path):
    from torch.distributed import FileStore

    from copilot_for_consensus_tpu_torch.parallel.collectives import (
        ChannelLost,
        ControlChannel,
    )

    store = FileStore(str(tmp_path / "store"), 1)
    pub = ControlChannel(store, "t", readers=1)
    sub = ControlChannel(store, "t", readers=1, dead_after_s=0.3,
                         poll_s=0.05)
    for i in range(3):
        pub.publish([("op", i)])
    assert [sub.receive() for _ in range(3)] == [[("op", i)]
                                                 for i in range(3)]
    # read messages leave the store
    assert not sub._store.check(["m1"])
    # nothing more comes and no heartbeat moves: the reader gives up
    t0 = time.monotonic()
    with pytest.raises(ChannelLost, match="heartbeat"):
        sub.receive()
    assert time.monotonic() - t0 < 5.0


def test_follower_supervisor_decides_nothing(weights):
    from copilot_for_consensus_tpu_torch.engine.mesh_runner import (
        LeaderVerdict,
    )
    from copilot_for_consensus_tpu_torch.engine.supervisor import (
        FollowerSupervisor,
    )

    eng = GenerationEngine(decoder_config("tiny"),
                           params_from_numpy(weights["tree"], "cpu",
                                             "float32"),
                           **{**R.FEAT_KW, **R.FEAT_PAGED})
    sup = FollowerSupervisor(eng)
    assert eng.supervisor is sup and sup.start() is sup
    sup.begin_dispatch("decode")
    sup.on_dispatch_error("verify", RuntimeError("RESOURCE_EXHAUSTED"))
    assert sup.spec_allowed() and sup.verify_breaker.state == "closed"
    assert sup.resource_breaker.state == "closed"
    ids = [eng.submit(p, 12) for p in R.PROMPTS[:2]]
    eng.step()
    plan = sup.contain(LeaderVerdict(injected=True, resource=False))
    assert sorted(r.request_id for r, _g in plan.evacuated) == ids
    assert plan.injected and not plan.resource
    assert eng._pool.free_blocks == R.FEAT_PAGED["kv_pool_blocks"]
    with pytest.raises(AssertionError, match="no clock"):
        sup._clock()
