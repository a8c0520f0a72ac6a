# The prefill/decode roles on the port, one CPU device a role: a
# DisaggregatedEngine's greedy streams equal a co-located paged engine's
# (the port's and the JAX package's) in float32, every handoff moves the
# exact KV and both pools get every block back; a full decode side
# re-parks handoffs; RoleConfig resolves as the JAX one does and a role
# over more than one device (dp or tp > 1) is refused, naming ROADMAP
# Queue 1 item 6; the engine-level plumbing (the release hold, deadlines
# armed on import, the external backlog, the journal across roles) holds.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.roles import (
    RoleConfig as JaxRoleConfig,
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
from copilot_for_consensus_tpu_torch.engine.journal import EngineJournal
from copilot_for_consensus_tpu_torch.engine.roles import (
    DisaggregatedEngine,
    RoleConfig,
)
from copilot_for_consensus_tpu_torch.engine.scheduler import SchedulerConfig
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

CFG = decoder_config("tiny")
KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
          prefill_chunk=8, kv_pool_blocks=24)
CPUS = ["cpu", "cpu"]


@functools.lru_cache(maxsize=None)
def _weights():
    jp = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                          dtype=jnp.float32)
    return jp, jax.tree.map(np.asarray, jp)


def _params():
    return params_from_numpy(_weights()[1], "cpu", "float32")


def _port(**kw):
    return GenerationEngine(CFG, _params(), dtype="float32", device="cpu",
                            **{**KW, "telemetry": False, **kw})


def _roles(**kw):
    engine_kw = {**KW, "dtype": "float32", **kw.pop("engine_kw", {})}
    return DisaggregatedEngine(CFG, _params(), devices=CPUS,
                               engine_kw=engine_kw, **kw)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(3, CFG.vocab_size, size=n).tolist()
            for n in (5, 12, 20, 30, 9, 17)]


@pytest.mark.parametrize("decode_kw", [
    {}, {"num_slots": 2, "kv_pool_blocks": 20}],
    ids=["equal_sides", "decode_backpressure"])
def test_roles_equal_a_colocated_engine_and_jax(decode_kw):
    want = [c.tokens for c in _port(kv_pool_blocks=20).generate(
        _prompts(), max_new_tokens=6)]
    jax_eng = JaxEngine(jax_config("tiny"), _weights()[0],
                        dtype=jnp.float32, kv_dtype=jnp.float32,
                        attn_impl="xla", kv_kernel="pallas",
                        telemetry=False, **{**KW, "kv_pool_blocks": 20})
    assert [c.tokens for c in jax_eng.generate(
        _prompts(), max_new_tokens=6)] == want
    dis = _roles(engine_kw={"telemetry": True}, decode_kw=decode_kw)
    comps = dis.generate(_prompts(), max_new_tokens=6)
    assert [c.tokens for c in comps] == want
    assert [c.request_id for c in comps] == list(range(len(want)))
    st = dis.stats()
    assert st["handoffs"] == len(want)
    assert st["handoff_blocks"] >= len(want)
    assert st["pending_handoffs"] == 0
    assert st["prefill"]["role"] == "prefill"
    assert st["decode"]["role"] == "decode"
    assert st["prefill"]["handoff_exported"] == len(want)
    assert st["decode"]["handoff_imported"] == len(want)
    for eng in (dis.prefill, dis.decode):
        assert eng._pool.free_blocks == eng._pool.num_blocks
    text = dis.prefill.telemetry.metrics.render_prometheus()
    for series in ("copilot_engine_role_handoff_blocks_total",
                   "copilot_engine_role_handoff_wait_seconds",
                   "copilot_engine_role_occupancy"):
        assert series in text


def test_role_config_resolve_equals_jax():
    for cfg, n in ((dict(prefill_dp=2, tp=2), 8), (dict(), 2),
                   (dict(prefill_dp=1, decode_dp=3), 4)):
        got, want = RoleConfig(**cfg).resolve(n), \
            JaxRoleConfig(**cfg).resolve(n)
        assert (got.prefill_dp, got.decode_dp, got.tp) == \
            (want.prefill_dp, want.decode_dp, want.tp)
    with pytest.raises(ValueError, match="nothing left"):
        RoleConfig(prefill_dp=4, tp=2).resolve(8)
    with pytest.raises(ValueError, match="do not divide"):
        RoleConfig(prefill_dp=1, tp=3).resolve(8)


@pytest.mark.parametrize("roles,n", [
    (RoleConfig(prefill_dp=2), 3), (RoleConfig(tp=2), 4),
    (RoleConfig(decode_dp=2), 3)], ids=["prefill_dp", "tp", "decode_dp"])
def test_a_role_over_several_devices_waits_for_item_6(roles, n):
    with pytest.raises(NotImplementedError, match="item 6"):
        DisaggregatedEngine(CFG, _params(), roles=roles,
                            devices=["cpu"] * n,
                            engine_kw={**KW, "dtype": "float32"})


def test_role_guards():
    with pytest.raises(ValueError, match="kv_pool_blocks"):
        _port(kv_pool_blocks=0, role="prefill")
    with pytest.raises(ValueError, match="'both', 'prefill' or 'decode'"):
        _port(role="prefill_only")
    with pytest.raises(ValueError, match="requires kv_pool_blocks"):
        DisaggregatedEngine(CFG, _params(), devices=CPUS,
                            engine_kw={"dtype": "float32"})
    with pytest.raises(ValueError, match="prefill-role"):
        _port(role="prefill").admit_prefilled(None)


def test_handoff_deadline_and_backpressure_plumbing():
    pre = _port(kv_pool_blocks=20, role="prefill")
    assert pre._handoff_high == pre.num_slots // 2
    dec = _port(kv_pool_blocks=20, role="decode")
    pre.submit([5, 9, 13], max_new_tokens=8, deadline_s=60.0)
    handoffs = []
    for _ in range(10):
        pre.step()
        handoffs = pre.take_prefilled()
        if handoffs:
            break
    assert len(handoffs) == 1
    assert not dec._deadlines_in_use
    assert dec.admit_prefilled(handoffs[0]) is not None
    assert dec._deadlines_in_use           # the expiry sweep is armed
    pre.set_handoff_external(7)
    assert pre._handoff_external == 7
    pre.set_handoff_external(-3)
    assert pre._handoff_external == 0


def test_release_hold_stops_waves_at_the_handoff_mark():
    pre = _port(role="prefill", handoff_high=2,
                scheduler=SchedulerConfig())
    for p in _prompts():
        pre.submit(p, max_new_tokens=6)
    pre.step()
    assert len(pre._handoff) >= 2          # parked, never decoded
    assert not pre._active
    queued = pre._sched.queued
    pre.step()                             # the hold: nothing released
    assert pre._sched.queued == queued
    assert pre.sched_stats()["signals"]["handoff_backlog"] >= 2
    pre.take_prefilled()
    pre.step()
    assert pre._sched.queued < queued      # drained: waves again


def test_parked_handoff_expires_with_its_deadline():
    pre = _port(role="prefill")
    rid = pre.submit([5, 9, 13, 21], max_new_tokens=8, deadline_s=60.0)
    pre.step()
    assert len(pre._handoff) == 1
    pre._handoff[next(iter(pre._handoff))][0].deadline_at = 0.0
    out = pre.step()
    assert [c.finish_reason for c in out if c.request_id == rid] == \
        ["deadline"]
    assert not pre._handoff
    assert pre._pool.free_blocks == pre._pool.num_blocks


def test_journal_across_roles_neither_loses_nor_duplicates(tmp_path):
    pj = EngineJournal(str(tmp_path / "pre.sqlite3"))
    dj = EngineJournal(str(tmp_path / "dec.sqlite3"))
    dis = _roles(prefill_kw={"journal": pj}, decode_kw={"journal": dj})
    for p in _prompts()[:3]:
        dis.submit(p, max_new_tokens=12)
    assert pj.depth() == 3
    dis.step()
    # exported at take_prefilled: each row moved from one journal to the
    # other, never in both and never in neither
    moved = dis.handoffs
    assert moved >= 1
    assert pj.depth() + dj.depth() == 3
    assert dj.depth() == moved
    # a warm restart of the decode role resumes exactly its rows
    want = {c.request_id: c.tokens for c in _port(
        kv_pool_blocks=20).generate(_prompts()[:3], max_new_tokens=12)}
    restarted = GenerationEngine(
        CFG, _params(), dtype="float32", device="cpu", telemetry=False,
        role="decode", journal=EngineJournal(
            str(tmp_path / "dec.sqlite3")), **KW)
    assert restarted.journal_replayed == moved
    done = {}
    while len(done) < moved:
        for c in restarted.step():
            done[c.request_id] = c
    assert sorted(len(c.tokens) for c in done.values()) == [12] * moved
    assert all(c.tokens in want.values() for c in done.values())
