# The port's decode dispatch — windows_per_dispatch, the done-window piece,
# the static-buffer body its CUDA graphs capture — against the JAX
# package's engine on the same weights in float32: greedy token streams
# must be EQUAL for every (decode_window, windows_per_dispatch), on the
# contiguous and the paged engine, plain and int8, tiny and tiny-swa. On
# the CPU the engine runs the very body the card captures, static buffers
# included. Ops are held to the JAX ones at 1e-5; the static-shape cache
# and pool writes to the host-masked writes they replace, exactly.
import functools

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
from copilot_for_consensus_tpu.ops.attention import (
    decode_attention_prefix_window as jax_prefix_window,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.faults import FaultSpec
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.kv_pool import BlockPool
from copilot_for_consensus_tpu_torch.engine.supervisor import (
    EngineSupervisor,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.ops.attention import (
    decode_attention_prefix_window,
)

TOL = 1e-5
#: one geometry for both layouts: blocks of 32 (dividing 128 and max_len),
#: a pool of 20 blocks (a max_len slot takes 4), one prefill bucket (each
#: wave shape is one more program for the JAX engine to compile)
KW = dict(num_slots=3, max_len=128, prefill_buckets=(32,),
          prefill_chunk=32)
# mixed lengths, twice as many requests as slots: two admission waves of
# three rows, slots that retire and refill between dispatches
PROMPTS = [[5, 9, 13], list(range(40, 61)), [7] * 9,
           list(range(100, 130)), [3, 4], list(range(200, 214))]
WINDOWS = [(1, 1), (4, 1), (4, 2), (2, 3)]
MODELS = [("tiny", {}), ("tiny-swa", {"sliding_window": 16})]


@functools.lru_cache(maxsize=None)
def _weights(name, window):
    over = {"sliding_window": window} if window else {}
    jcfg = jax_config(name, **over)
    jp = jdec.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    return jcfg, jp, jax.tree.map(np.asarray, jp)


def _pair(name, overrides, *, quantize=False, paged=False, **kw):
    jcfg, jp, tree = _weights(name, overrides.get("sliding_window", 0))
    kw = {**KW, **kw}
    blocks = 20 if paged else 0
    jeng = JaxEngine(jcfg, jp, dtype=jnp.float32, kv_dtype=jnp.float32,
                     attn_impl="xla", quantize=quantize,
                     kv_pool_blocks=blocks,
                     kv_kernel="pallas" if paged else "auto",
                     telemetry=False, **kw)
    teng = GenerationEngine(decoder_config(name, **overrides),
                            params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", quantize=quantize,
                            kv_pool_blocks=blocks, device="cpu", **kw)
    return jeng, teng


def _assert_same(want, got):
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        assert g.finish_reason == w.finish_reason
        assert g.prompt_len == w.prompt_len


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("quantize", [False, "int8"], ids=["plain", "int8"])
@pytest.mark.parametrize("name,overrides", MODELS, ids=["tiny", "tiny-swa16"])
@pytest.mark.parametrize("window,n_windows", WINDOWS,
                         ids=[f"w{w}x{n}" for w, n in WINDOWS])
def test_greedy_streams_equal_jax_engine(window, n_windows, name, overrides,
                                         quantize, paged):
    jeng, teng = _pair(name, overrides, quantize=quantize, paged=paged,
                       decode_window=window, windows_per_dispatch=n_windows)
    assert teng._dispatch_steps == window * n_windows
    assert teng.prompt_limit == jeng.prompt_limit
    _assert_same(jeng.generate(PROMPTS, max_new_tokens=12),
                 teng.generate(PROMPTS, max_new_tokens=12))
    if paged:
        st = teng.kv_pool_stats()
        assert st["free_blocks"] == st["num_blocks"]   # all returned
    # the CPU runs the body eagerly: every dispatch, no graph
    assert teng.graph_stats()["graphs"] == 0
    assert teng.graph_stats()["eager"] > 0


@pytest.mark.parametrize("max_len,window,n_windows", [
    (64, 8, 1), (64, 8, 4), (128, 4, 3), (1024, 8, 2), (1024, 16, 8)])
def test_prompt_limit_equals_jax_engine(max_len, window, n_windows):
    cfg = jax_config("tiny")
    jeng = JaxEngine(cfg, None, max_len=max_len, decode_window=window,
                     windows_per_dispatch=n_windows, telemetry=False,
                     dtype=jnp.float32)
    teng = GenerationEngine(decoder_config("tiny"), max_len=max_len,
                            decode_window=window,
                            windows_per_dispatch=n_windows,
                            dtype="float32", device="cpu")
    assert teng.prompt_limit == jeng.prompt_limit
    assert teng._dispatch_steps == jeng._dispatch_steps


def test_no_prompt_room_raises_like_jax():
    with pytest.raises(ValueError, match="windows/dispatch"):
        GenerationEngine(decoder_config("tiny"), max_len=32,
                         decode_window=8, windows_per_dispatch=4,
                         dtype="float32", device="cpu")


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_reused_slots_at_one_bucket_equal_jax(paged):
    """Many short requests through 4 slots: slots retire and refill
    between dispatches while every dispatch runs at the same kv bucket
    (max_len 128 snaps to one), so the static buffers are reused with
    the previous occupants' values in them — parked rows, old tokens,
    old tables and maps. Streams must still equal the JAX engine's."""
    rng = np.random.default_rng(11)
    prompts = [rng.integers(3, 500, size=int(n)).tolist()
               for n in rng.integers(2, 40, size=14)]
    budgets = [int(b) for b in rng.integers(2, 11, size=14)]
    jeng, teng = _pair("tiny", {}, quantize="int8", paged=paged,
                       decode_window=2, windows_per_dispatch=2)
    static = {k: v for k, v in teng._static.items()}
    buckets = set()
    plain_bucket = teng._kv_bucket

    def recording_bucket():
        buckets.add(plain_bucket())
        return buckets and plain_bucket()

    teng._kv_bucket = recording_bucket
    want = [jeng.submit(p, b) for p, b in zip(prompts, budgets)]
    got = [teng.submit(p, b) for p, b in zip(prompts, budgets)]
    assert want == got
    wres, tres = {}, {}
    while len(tres) < len(prompts):
        for c in jeng.step():
            wres[c.request_id] = c
        for c in teng.step():
            tres[c.request_id] = c
    _assert_same([wres[i] for i in want], [tres[i] for i in got])
    assert buckets == {128}
    # the same buffers throughout, never reallocated
    assert all(teng._static[k] is v for k, v in static.items())


def _prefix_window_inputs(seed, n_done):
    rng = np.random.default_rng(seed)
    b, hq, hkv, d, s_max, n_win = 3, 4, 2, 16, 24, 4
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa
    return dict(q=f(b, hq, d), k_pref=f(b, hkv, s_max, d),
                v_pref=f(b, hkv, s_max, d), k_win=f(b, hkv, n_win, d),
                v_win=f(b, hkv, n_win, d), k_cur=f(b, hkv, d),
                v_cur=f(b, hkv, d),
                k_done=f(b, hkv, n_done, d) if n_done else None,
                v_done=f(b, hkv, n_done, d) if n_done else None,
                prefix_lengths=np.array([3, 11, 17]))


@pytest.mark.parametrize("n_done", [0, 4, 8])
@pytest.mark.parametrize("window", [0, 5, 9])
@pytest.mark.parametrize("w", [0, 3])
def test_prefix_window_with_done_piece_matches_jax(n_done, window, w):
    x = _prefix_window_inputs(n_done * 10 + window + w, n_done)
    want = jax_prefix_window(
        **{k: None if v is None else jnp.asarray(v) for k, v in x.items()},
        w=jnp.int32(w), window=window, kv_len=20)
    got = decode_attention_prefix_window(
        **{k: None if v is None else torch.from_numpy(v)
           for k, v in x.items()}, w=w, window=window, kv_len=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _merge_window_masked(cache, k_win, v_win, positions0, steps):
    """merge_window as it was before its write had a static shape: the
    dropped columns filtered out on the host by a boolean mask."""
    b, w = k_win.shape[1], k_win.shape[3]
    steps = min(steps, w)
    s_max = cache["k"].shape[3]
    bidx = torch.arange(b)[:, None].expand(b, steps)
    pidx = positions0.long()[:, None] + torch.arange(steps)[None, :]
    keep = pidx < s_max
    bidx, pidx = bidx[keep], pidx[keep]
    for name, win in (("k", k_win), ("v", v_win)):
        upd = win[:, :, :, :steps].permute(1, 3, 0, 2, 4)[keep]
        cache[name][:, bidx, :, pidx, :] = upd.to(cache[name].dtype)
    return cache


@pytest.mark.parametrize("positions,steps", [
    ([0, 5, 9, 12], 4),        # all kept
    ([13, 16, 3, 15], 4),      # partly past the extent, one parked
    ([16, 16, 16, 16], 3),     # every slot parked: all dropped
    ([14, 1, 16, 2], 6),       # ragged drops, steps short of the window
])
def test_merge_window_drops_what_the_masked_write_dropped(positions, steps):
    rng = np.random.default_rng(sum(positions) + steps)
    shape = (2, 4, 2, 16, 8)                       # extent 16
    cache0 = {k: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
              for k in ("k", "v")}
    win = [torch.from_numpy(rng.normal(size=(2, 4, 2, 6, 8)).astype(
        np.float32)) for _ in range(2)]
    pos = torch.tensor(positions)
    want = _merge_window_masked({k: v.clone() for k, v in cache0.items()},
                                *win, pos, steps)
    got = {k: v.clone() for k, v in cache0.items()}
    assert tdec.merge_window(got, *win, pos, steps) is got
    for k in ("k", "v"):
        assert torch.equal(got[k], want[k])
    jgot = jdec.merge_window({k: jnp.asarray(v) for k, v in cache0.items()},
                             *(jnp.asarray(x) for x in win),
                             jnp.asarray(positions), steps=steps)
    for k in ("k", "v"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jgot[k]))


def test_scatter_static_drops_what_scatter_dropped():
    """The device-map pool write against the host-map one on the same
    maps: sentinel entries (a parked row, columns past max_len) dropped,
    the write-back position keeps its value, every kept entry lands."""
    cfg = decoder_config("tiny")
    rng = np.random.default_rng(5)

    def pool():
        p = BlockPool(cfg, num_blocks=6, block_size=4,
                      kv_dtype=torch.float32, device="cpu")
        p.k.copy_(torch.from_numpy(rng.normal(size=p.k.shape)))
        p.v.copy_(torch.from_numpy(rng.normal(size=p.v.shape)))
        return p

    a = pool()
    b = BlockPool(cfg, num_blocks=6, block_size=4, kv_dtype=torch.float32,
                  device="cpu")
    b.k.copy_(a.k)
    b.v.copy_(a.v)
    shape = (cfg.n_layers, 3, cfg.n_kv_heads, 5, cfg.head_dim)
    k_new = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v_new = -k_new
    # row 0: positions 6..10 of table [1, 4, 2]; row 1 parked; row 2:
    # positions 2..3 of table [5], the rest past its end
    sbids = np.array([[4, 4, 2, 2, 2], [6] * 5, [5, 5, 6, 6, 6]], np.int32)
    soffs = np.array([[2, 3, 0, 1, 2], [0] * 5, [2, 3, 0, 0, 0]], np.int32)
    back = np.array([4, 1], np.int32)           # row 0's position 5
    a.scatter(k_new, v_new, sbids, soffs)
    b.scatter_static(k_new, v_new, torch.from_numpy(sbids),
                     torch.from_numpy(soffs), torch.from_numpy(back))
    assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)


def test_failed_dispatch_drops_graphs_until_the_supervisor_repairs():
    """A decode dispatch that fails (an injected fault at its boundary)
    drops the decode graphs and, with a supervisor attached, blocks them
    until a repairing audit; the engine serves on afterwards."""
    eng = GenerationEngine(decoder_config("tiny"), dtype="float32",
                           device="cpu", faults=[FaultSpec(kind="decode")],
                           **KW)
    sup = EngineSupervisor(eng)
    eng.submit([5, 6, 7], 4)
    with pytest.raises(Exception, match="injected"):
        eng.step()
    assert eng._graphs.blocked and eng._last_failed_kind == "decode"
    plan = sup.contain(RuntimeError("decode failed"))
    assert not eng._graphs.blocked
    assert [len(g) for _req, g in plan.evacuated] == [1]
    eng.submit([5, 6, 7], 4)
    assert eng.generate([[8, 9]], max_new_tokens=3)[0].tokens


def test_failed_wave_puts_its_requests_back():
    """An admission wave that fails leaves the queue, the free list and
    the pool as they were (the JAX engine's lossless unwind)."""
    eng = GenerationEngine(decoder_config("tiny"), dtype="float32",
                           device="cpu", kv_pool_blocks=20,
                           faults=[FaultSpec(kind="prefill")], **KW)
    rids = [eng.submit([3 + i] * 20, 4) for i in range(3)]
    with pytest.raises(Exception, match="injected"):
        eng.step()
    assert [r.request_id for r in eng._queue] == rids
    assert sorted(eng._free) == list(range(3)) and not eng._active
    assert eng._pool.free_blocks == 20
    comps = {}
    while eng._queue or eng._active:
        comps.update({c.request_id: c for c in eng.step()})
    assert sorted(comps) == rids


def test_slot_cap_limits_admission():
    eng = GenerationEngine(decoder_config("tiny"), dtype="float32",
                           device="cpu", **KW)
    eng.set_slot_cap(2)
    for i in range(3):
        eng.submit([5 + i, 6], 50)
    eng.step()
    assert len(eng._active) == 2 and len(eng._queue) == 1
    eng.set_slot_cap(99)
    assert eng._slot_cap == eng.num_slots


def test_graph_key_holds_the_activation_quant_mode():
    """A graph is captured with each matmul's route baked in, and
    ``set_act_quant`` changes the routes (K5 → K6, K2 → K4): a dispatch
    under another mode must not replay the other mode's graph."""
    from copilot_for_consensus_tpu_torch.models import quant

    eng = GenerationEngine(decoder_config("tiny"), dtype="float32",
                           device="cpu", **KW)
    plain = eng._graph_key(128)
    quant.set_act_quant("a8")
    try:
        a8 = eng._graph_key(128)
    finally:
        quant.set_act_quant("weight_only")
    assert plain != a8 and plain[0] == a8[0] == 128
    assert eng._graph_key(128) == plain


def test_a_new_thread_warms_up_before_it_captures():
    """cuBLAS creates a thread's handle at its first call, which a capture
    cannot hold: an engine warmed on one thread (a synchronous generate)
    and then driven from another (the async runner) runs that thread's
    first dispatch at a new bucket eagerly instead of capturing it. Runs
    on the CPU with graphs enabled for a CUDA device: no capture is
    attempted."""
    import threading

    from copilot_for_consensus_tpu_torch.engine.graphs import DecodeGraphs

    g = DecodeGraphs(torch.device("cuda"))
    ran = []
    g.run((128, "weight_only"), lambda: ran.append("main"),
          family="weight_only")
    t = threading.Thread(target=g.run, args=(
        (256, "weight_only"), lambda: ran.append("runner")),
        kwargs={"family": "weight_only"})
    t.start()
    t.join(10)
    assert not t.is_alive()
    assert ran == ["main", "runner"]
    assert g.stats()["eager"] == 2 and g.stats()["captured"] == 0


def test_a_thread_after_a_finished_one_warms_up_again():
    """Thread idents are reused once a thread exits: a runner thread
    started after another one ended (a summarizer's runner closed and a
    new one opened on the same engine) is still a new thread for cuBLAS,
    and its first dispatch at a new bucket runs eagerly."""
    import threading

    from copilot_for_consensus_tpu_torch.engine.graphs import DecodeGraphs

    g = DecodeGraphs(torch.device("cuda"))
    ran = []

    def runner(bucket, name):
        g.run((bucket, "weight_only"), lambda: ran.append(name),
              family="weight_only")

    for bucket, name in ((128, "first"), (256, "second")):
        t = threading.Thread(target=runner, args=(bucket, name))
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert ran == ["first", "second"]
    assert g.stats()["eager"] == 2 and g.stats()["captured"] == 0


def test_dropped_graphs_stay_warm_and_block_until_release():
    """After a failed dispatch the engine drops its graphs; with a
    supervisor it refuses to capture or replay until the repair, and the
    warm-up (once a process per act-quant mode) is not run again. The
    eager warm-up dispatch itself touches no CUDA API, so this runs on
    the CPU with graphs enabled for a CUDA device."""
    from copilot_for_consensus_tpu_torch.engine.graphs import DecodeGraphs

    g = DecodeGraphs(torch.device("cuda"))
    assert g.enabled
    ran = []
    g.run((128, "weight_only"), lambda: ran.append(1), family="weight_only")
    assert ran == [1] and g.stats()["eager"] == 1 and len(g) == 0
    g.drop(block=True)
    assert "weight_only" in g._warm and g.blocked
    with pytest.raises(RuntimeError, match="not been repaired"):
        g.run((128, "weight_only"), lambda: ran.append(2),
              family="weight_only")
    assert ran == [1]
    g.release()
    assert not g.blocked and "weight_only" in g._warm
