# The port's Mixtral-class MoE FFN and the MoE decoder against the JAX
# package's on the same weights (JAX params -> numpy -> params_from_numpy)
# and the same numpy-made inputs, at tiny-moe (d 128, 2 layers, 4 experts,
# top-2): ``moe_ffn`` within 1e-5 at f32 for full-precision, int8 and int4
# experts — the expert ids equal to ``jax.lax.top_k``'s, ties included (a
# zero router: experts 0 and 1 win), capacity drops included (capacity
# factor 0.25), a padded wave, "a8" mode (the experts stay weight-only) —
# and within rel-L2 5e-2 at bf16 with an f32 router; the load-balancing
# loss; the decoder's forward, prefill, windowed decode, contiguous and
# paged seeded passes within 1e-4 on MoE params; ``init_random_quantized``
# against the JAX package's shape tree; an f32 router through the bridge
# and native save/load; the int4 MoE engine unfused; piggyback refused.
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models import moe as jmoe
from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.ops.paged_attention import (
    paged_attention_partial_pallas,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.checkpoint.native import (
    load_native,
    save_native,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models import layers as tlayers
from copilot_for_consensus_tpu_torch.models import moe as tmoe
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.ops.paged_attention import (
    paged_attention_partial,
)

JCFG, CFG = jax_config("tiny-moe"), decoder_config("tiny-moe")
TOL = 1e-5
MODES = [None, "int8", "int4"]
MODE_IDS = ["f32", "int8", "int4"]


def _jax_params(mode, dtype=jnp.float32):
    jp = jdec.init_params(jax.random.PRNGKey(5), JCFG, dtype=dtype)
    return jp if mode is None else jquant.quantize_params(jp, mode=mode)


def _pair(mode, dtype=jnp.float32, tdtype="float32"):
    jp = _jax_params(mode, dtype)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", tdtype)


def _layer0(jp, tp):
    return (jax.tree.map(lambda a: a[0], jp["layers"]),
            tdec.layer_params(tp, 0))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _padded_wave():
    """A wave of 4 rows x 16 whose rows are right-padded with one repeated
    vector (the pad token's), as a padded admission wave routes them."""
    x = _x((4, 16, CFG.d_model), 1)
    pad = _x((CFG.d_model,), 2)
    for row, length in enumerate((16, 3, 9, 1)):
        x[row, length:] = pad
    return x


def _ffn_both(jl, tl, x, jcfg=JCFG, tcfg=CFG):
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x), jl, jcfg))
    got = tmoe.moe_ffn(torch.from_numpy(x), tl, tcfg).numpy()
    return got, want


def _jax_routing(xt, router, k):
    probs = jax.nn.softmax((jnp.asarray(xt) @ jnp.asarray(router))
                           .astype(jnp.float32), axis=-1)
    vals, idx = jax.lax.top_k(probs, k)
    return np.asarray(vals / vals.sum(-1, keepdims=True)), np.asarray(idx)


def _drops(x, tl, cfg):
    """Choices past their expert's capacity, from the port's routing."""
    xt = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, _, idx = tmoe.moe_route(xt, tl["router"], cfg.experts_per_token)
    loads = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    cap = tmoe.moe_capacity(xt.shape[0], cfg)
    return int((loads - cap).clamp(min=0).sum())


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("case", ["plain", "padded_wave", "decode"])
def test_moe_ffn_matches_jax(mode, case):
    jl, tl = _layer0(*_pair(mode))
    x = {"plain": lambda: _x((3, 20, CFG.d_model)),
         "padded_wave": _padded_wave,
         "decode": lambda: _x((8, 1, CFG.d_model), 3)}[case]()
    got, want = _ffn_both(jl, tl, x)
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("router_dtype", ["float32", "bfloat16"])
def test_gate_idx_equals_jax_top_k(router_dtype):
    jl, tl = _layer0(*_pair(None))
    xt = _x((64, CFG.d_model), 4)
    router = np.asarray(jl["router"])
    if router_dtype == "bfloat16":
        # bf16-rounded operands tie more often; both sides see the same
        xt = np.asarray(jnp.asarray(xt, jnp.bfloat16).astype(jnp.float32))
        router = np.asarray(jnp.asarray(router, jnp.bfloat16)
                            .astype(jnp.float32))
    want_vals, want_idx = _jax_routing(xt, router, 2)
    _, vals, idx = tmoe.moe_route(torch.from_numpy(xt.copy()),
                                  torch.from_numpy(router.copy()), 2)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(vals.numpy(), want_vals, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_tie_case_routes_to_the_lower_experts(mode):
    # a zero router: every probability equal, so experts 0 and 1 win every
    # token, and capacity drops the spill-over in both packages alike
    jp, tp = _pair(mode)
    jl, tl = _layer0(jp, tp)
    jl = {**jl, "router": jnp.zeros_like(jl["router"])}
    tl = {**tl, "router": torch.zeros_like(tl["router"])}
    x = _x((2, 24, CFG.d_model), 5)
    _, _, idx = tmoe.moe_route(torch.from_numpy(x).reshape(48, -1),
                               tl["router"], 2)
    assert (idx == torch.tensor([0, 1])).all()
    assert _drops(x, tl, CFG) > 0
    got, want = _ffn_both(jl, tl, x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_drop_case_matches_jax(mode):
    jcfg = dataclasses.replace(JCFG, expert_capacity_factor=0.25)
    tcfg = dataclasses.replace(CFG, expert_capacity_factor=0.25)
    jl, tl = _layer0(*_pair(mode))
    x = _x((4, 32, CFG.d_model), 6)
    assert tmoe.moe_capacity(128, tcfg) == jmoe.moe_capacity(128, jcfg) == 16
    assert _drops(x, tl, tcfg) > 0
    got, want = _ffn_both(jl, tl, x, jcfg, tcfg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("t", [1, 7, 8, 33, 100, 4096])
def test_capacity_equals_jax(t):
    for cf in (0.25, 1.25, 2.0):
        assert tmoe.moe_capacity(t, dataclasses.replace(
            CFG, expert_capacity_factor=cf)) == jmoe.moe_capacity(
            t, dataclasses.replace(JCFG, expert_capacity_factor=cf))


@pytest.fixture
def _a8_mode():
    tquant.set_act_quant("a8")
    yield
    tquant.set_act_quant("weight_only")


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_a8_mode_keeps_the_experts_weight_only(mode, _a8_mode, monkeypatch):
    # the JAX package's _q_einsum ignores the act-quant mode: the experts
    # take K2 / K5 (here their plain versions), never K4 / K6
    calls = {"weight_only": 0, "a8": 0}
    for kind, (wo, a8) in list(tlayers._ROUTES.items()):
        def counted(route, fn):
            def f(*a):
                calls[route] += 1
                return fn(*a)
            return f
        monkeypatch.setitem(tlayers._ROUTES, kind, (
            tuple(counted("weight_only", fn) for fn in wo),
            tuple(counted("a8", fn) for fn in a8)))
    jl, tl = _layer0(*_pair(mode))
    x = _x((4, 300, CFG.d_model), 7)          # 1200 rows: K4's extent
    got, want = _ffn_both(jl, tl, x)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert calls == {"weight_only": 3 * CFG.n_experts, "a8": 0}


def test_bf16_with_an_f32_router_within_rel_l2():
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), _jax_params(None))
    jp["layers"]["router"] = jp["layers"]["router"].astype(jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", "bfloat16")
    assert tp["layers"]["router"].dtype == torch.float32
    assert tp["layers"]["w_gate"].dtype == torch.bfloat16
    jl, tl = _layer0(jp, tp)
    x = _x((3, 20, CFG.d_model), 8)
    want = np.asarray(jmoe.moe_ffn(jnp.asarray(x, jnp.bfloat16), jl, JCFG),
                      np.float32)
    got = tmoe.moe_ffn(torch.from_numpy(x).bfloat16(), tl, CFG)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 5e-2


def test_load_balancing_loss_matches_jax():
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((50, CFG.n_experts)).astype(np.float32)
    idx = np.argsort(-logits, axis=-1)[:, :2]
    want = jmoe.moe_load_balancing_loss(jnp.asarray(logits),
                                        jnp.asarray(idx), CFG.n_experts)
    got = tmoe.moe_load_balancing_loss(torch.from_numpy(logits),
                                       torch.from_numpy(idx), CFG.n_experts)
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


# ---------------------------------------------------------------------------
# the decoder on MoE params
# ---------------------------------------------------------------------------

TOKENS = np.random.default_rng(0).integers(3, 500, (3, 24))
LENGTHS = np.array([24, 10, 17])
DTOL = 1e-4


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DTOL,
                               atol=DTOL)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_forward_matches_jax(mode):
    jp, tp = _pair(mode)
    want = jdec.forward(jp, jnp.asarray(TOKENS), JCFG)
    got = tdec.forward(tp, torch.from_numpy(TOKENS), CFG)
    _close(got, want)


@pytest.mark.parametrize("mode", [None, "int8"], ids=["f32", "int8"])
def test_prefill_and_windowed_decode_match_jax(mode):
    jp, tp = _pair(mode)
    max_len = 32
    jcache = jdec.init_cache(JCFG, 3, max_len, dtype=jnp.float32)
    jl, jcache = jdec.prefill(jp, jnp.asarray(TOKENS), jnp.asarray(LENGTHS),
                              JCFG, jcache)
    tcache = tdec.init_cache(CFG, 3, max_len, dtype=torch.float32,
                             device="cpu")
    tl, tcache = tdec.prefill(tp, torch.from_numpy(TOKENS),
                              torch.from_numpy(LENGTHS), CFG, tcache)
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    shape = (CFG.n_layers, 3, CFG.n_kv_heads, 4, CFG.head_dim)
    toks = np.array([7, 11, 13])
    pos = np.array([24, max_len, 17])        # row 1 parked: a free slot
    want = jdec.decode_step_windowed(
        jp, jnp.asarray(toks), jnp.asarray(pos), 0, JCFG, jcache,
        jnp.zeros(shape), jnp.zeros(shape))
    got = tdec.decode_step_windowed(
        tp, torch.from_numpy(toks), torch.from_numpy(pos), 0, CFG, tcache,
        torch.zeros(shape), torch.zeros(shape))
    for g, w in zip(got, want):
        _close(g, w)


def test_prefill_seeded_matches_jax():
    jp, tp = _pair("int8")
    rng = np.random.default_rng(3)
    b, s, p = 3, 16, 24
    tokens = rng.integers(3, CFG.vocab_size, size=(b, s))
    lengths = np.array([16, 5, 9], np.int32)
    pref = np.array([24, 0, 12], np.int32)
    shape = (CFG.n_layers, b, CFG.n_kv_heads, p, CFG.head_dim)
    kp, vp = _x(shape, 10), _x(shape, 11)
    want, _ = jdec.prefill_seeded(
        jp, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(kp),
        jnp.asarray(vp), jnp.asarray(pref), JCFG,
        jdec.init_cache(JCFG, b, s, dtype=jnp.float32))
    got, _ = tdec.prefill_seeded(
        tp, torch.tensor(tokens), torch.tensor(lengths), torch.tensor(kp),
        torch.tensor(vp), torch.tensor(pref), CFG,
        tdec.init_cache(CFG, b, s, dtype=torch.float32, device="cpu"))
    _close(got, want)


def test_verify_seeded_matches_jax():
    jp, tp = _pair(None)
    rng = np.random.default_rng(11)
    max_len, b, s = 64, 4, 5
    shape = (CFG.n_layers, b, CFG.n_kv_heads, max_len, CFG.head_dim)
    kc, vc = _x(shape, 12), _x(shape, 13)
    tokens = rng.integers(3, CFG.vocab_size, (b, s)).astype(np.int64)
    lengths = np.array([5, 1, 3, 5], np.int64)
    pref = np.array([17, 0, 40, max_len], np.int64)
    want = jdec.verify_seeded(
        jp, jnp.asarray(tokens.astype(np.int32)),
        jnp.asarray(lengths.astype(np.int32)),
        jnp.asarray(pref.astype(np.int32)), JCFG,
        {"k": jnp.asarray(kc), "v": jnp.asarray(vc)})
    got = tdec.verify_seeded(
        tp, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(pref), CFG,
        {"k": torch.from_numpy(kc), "v": torch.from_numpy(vc)})
    for g, w in zip(got, want):
        _close(g, w)


def test_prefill_seeded_paged_all_logits_matches_jax():
    jp, tp = _pair("int4")
    rng = np.random.default_rng(10)
    shape = (CFG.n_layers, 12, CFG.n_kv_heads, 8, CFG.head_dim)
    pk, pv = _x(shape, 14), _x(shape, 15)
    tables = rng.integers(0, 13, (3, 4)).astype(np.int32)     # 12 = pad
    pref = np.array([16, 0, 29], np.int64)
    lengths = np.array([5, 8, 1], np.int64)
    tokens = rng.integers(3, CFG.vocab_size, (3, 8)).astype(np.int64)

    def jfn(li, q_rows, lns, q_pos):
        return paged_attention_partial_pallas(
            q_rows, jnp.asarray(pk), jnp.asarray(pv),
            jnp.asarray([li], jnp.int32), jnp.asarray(tables), lns, q_pos,
            window=0, interpret=True)

    tk, tv, tt = (torch.from_numpy(a) for a in (pk, pv, tables))

    def tfn(li, q_rows, lns, q_pos):
        return paged_attention_partial(q_rows, tk, tv, li, tt, lns, q_pos)

    want = jdec.prefill_seeded_paged(
        jp, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(pref),
        JCFG, jfn, all_logits=True)
    got = tdec.prefill_seeded_paged(
        tp, torch.from_numpy(tokens), torch.from_numpy(lengths),
        torch.from_numpy(pref), CFG, tfn, all_logits=True)
    for g, w in zip(got, want):
        _close(g, w)


def test_piggyback_refuses_moe():
    # the JAX decoder asserts it; the port raises in the same words, and
    # the engine never takes the piggyback route for an MoE config
    _, tp = _pair(None)
    with pytest.raises(ValueError, match="dense FFN only"):
        tdec.decode_step_piggyback(tp, None, None, 0, CFG, *([None] * 10))
    eng = GenerationEngine(CFG, tp, dtype="float32", device="cpu",
                           num_slots=2, max_len=64, prefill_buckets=(16,),
                           piggyback_min_prompt=1, telemetry=False)
    assert not eng._piggyback_ok


# ---------------------------------------------------------------------------
# params: shapes, the router's dtype, fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_init_random_quantized_matches_jax_shapes(mode):
    want = jax.eval_shape(lambda k: jquant.init_random_quantized(
        k, JCFG, dtype=jnp.bfloat16, mode=mode), jax.random.PRNGKey(0))
    got = tquant.init_random_quantized(CFG, dtype=torch.bfloat16,
                                       device="cpu", mode=mode)
    flat_w = {jax.tree_util.keystr(p): a for p, a in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(p): a for p, a in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat_g.keys() == flat_w.keys()
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32,
             "int8": torch.int8}
    for key, aval in flat_w.items():
        assert tuple(flat_g[key].shape) == aval.shape, key
        assert flat_g[key].dtype == names[str(aval.dtype)], key
    assert got["layers"]["w_gate"]["scale"].shape[:2] == (2, 4)


def test_param_bytes_count_the_experts():
    p8 = tquant.init_random_quantized(CFG, dtype=torch.float32,
                                      device="cpu", mode="int8")
    e, d, f = CFG.n_experts, CFG.d_model, CFG.d_ff
    experts = CFG.n_layers * e * 3 * (d * f + 4 * max(d, f))
    assert tquant.param_bytes(p8) > experts > \
        tquant.param_bytes(p8) - experts


def test_router_keeps_f32_through_the_bridge_and_native(tmp_path):
    jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), _jax_params(None))
    jp["layers"]["router"] = jp["layers"]["router"].astype(jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    tp = params_from_numpy(tree, "cpu", "bfloat16")
    assert tp["layers"]["router"].dtype == torch.float32
    np.testing.assert_array_equal(tp["layers"]["router"].numpy(),
                                  tree["layers"]["router"])
    # the torch branch, as a checkpoint read gives it
    t2 = params_from_numpy(tp, "cpu", "bfloat16")
    assert t2["layers"]["router"].dtype == torch.float32
    assert t2["layers"]["wq"].dtype == torch.bfloat16
    q = tquant.quantize_params(t2, mode="int8")
    save_native(tmp_path / "ck", CFG, q)
    cfg, back, meta = load_native(tmp_path / "ck")
    assert cfg == CFG and meta["quantized"] == "int8"
    t3 = params_from_numpy(back, "cpu", "bfloat16")
    assert t3["layers"]["router"].dtype == torch.float32
    assert torch.equal(t3["layers"]["router"], tp["layers"]["router"])
    # a random-init router is born in the activation dtype
    r = tquant.init_random_quantized(CFG, dtype=torch.bfloat16,
                                     device="cpu")
    assert r["layers"]["router"].dtype == torch.bfloat16


def test_int4_moe_engine_is_unfused():
    eng = GenerationEngine(CFG, quantize="int4", dtype="float32",
                           device="cpu", num_slots=2, max_len=64,
                           prefill_buckets=(16,), telemetry=False)
    lt = eng.params["layers"]
    assert "wqkv" not in lt and "w_gu" not in lt
    assert tquant.quant_kind(lt["wq"]) == "int4"
    assert lt["w_gate"]["q4"].shape == (2, 4, CFG.d_model // 2, CFG.d_ff)
    (comp,) = eng.generate([[5, 6, 7]], max_new_tokens=3)
    assert len(comp.tokens) == 3
    with pytest.raises(ValueError, match="dense FFN"):
        tquant.fuse_int4_projections(eng.params)
