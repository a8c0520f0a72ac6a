# The port's int4 path against the JAX package's on the same numpy inputs:
# the packed format and its quantizer (byte for byte), K5's plain version
# against the Pallas kernel in interpret mode, the fused leaves, the
# bridge, the decoder and the engine.
#
# Tolerances. K5's plain version and the Pallas kernel both take each
# group's f32 partial product and scale it in f32 before summing; they
# differ in the order of the f32 sums only: 1e-5 relative to the largest
# output at f32. At bf16 both round the same f32 sum once, so an output
# may differ by one bf16 step (2**-8 relative) where the sum sits on a
# rounding boundary. Decoder logits and KV: 1e-4 at f32 (the JAX decoder
# on the CPU dequantizes int4 exactly at f32 and takes one matmul, the
# port sums group partials). Greedy f32 token streams: equal.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.ops import quant_matmul as jqm
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.models.layers import qmatmul
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -8
LOGITS_TOL = 1e-4
#: (m, d, f, group): G > 1 and ragged M / F
KERNEL_SHAPES = [(4, 512, 96, 256), (9, 256, 33, 256), (8, 1024, 96, 512)]


def _int4_operands(seed, m, d, f, group):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    return x, jquant.quantize_tensor_int4(jnp.asarray(w), group=group)


def _torch_leaf(leaf):
    return {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}


@pytest.mark.parametrize("shape", [(64, 48), (3, 256, 16), (2, 8, 5)])
def test_pack_unpack_round_trip_and_jax_bytes(shape):
    rng = np.random.default_rng(len(shape))
    q = rng.integers(-8, 8, shape).astype(np.int8)
    packed = tqm.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int8
    assert packed.shape == (*shape[:-2], shape[-2] // 2, shape[-1])
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jqm.pack_int4(jnp.asarray(q))))
    np.testing.assert_array_equal(tqm.unpack_int4(packed).numpy(), q)


def test_pack_rejects_odd_rows():
    with pytest.raises(ValueError, match="even"):
        tqm.pack_int4(torch.zeros((7, 8), dtype=torch.int8))


@pytest.mark.parametrize("shape,group", [((512, 48), 256), ((64, 96), 256),
                                         ((3, 256, 16), 128)])
def test_quantize_and_dequant_int4_match_jax(shape, group):
    rng = np.random.default_rng(sum(shape))
    w = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    w[..., 3] = 0.0                                # an all-zero column
    want = jquant.quantize_tensor_int4(jnp.asarray(w), group=group)
    got = tquant.quantize_tensor_int4(torch.from_numpy(w), group=group)
    assert got["q4"].dtype == torch.int8
    assert got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q4"].numpy(), np.asarray(want["q4"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    np.testing.assert_array_equal(
        tquant.dequant_int4(got, torch.float32).numpy(),
        np.asarray(jquant.dequant_int4(want, jnp.float32)))
    if len(shape) == 3:
        # stacked leaves: each layer's slice dequantizes alone the same
        full = tquant.dequant_int4(got, torch.float32)
        for i in range(shape[0]):
            one = tquant.dequant_int4({"q4": got["q4"][i],
                                       "scale": got["scale"][i]},
                                      torch.float32)
            assert torch.equal(full[i], one)


@pytest.mark.parametrize("m,d,f,group", KERNEL_SHAPES)
def test_plain_k5_matches_pallas_int4_matmul(m, d, f, group):
    x, qw = _int4_operands(m + d, m, d, f, group)
    want = np.asarray(jqm.int4_matmul(jnp.asarray(x), qw["q4"], qw["scale"],
                                      block_f=32, interpret=True))
    leaf = _torch_leaf(qw)
    got = tqm.int4_matmul_ref(torch.from_numpy(x), leaf["q4"], leaf["scale"])
    assert got.shape == (m, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())
    # bf16 x: both round one f32 sum to bf16
    wantb = np.asarray(jqm.int4_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), qw["q4"], qw["scale"],
        block_f=32, interpret=True).astype(jnp.float32))
    gotb = tqm.int4_matmul_ref(torch.from_numpy(x).bfloat16(), leaf["q4"],
                               leaf["scale"])
    assert gotb.dtype == torch.bfloat16
    np.testing.assert_allclose(gotb.float().numpy(), wantb, rtol=BF16_RTOL,
                               atol=BF16_RTOL * np.abs(wantb).max())


def test_plain_k5_leading_dims():
    x, qw = _int4_operands(2, 6, 256, 48, 256)
    leaf = _torch_leaf(qw)
    flat = tqm.int4_matmul_ref(torch.from_numpy(x), leaf["q4"],
                               leaf["scale"])
    got = tqm.int4_matmul_ref(torch.from_numpy(x).reshape(2, 3, 256),
                              leaf["q4"], leaf["scale"])
    assert got.shape == (2, 3, 48)
    assert torch.equal(got.reshape(6, 48), flat)


@pytest.mark.parametrize("fn", [tqm.int4_matmul, tqm.w4a8_matmul],
                         ids=["int4", "w4a8"])
def test_bad_group_is_rejected(fn):
    leaf = tquant.quantize_tensor_int4(torch.randn(512, 64), group=256)
    with pytest.raises(ValueError, match="divide"):
        fn(torch.ones(4, 512), leaf["q4"], torch.ones(3, 64))
    with pytest.raises(ValueError, match="packed rows"):
        fn(torch.ones(4, 256), leaf["q4"], leaf["scale"])


def test_wrappers_on_cpu_are_the_plain_versions():
    x, qw = _int4_operands(5, 3, 256, 40, 128)
    leaf = _torch_leaf(qw)
    xt = torch.from_numpy(x)
    for fn, ref in ((tqm.int4_matmul, tqm.int4_matmul_ref),
                    (tqm.w4a8_matmul, tqm.w4a8_matmul_ref)):
        launches = fn.launches
        assert torch.equal(fn(xt, leaf["q4"], leaf["scale"]),
                           ref(xt, leaf["q4"], leaf["scale"]))
        assert fn.launches == launches


#: the int4 main path's projections (D, F) of mistral-7b: fused q/k/v,
#: wo, fused gate/up, w_down, lm_head
MISTRAL_INT4 = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
                (4096, 32000)]


@pytest.mark.parametrize("m", [33, 2816, 5632])
@pytest.mark.parametrize("d,f", MISTRAL_INT4)
def test_mistral_int4_waves_take_the_wgmma_body(m, d, f):
    # every admission-wave projection at the default group goes to the
    # Hopper body, never to the mma.sync tiling
    assert tqm.int4_body(m, f, tquant.INT4_GROUP, torch.bfloat16) == "wgmma"
    assert d % tqm.K5_WGMMA_KSTEP == 0


@pytest.mark.parametrize("m,f,group,dtype,body", [
    (1, 4096, 256, torch.bfloat16, "stream"),
    (32, 28672, 256, torch.bfloat16, "stream"),
    (32, 4104, 256, torch.bfloat16, "split"),          # F % 16 = 8
    (8, 4096, 64, torch.bfloat16, "split"),            # group % 128 = 64
    (1, 4096, 32, torch.bfloat16, "split"),            # group % 128 = 32
    (17, 6152, 128, torch.bfloat16, "split"),          # F % 16 = 8
    (33, 4096, 256, torch.bfloat16, "wgmma"),
    (4096, 4104, 256, torch.bfloat16, "mma_sync"),     # F % 16 = 8
    (4096, 4096, 32, torch.bfloat16, "mma_sync"),      # group % 64 = 32
    (4096, 4096, 64, torch.bfloat16, "wgmma"),
    (4096, 4096, 128, torch.bfloat16, "wgmma"),
    (4096, 4096, 4096, torch.bfloat16, "wgmma"),       # one group
    (32, 4096, 256, torch.float32, "simt"),
    (5632, 28672, 256, torch.float32, "simt")])
def test_int4_body_rule(m, f, group, dtype, body):
    # K5's body is chosen from dtype and shape alone
    assert tqm.int4_body(m, f, group, dtype) == body
    assert body in tqm.K5_BODIES


def test_int4_wrapper_on_cpu_counts_no_body():
    x, qw = _int4_operands(6, 40, 256, 48, 128)
    leaf = _torch_leaf(qw)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    before = dict(tqm.int4_matmul.launches_by_body)
    assert torch.equal(tqm.int4_matmul(xt, leaf["q4"], leaf["scale"]),
                       tqm.int4_matmul_ref(xt, leaf["q4"], leaf["scale"]))
    assert tqm.int4_matmul.launches_by_body == before
    assert sorted(before) == sorted(tqm.K5_BODIES)


def test_stream_splits_cover_the_groups():
    for m, g, f in [(32, 16, 28672), (32, 16, 4096), (32, 56, 4096),
                    (32, 16, 32000), (4, 1, 96), (33, 16, 4096)]:
        splits = tqm.stream_splits(m, g, f)
        if m > tqm.STREAM_MAX_M:
            assert splits == 0
            continue
        per = -(-g // splits)            # the kernels' groups per split
        assert 1 <= splits <= g and per * splits >= g
        assert per * (splits - 1) < g    # no split is empty


def _tiny_int4(name="tiny", seed=11, **overrides):
    jcfg = jax_config(name, **overrides)
    tcfg = decoder_config(name, **overrides)
    jp = jdec.init_params(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    jq = jquant.quantize_params(jp, mode="int4")
    tp = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", "float32")
    return jcfg, jq, tcfg, tp


def test_quantize_params_int4_matches_jax_leaves():
    jcfg, jq, tcfg, _ = _tiny_int4()
    jp = jdec.init_params(jax.random.PRNGKey(11), jcfg, dtype=jnp.float32)
    got = tquant.quantize_params(
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", "float32"),
        mode="int4")
    for path in tquant.DECODER_QUANT_LEAVES:
        g, w = got, jq
        for p in path:
            g, w = g[p], w[p]
        assert tquant.quant_kind(g) == "int4"
        np.testing.assert_array_equal(g["q4"].numpy(), np.asarray(w["q4"]))
        np.testing.assert_array_equal(g["scale"].numpy(),
                                      np.asarray(w["scale"]))
    with pytest.raises(ValueError, match="mode"):
        tquant.quantize_params(got, mode="int3")


def test_bridge_keeps_int4_bytes_and_f32_scales():
    _, jq, _, tp = _tiny_int4()
    for name in ("wq", "w_down"):
        want = jq["layers"][name]
        got = tp["layers"][name]
        assert got["q4"].dtype == torch.int8
        assert got["scale"].dtype == torch.float32
        np.testing.assert_array_equal(got["q4"].numpy(),
                                      np.asarray(want["q4"]))
        np.testing.assert_array_equal(got["scale"].numpy(),
                                      np.asarray(want["scale"]))
    # a bf16 tree keeps the bytes and the scales just the same
    bf = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", "bfloat16")
    assert torch.equal(bf["lm_head"]["q4"], tp["lm_head"]["q4"])
    assert bf["lm_head"]["scale"].dtype == torch.float32
    assert bf["tok_emb"].dtype == torch.bfloat16


def test_init_random_int4_matches_jax_structure():
    jcfg, tcfg = jax_config("tiny"), decoder_config("tiny")
    want = jquant.init_random_quantized(jax.random.PRNGKey(0), jcfg,
                                        dtype=jnp.float32, mode="int4")
    got = tquant.init_random_quantized(tcfg, seed=0, dtype=torch.float32,
                                       device="cpu", mode="int4")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else
                (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tree.items()}
    assert shapes(got) == jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), want)
    scale = got["layers"]["w_down"]["scale"]
    assert torch.equal(scale, torch.full_like(
        scale, tcfg.d_ff ** -0.5 / 4.61))
    # every packed byte value is drawn
    q4 = got["layers"]["w_gate"]["q4"]
    assert int(q4.min()) == -128 and int(q4.max()) == 127


def test_fused_leaves_equal_the_unfused_forward():
    _, _, tcfg, tp = _tiny_int4(d_model=512, d_ff=512)
    fused = tquant.fuse_int4_projections(tp)
    assert "wqkv" in fused["layers"] and "wq" not in fused["layers"]
    assert "w_gu" in fused["layers"] and "w_up" not in fused["layers"]
    assert fused["layers"]["wqkv"]["scale"].shape[-2] == 2     # G = 2
    assert tquant.fuse_int4_projections(fused) is fused
    toks = torch.from_numpy(np.random.default_rng(12).integers(3, 500,
                                                               (2, 9)))
    ref = tdec.forward(tp, toks, tcfg)
    out = tdec.forward(fused, toks, tcfg)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)
    # the fused columns are the unfused ones, in order
    x = torch.randn(3, 512)
    lay = tdec.layer_params(tp, 1)
    flay = tdec.layer_params(fused, 1)
    want = torch.cat([qmatmul(x, lay[k]) for k in ("wq", "wk", "wv")], -1)
    assert torch.equal(qmatmul(x, flay["wqkv"]), want)


def test_fuse_needs_dense_int4_leaves():
    _, _, tcfg, tp = _tiny_int4()
    with pytest.raises(ValueError, match="int4"):
        tquant.fuse_int4_projections(tquant.quantize_params(
            tdec.init_params(tcfg, seed=0, dtype=torch.float32,
                             device="cpu")))
    moe = {**tp, "layers": {**tp["layers"], "w_gate": {
        "q4": tp["layers"]["w_gate"]["q4"][:, None],
        "scale": tp["layers"]["w_gate"]["scale"][:, None]}}}
    with pytest.raises(ValueError, match="dense FFN"):
        tquant.fuse_int4_projections(moe)


TOKENS = np.random.default_rng(0).integers(3, 500, (3, 24))
LENGTHS = np.array([24, 10, 17])
# tiny: every int4 leaf is one group (G = 1); widened: G = 2
INT4_MODELS = [("tiny", {}), ("tiny", {"d_model": 512, "d_ff": 512})]


@pytest.mark.parametrize("overrides", [m[1] for m in INT4_MODELS],
                         ids=["tiny-G1", "wide-G2"])
@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
def test_int4_decoder_matches_jax(overrides, fuse):
    jcfg, jq, tcfg, tp = _tiny_int4(**overrides)
    if fuse:
        tp = tquant.fuse_int4_projections(tp)
    jcache = jdec.init_cache(jcfg, 3, 32, dtype=jnp.float32)
    jl, jcache = jdec.prefill(jq, jnp.asarray(TOKENS), jnp.asarray(LENGTHS),
                              jcfg, jcache)
    tcache = tdec.init_cache(tcfg, 3, 32, dtype=torch.float32, device="cpu")
    tl, tcache = tdec.prefill(tp, torch.from_numpy(TOKENS),
                              torch.from_numpy(LENGTHS), tcfg, tcache)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LOGITS_TOL,
                               atol=LOGITS_TOL)
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)
    # one decode step against the cache each prefill wrote
    shape = (tcfg.n_layers, 3, tcfg.n_kv_heads, 4, tcfg.head_dim)
    toks, pos = np.array([7, 8, 9]), np.array([24, 10, 17])
    jlog, _, _ = jdec.decode_step_windowed(
        jq, jnp.asarray(toks), jnp.asarray(pos), jnp.int32(0), jcfg, jcache,
        jnp.zeros(shape), jnp.zeros(shape), kv_len=32)
    tlog, _, _ = tdec.decode_step_windowed(
        tp, torch.from_numpy(toks), torch.from_numpy(pos), 0, tcfg, tcache,
        torch.zeros(shape), torch.zeros(shape), kv_len=32)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=LOGITS_TOL, atol=LOGITS_TOL)


ENGINE_KW = dict(num_slots=4, max_len=64, prefill_buckets=(16, 32),
                 decode_window=4)
PROMPTS = [[5, 9, 13], list(range(40, 61)), [7] * 9,
           list(range(100, 130)), [3, 4], list(range(200, 214))]


@pytest.mark.parametrize("overrides", [m[1] for m in INT4_MODELS],
                         ids=["tiny-G1", "wide-G2"])
def test_int4_engine_streams_equal_jax_engine(overrides):
    jcfg = jax_config("tiny", **overrides)
    jp = jdec.init_params(jax.random.PRNGKey(7), jcfg, dtype=jnp.float32)
    jeng = JaxEngine(jcfg, jp, dtype=jnp.float32, quantize="int4",
                     telemetry=False, **ENGINE_KW)
    teng = GenerationEngine(
        decoder_config("tiny", **overrides),
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", "float32"),
        dtype="float32", quantize="int4", device="cpu", **ENGINE_KW)
    assert teng.quant_mode == "int4"
    # the port fuses (single card, dense); the JAX engine on the CPU not
    assert "wqkv" in teng.params["layers"]
    assert "wq" in jeng.params["layers"]
    want = jeng.generate(PROMPTS, max_new_tokens=12)
    got = teng.generate(PROMPTS, max_new_tokens=12)
    for w, g in zip(want, got):
        assert g.tokens == w.tokens
        assert g.finish_reason == w.finish_reason
    assert sum(len(g.tokens) for g in got) > 2 * len(PROMPTS)


def test_int4_engine_from_random_and_prequantized_params():
    cfg = decoder_config("tiny")
    eng = GenerationEngine(cfg, dtype="float32", quantize="int4",
                           device="cpu", **ENGINE_KW)
    lay = eng.params["layers"]
    assert set(lay) >= {"wqkv", "w_gu", "wo", "w_down"}
    assert tquant.quant_kind(eng.params["lm_head"]) == "int4"
    # an already fused int4 tree is taken as it is
    again = GenerationEngine(cfg, eng.params, dtype="float32",
                             quantize="int4", device="cpu", **ENGINE_KW)
    assert again.params["layers"]["wqkv"]["q4"] is lay["wqkv"]["q4"]
    (c,) = again.generate([[5, 6, 7]], max_new_tokens=3)
    assert len(c.tokens) >= 1
    with pytest.raises(ValueError, match="quantize"):
        GenerationEngine(cfg, dtype="float32", quantize="int2",
                         device="cpu", **ENGINE_KW)


def test_summarizer_serves_int4():
    from copilot_for_consensus_tpu_torch.summarization.base import (
        ThreadContext,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    summ = CUDASummarizer("tiny", quantize="int4", dtype=torch.float32,
                          num_slots=2, max_len=256, max_new_tokens=4,
                          device="cpu")
    assert summ.engine.quant_mode == "int4"
    assert "w_gu" in summ.engine.params["layers"]
    threads = [ThreadContext(thread_id=f"t{i}", subject="s",
                             chunks=[{"chunk_id": "c", "text": "hello " * i}])
               for i in range(3)]
    out = summ.summarize_batch(threads)
    assert [s.thread_id for s in out] == ["t0", "t1", "t2"]
    assert all(1 <= s.completion_tokens <= 4 for s in out)
