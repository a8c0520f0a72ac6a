# The port's activation-quantized ("a8") path against the JAX package's on
# the same numpy inputs: quantize_rows (bit for bit), the plain versions of
# K4 (W8A8) and K6 (W4A8) against the Pallas kernels in interpret mode,
# qmatmul's routing, and decoder logits in a8 mode.
#
# Tolerances. K4: the integer product is exact in both, and the port's plain
# version equals (acc·sx)·sw bit for bit; the Pallas kernel under XLA's CPU
# interpreter lands within one f32 step of that formula, so 1e-6. K6: the
# group dots are exact in both, the f32 sums of scaled groups differ in
# order: 1e-5 relative to the largest output.
#
# Decoder logits in a8 mode. Both decoders quantize their own f32
# activations, which agree to ~1e-7 but not bit for bit, so an element that
# sits that close to a rounding boundary of its row's int8 grid can round
# to neighbouring integers on the two sides (a "flip"). A flip moves that
# token's product by one step of the row scale, the next layer's inputs by
# ~1e-3, and from there later quantizations decorrelate: the batch row's
# logits can then differ by up to about the a8 error itself. The test
# records every a8 quantization on both sides: the quantized inputs must be
# equal up to the first that differs, which may differ only in a few
# elements, each within 1e-3 of a grid step's rounding boundary (a flip,
# not a fault); a batch row with no difference in its history (positions
# before its length) must match to 1e-4, as in weight-only mode, and a row
# with one to 1e-1, a few times the a8-vs-weight-only distance.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models import layers as jlayers
from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.ops import quant_matmul as jqm
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models import layers as tlayers
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm

K4_TOL = 1e-6
K6_RTOL = 1e-5
A8_LOGITS_REL_L2 = 1e-4
A8_FLIPPED_REL_L2 = 1e-1


@pytest.fixture
def a8():
    """The process-wide act-quant mode set to "a8", restored after."""
    tquant.set_act_quant("a8")
    yield
    tquant.set_act_quant("weight_only")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((7, 128)) * 3.0).astype(np.float32)
    x[2] = 0.0                                    # zero row: scale 1
    x[4, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -127.0]  # ties
    x[5] *= 1e-30                                 # subnormal-scale row
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want_q, want_s = jqm.quantize_rows(xj)
    got_q, got_s = tqm.quantize_rows(xt)
    assert got_q.dtype == torch.int8 and got_s.shape == (7, 1)
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert float(got_s[2]) == 1.0 and not got_q[2].any()
    if dtype == "float32":
        # round half to even on the exact ties of the amax-127 row
        assert got_q[4, :8].tolist() == [127, 0, 2, 2, 0, -2, 126, -127]


def _int8_operands(seed, m, d, f):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    return x, jquant.quantize_tensor(jnp.asarray(w))


@pytest.mark.parametrize("m,d,f", [(4, 64, 96), (1, 128, 512), (9, 32, 33),
                                   (37, 256, 200)])
def test_plain_k4_matches_pallas_w8a8(m, d, f):
    x, qw = _int8_operands(m * d, m, d, f)
    want = np.asarray(jqm.w8a8_matmul(jnp.asarray(x), qw["q"], qw["scale"],
                                      block_f=32, interpret=True))
    q = torch.from_numpy(np.array(qw["q"]))
    s = torch.from_numpy(np.array(qw["scale"]))
    got = tqm.w8a8_matmul_ref(torch.from_numpy(x), q, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=K4_TOL, atol=K4_TOL)
    # the formula, with the integer sum taken exactly in int64
    xq, sx = tqm.quantize_rows(torch.from_numpy(x))
    acc = (xq.numpy().astype(np.int64) @ q.numpy().astype(np.int64))
    formula = (acc.astype(np.float32) * sx.numpy()) * s.numpy()
    np.testing.assert_array_equal(got.numpy(), formula)
    # bf16 x: the same formula rounded once to bf16
    gotb = tqm.w8a8_matmul_ref(torch.from_numpy(x).bfloat16(), q, s)
    xqb, sxb = tqm.quantize_rows(torch.from_numpy(x).bfloat16())
    accb = (xqb.numpy().astype(np.int64) @ q.numpy().astype(np.int64))
    assert torch.equal(gotb, torch.from_numpy(
        (accb.astype(np.float32) * sxb.numpy()) * s.numpy()).bfloat16())


@pytest.mark.parametrize("m,d,f,group", [(4, 512, 96, 256),
                                         (9, 256, 33, 256),
                                         (8, 1024, 96, 512),
                                         (130, 512, 200, 256)])
def test_plain_k6_matches_pallas_w4a8(m, d, f, group):
    rng = np.random.default_rng(m + f)
    w = (rng.standard_normal((d, f)) * 0.04).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    qw = jquant.quantize_tensor_int4(jnp.asarray(w), group=group)
    want = np.asarray(jqm.w4a8_matmul(jnp.asarray(x), qw["q4"], qw["scale"],
                                      block_f=16, interpret=True))
    q4 = torch.from_numpy(np.array(qw["q4"]))
    s = torch.from_numpy(np.array(qw["scale"]))
    got = tqm.w4a8_matmul_ref(torch.from_numpy(x), q4, s)
    assert got.shape == (m, f)
    np.testing.assert_allclose(got.numpy(), want, rtol=K6_RTOL,
                               atol=K6_RTOL * np.abs(want).max())
    gotb = tqm.w4a8_matmul_ref(torch.from_numpy(x).bfloat16(), q4, s)
    wantb = np.asarray(jqm.w4a8_matmul(
        jnp.asarray(x).astype(jnp.bfloat16), qw["q4"], qw["scale"],
        block_f=16, interpret=True).astype(jnp.float32))
    np.testing.assert_allclose(gotb.float().numpy(), wantb, rtol=2.0 ** -8,
                               atol=2.0 ** -8 * np.abs(wantb).max())


def test_w8a8_wrapper_on_cpu_is_the_plain_version():
    x, qw = _int8_operands(3, 5, 64, 40)
    q = torch.from_numpy(np.array(qw["q"]))
    s = torch.from_numpy(np.array(qw["scale"]))
    launches = tqm.w8a8_matmul.launches
    got = tqm.w8a8_matmul(torch.from_numpy(x).reshape(5, 1, 64), q, s)
    assert got.shape == (5, 1, 40)
    assert torch.equal(got.reshape(5, 40),
                       tqm.w8a8_matmul_ref(torch.from_numpy(x), q, s))
    assert tqm.w8a8_matmul.launches == launches


def test_act_quant_mode_is_process_wide_and_checked():
    assert tquant.act_quant_mode() == "weight_only"
    with pytest.raises(ValueError, match="act-quant"):
        tquant.set_act_quant("a4")
    tquant.set_act_quant("a8")
    try:
        assert tquant.act_quant_mode() == "a8"
    finally:
        tquant.set_act_quant("weight_only")
    assert tquant.act_quant_mode() == "weight_only"


@pytest.mark.parametrize("rows,kind,want", [
    (4, "int8", "int8_matmul_ref"), (1023, "int8", "int8_matmul_ref"),
    (1024, "int8", "w8a8_matmul_ref"), (4, "int4", "w4a8_matmul_ref"),
    (1024, "int4", "w4a8_matmul_ref")])
def test_qmatmul_routes_a8_by_kind_and_rows(a8, rows, kind, want):
    w = torch.randn(64, 24)
    leaf = (tquant.quantize_tensor(w) if kind == "int8"
            else tquant.quantize_tensor_int4(w))
    key = "q" if kind == "int8" else "q4"
    # rows counted over every leading dim, as the JAX package counts them
    x = torch.randn(rows, 1, 64)
    ref = getattr(tqm, want)(x, leaf[key], leaf["scale"])
    assert torch.equal(tlayers.qmatmul(x, leaf), ref)
    assert torch.equal(tlayers.qmatmul(x, leaf, "plain"), ref)


def _routed_jax_qmatmul(x, w, record=None):
    """The JAX package's qmatmul under its TPU rule (layers.py:46-70) with
    a8 on, the Pallas kernels run in interpret mode: int4 → w4a8_matmul;
    int8 → w8a8_matmul from 1024 rows, else the XLA serving expression.
    ``record`` receives the input of every a8 call, as numpy."""
    kind = jquant.quant_kind(w)
    m = 1
    for s in x.shape[:-1]:
        m *= s
    a8 = kind == "int4" or (kind == "int8" and m >= 1024)
    if a8 and record is not None:
        jax.debug.callback(lambda v: record.append(np.asarray(v)), x,
                           ordered=True)
    if kind == "int4":
        return jqm.w4a8_matmul(x, w["q4"], w["scale"], interpret=True)
    if kind == "int8":
        if a8:
            return jqm.w8a8_matmul(x, w["q"], w["scale"], interpret=True)
        return (x @ w["q"].astype(x.dtype)) * w["scale"].astype(x.dtype)
    return x @ w


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _distinct(pairs):
    """(input, quantized input) pairs with repeats of the previous input
    dropped: the unfused q/k/v and gate/up leaves share their input."""
    out = []
    for x, q in pairs:
        if not (out and out[-1][1].shape == q.shape
                and np.array_equal(out[-1][1], q)):
            out.append((x, q))
    return out


def _check_flips(jax_pairs, port_xq, lengths, s):
    """Hold the two sides' quantized inputs to the flip rule above; returns
    the batch rows whose history holds a difference, over the real
    positions of each input ([B·S, D] for the layers' projections, [B, D]
    for the lm_head)."""
    b = len(lengths)
    flipped = np.zeros(b, dtype=bool)
    assert len(jax_pairs) == len(port_xq)
    first = True
    for (x, j), t in zip(jax_pairs, port_xq):
        assert j.shape == t.shape
        if first and (j != t).any():
            first = False
            where = np.argwhere(j != t)
            assert len(where) <= 4, f"{len(where)} elements differ"
            xf = x.reshape(j.shape).astype(np.float32)
            amax = np.abs(xf).max(axis=-1, keepdims=True)
            steps = xf / (amax / np.float32(127.0))
            margin = np.abs(np.abs(steps - np.round(steps)) - 0.5)
            assert (margin[tuple(where.T)] <= 1e-3).all(), \
                "a difference that is no rounding flip"
        diff = (j != t).any(axis=-1)
        if diff.shape[0] == b * s:
            real = np.arange(s)[None, :] < lengths[:, None]
            flipped |= (diff.reshape(b, s) & real).any(axis=1)
        else:
            flipped |= diff
    return flipped


@pytest.mark.parametrize("mode,overrides,shape", [
    ("int4", {}, (3, 24)),
    ("int4", {"d_model": 512, "d_ff": 512}, (3, 24)),
    ("int8", {}, (2, 512))],
    ids=["int4-tiny-G1", "int4-wide-G2", "int8-2x512"])
def test_a8_decoder_logits_match_jax(a8, monkeypatch, mode, overrides,
                                     shape):
    jcfg = jax_config("tiny", **overrides)
    tcfg = decoder_config("tiny", **overrides)
    jp = jdec.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    jq = jquant.quantize_params(jp, mode=mode)
    tp = params_from_numpy(jax.tree.map(np.asarray, jq), "cpu", "float32")
    if mode == "int4":
        tp = tquant.fuse_int4_projections(tp)
    rng = np.random.default_rng(1)
    b, s = shape
    tokens = rng.integers(3, 500, (b, s))
    lengths = np.array([s, s // 2 + 1, 7][:b])
    want_w = np.asarray(jdec.prefill(
        jq, jnp.asarray(tokens), jnp.asarray(lengths), jcfg,
        jdec.init_cache(jcfg, b, s, dtype=jnp.float32))[0])
    jax_x: list = []
    monkeypatch.setattr(jlayers, "qmatmul",
                        lambda x, w: _routed_jax_qmatmul(x, w, jax_x))
    want = np.asarray(jdec.prefill(
        jq, jnp.asarray(tokens), jnp.asarray(lengths), jcfg,
        jdec.init_cache(jcfg, b, s, dtype=jnp.float32))[0])
    jax.effects_barrier()
    port_xq: list = []
    plain_quantize = tqm.quantize_rows

    def recording_quantize(x):
        xq, sx = plain_quantize(x)
        port_xq.append(xq.numpy())
        return xq, sx
    monkeypatch.setattr(tqm, "quantize_rows", recording_quantize)
    counts = {n: getattr(tqm, n).launches
              for n in ("w4a8_matmul", "w8a8_matmul")}
    got, _ = tdec.prefill(tp, torch.from_numpy(tokens),
                          torch.from_numpy(lengths), tcfg,
                          tdec.init_cache(tcfg, b, s, dtype=torch.float32,
                                          device="cpu"))
    got = got.numpy()
    assert counts == {n: getattr(tqm, n).launches for n in counts}
    jax_pairs = _distinct(
        (x, np.asarray(jqm.quantize_rows(
            jnp.asarray(x.reshape(-1, x.shape[-1])))[0])) for x in jax_x)
    port_xq = [q for _, q in _distinct((None, q) for q in port_xq)]
    # 2 layers x 4 distinct inputs (+ the lm_head's, a8 for int4 only)
    assert len(port_xq) == 8 + (mode == "int4")
    flipped = _check_flips(jax_pairs, port_xq, lengths, s)
    for i in range(b):
        tol = A8_FLIPPED_REL_L2 if flipped[i] else A8_LOGITS_REL_L2
        assert _rel_l2(got[i], want[i]) <= tol, (i, flipped)
    # a8 moves the logits well past that against weight-only
    assert _rel_l2(want, want_w) > 10 * A8_LOGITS_REL_L2
