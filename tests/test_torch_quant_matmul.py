# The port's int8 weight-only matmul (K2's plain version, qmatmul) and
# int8 quantization against the JAX package on the same numpy inputs.
#
# Tolerances: float32 agrees to 1e-5. In bfloat16 the JAX serving
# expression (models/layers.py:77) rounds the product to bf16 BEFORE the
# bf16 scale, while K2 (like the Pallas kernel) scales in f32 and rounds
# once — so the two differ at bf16 rounding: a few units in the last place,
# 2**-6 relative here.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.models.configs import decoder_config
from copilot_for_consensus_tpu.ops.quant_matmul import (
    int8_matmul as jax_int8_matmul,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.models.layers import qmatmul
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm
from copilot_for_consensus_tpu_torch.ops.quant_matmul import (
    GEMV_MAX_M,
    gemv_splits,
    int4_matmul_ref,
    int8_matmul,
    int8_matmul_ref,
)

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -6


def _operands(seed, m, d, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    q = rng.integers(-127, 128, (d, f)).astype(np.int8)
    scale = (rng.random((1, f)) * 2 * d ** -0.5 / 73.3).astype(np.float32)
    return x, q, scale


SHAPES = [(4, 128, 256), (5, 96, 200), (37, 64, 1000), (1, 256, 64)]


@pytest.mark.parametrize("m,d,f", SHAPES)
def test_plain_matches_jax_int8_matmul(m, d, f):
    x, q, scale = _operands(m + d, m, d, f)
    want = jax_int8_matmul(x, q, scale, block_m=32, block_f=128,
                           block_d=64, interpret=True)
    got = int8_matmul_ref(torch.from_numpy(x), torch.from_numpy(q),
                          torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,f", SHAPES)
def test_plain_against_jax_serving_expression(m, d, f, dtype):
    x, q, scale = _operands(m * 3 + f, m, d, f)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj = jnp.asarray(x).astype(jdt)
    want = np.asarray(((xj @ jnp.asarray(q).astype(jdt))
                       * jnp.asarray(scale).astype(jdt)).astype(jnp.float32))
    got = int8_matmul_ref(torch.from_numpy(x).to(tdt), torch.from_numpy(q),
                          torch.from_numpy(scale))
    assert got.dtype == tdt and got.shape == (m, f)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL,
                                   atol=F32_TOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_RTOL,
                                   atol=BF16_RTOL * np.abs(want).max())


def test_wrapper_on_cpu_is_the_plain_version():
    x, q, scale = (torch.from_numpy(a) for a in _operands(1, 3, 64, 96))
    launches = int8_matmul.launches
    x3 = x.reshape(3, 1, 64)
    got = int8_matmul(x3, q, scale)
    assert int8_matmul.launches == launches
    assert got.shape == (3, 1, 96)
    assert torch.equal(got.reshape(3, 96), int8_matmul_ref(x, q, scale))


@pytest.mark.parametrize("shape", [(64, 96), (3, 128, 48)])
def test_quantize_tensor_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    w[..., 5] = 0.0                               # an all-zero column
    want = jquant.quantize_tensor(jnp.asarray(w))
    got = tquant.quantize_tensor(torch.from_numpy(w))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))


def test_quantize_params_matches_jax_leaves():
    cfg = decoder_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    want = jquant.quantize_params(jp)
    tree = jax.tree.map(np.asarray, jp)
    got = tquant.quantize_params(params_from_numpy(tree, "cpu", "float32"))
    for path in tquant.DECODER_QUANT_LEAVES:
        g, w = got, want
        for p in path:
            g, w = g[p], w[p]
        assert tquant.quant_kind(g) == "int8"
        np.testing.assert_array_equal(g["q"].numpy(), np.asarray(w["q"]))
        np.testing.assert_array_equal(g["scale"].numpy(),
                                      np.asarray(w["scale"]))
    assert not tquant.is_quantized(got["tok_emb"])


def test_qmatmul_routes_by_leaf_kind():
    x, q, scale = (torch.from_numpy(a) for a in _operands(2, 4, 64, 32))
    leaf = {"q": q, "scale": scale}
    assert torch.equal(qmatmul(x, leaf), int8_matmul_ref(x, q, scale))
    assert torch.equal(qmatmul(x, leaf, "plain"),
                       int8_matmul_ref(x, q, scale))
    w = torch.randn(64, 32)
    assert torch.equal(qmatmul(x, w), x @ w)
    # an int4 leaf: 64 rows packed into 32 bytes, one scale group
    q4 = q[:32]
    assert torch.equal(qmatmul(x, {"q4": q4, "scale": scale}),
                       int4_matmul_ref(x, q4, scale))
    with pytest.raises(ValueError):
        qmatmul(x, leaf, "pallas")


@pytest.mark.parametrize("m,d,f", [(4, 4096, 1024), (4, 4096, 32000),
                                   (1, 14336, 4096), (8, 40, 77),
                                   (9, 4096, 4096)])
def test_gemv_splits_cover_the_contraction(m, d, f):
    splits = gemv_splits(m, d, f)
    if m > GEMV_MAX_M:
        assert splits == 0
        return
    assert 1 <= splits <= max(1, d // 16)
    chunk = -(-d // splits)
    assert chunk * splits >= d


# ---------------------------------------------------------------------------
# K2's bodies: the route rule, the tile width, the wgmma body's conversion
# ---------------------------------------------------------------------------

#: the int8 layer projections (D, F) of mistral-7b (q, k, v, o, gate, up,
#: down, each its own leaf) and the lm_head
MISTRAL_INT8 = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                (4096, 32000)]


@pytest.mark.parametrize("m", [9, 2048, 4096])
@pytest.mark.parametrize("d,f", MISTRAL_INT8)
def test_mistral_int8_waves_take_the_wgmma_body(m, d, f):
    # every admission-wave projection goes to the Hopper body, and a decode
    # step's four rows to the Hopper weight stream
    assert tqm.int8_body(m, d, f, torch.bfloat16) == "wgmma"
    assert tqm.int8_body(4, d, f, torch.bfloat16) == "stream"


@pytest.mark.parametrize("m,d,f,dtype,body", [
    (1, 4096, 4096, torch.bfloat16, "stream"),
    (8, 4096, 4096, torch.bfloat16, "stream"),
    (1, 4096, 4096, torch.float32, "gemv"),
    (8, 4096, 4096, torch.float32, "gemv"),
    (9, 4096, 4096, torch.bfloat16, "wgmma"),
    (300, 128, 208, torch.bfloat16, "wgmma"),
    (4096, 96, 4096, torch.bfloat16, "wmma"),      # D % 64 = 32
    (4096, 4096, 200, torch.bfloat16, "wmma"),     # F % 16 = 8
    (37, 64, 1000, torch.bfloat16, "wmma"),
    (9, 4096, 4096, torch.float32, "simt"),
    (4096, 4096, 14336, torch.float32, "simt")])
def test_int8_body_rule(m, d, f, dtype, body):
    # K2's body is chosen from dtype and shape alone
    assert tqm.int8_body(m, d, f, dtype) == body
    assert body in tqm.K2_BODIES


@pytest.mark.parametrize("m,f,tn", [
    (2048, 1024, 128), (4096, 1024, 128),        # the k/v projections
    (2048, 4096, 256), (4096, 4096, 256), (4096, 14336, 256),
    (4096, 32000, 256), (512, 14336, 256),
    (512, 4096, 128), (64, 14336, 128), (9, 64, 128)])   # few rows
def test_int8_tile_n(m, f, tn):
    # 256-column tiles only where they still make a wave on 132 SMs
    assert tqm.int8_tile_n(m, f) == tn
    wide = -(-m // 128) * -(-f // 256)
    assert (wide >= tqm.K2_WIDE_MIN_TILES) == (tn == 256)


def test_int8_wrapper_on_cpu_counts_no_body():
    x, q, scale = (torch.from_numpy(a) for a in _operands(7, 40, 128, 48))
    xb = x.to(torch.bfloat16)
    before = dict(tqm.int8_matmul.launches_by_body)
    assert torch.equal(int8_matmul(xb, q, scale),
                       int8_matmul_ref(xb, q, scale))
    assert tqm.int8_matmul.launches_by_body == before
    assert tuple(before) == tqm.K2_BODIES == ("stream", "gemv", "wgmma",
                                              "wmma", "simt")


def test_wgmma_conversion_route_is_exact_for_every_byte():
    # the wgmma body's int8 -> bf16 route (int8_wgmma.cuh `i8x4_bf16`),
    # in numpy: (v + 128) in the low mantissa bits of the f32 2^23, minus
    # 2^23 + 128, is v for every byte, and v is exact in bf16
    v = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    u = (v.view(np.uint8) ^ np.uint8(0x80)).astype(np.uint32)
    f = (u | np.uint32(0x4B000000)).view(np.float32) - np.float32(8388736.0)
    assert f.dtype == np.float32
    np.testing.assert_array_equal(f, v.astype(np.float32))
    t = torch.from_numpy(f)
    assert torch.equal(t.to(torch.bfloat16).float(), t)
