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
