# The port's weight-stream probe (kernel P, ops/probe_stream.py and
# scripts/probe_stream.py of the port) against the reference script
# scripts/probe_stream.py, on the same numpy inputs: each Pallas body run in
# interpret mode with the script's own BlockSpec layout, against the port's
# wrapper on CPU tensors (its plain version), and the chained step_n of all
# five modes, the reference's shapes cut to B 8, D 2048, F 2048, L 2.
#
# Tolerances. dma and i8dot: integers summed exactly, one f32 addition or
# multiply, one bf16 rounding, the same in both: equal. unpack8 and
# unpack32 differ only in how the nibbles are unpacked: equal. convdot and
# unpack: f32 sums (XLA's dot vs torch's matmul, and XLA may fuse the
# group fold) in another order can land on the other side of a bf16
# rounding boundary: one bf16 step at the largest output, 2**-7 relative to
# it. The chain is held layer by layer: each layer of each pass gets the
# reference's own chained x on both sides, and its output
# x = tanh(y · 1e-2) is held to one bf16 step of that layer's largest
# output, so no layer's error hides below a fixed absolute tolerance. The
# reference's chain dies by design: x lies in (-1, 1) after the first
# layer, so i8dot's int8 x truncates to 0 from the second layer on and
# unpack's round(x · 16) from the third (at an input scale of 8); those
# layers must give exactly 0 on both sides, and the layers before them must
# not. The whole chain (2 passes of 2 layers) is held to the same step of
# its own largest output (exact 0 where the chain died). convdot's whole
# chain is the exception: |y| ~ 10^3-10^4, so ~92% of x saturates at ±1
# (held to two bf16 steps there, 2**-7), while near y = 0 one bf16 step of
# y (up to 32) moves tanh(y · 1e-2) by up to ~0.3 and the move compounds
# through the layers: there at most 1% of the elements may lie beyond
# 2**-6. Its layers, held one by one, and the one-layer comparison before
# tanh are its strict checks.
import functools
import importlib.util
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from copilot_for_consensus_tpu_torch.ops import probe_stream as tps
from copilot_for_consensus_tpu_torch.scripts import probe_stream as tdrv

ROOT = pathlib.Path(__file__).resolve().parent.parent
BF16_STEP_RTOL = 2.0 ** -7
CHAIN_ATOL = 2.0 ** -6
SATURATED_ATOL = 2.0 ** -7
CONVDOT_CHAIN_OUTLIERS = 0.01


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_probe_stream", ROOT / "scripts" / "probe_stream.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference()


def _x(b, d, seed, scale=1.0):
    """bf16 x from a numpy seed: (torch bf16, jax bf16), equal values."""
    x = np.random.default_rng(seed).standard_normal((b, d)) * scale
    xt = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    return xt, jnp.asarray(xt.float().numpy(), jnp.bfloat16)


def _w(shape, seed, lo):
    return np.random.default_rng(seed).integers(
        lo, 128, size=shape).astype(np.int8)


def _np(y):
    return np.asarray(jnp.asarray(y, jnp.float32))


def _pallas(kern, b, f, bf, acc_dtype, grid_k, xspecs, wblock, *args):
    """The script's pallas_call layout: grid (F/bf, k tiles); x blocks
    (B, width) at column block k; the weight block (rows, bf) at (k, j)."""
    in_specs = [pl.BlockSpec((b, xw), lambda j, k: (0, k)) for xw in xspecs]
    in_specs.append(pl.BlockSpec((wblock, bf), lambda j, k: (k, j)))
    return pl.pallas_call(
        kern, grid=(f // bf, grid_k), in_specs=in_specs,
        out_specs=pl.BlockSpec((b, bf), lambda j, k: (0, j)),
        out_shape=jax.ShapeDtypeStruct((b, f), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((b, bf), acc_dtype)],
        interpret=True)(*args)


def _rel_err(got: torch.Tensor, want) -> tuple[float, float]:
    want = _np(want)
    err = float(np.abs(got.float().numpy() - want).max())
    return err, float(np.abs(want).max())


# ---------------------------------------------------------------------------
# Per body, at small blocks
# ---------------------------------------------------------------------------

B, D, F, BD, BFB = 8, 256, 256, 128, 128


def test_dma_body_equals_the_wrapper():
    xt, xj = _x(B, D, 0)
    w = _w((D, F), 1, -127)
    want = _pallas(REF.k_dma, B, F, BFB, jnp.float32, D // BD, [BD], BD,
                   xj, jnp.asarray(w))
    got = tps.probe_dma(xt, torch.from_numpy(w), bd=BD)
    assert got.dtype == torch.bfloat16 and got.shape == (B, F)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))
    # only the sampled rows and the last block's first x column count
    w2 = w.copy()
    w2[np.arange(D) % BD != 0] = 0
    xt2 = xt.clone()
    xt2[:, :D - BD] = 0
    xt2[:, D - BD + 1:] = 0
    assert torch.equal(tps.probe_dma(xt2, torch.from_numpy(w2), bd=BD), got)


def test_convdot_body_matches_the_wrapper():
    xt, xj = _x(B, D, 2)
    w = _w((D, F), 3, -127)
    want = _pallas(REF.k_convdot, B, F, BFB, jnp.float32, D // BD, [BD], BD,
                   xj, jnp.asarray(w))
    got = tps.probe_convdot(xt, torch.from_numpy(w), bd=BD)
    err, top = _rel_err(got, want)
    assert err <= BF16_STEP_RTOL * top


def test_i8dot_body_equals_the_wrapper():
    # x spread over several integers, negative ones included: truncation
    xt, xj = _x(B, D, 4, scale=4.0)
    w = _w((D, F), 5, -127)
    want = _pallas(REF.k_i8dot, B, F, BFB, jnp.int32, D // BD, [BD], BD,
                   xj.astype(jnp.int8), jnp.asarray(w))
    got = tps.probe_i8dot(xt, torch.from_numpy(w))
    assert got.abs().max() > 0
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("widen", [False, True], ids=["unpack8", "unpack32"])
def test_unpack_body_matches_the_wrapper(widen):
    gdp, bdp = 32, 64                          # two tiles of two groups
    xt, xj = _x(B, D, 6, scale=2.0)
    w4 = _w((D // 2, F), 7, -128)
    xq = jnp.clip(jnp.round(xj.astype(jnp.float32) * 16), -127,
                  127).astype(jnp.int8)
    kern = functools.partial(REF.k_unpack, widen=widen, groups=bdp // gdp,
                             gdp=gdp)
    want = _pallas(kern, B, F, BFB, jnp.float32, (D // 2) // bdp,
                   [bdp, bdp], bdp, xq[:, 0::2], xq[:, 1::2],
                   jnp.asarray(w4))
    other = functools.partial(REF.k_unpack, widen=not widen,
                              groups=bdp // gdp, gdp=gdp)
    want_other = _pallas(other, B, F, BFB, jnp.float32, (D // 2) // bdp,
                         [bdp, bdp], bdp, xq[:, 0::2], xq[:, 1::2],
                         jnp.asarray(w4))
    np.testing.assert_array_equal(_np(want), _np(want_other))
    got = tps.probe_unpack(xt, torch.from_numpy(w4), widen=widen, gdp=gdp,
                           groups=bdp // gdp)
    assert torch.equal(got, tps.probe_unpack(
        xt, torch.from_numpy(w4), widen=not widen, gdp=gdp,
        groups=bdp // gdp))
    err, top = _rel_err(got, want)
    assert top > 0 and err <= BF16_STEP_RTOL * top


def test_unpack_scale_index_is_local_to_its_tile():
    """Group g of every tile gets 1e-4 · (g + 1): two tiles with the same
    bytes and the same x columns give the same part, twice one."""
    gdp, groups = 32, 2
    xt, _ = _x(B, 2 * gdp * groups, 8, scale=2.0)
    w4 = torch.from_numpy(_w((gdp * groups, F), 9, -128))
    one = tps.probe_unpack(xt, w4, gdp=gdp, groups=groups).float()
    two = tps.probe_unpack(torch.cat([xt, xt], 1), torch.cat([w4, w4]),
                           gdp=gdp, groups=groups).float()
    assert one.abs().max() > 0
    assert torch.equal(two, 2 * one)              # doubling is exact


# ---------------------------------------------------------------------------
# The slice as a whole: the reference's build and step_n, cut in size
# ---------------------------------------------------------------------------

SB, SD, SF, SL = 8, 2048, 2048, 2


@pytest.fixture
def reference(monkeypatch):
    """The reference script at B 8, D 2048, F 2048, L 2, its pallas_calls
    run in interpret mode."""
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                  if not k.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(REF, "pl", ns)
    for name, v in (("B", SB), ("D", SD), ("F", SF), ("L", SL)):
        monkeypatch.setattr(REF, name, v)
    return REF


#: input scale of the chains: large enough that unpack's second layer
#: still sees a nonzero round(x · 16)
CHAIN_SCALE = 8.0
#: (pass, layer) steps of the 2 x 2 chain whose output is nonzero; the
#: rest are 0 by the reference's design (see the head of this file)
LIVE_STEPS = {"dma": 4, "convdot": 4, "i8dot": 1, "unpack8": 2,
              "unpack32": 2}


def _ported(reference, mode):
    """The reference's weights and step_n, and the port's on the same
    weights (carried through numpy)."""
    w_j, step_j = reference.build(mode)
    w = tdrv.weights_from_numpy(w_j, device="cpu")
    assert w.dtype == torch.int8 and tuple(w.shape) == w_j.shape
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    w_own, step_t = tdrv.build(mode, b=SB, d=SD, f=SF, n_layers=SL,
                               device="cpu")
    assert w_own.shape == w.shape and w_own.dtype == torch.int8
    return w_j, step_j, w, step_t


@pytest.mark.parametrize("mode", tdrv.MODES)
def test_step_n_matches_the_reference(reference, mode):
    w_j, step_j, w, step_t = _ported(reference, mode)
    xt, xj = _x(SB, SD, 10, scale=CHAIN_SCALE)
    want = _np(step_j(w_j, xj, 2))
    got = step_t(w, xt, 2)
    assert got.dtype == torch.bfloat16 and got.shape == (SB, SD)
    got = got.float().numpy()
    err = np.abs(got - want)
    top = float(np.abs(want).max())
    if mode != "convdot":
        # the chain dies (exactly 0) where its last step is not live
        assert (top > 0) == (LIVE_STEPS[mode] == 2 * SL)
        assert err.max() <= BF16_STEP_RTOL * top
        return
    saturated = np.abs(want) == 1
    assert saturated.mean() > 0.5
    assert err[saturated].max() <= SATURATED_ATOL
    assert (err > CHAIN_ATOL).mean() <= CONVDOT_CHAIN_OUTLIERS


@pytest.mark.parametrize("mode", tdrv.MODES)
def test_step_n_matches_the_reference_layer_by_layer(reference, mode):
    """Each (pass, layer) step of the chain, one layer and one pass on
    each side, from the reference's chained x: one bf16 step of the
    step's largest output, nonzero where the chain is live."""
    w_j, step_j, w, step_t = _ported(reference, mode)
    xt, xj = _x(SB, SD, 10, scale=CHAIN_SCALE)
    live = 0
    for _ in range(2):
        for layer in range(SL):
            want = _np(step_j(w_j[layer:layer + 1], xj, 1))
            got = step_t(w[layer:layer + 1], xt, 1).float().numpy()
            top = float(np.abs(want).max())
            assert np.abs(got - want).max() <= BF16_STEP_RTOL * top
            live += top > 0
            xj = jnp.asarray(want, jnp.bfloat16)
            xt = torch.from_numpy(want.copy()).to(torch.bfloat16)
    assert live == LIVE_STEPS[mode]


@pytest.mark.parametrize("mode", tdrv.MODES)
def test_one_layer_at_the_reference_blocks(mode):
    """One layer before tanh (where convdot saturates), with the
    reference's own blocks (bf 512, bd 2048; gdp 128, bdp 1024)."""
    bf, bd = 512, 2048
    xt, xj = _x(SB, SD, 11, scale=2.0)
    if mode in ("dma", "convdot", "i8dot"):
        w = _w((SD, SF), 12, -127)
        kern = {"dma": REF.k_dma, "convdot": REF.k_convdot,
                "i8dot": REF.k_i8dot}[mode]
        acc = jnp.int32 if mode == "i8dot" else jnp.float32
        xin = xj.astype(jnp.int8) if mode == "i8dot" else xj
        want = _pallas(kern, SB, SF, bf, acc, SD // bd, [bd], bd, xin,
                       jnp.asarray(w))
        fn = {"dma": tps.probe_dma, "convdot": tps.probe_convdot,
              "i8dot": tps.probe_i8dot}[mode]
        got = fn(xt, torch.from_numpy(w))
    else:
        gdp, bdp = REF.GROUP // 2, bd // 2
        w = _w((SD // 2, SF), 13, -128)
        xq = jnp.clip(jnp.round(xj.astype(jnp.float32) * 16), -127,
                      127).astype(jnp.int8)
        kern = functools.partial(REF.k_unpack, widen=mode == "unpack32",
                                 groups=bdp // gdp, gdp=gdp)
        want = _pallas(kern, SB, SF, bf, jnp.float32, (SD // 2) // bdp,
                       [bdp, bdp], bdp, xq[:, 0::2], xq[:, 1::2],
                       jnp.asarray(w))
        got = tps.probe_unpack(xt, torch.from_numpy(w),
                               widen=mode == "unpack32")
    err, top = _rel_err(got, want)
    assert top > 0
    if mode in ("dma", "i8dot"):
        assert err == 0
    else:
        assert err <= BF16_STEP_RTOL * top


# ---------------------------------------------------------------------------
# Refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", [
    "x_f32", "w_int16", "rows", "tile", "noncontiguous", "packed_rows"])
def test_wrappers_refuse_bad_operands(case):
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    w = torch.zeros(256, 64, dtype=torch.int8)
    w4 = torch.zeros(128, 64, dtype=torch.int8)
    bad = {
        "x_f32": (TypeError, lambda: tps.probe_convdot(x.float(), w)),
        "w_int16": (TypeError, lambda: tps.probe_dma(x, w.to(torch.int16))),
        "rows": (ValueError, lambda: tps.probe_i8dot(x, w[:128])),
        "tile": (ValueError, lambda: tps.probe_dma(x, w, bd=100)),
        "noncontiguous": (ValueError,
                          lambda: tps.probe_convdot(x[:, ::2], w[:128])),
        "packed_rows": (ValueError, lambda: tps.probe_unpack(x, w)),
    }
    exc, call = bad[case]
    with pytest.raises(exc):
        call()


def test_wrappers_do_not_fall_back_off_the_cpu():
    x = torch.zeros(4, 256, dtype=torch.bfloat16, device="meta")
    w = torch.zeros(256, 64, dtype=torch.int8, device="meta")
    for fn in (tps.probe_dma, tps.probe_convdot, tps.probe_i8dot):
        with pytest.raises(ValueError, match="no probe"):
            fn(x, w, 128)
    with pytest.raises(ValueError, match="no probe"):
        tps.probe_unpack(x, w[:128], gdp=32, groups=4)
    assert (tps.probe_dma.launches, tps.probe_convdot.launches,
            tps.probe_i8dot.launches, tps.probe_unpack.launches) == (0,) * 4


def test_the_probe_script_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdrv.build("dma", b=8, d=2048, f=2048, n_layers=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdrv.weights_from_numpy(np.zeros((1, 2, 2), np.int8))
    with pytest.raises(ValueError, match="CUDA device"):
        tdrv.run("dma", device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        tdrv.build("bf16dot", device="cpu")
