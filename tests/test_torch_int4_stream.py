# K5's stream body (``csrc/int4_stream.cuh``, bf16 x at M <= 32) on the
# CPU: the rule that routes to it, the wrapper's grid plan, its order of
# operations against the Pallas ``int4_matmul`` in interpret mode, and
# numpy mirrors of the device's integer unpacking, its fragment-row to
# column map and its swizzled shared-memory addresses. The kernel itself
# runs only on the card (chip_smoke.py holds it against its plain version).
#
# Tolerance. The mirror and the Pallas kernel both take each group's f32
# partial product and scale it in f32 before summing; they differ in the
# order of the f32 sums (splits, and the Pallas kernel's blocks): 1e-5
# relative to the largest output at f32. The conversion is exact: equal.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.ops import quant_matmul as jqm
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm

F32_RTOL = 1e-5
#: the int4 main path's leaves (D, F) of mistral-7b: fused q/k/v, wo,
#: fused gate/up, w_down, lm_head
MISTRAL_INT4 = {"wqkv": (4096, 6144), "wo": (4096, 4096),
                "w_gu": (4096, 28672), "w_down": (14336, 4096),
                "lm_head": (4096, 32000)}
#: the stream body's geometry (int4_stream.cuh): 128-byte lines, 32
#: columns a consumer warp, 8 packed rows (k16) a slice
LINE = 128
WARPS = 4


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT4))
def test_mistral_int4_decode_takes_the_stream_body(m, leaf):
    _, f = MISTRAL_INT4[leaf]
    assert tqm.int4_body(m, f, tquant.INT4_GROUP, torch.bfloat16) == "stream"


@pytest.mark.parametrize("m", [1, 32])
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT4))
def test_stream_plan_covers_columns_and_groups_once(m, leaf):
    d, f = MISTRAL_INT4[leaf]
    groups = d // tquant.INT4_GROUP
    tn, splits, per = tqm.stream_plan(m, d, f, groups)
    assert tn == tqm.STREAM_TN
    tiles = -(-f // tn)
    cover = np.zeros((f, groups), dtype=np.int64)
    for tile in range(tiles):
        for split in range(splits):
            gs = range(split * per, min(groups, (split + 1) * per))
            assert len(gs) > 0                       # no empty split
            cover[tile * tn:(tile + 1) * tn, gs.start:gs.stop] += 1
    assert (cover == 1).all()
    weight = d // 2 * f
    workspace = splits * m * f * 4 if splits > 1 else 0
    assert 4 * workspace <= weight
    # the CTAs stay within the resident slots unless the tiles alone
    # exceed them
    assert tiles * splits <= max(tiles, tqm._STREAM_SLOTS)


def test_stream_plan_splits_only_narrow_leaves():
    # the wide leaves stream in one pass; the narrow ones split
    for leaf, (d, f) in MISTRAL_INT4.items():
        _, splits, _ = tqm.stream_plan(32, d, f, d // tquant.INT4_GROUP)
        assert (splits == 1) == (f >= 16384), leaf


def _pallas_group_sum(x, q4, scale, group):
    """The Pallas kernel's function at any group size: one interpret-mode
    call per group where the TPU's lane tiling refuses the group (a group
    spanning its own contraction is always taken), summed in group order;
    one call over all groups where it takes them."""
    d = x.shape[-1]
    if group % 256 == 0:
        return np.asarray(jqm.int4_matmul(jnp.asarray(x), jnp.asarray(q4),
                                          jnp.asarray(scale), block_f=32,
                                          interpret=True))
    out = None
    for gi in range(d // group):
        part = np.asarray(jqm.int4_matmul(
            jnp.asarray(x[:, gi * group:(gi + 1) * group]),
            jnp.asarray(q4[gi * group // 2:(gi + 1) * group // 2]),
            jnp.asarray(scale[gi:gi + 1]), block_f=32, interpret=True))
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("group", [64, 128, 256])
@pytest.mark.parametrize("m", [1, 5, 32])
def test_stream_order_matches_pallas(m, group, splits):
    groups, f = 6, 48
    d = group * groups
    rng = np.random.default_rng(m * 1000 + group + splits)
    w = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    leaf = jquant.quantize_tensor_int4(jnp.asarray(w), group=group)
    q4, scale = np.array(leaf["q4"]), np.array(leaf["scale"])
    want = _pallas_group_sum(x, q4, scale, group)
    per = -(-groups // splits)
    got = tqm.int4_matmul_stream_ref(torch.from_numpy(x),
                                     torch.from_numpy(q4),
                                     torch.from_numpy(scale), per)
    assert got.shape == (m, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_RTOL,
                               atol=F32_RTOL * np.abs(want).max())
    if splits == 1:
        # one split is the plain version, operation for operation
        assert torch.equal(got, tqm.int4_matmul_ref(
            torch.from_numpy(x), torch.from_numpy(q4),
            torch.from_numpy(scale)))


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 numpy arrays (selector values 0-7)."""
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 0x7] << (8 * i)
    return out


def _bf16_bits_to_f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("j", range(4))
def test_unpack_integer_ops_give_the_nibbles_exactly(j):
    # all 256 byte values at byte j of a word whose other bytes vary
    rng = np.random.default_rng(j)
    byte = np.arange(256, dtype=np.uint32)
    other = rng.integers(0, 2 ** 32, 256, dtype=np.uint64).astype(np.uint32)
    w = (other & ~np.uint32(0xFF << (8 * j))) | (byte << (8 * j))
    w4 = w >> 4
    sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12)
    biased = (_byte_perm(w, w4, sel) & 0x000F000F) ^ 0x43084308
    # one bf16x2 subtraction of {136, 136}: exact on these small integers,
    # so the f32 difference is the bf16 result
    lo = _bf16_bits_to_f32(biased & 0xFFFF) - np.float32(136.0)
    hi = _bf16_bits_to_f32(biased >> 16) - np.float32(136.0)
    want = tqm.unpack_int4(torch.from_numpy(
        byte.astype(np.uint8).view(np.int8)).reshape(1, 256)).numpy()
    np.testing.assert_array_equal(lo, want[0].astype(np.float32))
    np.testing.assert_array_equal(hi, want[1].astype(np.float32))
    # the bit patterns of the bf16x2 word: the values' own bf16 bits
    got_bits = (lo.view(np.uint32) >> 16) | (hi.view(np.uint32) >> 16 << 16)
    want_bits = torch.from_numpy(
        np.stack([want[0], want[1]], axis=1).astype(np.float32)
    ).to(torch.bfloat16).view(torch.int16).numpy().astype(np.uint16)
    np.testing.assert_array_equal(
        got_bits, want_bits[:, 0].astype(np.uint32)
        | (want_bits[:, 1].astype(np.uint32) << 16))


def _lane_columns(warp, lane):
    """The four columns (of a 128-column tile) whose packed bytes a
    consumer lane's word holds, in byte order: its chunk c = warp + 4
    (g // 4), word g % 4."""
    g = lane >> 2
    c = warp + 4 * (g >> 2)
    return [16 * c + 4 * (g & 3) + byte for byte in range(4)]


def test_fragment_rows_map_onto_the_tile_columns_once():
    # fragment row (tile T, row g + 8h) of warp w is byte 2T + h of lane
    # g's word: over the tile's warps, a bijection onto its 128 columns,
    # the same column for the four lanes (k-pairs) that share a row
    seen = {}
    for warp in range(WARPS):
        for lane in range(32):
            g = lane >> 2
            cols = _lane_columns(warp, lane)
            for tile in range(2):
                for h in range(2):
                    key = (warp, tile, g + 8 * h)
                    col = cols[2 * tile + h]
                    assert seen.setdefault(key, col) == col
    assert sorted(seen.values()) == list(range(WARPS * 32))
    # each warp's 32 columns: the epilogue's four adjacent columns a lane
    for warp in range(WARPS):
        cols = sorted({c for lane in range(32)
                       for c in _lane_columns(warp, lane)})
        assert len(cols) == 32


def _swizzle_128(row, col):
    """Byte offset of (line row, byte col) in a TMA box of 128-byte lines
    with the 128-byte swizzle: chunk col // 16 sits at chunk ^ (row % 8)."""
    return row * LINE + ((((col >> 4) ^ (row & 7))) << 4) + (col & 15)


def test_weight_fragment_loads_read_their_columns_without_conflicts():
    for warp in range(WARPS):
        for word in (0, 1):                     # k-pair rows t and t + 4
            banks = set()
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                c = warp + 4 * (g >> 2)
                r = t + 4 * word
                off = r * LINE + ((c ^ r) << 4) + 4 * (g & 3)
                # the address is the swizzled home of the lane's columns
                # at packed row r of the slice
                assert [off + b for b in range(4)] == [
                    _swizzle_128(r, col) for col in _lane_columns(warp, lane)]
                banks.add((off // 4) % 32)
            assert len(banks) == 32


@pytest.mark.parametrize("nt", [1, 2, 3, 4])
def test_x_fragment_ldmatrix_rows_are_conflict_free(nt):
    for sub in range(4):                        # k16 slices of a 64-k box
        for j in range(0, nt, 2):               # x4 (or x2 at the end)
            mats = 4 if j + 1 < nt else 2
            for mi in range(mats):
                banks = set()
                for r8 in range(8):
                    token = 8 * (j + (mi >> 1)) + r8
                    chunk = 2 * sub + (mi & 1)
                    off = token * LINE + ((chunk ^ r8) << 4)
                    # token's k values 8 chunk .. 8 chunk + 7 (bf16)
                    assert off == _swizzle_128(token, 16 * chunk)
                    banks.update((off // 4 + i) % 32 for i in range(4))
                assert len(banks) == 32
