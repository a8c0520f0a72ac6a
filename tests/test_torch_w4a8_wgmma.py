# K6's wgmma body (``csrc/w4a8_wgmma.cuh``, M > 32: the a8 prefill waves)
# on the CPU: the rule that routes to it, its grouped raster, and numpy
# mirrors of the device's integer unpacking, the placement of the unpacked
# weight in wgmma's register A fragment (from the swizzled shared-memory
# tile TMA writes), its accumulator-to-output map and its group fold. The
# kernel itself runs only on the card (chip_smoke.py holds it to its plain
# version bit for bit).
#
# Tolerance: none. The mirror does the body's integer work exactly and its
# f32 work (the cast of each group's int32 partial, the product with the
# group's scale, the sum in group order, the product with sx) with the
# plain version's operations in its order, so it must equal
# ``w4a8_matmul_ref`` bit for bit, as the kernel must on the card.
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm

#: the int4 main path's leaves (D, F) of mistral-7b: fused q/k/v, wo,
#: fused gate/up, w_down, lm_head
MISTRAL_INT4 = {"wqkv": (4096, 6144), "wo": (4096, 4096),
                "w_gu": (4096, 28672), "w_down": (14336, 4096),
                "lm_head": (4096, 32000)}
#: the body's geometry (w4a8_wgmma.cuh): tokens and columns a CTA, k a
#: stage, packed rows a stage, 128-byte lines, token tiles a raster group
TT, TC, KS, KP = 176, 128, 128, 64
LINE = 128
GROUP_M = 8


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [33, 2816, 5632])
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT4))
def test_mistral_int4_waves_take_the_wgmma_body(leaf, m, dtype):
    d, f = MISTRAL_INT4[leaf]
    assert tqm.w4a8_body(m, d, f, tquant.INT4_GROUP, dtype) == "wgmma"


@pytest.mark.parametrize("m", [1, 8, 32])
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT4))
def test_mistral_int4_decode_keeps_the_split_qgemm(leaf, m):
    # decode no longer keeps the split qgemm: every Mistral-7B leaf takes
    # the stream body of w4a8_stream.cuh at M <= 32 (the split qgemm stays
    # for the layouts that body refuses, test_w4a8_body_edges)
    d, f = MISTRAL_INT4[leaf]
    assert tqm.w4a8_body(m, d, f, tquant.INT4_GROUP,
                         torch.bfloat16) == "stream"


@pytest.mark.parametrize("m,d,f,group,body", [
    (33, 4096, 6144, 256, "wgmma"),        # the smallest tiled M
    (5000, 4096, 6128, 256, "wgmma"),      # ragged M and F
    (512, 4096, 4104, 256, "mma_sync"),    # F % 16 = 8: TMA's row pitch
    (512, 4096, 4096, 64, "mma_sync"),     # a group of half a stage
    (512, 4160, 4096, 320, "mma_sync"),    # D and the group off the stage
    (512, 14336, 4096, 14336, "wgmma"),    # one group of the whole depth
    (32, 4096, 4104, 256, "split"),        # decode, F % 16 = 8
    (32, 4096, 4096, 64, "split"),         # decode, a group of half a stage
    (1, 4096, 6144, 256, "stream"),        # one token
    (17, 4096, 6144, 256, "stream"),       # a ragged third token tile
])
def test_w4a8_body_edges(m, d, f, group, body):
    assert tqm.w4a8_body(m, d, f, group, torch.bfloat16) == body
    assert tqm.w4a8_body(m, d, f, group, torch.float32) == body


def test_w4a8_body_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tqm.w4a8_body(64, 4096, 4096, 256, torch.float16)


def _raster(block, tiles_m, tiles_n):
    """The body's grouped raster: blockIdx.x -> (token tile, column
    tile)."""
    per_group = GROUP_M * tiles_n
    first_m = (block // per_group) * GROUP_M
    gm = min(tiles_m - first_m, GROUP_M)
    in_group = block % per_group
    return first_m + in_group % gm, in_group // gm


@pytest.mark.parametrize("m,f", [(5632, 28672), (5632, 4096), (33, 6144),
                                 (5000, 6128), (176 * 17, 256)])
def test_grouped_raster_visits_every_tile_once(m, f):
    tiles_m, tiles_n = -(-m // TT), -(-f // TC)
    seen = np.zeros((tiles_m, tiles_n), dtype=np.int64)
    for block in range(tiles_m * tiles_n):
        tm, tn = _raster(block, tiles_m, tiles_n)
        seen[tm, tn] += 1
    assert (seen == 1).all()


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 numpy arrays (selector values 0-7)."""
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 0x7] << (8 * i)
    return out


def _unpack2(h0, h1):
    """The body's unpack (``qmma::nibble_quads<0>``): the 16-bit loads of
    columns (c, c + 1) at packed rows r and r + 1 -> the A registers of
    the two columns."""
    w = _byte_perm(h0, h1, 0x5410)
    lo = ((w & 0x0F0F0F0F) ^ 0x88888888) - np.uint32(0x08080808)
    hi = (((w >> 4) & 0x0F0F0F0F) ^ 0x88888888) - np.uint32(0x08080808)
    return (_byte_perm(lo, hi, 0x6240) ^ 0x80808080,
            _byte_perm(lo, hi, 0x7351) ^ 0x80808080)


def _signed_bytes(reg):
    """uint32 registers -> their four bytes as int8 values, byte 0 first."""
    return np.stack([((reg >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
                     for b in range(4)], axis=-1)


@pytest.mark.parametrize("pos", range(4))
def test_unpack_integer_ops_give_the_nibbles_exactly(pos):
    # every byte value at byte `pos` of the two loads, the other bytes
    # random: (r, c) = h0 byte 0, (r, c + 1) h0 byte 1, (r + 1, c) h1 byte
    # 0, (r + 1, c + 1) h1 byte 1
    rng = np.random.default_rng(pos)
    byte = np.arange(256, dtype=np.uint32)
    raw = rng.integers(0, 256, (4, 256)).astype(np.uint32)
    raw[pos] = byte
    h0 = raw[0] | (raw[1] << 8)
    h1 = raw[2] | (raw[3] << 8)
    c0, c1 = _unpack2(h0, h1)
    assert c0.dtype == c1.dtype == np.uint32
    packed = torch.from_numpy(raw.T.astype(np.uint8).view(np.int8).copy())
    # rows: r at c, r at c + 1, r + 1 at c, r + 1 at c + 1 -> nibbles
    nib = tqm.unpack_int4(packed.reshape(256, 4, 1)).numpy()[..., 0]
    lo, hi = nib[:, 0::2], nib[:, 1::2]          # [256, 4 bytes]
    # column c: [lo(r, c), hi(r, c), lo(r + 1, c), hi(r + 1, c)]
    np.testing.assert_array_equal(
        _signed_bytes(c0), np.stack([lo[:, 0], hi[:, 0], lo[:, 2], hi[:, 2]],
                                    axis=1))
    np.testing.assert_array_equal(
        _signed_bytes(c1), np.stack([lo[:, 1], hi[:, 1], lo[:, 3], hi[:, 3]],
                                    axis=1))


def _swizzled(tile):
    """A [rows, 128] uint8 tile as TMA writes it with the 128-byte swizzle:
    16-byte chunk c of line r at chunk c ^ (r % 8)."""
    rows = tile.shape[0]
    r = np.arange(rows)[:, None]
    col = np.arange(LINE)[None, :]
    smem = np.zeros(rows * LINE, dtype=np.uint8)
    smem[r * LINE + (((col >> 4) ^ (r & 7)) << 4) + (col & 15)] = tile
    return smem


def _lanes():
    """Per consumer lane [warpgroup, warp, lane]: g, t, its first column
    cb and its swizzled offsets at packed rows 2t and 2t + 1."""
    wg, warp, lane = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                 indexing="ij")
    g, t = lane >> 2, lane & 3
    cb = 64 * wg + 16 * warp + 2 * g
    c = cb >> 4
    off_e = 2 * t * LINE + ((c ^ (2 * t)) << 4) + 2 * g
    off_o = (2 * t + 1) * LINE + ((c ^ (2 * t + 1)) << 4) + 2 * g
    return wg, warp, g, t, cb, off_e, off_o


def _u16(smem, off):
    return smem[off].astype(np.uint32) | (smem[off + 1].astype(np.uint32)
                                          << 8)


def _load_a(smem, j, off_e, off_o):
    """The body's ``load_a``: the four A registers of k32 step j."""
    p = j * 16 * LINE
    a0, a1 = _unpack2(_u16(smem, p + off_e), _u16(smem, p + off_o))
    a2, a3 = _unpack2(_u16(smem, p + 1024 + off_e),
                      _u16(smem, p + 1024 + off_o))
    return a0, a1, a2, a3


def _a_rows(regs, warp, g, t):
    """The register A fragments of a stage step as the two warpgroups'
    [64 rows, 32 k] operands: register r holds row 16 warp + g + 8 (r %
    2), k 16 (r // 2) + 4t + byte. Also counts each (row, k) written."""
    a = np.zeros((2, 64, 32), dtype=np.int64)
    hits = np.zeros((2, 64, 32), dtype=np.int64)
    wgi = np.broadcast_to(np.arange(2)[:, None, None], warp.shape)
    for r, reg in enumerate(regs):
        vals = _signed_bytes(reg)
        for b in range(4):
            row = 16 * warp + g + 8 * (r % 2)
            k = 16 * (r // 2) + 4 * t + b
            a[wgi, row, k] = vals[..., b]
            np.add.at(hits, (wgi, row, k), 1)
    return a, hits


def test_fragment_rows_map_onto_the_tile_columns_once():
    # fragment row 16 w + g + 8h of warpgroup wg is column 64 wg + 16 w +
    # 2g + h: over both warpgroups a bijection onto the 128 columns
    _, warp, g, _, cb, _, _ = _lanes()
    cols = {}
    for wg in range(2):
        for h in range(2):
            for w, gg, c in zip(warp[wg].ravel(), g[wg].ravel(),
                                cb[wg].ravel()):
                key = (wg, 16 * w + gg + 8 * h)
                assert cols.setdefault(key, c + h) == c + h
    assert sorted(cols.values()) == list(range(TC))


@pytest.mark.parametrize("seed", range(3))
def test_a_fragments_reassemble_the_unpacked_stage(seed):
    # one stage of q4 (64 packed rows x 128 columns) through TMA's swizzle
    # and the lanes' loads and unpacking: every (k, column) exactly once,
    # equal to unpack_int4 of the tile
    rng = np.random.default_rng(seed)
    q4 = rng.integers(-128, 128, (KP, TC)).astype(np.int8)
    smem = _swizzled(q4.view(np.uint8))
    _, warp, g, t, _, off_e, off_o = _lanes()
    want = tqm.unpack_int4(torch.from_numpy(q4)).numpy()     # [128 k, 128]
    col_of_row = np.array([[64 * wg + 16 * (r // 16) + 2 * (r % 8)
                            + (r % 16) // 8 for r in range(64)]
                           for wg in range(2)])
    for j in range(KS // 32):
        a, hits = _a_rows(_load_a(smem, j, off_e, off_o), warp, g, t)
        assert (hits == 1).all()
        for wg in range(2):
            np.testing.assert_array_equal(
                a[wg], want[32 * j:32 * (j + 1), col_of_row[wg]].T)


def test_a_fragment_loads_are_conflict_free():
    # each 16-bit load of a warp: the 32 lanes' words fall in distinct
    # banks, or share the word (a broadcast)
    _, _, _, _, _, off_e, off_o = _lanes()
    for wg in range(2):
        for warp in range(4):
            for j in range(KS // 32):
                for base in (0, 1024):
                    for off in (off_e, off_o):
                        addr = j * 16 * LINE + base + off[wg, warp]
                        words = {}
                        for word in addr // 4:
                            words.setdefault(word % 32, set()).add(word)
                        assert all(len(w) == 1 for w in words.values())


def _mirror(x, q4, scale):
    """The body's arithmetic on the CPU, tile by tile: xq and sx from
    ``quantize_rows``; per stage and k32 step the A registers unpacked from
    the swizzled q4 tile, their exact products with xq's tokens (wgmma's
    s32 accumulators, D row = fragment row, D column = token); at a
    group's end the cast, scale and sum; the epilogue's store map."""
    m, d = x.shape
    f = q4.shape[1]
    n_groups = scale.shape[0]
    gsteps = d // n_groups // KS
    xq, sx = tqm.quantize_rows(x)
    xq = xq.numpy().astype(np.int64)
    sx = sx.numpy()[:, 0]
    q4n, sc = q4.numpy(), scale.numpy()
    _, warp, g, t, cb, off_e, off_o = _lanes()
    out = np.full((m, f), np.nan, dtype=np.float32)
    j8, e, h = np.meshgrid(np.arange(TT // 8), np.arange(2), np.arange(2),
                           indexing="ij")
    for m0 in range(0, m, TT):
        xt = np.zeros((TT, d), dtype=np.int64)
        xt[:min(TT, m - m0)] = xq[m0:m0 + TT]
        for n0 in range(0, f, TC):
            qt = np.zeros((d // 2, TC), dtype=np.int8)
            qt[:, :min(TC, f - n0)] = q4n[:, n0:n0 + TC]
            st = np.zeros((n_groups, TC), dtype=np.float32)
            st[:, :min(TC, f - n0)] = sc[:, n0:n0 + TC]
            facc = np.zeros((2, 64, TT), dtype=np.float32)
            col_of_row = np.array([[64 * wg + 16 * (r // 16) + 2 * (r % 8)
                                    + (r % 16) // 8 for r in range(64)]
                                   for wg in range(2)])
            for gi in range(n_groups):
                acc = np.zeros((2, 64, TT), dtype=np.int64)
                for k in range(gi * gsteps, (gi + 1) * gsteps):
                    smem = _swizzled(qt[k * KP:(k + 1) * KP].view(np.uint8))
                    for j in range(KS // 32):
                        a, _ = _a_rows(_load_a(smem, j, off_e, off_o),
                                       warp, g, t)
                        b = xt[:, k * KS + 32 * j:k * KS + 32 * (j + 1)]
                        acc += a @ b.T
                assert np.abs(acc).max() < 2 ** 31           # int32
                p = acc.astype(np.int32).astype(np.float32)  # cvt.rn
                s_row = st[gi][col_of_row][..., None]
                facc = facc + p * s_row
            # epilogue: accumulator 4j + 2h + e of lane (g, t) is fragment
            # row 16 w + g + 8h, token 8j + 2t + e; column cb + h
            for wg in range(2):
                for w in range(4):
                    for lane in range(32):
                        gg, tt = lane >> 2, lane & 3
                        row = 16 * w + gg + 8 * h
                        tok = 8 * j8 + 2 * tt + e
                        mm = m0 + tok
                        nn = n0 + cb[wg, w, lane] + h
                        ok = (mm < m) & (nn < f)
                        vals = facc[wg, row, tok] * sx[np.minimum(mm, m - 1)]
                        assert np.isnan(out[mm[ok], nn[ok]]).all()
                        out[mm[ok], nn[ok]] = vals[ok]
    assert not np.isnan(out).any()
    return torch.from_numpy(out).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f,group", [(197, 512, 144, 128),
                                         (40, 256, 256, 256),
                                         (180, 768, 128, 256)])
def test_mirror_equals_the_plain_version_bit_for_bit(m, d, f, group, dtype):
    rng = np.random.default_rng(m * f + group)
    x = torch.from_numpy(
        (rng.standard_normal((m, d)) * 2.0).astype(np.float32)).to(dtype)
    q4 = torch.from_numpy(rng.integers(-128, 128, (d // 2, f))
                          .astype(np.int8))
    scale = torch.from_numpy(
        (rng.random((d // group, f)) * 0.01 + 1e-4).astype(np.float32))
    got = _mirror(x, q4, scale)
    want = tqm.w4a8_matmul_ref(x, q4, scale)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    # and the wrapper on the CPU is that plain version
    assert torch.equal(tqm.w4a8_matmul(x, q4, scale), want)
