# K4's wgmma body (``csrc/w8a8_wgmma.cuh``: the a8 prefill waves) on the
# CPU: the rule that routes to it, its grouped raster, and numpy mirrors of
# the device's A-fragment loads (ldmatrix.x4.trans from the swizzled int8
# weight stage TMA writes, then byte permutes), their bank map, the
# swizzled xq rows wgmma reads as B, and the whole body: the int32 chain,
# the cast, the two scales and the epilogue's store map. The kernel itself
# runs only on the card (chip_smoke.py holds it to its plain version bit
# for bit).
#
# Tolerances. The mirror does the body's integer work exactly and its f32
# work (the cast of the int32 sum, the product with sx, the product with
# sw, one rounding to x's dtype) with the plain version's operations in its
# order, so it must equal ``w8a8_matmul_ref`` bit for bit, as the kernel
# must on the card. Against the Pallas kernel in interpret mode it is held
# to ``tests/test_torch_a8.py``'s K4 tolerance, 1e-6: XLA's CPU interpreter
# lands within one f32 step of the same formula.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.ops import quant_matmul as jqm
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm

K4_TOL = 1e-6
#: the int8 leaves (D, F) of mistral-7b: q, k, v, o, gate, up, down and
#: the lm_head
MISTRAL_INT8 = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
                "wo": (4096, 4096), "w_gate": (4096, 14336),
                "w_up": (4096, 14336), "w_down": (14336, 4096),
                "lm_head": (4096, 32000)}
#: the four layer shapes K4 takes in the a8 wave (chip_smoke's A8_SHAPES)
A8_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
#: the body's geometry (w8a8_wgmma.cuh): tokens and columns a CTA, k a
#: stage, 128-byte lines, token tiles a raster group
TT, TC, KS = 256, 128, 128
LINE = 128
GROUP_M = 8


# ---------------------------------------------------------------------------
# the route and the raster
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1024, 4096])
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT8))
def test_mistral_int8_waves_take_the_wgmma_body(leaf, m, dtype):
    d, f = MISTRAL_INT8[leaf]
    assert tqm.w8a8_body(m, d, f, dtype) == "wgmma"


@pytest.mark.parametrize("m,d,f,body", [
    (1000, 4096, 4112, "wgmma"),       # ragged M and F against the tiles
    (1, 128, 16, "wgmma"),             # one token, one stage, one chunk
    (1024, 4160, 4096, "mma_sync"),    # D off the 128-row stage
    (1024, 4096, 4104, "mma_sync"),    # F % 16 = 8: TMA's row pitch
    (4096, 4160, 4104, "mma_sync"),    # both
])
def test_w8a8_body_edges(m, d, f, body):
    assert tqm.w8a8_body(m, d, f, torch.bfloat16) == body
    assert tqm.w8a8_body(m, d, f, torch.float32) == body


def test_w8a8_body_refuses_other_dtypes():
    with pytest.raises(TypeError):
        tqm.w8a8_body(4096, 4096, 4096, torch.float16)


def test_w8a8_counts_its_bodies():
    assert tuple(tqm.w8a8_matmul.launches_by_body) == tqm.K4_BODIES
    assert set(tqm.K4_BODIES) == {"wgmma", "mma_sync"}


def _raster(block, tiles_m, tiles_n):
    """The body's grouped raster: tile index -> (token tile, column
    tile)."""
    per_group = GROUP_M * tiles_n
    first_m = (block // per_group) * GROUP_M
    gm = min(tiles_m - first_m, GROUP_M)
    in_group = block % per_group
    return first_m + in_group % gm, in_group // gm


@pytest.mark.parametrize("m,f", [(4096, f) for _, f in A8_SHAPES]
                         + [(1000, 4112), (4096 + 1, 1024), (300, 16),
                            (256 * 17, 14336 + 16)])
def test_grouped_raster_visits_every_tile_once(m, f):
    tiles_m, tiles_n = -(-m // TT), -(-f // TC)
    seen = np.zeros((tiles_m, tiles_n), dtype=np.int64)
    for block in range(tiles_m * tiles_n):
        tm, tn = _raster(block, tiles_m, tiles_n)
        seen[tm, tn] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the A fragment: ldmatrix.x4.trans and byte permutes
# ---------------------------------------------------------------------------


def _swizzled(tile):
    """A [rows, 128] uint8 tile as TMA writes it with the 128-byte swizzle:
    16-byte chunk c of line r at chunk c ^ (r % 8)."""
    rows = tile.shape[0]
    r = np.arange(rows)[:, None]
    col = np.arange(LINE)[None, :]
    smem = np.zeros(rows * LINE, dtype=np.uint8)
    smem[r * LINE + (((col >> 4) ^ (r & 7)) << 4) + (col & 15)] = tile
    return smem


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 numpy arrays (selector values 0-7)."""
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        idx = (sel >> (4 * i)) & 0x7
        out |= np.take_along_axis(src, idx[None], axis=0)[0] << (8 * i)
    return out


def _signed_bytes(reg):
    """uint32 registers -> their four bytes as int8 values, byte 0 first."""
    return np.stack([((reg >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
                     for b in range(4)], axis=-1)


def _lanes():
    """Per consumer lane [warpgroup, warp, lane]: g, t, its first column
    cb, the swizzled offset of the k row whose address it gives ldmatrix,
    and its two byte-permute selectors (the body's consumer set-up)."""
    wg, warp, lane = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                 indexing="ij")
    g, t = lane >> 2, lane & 3
    cb = 64 * wg + 16 * warp + 2 * g
    c = cb >> 4
    p, mi = lane & 7, lane >> 3
    tp = p >> 1
    k0 = 16 * (mi >> 1) + 4 * tp + (p & 1) + 2 * ((mi & 1) ^ (tp >> 1))
    off = k0 * LINE + ((c ^ (k0 & 7)) << 4)
    sel0 = np.where(t < 2, 0x6420, 0x2064).astype(np.uint32)
    sel1 = np.where(t < 2, 0x7531, 0x3175).astype(np.uint32)
    return dict(warp=warp, g=g, t=t, cb=cb, off=off, sel0=sel0, sel1=sel1)


def _u16(smem, off):
    return smem[off].astype(np.uint32) | (smem[off + 1].astype(np.uint32)
                                          << 8)


def _ldsm_x4_t(smem, addr):
    """ldmatrix.sync.aligned.m8n8.x4.trans.b16 for every warp at once:
    ``addr`` [..., 32] the lanes' row addresses (lane l gives row l % 8 of
    matrix l / 8); lane (g, t) receives, for each matrix i, element (row
    2t, column g) in the low half and (row 2t + 1, column g) in the high
    half."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    regs = []
    for i in range(4):
        lo = _u16(smem, np.take(addr, 8 * i + 2 * t, axis=-1) + 2 * g)
        hi = _u16(smem, np.take(addr, 8 * i + 2 * t + 1, axis=-1) + 2 * g)
        regs.append(lo | (hi << 16))
    return regs


def _load_a(smem, j, ln):
    """The body's ``load_a``: the four A registers of k32 step j."""
    r0, r1, r2, r3 = _ldsm_x4_t(smem, j * 32 * LINE + ln["off"])
    return (_byte_perm(r0, r1, ln["sel0"]), _byte_perm(r0, r1, ln["sel1"]),
            _byte_perm(r2, r3, ln["sel0"]), _byte_perm(r2, r3, ln["sel1"]))


def _a_rows(regs, ln):
    """The register A fragments of a k32 step as the two warpgroups' [64
    rows, 32 k] operands (m16n8k32's s8 A layout, each warp's 16 rows):
    register r holds row 16 warp + g + 8 (r % 2), k 16 (r // 2) + 4t +
    byte. Also counts each (row, k) written."""
    warp, g, t = ln["warp"], ln["g"], ln["t"]
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


def _col_of_row():
    """Fragment row R of warpgroup wg -> its tile column: 64 wg + 16 (R //
    16) + 2 (R % 8) + (R % 16) // 8."""
    return np.array([[64 * wg + 16 * (r // 16) + 2 * (r % 8) + (r % 16) // 8
                      for r in range(64)] for wg in range(2)])


def test_fragment_rows_map_onto_the_tile_columns_once():
    # fragment row 16 w + g + 8h of warpgroup wg is column 64 wg + 16 w +
    # 2g + h: over both warpgroups a bijection onto the 128 columns, and
    # the lane's first column is the one its ldmatrix element g holds
    ln = _lanes()
    cols = {}
    for wg in range(2):
        for h in range(2):
            for w, gg, c in zip(ln["warp"][wg].ravel(), ln["g"][wg].ravel(),
                                ln["cb"][wg].ravel()):
                key = (wg, 16 * w + gg + 8 * h)
                assert cols.setdefault(key, c + h) == c + h
                assert _col_of_row()[key] == c + h
    assert sorted(cols.values()) == list(range(TC))
    assert (ln["cb"] == 16 * (ln["cb"] >> 4) + 2 * ln["g"]).all()


@pytest.mark.parametrize("seed", range(3))
def test_a_fragments_reassemble_the_int8_stage(seed):
    # one stage of q (128 k rows x 128 columns) through TMA's swizzle and
    # the lanes' ldmatrix.trans and byte permutes: every (k, column) exactly
    # once, in wgmma's k32 s8 A layout
    rng = np.random.default_rng(seed)
    q = rng.integers(-128, 128, (KS, TC)).astype(np.int8)
    smem = _swizzled(q.view(np.uint8))
    ln = _lanes()
    col_of_row = _col_of_row()
    for j in range(KS // 32):
        a, hits = _a_rows(_load_a(smem, j, ln), ln)
        assert (hits == 1).all()
        for wg in range(2):
            np.testing.assert_array_equal(
                a[wg], q[32 * j:32 * (j + 1), col_of_row[wg]].T)


def test_a_fragment_ldmatrix_rows_are_conflict_free():
    # each of ldmatrix's four phases reads one matrix: eight 16-byte rows,
    # which must fall in eight distinct chunks (all 32 banks once)
    ln = _lanes()
    for wg in range(2):
        for warp in range(4):
            for j in range(KS // 32):
                addr = j * 32 * LINE + ln["off"][wg, warp]
                assert (addr % 16 == 0).all()
                for i in range(4):
                    rows = addr[8 * i:8 * i + 8]
                    banks = {(a // 4 + b) % 32 for a in rows
                             for b in range(4)}
                    assert len(banks) == 32


@pytest.mark.parametrize("j", range(KS // 32))
def test_xq_b_rows_spread_over_the_banks(j):
    # wgmma's B at k32 step j: each token reads bytes 32j .. 32j + 31 of its
    # 128-byte line, two chunks. Under the swizzle each 8-token atom's
    # sixteen chunk reads cover the eight chunk positions twice each: two
    # full 128-byte wavefronts, no bank read more than the minimum.
    for atom in range(TT // 8):
        pos = np.zeros(8, dtype=np.int64)
        for r in range(8 * atom, 8 * atom + 8):
            for c in (2 * j, 2 * j + 1):
                pos[c ^ (r & 7)] += 1
        assert (pos == 2).all()
    # and the descriptor's start (32 j bytes into the atom) with SBO 1024
    # walks the tile: token r's line sits at r * 128 bytes
    xq = np.random.default_rng(j).integers(-127, 128, (TT, KS)).astype(
        np.int8)
    smem = _swizzled(xq.view(np.uint8))
    for r in (0, 7, 8, 255):
        line = r * LINE
        got = [smem[line + ((((32 * j + b) >> 4) ^ (r & 7)) << 4)
                    + ((32 * j + b) & 15)] for b in range(32)]
        np.testing.assert_array_equal(
            np.array(got, dtype=np.uint8).view(np.int8),
            xq[r, 32 * j:32 * (j + 1)])


# ---------------------------------------------------------------------------
# the whole body
# ---------------------------------------------------------------------------


def _mirror(x, q, scale):
    """The body's arithmetic on the CPU, tile by tile: xq and sx from
    ``quantize_rows``; per stage and k32 step the A registers from the
    swizzled q stage (ldmatrix.trans and permutes), their exact products
    with xq's tokens (wgmma's s32 accumulators, D row = fragment row, D
    column = token), one chain over the whole depth; then cvt.rn, ×sx,
    ×sw in f32 and the epilogue's store map, one rounding to x's dtype."""
    m, d = x.shape
    f = q.shape[1]
    xq, sx = tqm.quantize_rows(x)
    xq = xq.numpy().astype(np.int64)
    sx = sx.numpy()[:, 0]
    qn, sw = q.numpy(), scale.numpy().reshape(f)
    ln = _lanes()
    col_of_row = _col_of_row()
    out = np.full((m, f), np.nan, dtype=np.float32)
    j8, e, h = np.meshgrid(np.arange(TT // 8), np.arange(2), np.arange(2),
                           indexing="ij")
    for m0 in range(0, m, TT):
        xt = np.zeros((TT, d), dtype=np.int64)
        xt[:min(TT, m - m0)] = xq[m0:m0 + TT]
        for n0 in range(0, f, TC):
            qt = np.zeros((d, TC), dtype=np.int8)
            qt[:, :min(TC, f - n0)] = qn[:, n0:n0 + TC]
            acc = np.zeros((2, 64, TT), dtype=np.int64)
            for k in range(d // KS):
                smem = _swizzled(qt[k * KS:(k + 1) * KS].view(np.uint8))
                for j in range(KS // 32):
                    a, _ = _a_rows(_load_a(smem, j, ln), ln)
                    b = xt[:, k * KS + 32 * j:k * KS + 32 * (j + 1)]
                    acc += a @ b.T
            assert np.abs(acc).max() < 2 ** 31                  # int32
            p = acc.astype(np.int32).astype(np.float32)         # cvt.rn
            # epilogue: accumulator 4j + 2h + e of lane (g, t) is fragment
            # row 16 w + g + 8h, token 8j + 2t + e; column cb + h
            for wg in range(2):
                for w in range(4):
                    for lane in range(32):
                        gg, tt = lane >> 2, lane & 3
                        row = 16 * w + gg + 8 * h
                        tok = 8 * j8 + 2 * tt + e
                        mm = m0 + tok
                        nn = n0 + ln["cb"][wg, w, lane] + h
                        assert (nn - n0 == col_of_row[wg, row]).all()
                        ok = (mm < m) & (nn < f)
                        vals = (p[wg, row, tok]
                                * sx[np.minimum(mm, m - 1)]) \
                            * sw[np.minimum(nn, f - 1)]
                        assert np.isnan(out[mm[ok], nn[ok]]).all()
                        out[mm[ok], nn[ok]] = vals[ok]
    assert not np.isnan(out).any()
    return torch.from_numpy(out).to(x.dtype)


def _operands(seed, m, d, f):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, d)) * 2.0).astype(np.float32)
    q = rng.integers(-127, 128, (d, f)).astype(np.int8)
    scale = (rng.random((1, f)) * 2 * d ** -0.5 / 73.3 + 1e-6).astype(
        np.float32)
    return x, q, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f", [(300, 256, 144), (40, 512, 128),
                                   (257, 128, 272)])
def test_mirror_equals_the_plain_version_bit_for_bit(m, d, f, dtype):
    x, q, scale = _operands(m * f + d, m, d, f)
    xt = torch.from_numpy(x).to(dtype)
    qt, st = torch.from_numpy(q), torch.from_numpy(scale)
    got = _mirror(xt, qt, st)
    want = tqm.w8a8_matmul_ref(xt, qt, st)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    # and the wrapper on the CPU is that plain version
    assert torch.equal(tqm.w8a8_matmul(xt, qt, st), want)


@pytest.mark.parametrize("m,d,f", [(300, 256, 144), (40, 512, 128)])
def test_mirror_matches_the_pallas_kernel(m, d, f):
    x, q, scale = _operands(m + d + f, m, d, f)
    got = _mirror(torch.from_numpy(x), torch.from_numpy(q),
                  torch.from_numpy(scale))
    want = np.asarray(jqm.w8a8_matmul(jnp.asarray(x), jnp.asarray(q),
                                      jnp.asarray(scale), block_f=32,
                                      interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=K4_TOL, atol=K4_TOL)
