# P's Hopper body (``csrc/probe_wgmma.cuh``: convdot, i8dot, unpack8 and
# unpack32 as one TMA-fed wgmma weight stream) on the CPU: the rule that
# routes to it, the launch counts by body, and numpy mirrors of the
# device's A-fragment loads for each conversion (ldmatrix.x2.trans and the
# exact int8 -> bf16 trick; K4's ldmatrix.x4.trans and byte permutes; K6's
# 16-bit loads with the nibble unpack in the int8 domain, and through
# int32), their bank maps, the x rows wgmma reads as B after a TMA
# multicast of two halves, the cluster's barrier counts, the schedule of
# stages, segments and folds, and the whole body in its own order. The
# kernel itself runs only on the card (chip_smoke.py holds it to the plain
# versions).
#
# Tolerances. i8dot and unpack: none. The mirror does the body's integer
# work exactly and its f32 work (cvt of the s32 sum, the multiply by 1e-4;
# for unpack each group's cvt, scale, sum in group order, and the tiles'
# sum in order) with the plain version's operations in its order, so it
# must equal ``i8dot_ref`` and ``unpack_ref`` bit for bit, as the kernel
# must on the card. convdot: the tensor cores sum a tile's exact products
# in f32 in their own order; the mirror sums them exactly (f64) and rounds
# once to f32 a tile, then adds the tiles in order: one bf16 step of the
# largest output (2**-7 relative), chip_smoke's P_RTOL. Against the Pallas
# bodies of the reference script, in interpret mode: the same, with XLA's
# f32 sums for convdot and unpack.
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from copilot_for_consensus_tpu_torch.ops import probe_stream as tps
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm
from copilot_for_consensus_tpu_torch.scripts import probe_stream as tdrv

ROOT = pathlib.Path(__file__).resolve().parent.parent
BF16_STEP_RTOL = 2.0 ** -7
MODES = ("convdot", "i8dot", "unpack8", "unpack32")
#: the body's geometry (probe_wgmma.cuh): tokens, columns a CTA, CTAs a
#: cluster, 128-byte lines, consumer warps a CTA, stages of the ring
TT, TC, CL, LINE = 128, 128, 2, 128
NCONS_WARPS = 8
KS = {"convdot": 64, "i8dot": 128, "unpack8": 128, "unpack32": 128}
WROWS = {"convdot": 64, "i8dot": 128, "unpack8": 64, "unpack32": 64}
STAGES = {"convdot": 8, "i8dot": 6, "unpack8": 6, "unpack32": 6}
STEPS = 4


# ---------------------------------------------------------------------------
# the route and the counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_the_reference_layout_takes_the_wgmma_body(mode):
    assert tps.probe_body(mode, tdrv.B, tdrv.D, tdrv.F) == "wgmma"
    assert tps.probe_body(mode, tdrv.B, tdrv.D, tdrv.F, tps.BD, tps.GDP,
                          tps.GROUPS) == "wgmma"


@pytest.mark.parametrize("mode,b,d,f,kw,body", [
    ("convdot", 1, 2048, 256, {}, "wgmma"),          # one token, one tile
    ("convdot", 128, 6144, 1024, {}, "wgmma"),       # three tiles
    ("convdot", 129, 4096, 14336, {}, "simple"),     # over one token tile
    ("convdot", 128, 4096, 14336 + 128, {}, "simple"),   # half a cluster
    ("convdot", 128, 4096, 384, {}, "simple"),       # F % 256 = 128
    ("convdot", 128, 4096, 4104, {}, "simple"),      # F % 16 = 8
    ("convdot", 128, 4096, 512, {"bd": 64}, "wgmma"),    # a one-stage tile
    ("convdot", 128, 4096, 512, {"bd": 32}, "simple"),   # half a stage
    ("convdot", 128, 4096, 512, {"bd": 96}, "simple"),   # not whole stages
    ("i8dot", 100, 4096, 512, {}, "wgmma"),          # ragged tokens
    ("i8dot", 128, 4160, 512, {"bd": 4160}, "simple"),   # D % 128 = 64
    ("i8dot", 128, 128, 256, {"bd": 128}, "wgmma"),  # one stage
    ("unpack8", 128, 4096, 512, {"gdp": 64, "groups": 1}, "wgmma"),
    ("unpack8", 128, 4096, 512, {"gdp": 32, "groups": 4}, "simple"),
    ("unpack32", 128, 4096, 512, {"gdp": 96, "groups": 2}, "simple"),
    ("unpack32", 128, 6144, 512, {}, "wgmma"),       # three tiles
    ("unpack32", 128, 3072, 512, {}, "simple"),      # 1.5 tiles
    ("unpack8", 0, 4096, 512, {}, "simple"),         # no token
])
def test_probe_body_edges(mode, b, d, f, kw, body):
    assert tps.probe_body(mode, b, d, f, **kw) == body


def test_probe_body_has_no_dma():
    with pytest.raises(ValueError, match="no Hopper body"):
        tps.probe_body("dma", 128, 4096, 14336)


def test_wrappers_count_their_bodies():
    assert tps.P_BODIES == ("wgmma", "simple")
    for fn in (tps.probe_convdot, tps.probe_i8dot, tps.probe_unpack):
        assert tuple(fn.launches_by_body) == tps.P_BODIES
    assert not hasattr(tps.probe_dma, "launches_by_body")


def test_cpu_calls_count_no_body():
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    w = torch.zeros(256, 256, dtype=torch.int8)
    before = [dict(fn.launches_by_body) for fn in
              (tps.probe_convdot, tps.probe_i8dot, tps.probe_unpack)]
    tps.probe_convdot(x, w, 128)
    tps.probe_i8dot(x, w, 128)
    tps.probe_unpack(x, w[:128], gdp=64, groups=2)
    after = [dict(fn.launches_by_body) for fn in
             (tps.probe_convdot, tps.probe_i8dot, tps.probe_unpack)]
    assert after == before


# ---------------------------------------------------------------------------
# helpers: the swizzle, byte permutes, the lanes
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
    a, b = np.asarray(a, np.uint32), np.asarray(b, np.uint32)
    sel = np.broadcast_to(np.asarray(sel, np.uint32), a.shape)
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros(a.shape, dtype=np.uint32)
    for i in range(4):
        idx = ((sel >> (4 * i)) & 0x7).astype(np.int64)
        out |= np.take_along_axis(src, idx[None], axis=0)[0] << (8 * i)
    return out


def _signed_bytes(reg):
    """uint32 registers -> their four bytes as int8 values, byte 0 first."""
    return np.stack([((reg >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
                     for b in range(4)], axis=-1)


def _u16(smem, off):
    return smem[off].astype(np.uint32) | (smem[off + 1].astype(np.uint32)
                                          << 8)


def _lane_grid():
    """[warpgroup, warp, lane] indices of the 256 consumer threads."""
    wg, warp, lane = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                 indexing="ij")
    return wg, warp, lane


def _col_of_row():
    """Fragment row R of warpgroup wg -> its tile column: 64 wg + 16 (R //
    16) + 2 (R % 8) + (R % 16) // 8 (rows g, g + 8 of warp w are columns
    cb = 64 wg + 16 w + 2g and cb + 1)."""
    return np.array([[64 * wg + 16 * (r // 16) + 2 * (r % 8) + (r % 16) // 8
                      for r in range(64)] for wg in range(2)])


# ---------------------------------------------------------------------------
# the A fragments, per conversion (Frag<MODE> of the header)
# ---------------------------------------------------------------------------


def _bytes_bf16x2(u, j0, j1):
    """``bytes_bf16x2<J0, J1>``: bytes j0 and j1 of u (already ^ 0x80) ->
    bf16x2 through f32 0x4B0000__ - (2^23 + 128), the high halves packed."""
    magic = np.float32(8388736.0)

    def one(j):
        bits = np.uint32(0x4B000000) | ((u >> (8 * j)) & 0xFF)
        return (bits.view(np.float32) - magic).astype(np.float32)

    f0, f1 = one(j0), one(j1)
    return _byte_perm(f0.view(np.uint32), f1.view(np.uint32), 0x7632)


def _ldsm_trans(smem, addr, mats):
    """ldmatrix.sync.aligned.m8n8.x{mats}.trans.b16 for every warp at once:
    ``addr`` [..., 32] the lanes' row addresses (lane l gives row l % 8 of
    matrix l / 8); lane (g, t) receives, for each matrix i, element (row
    2t, column g) in the low half and (row 2t + 1, column g) in the high
    half."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    regs = []
    for i in range(mats):
        lo = _u16(smem, np.take(addr, 8 * i + 2 * t, axis=-1) + 2 * g)
        hi = _u16(smem, np.take(addr, 8 * i + 2 * t + 1, axis=-1) + 2 * g)
        regs.append(lo | (hi << 16))
    return regs


def _frag_offsets(mode):
    """The lanes' set-up of ``Frag<mode>``: shared-memory offsets (and
    i8dot's byte-permute selectors), [warpgroup, warp, lane]."""
    wg, warp, lane = _lane_grid()
    g, t = lane >> 2, lane & 3
    cb = 64 * wg + 16 * warp + 2 * g
    c = cb >> 4
    if mode == "convdot":
        k = lane & 15
        return {"off": k * LINE + ((c ^ (k & 7)) << 4)}
    if mode == "i8dot":
        p, mi = lane & 7, lane >> 3
        tp = p >> 1
        k0 = 16 * (mi >> 1) + 4 * tp + (p & 1) + 2 * ((mi & 1) ^ (tp >> 1))
        return {"off": k0 * LINE + ((c ^ (k0 & 7)) << 4),
                "sel0": np.where(t < 2, 0x6420, 0x2064).astype(np.uint32),
                "sel1": np.where(t < 2, 0x7531, 0x3175).astype(np.uint32)}
    return {"off_e": 2 * t * LINE + ((c ^ (2 * t)) << 4) + 2 * g,
            "off_o": (2 * t + 1) * LINE + ((c ^ (2 * t + 1)) << 4) + 2 * g}


def _unpack8(h0, h1):
    """``qmma::nibble_quads<0>``: the 16-bit loads of columns (c, c + 1) at
    packed rows r and r + 1 -> the A registers of the two columns."""
    w = _byte_perm(h0, h1, 0x5410)
    lo = ((w & 0x0F0F0F0F) ^ 0x88888888) - np.uint32(0x08080808)
    hi = (((w >> 4) & 0x0F0F0F0F) ^ 0x88888888) - np.uint32(0x08080808)
    return (_byte_perm(lo, hi, 0x6240) ^ np.uint32(0x80808080),
            _byte_perm(lo, hi, 0x7351) ^ np.uint32(0x80808080))


def _quad_int32(e, o, b):
    """``quad_int32``: byte b of the packed words e (row 2r) and o (row 2r +
    1), each nibble widened through int32: ((p & 0xF) ^ 8) - 8 and the
    arithmetic p >> 4 of the signed byte, packed back to four bytes."""
    pe = ((e >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8).astype(
        np.int32)
    po = ((o >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8).astype(
        np.int32)
    vals = [((pe & 0xF) ^ 8) - 8, pe >> 4, ((po & 0xF) ^ 8) - 8, po >> 4]
    out = np.zeros(e.shape, dtype=np.uint32)
    for i, v in enumerate(vals):
        out |= (v.astype(np.uint32) & 0xFF) << (8 * i)
    return out


def _load_a(mode, smem, j, fo):
    """``Frag<mode>::load``: the four A registers of wgmma step j of a
    weight stage, [warpgroup, warp, lane] each."""
    if mode == "convdot":
        r0, r1 = _ldsm_trans(smem, j * 16 * LINE + fo["off"], 2)
        r0, r1 = r0 ^ np.uint32(0x80808080), r1 ^ np.uint32(0x80808080)
        return (_bytes_bf16x2(r0, 0, 2), _bytes_bf16x2(r0, 1, 3),
                _bytes_bf16x2(r1, 0, 2), _bytes_bf16x2(r1, 1, 3))
    if mode == "i8dot":
        r0, r1, r2, r3 = _ldsm_trans(smem, j * 32 * LINE + fo["off"], 4)
        return (_byte_perm(r0, r1, fo["sel0"]), _byte_perm(r0, r1, fo["sel1"]),
                _byte_perm(r2, r3, fo["sel0"]), _byte_perm(r2, r3, fo["sel1"]))
    p = j * 16 * LINE
    h = [_u16(smem, base + fo[off]) for base in (p, p + 1024)
         for off in ("off_e", "off_o")]
    if mode == "unpack8":
        a0, a1 = _unpack8(h[0], h[1])
        a2, a3 = _unpack8(h[2], h[3])
        return a0, a1, a2, a3
    return (_quad_int32(h[0], h[1], 0), _quad_int32(h[0], h[1], 1),
            _quad_int32(h[2], h[3], 0), _quad_int32(h[2], h[3], 1))


def _a_rows(mode, regs):
    """The register A fragments of a step as the two warpgroups' [64 rows,
    k] operands (f32 values for convdot's bf16, int64 otherwise), and a
    count of each (row, k) written. bf16 m16k16: register r holds row g +
    8 (r % 2), k 8 (r // 2) + 2t + half; s8 m16k32: row g + 8 (r % 2), k
    16 (r // 2) + 4t + byte."""
    wg, warp, lane = _lane_grid()
    g, t = lane >> 2, lane & 3
    kw = 16 if mode == "convdot" else 32
    a = np.zeros((2, 64, kw), dtype=np.float64)
    hits = np.zeros((2, 64, kw), dtype=np.int64)
    for r, reg in enumerate(regs):
        row = 16 * warp + g + 8 * (r % 2)
        if mode == "convdot":
            for half in range(2):
                bits = ((reg >> (16 * half)) & 0xFFFF) << 16
                vals = bits.astype(np.uint32).view(np.float32)
                k = 8 * (r // 2) + 2 * t + half
                a[wg, row, k] = vals
                np.add.at(hits, (wg, row, k), 1)
        else:
            vals = _signed_bytes(reg)
            for b in range(4):
                k = 16 * (r // 2) + 4 * t + b
                a[wg, row, k] = vals[..., b]
                np.add.at(hits, (wg, row, k), 1)
    return a, hits


def _weight_stage(mode, rng):
    """A weight stage as the kernel's TMA brings it: int8 [KS, 128] (k
    rows), or packed [KS / 2, 128] bytes, and its unpacked [KS, 128]
    values."""
    if mode in ("convdot", "i8dot"):
        w = rng.integers(-128, 128, (KS[mode], TC)).astype(np.int8)
        return w, w.astype(np.int64)
    w4 = rng.integers(-128, 128, (KS[mode] // 2, TC)).astype(np.int8)
    return w4, tqm.unpack_int4(torch.from_numpy(w4)).numpy().astype(np.int64)


def test_fragment_rows_map_onto_the_tile_columns_once():
    # fragment row 16 w + g + 8h of warpgroup wg is column 64 wg + 16 w +
    # 2g + h: over both warpgroups a bijection onto the 128 columns
    cols = _col_of_row()
    assert sorted(cols.ravel().tolist()) == list(range(TC))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(2))
def test_a_fragments_reassemble_the_stage(mode, seed):
    # one weight stage through TMA's swizzle and the lanes' loads and
    # conversions: every (column, k) exactly once, in wgmma's A layout
    # (bf16 m16k16 for convdot, s8 m16k32 otherwise), with the stage's
    # values: bf16 of the int8 bytes, the int8 bytes, the nibbles
    rng = np.random.default_rng(seed)
    raw, vals = _weight_stage(mode, rng)
    smem = _swizzled(raw.view(np.uint8))
    fo = _frag_offsets(mode)
    cols = _col_of_row()
    kw = 16 if mode == "convdot" else 32
    for j in range(STEPS):
        a, hits = _a_rows(mode, _load_a(mode, smem, j, fo))
        assert (hits == 1).all()
        for wg in range(2):
            np.testing.assert_array_equal(
                a[wg], vals[kw * j:kw * (j + 1), cols[wg]].T)


def test_bytes_bf16x2_converts_every_byte_exactly():
    # every byte value in every position: the bf16 halves hold the signed
    # byte exactly
    byte = np.arange(256, dtype=np.uint32)
    for pos in range(4):
        u = (byte << (8 * pos)) ^ np.uint32(0x80808080)
        got = _bytes_bf16x2(u, pos, pos)
        lo = ((got & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
        hi = (got & 0xFFFF0000).astype(np.uint32).view(np.float32)
        want = byte.astype(np.uint8).view(np.int8).astype(np.float32)
        np.testing.assert_array_equal(lo, want)
        np.testing.assert_array_equal(hi, want)


@pytest.mark.parametrize("pos", range(4))
def test_both_unpackings_give_the_nibbles_exactly(pos):
    # every byte value at byte `pos` of the two 16-bit loads, the other
    # bytes random: unpack8's int8-domain words and unpack32's int32 path
    # are equal, and are the reference's nibbles
    rng = np.random.default_rng(pos)
    raw = rng.integers(0, 256, (4, 256)).astype(np.uint32)
    raw[pos] = np.arange(256, dtype=np.uint32)
    h0 = raw[0] | (raw[1] << 8)
    h1 = raw[2] | (raw[3] << 8)
    c8 = _unpack8(h0, h1)
    c32 = (_quad_int32(h0, h1, 0), _quad_int32(h0, h1, 1))
    np.testing.assert_array_equal(c8[0], c32[0])
    np.testing.assert_array_equal(c8[1], c32[1])
    packed = torch.from_numpy(raw.T.astype(np.uint8).view(np.int8).copy())
    nib = tqm.unpack_int4(packed.reshape(256, 4, 1)).numpy()[..., 0]
    lo, hi = nib[:, 0::2], nib[:, 1::2]
    np.testing.assert_array_equal(
        _signed_bytes(c32[0]),
        np.stack([lo[:, 0], hi[:, 0], lo[:, 2], hi[:, 2]], axis=1))
    np.testing.assert_array_equal(
        _signed_bytes(c32[1]),
        np.stack([lo[:, 1], hi[:, 1], lo[:, 3], hi[:, 3]], axis=1))


# ---------------------------------------------------------------------------
# bank maps
# ---------------------------------------------------------------------------


def _conflict_free(addr, width):
    """One shared-memory request of a warp: ``addr`` [32] byte addresses,
    ``width`` bytes each; conflict-free if no bank is asked for two
    different 4-byte words."""
    words = {}
    for a in np.asarray(addr).ravel():
        for w in range(a // 4, (a + width - 1) // 4 + 1):
            words.setdefault(w % 32, set()).add(w)
    return all(len(v) == 1 for v in words.values())


@pytest.mark.parametrize("mode", ["convdot", "i8dot"])
def test_ldmatrix_rows_are_conflict_free(mode):
    # each phase of ldmatrix reads one matrix: eight 16-byte rows, which
    # must fall in eight distinct chunks (all 32 banks once)
    fo = _frag_offsets(mode)
    mats, step = (2, 16) if mode == "convdot" else (4, 32)
    for wg in range(2):
        for warp in range(4):
            for j in range(STEPS):
                addr = j * step * LINE + fo["off"][wg, warp]
                assert (addr % 16 == 0).all()
                for i in range(mats):
                    rows = addr[8 * i:8 * i + 8]
                    banks = {(a // 4 + b) % 32 for a in rows
                             for b in range(4)}
                    assert len(banks) == 32


@pytest.mark.parametrize("mode", ["unpack8", "unpack32"])
def test_packed_loads_are_conflict_free(mode):
    # each of the four 16-bit loads of a step: the warp's 32 lanes ask
    # each bank for one word at most (lanes 2g, 2g + 1 share one)
    fo = _frag_offsets(mode)
    for wg in range(2):
        for warp in range(4):
            for j in range(STEPS):
                p = j * 16 * LINE
                for off in (fo["off_e"], fo["off_o"]):
                    for base in (p, p + 1024):
                        assert _conflict_free(base + off[wg, warp], 2)


@pytest.mark.parametrize("mode", ["convdot", "i8dot"])
def test_x_b_rows_spread_over_the_banks(mode):
    # wgmma's B at step j: each token reads bytes 32j .. 32j + 31 of its
    # 128-byte line (16 bf16 or 32 int8 k), two chunks. Under the swizzle
    # each 8-token atom's sixteen chunk reads cover the eight chunk
    # positions twice each: two full 128-byte wavefronts
    for j in range(STEPS):
        for atom in range(TT // 8):
            pos = np.zeros(8, dtype=np.int64)
            for r in range(8 * atom, 8 * atom + 8):
                for c in (2 * j, 2 * j + 1):
                    pos[c ^ (r & 7)] += 1
            assert (pos == 2).all()


# ---------------------------------------------------------------------------
# x: two multicast halves make the stage wgmma reads
# ---------------------------------------------------------------------------


def _x_stage(x_bytes, b):
    """The x stage of a cluster: rank r's TMA box (tokens 64r .. 64r + 63,
    one 128-byte line each, zeros past B) written at byte 8192 r of the
    stage in both CTAs, each box swizzled from its own start."""
    stage = np.zeros(TT * LINE, dtype=np.uint8)
    rows = TT // CL
    arrivals = np.zeros(TT, dtype=np.int64)
    for rank in range(CL):
        box = np.zeros((rows, LINE), dtype=np.uint8)
        lo, hi = rank * rows, min((rank + 1) * rows, b)
        if hi > lo:
            box[:hi - lo] = x_bytes[lo:hi]
        part = _swizzled(box)
        off = rank * (TT * LINE // CL)
        assert off % 1024 == 0               # swizzle atoms stay aligned
        stage[off:off + part.size] = part
        arrivals[rank * rows:(rank + 1) * rows] += 1
    assert (arrivals == 1).all()             # each token line once
    return stage


def _b_values(mode, stage, j):
    """wgmma's B at step j from the x stage (descriptor start 32 j bytes
    into each line, SBO 1024): [128 tokens, k] values."""
    r = np.arange(TT)[:, None]
    byte = 32 * j + np.arange(32)[None, :]
    got = stage[r * LINE + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15)]
    if mode == "convdot":
        bits = got.reshape(TT, 16, 2).astype(np.uint32)
        bits = (bits[..., 0] | (bits[..., 1] << 8)) << 16
        return bits.astype(np.uint32).view(np.float32).astype(np.float64)
    return got.view(np.int8).astype(np.int64)


@pytest.mark.parametrize("b", [128, 100, 64, 1])
@pytest.mark.parametrize("mode", ["convdot", "i8dot"])
def test_multicast_halves_make_the_x_stage(mode, b):
    rng = np.random.default_rng(b)
    if mode == "convdot":
        xv = torch.from_numpy(rng.standard_normal((b, 64)).astype(
            np.float32)).to(torch.bfloat16)
        x_bytes = xv.view(torch.int16).numpy().view(np.uint8).reshape(b, LINE)
        want = np.zeros((TT, 64))
        want[:b] = xv.float().numpy()
    else:
        xi = rng.integers(-127, 128, (b, 128)).astype(np.int8)
        x_bytes = xi.view(np.uint8)
        want = np.zeros((TT, 128), dtype=np.int64)
        want[:b] = xi
    stage = _x_stage(x_bytes, b)
    # the halves laid side by side are the whole tile swizzled in one piece
    full = np.zeros((TT, LINE), dtype=np.uint8)
    full[:b] = x_bytes
    np.testing.assert_array_equal(stage, _swizzled(full))
    kw = 16 if mode == "convdot" else 32
    for j in range(STEPS):
        np.testing.assert_array_equal(_b_values(mode, stage, j),
                                      want[:, kw * j:kw * (j + 1)])


def test_the_cluster_barrier_counts_balance():
    # full: one arrive (the CTA's producer, with the stage's bytes) and
    # both ranks' x parts plus its own weight as transactions; empty: one
    # arrive from each consumer warp of each CTA of the cluster, the count
    # it is initialised with
    for mode in MODES:
        w_bytes = WROWS[mode] * TC
        tx = {rank: 0 for rank in range(CL)}
        for sender in range(CL):
            for rank in range(CL):                  # multicast to all
                tx[rank] += TT * LINE // CL
            tx[sender] += w_bytes                   # its own weight
        assert all(v == w_bytes + TT * LINE for v in tx.values())
    arrivals = {rank: 0 for rank in range(CL)}
    for _cta in range(CL):
        for _warp in range(NCONS_WARPS):
            for rank in range(CL):
                arrivals[rank] += 1
    assert all(v == CL * NCONS_WARPS for v in arrivals.values())


@pytest.mark.parametrize("mode", MODES)
def test_shared_memory_fits_one_cta_an_sm(mode):
    x = STAGES[mode] * TT * LINE
    w = STAGES[mode] * WROWS[mode] * TC
    total = 256 * 64 * 4 if mode.startswith("unpack") else 16
    smem = x + w + total + 2 * 8 * STAGES[mode] + 1024
    assert smem <= 232448                    # a block's share of an SM
    assert 2 * smem > 233472                 # so one CTA an SM


# ---------------------------------------------------------------------------
# the schedule: stages, segments, folds
# ---------------------------------------------------------------------------


def _segments(mode, d, bd, gdp, groups):
    """``launch``'s geometry: stages a segment, segments a tile."""
    if mode == "convdot":
        return bd // KS[mode], 1
    if mode == "i8dot":
        return d // KS[mode], 1
    return 2 * gdp // KS[mode], groups


def _schedule(mode, d, bd=tps.BD, gdp=tps.GDP, groups=tps.GROUPS):
    """The consumers' walk (probe_wgmma's loop) as events: ("mma", stage,
    step, scale_d) and, after each segment's last product has retired,
    ("fold", segment, group, tile end, first tile, last tile)."""
    stages = d // KS[mode]
    seg, per_tile = _segments(mode, d, bd, gdp, groups)
    segs = stages // seg
    events, k = [], 0
    for si in range(segs):
        for sg in range(seg):
            for j in range(STEPS):
                events.append(("mma", k, j, int(j > 0 or sg > 0)))
            k += 1
        g = si % per_tile
        events.append(("fold", si, g, g == per_tile - 1,
                       si + 1 == per_tile, si + 1 == segs))
    assert k == stages
    return events


@pytest.mark.parametrize("mode,d,kw", [
    ("convdot", 4096, {}), ("convdot", 6144, {}), ("convdot", 512,
                                                   {"bd": 128}),
    ("i8dot", 4096, {}), ("i8dot", 128, {}),
    ("unpack8", 4096, {}), ("unpack32", 6144, {}),
    ("unpack8", 512, {"gdp": 64, "groups": 2}),
])
def test_schedule_visits_every_stage_once_in_order(mode, d, kw):
    events = _schedule(mode, d, **kw)
    mmas = [e for e in events if e[0] == "mma"]
    assert [(e[1], e[2]) for e in mmas] == [
        (k, j) for k in range(d // KS[mode]) for j in range(STEPS)]
    bd = kw.get("bd", tps.BD)
    gdp, groups = kw.get("gdp", tps.GDP), kw.get("groups", tps.GROUPS)
    folds = [e for e in events if e[0] == "fold"]
    # each chain starts from zero (scale-d 0) exactly where the function's
    # own sum starts: a bd tile (convdot), all of D (i8dot), a group of
    # 2 * gdp rows (unpack)
    starts = [e[1] * KS[mode] for e in mmas if e[3] == 0]
    chain = {"convdot": bd, "i8dot": d}.get(mode, 2 * gdp)
    assert starts == list(range(0, d, chain))
    assert len(folds) == d // chain
    if mode.startswith("unpack"):
        # groups counted within their tile, tiles closed in order
        assert [e[2] for e in folds] == [i % groups for i in
                                        range(len(folds))]
        ends = [i for i, e in enumerate(folds) if e[3]]
        assert ends == [t * groups + groups - 1
                        for t in range(d // (2 * gdp * groups))]
        assert folds[groups - 1][4] and folds[-1][5]


def test_every_column_tile_is_one_cta_of_one_cluster():
    # F / 128 CTAs in clusters of two adjacent column tiles: each (column
    # tile, stage) is walked by exactly one CTA, and the two CTAs of a
    # cluster walk the same stages in the same order (their x parts meet)
    f, d = tdrv.F, tdrv.D
    ctas = f // TC
    assert ctas % CL == 0 and ctas == 112
    seen = np.zeros((ctas, d // KS["i8dot"]), dtype=np.int64)
    for block in range(ctas):
        cluster, rank = divmod(block, CL)
        assert block * TC == (cluster * CL + rank) * TC
        for e in _schedule("i8dot", d):
            if e[0] == "mma" and e[2] == 0:
                seen[block, e[1]] += 1
    assert (seen == 1).all()


# ---------------------------------------------------------------------------
# the whole body
# ---------------------------------------------------------------------------


def _x_in(mode, x):
    """The body's x: bf16 x itself (convdot), else the pre-pass's int8 x:
    truncated (i8dot), clip(rint(x * 16), +-127) (unpack)."""
    if mode == "convdot":
        return x.view(torch.int16).numpy().view(np.uint8).reshape(
            x.shape[0], -1)
    xi = x.to(torch.int8) if mode == "i8dot" else tps.quantize_x16(x)
    return xi.numpy().view(np.uint8)


def _mirror(mode, x, w, bd=tps.BD, gdp=tps.GDP, groups=tps.GROUPS):
    """The body on the CPU, CTA by CTA in its own order: per stage the x
    stage from the cluster's two multicast halves and the swizzled weight
    stage, per step the A registers from the lanes' loads, their products
    with the x rows (exact: int64, or f64 for convdot's bf16 x int8), the
    chains started with scale-d 0 as the schedule says, the folds (convdot:
    the tile's f32 sum added to the tiles' sum; unpack: cvt, x scale, +
    part in group order, parts in tile order; i8dot: cvt, x 1e-4f at the
    end) and the epilogue's store map, one rounding to bf16."""
    b, d = x.shape
    f = w.shape[1]
    xb = _x_in(mode, x)
    wn = w.numpy()
    fo = _frag_offsets(mode)
    cols = _col_of_row()
    lines = d * (2 if mode == "convdot" else 1) // LINE
    out = np.full((b, f), np.nan, dtype=np.float32)
    events = _schedule(mode, d, bd, gdp, groups)
    _, per_tile = _segments(mode, d, bd, gdp, groups)
    wr = WROWS[mode]
    for n0 in range(0, f, TC):
        acc = np.zeros((2, 64, TT))
        total = np.zeros((2, 64, TT), dtype=np.float32)   # convdot, unpack
        part = np.zeros((2, 64, TT), dtype=np.float32)
        stage = wstage = None
        for e in events:
            if e[0] == "mma":
                _, k, j, scale_d = e
                if j == 0:
                    assert k < lines
                    stage = _x_stage(xb[:, k * LINE:(k + 1) * LINE], b)
                    wstage = _swizzled(
                        wn[k * wr:(k + 1) * wr, n0:n0 + TC].view(np.uint8))
                a, _ = _a_rows(mode, _load_a(mode, wstage, j, fo))
                bv = _b_values(mode, stage, j)
                if not scale_d:
                    acc[:] = 0
                acc += a @ bv.T
                continue
            _, si, g, tile_end, first_tile, last_tile = e
            if mode == "convdot":
                total = (total + acc.astype(np.float32)).astype(np.float32)
            elif mode.startswith("unpack"):
                assert np.abs(acc).max() < 2 ** 31
                sc = np.float32(1e-4 * (g + 1))
                part = (part + acc.astype(np.int32).astype(np.float32)
                        * sc).astype(np.float32)
                if tile_end:
                    total = ((np.float32(0) if first_tile else total)
                             + part).astype(np.float32)
                    part[:] = 0
        if mode == "i8dot":
            assert np.abs(acc).max() < 2 ** 31
            final = (acc.astype(np.int32).astype(np.float32)
                     * np.float32(1e-4)).astype(np.float32)
        else:
            final = total
        # epilogue: lane (g, t) of warp w holds fragment rows 16w + g + 8h
        # (columns cb + h) for tokens 8j + 2t + e; tokens past B are not
        # stored
        for wg in range(2):
            for r in range(64):
                n = n0 + cols[wg, r]
                assert np.isnan(out[:, n]).all()
                out[:, n] = final[wg, r, :b]
    assert not np.isnan(out).any()
    return torch.from_numpy(out).to(torch.bfloat16)


def _operands(mode, seed, b, d, f, scale=1.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((b, d)) * scale).astype(
        np.float32)).to(torch.bfloat16)
    rows = d if mode in ("convdot", "i8dot") else d // 2
    lo = -127 if mode in ("convdot", "i8dot") else -128
    w = torch.from_numpy(rng.integers(lo, 128, (rows, f)).astype(np.int8))
    return x, w


def _plain(mode, x, w, bd, gdp, groups):
    if mode == "convdot":
        return tps.convdot_ref(x, w, bd)
    if mode == "i8dot":
        return tps.i8dot_ref(x, w)
    return tps.unpack_ref(x, w, gdp, groups)


#: (b, d, f, bd, gdp, groups): ragged tokens and two column tiles; one
#: token; three contraction tiles of small groups
MIRROR_CASES = [(100, 512, 256, 256, 64, 2), (1, 256, 256, 128, 64, 1),
                (40, 768, 256, 256, 64, 2)]


@pytest.mark.parametrize("case", MIRROR_CASES,
                         ids=lambda c: "x".join(map(str, c[:3])))
@pytest.mark.parametrize("mode", MODES)
def test_mirror_matches_the_plain_version(mode, case):
    b, d, f, bd, gdp, groups = case
    assert tps.probe_body(mode, b, d, f, bd, gdp, groups) == "wgmma"
    x, w = _operands(mode, b + d + f, b, d, f, scale=3.0)
    got = _mirror(mode, x, w, bd, gdp, groups)
    want = _plain(mode, x, w, bd, gdp, groups)
    assert got.dtype == want.dtype == torch.bfloat16
    top = want.float().abs().max().item()
    assert top > 0
    if mode == "convdot":
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_STEP_RTOL * top
    else:
        assert torch.equal(got, want)
    # and the wrapper on the CPU is that plain version
    if mode.startswith("unpack"):
        cpu = tps.probe_unpack(x, w, widen=mode == "unpack32", gdp=gdp,
                               groups=groups)
    else:
        cpu = getattr(tps, f"probe_{mode}")(x, w, bd)
    assert torch.equal(cpu, want)


def _load_reference():
    spec = importlib.util.spec_from_file_location(
        "reference_probe_stream", ROOT / "scripts" / "probe_stream.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas(kern, b, f, bf, acc_dtype, grid_k, xspecs, wblock, *args):
    """The reference script's pallas_call layout, in interpret mode."""
    in_specs = [pl.BlockSpec((b, xw), lambda j, k: (0, k)) for xw in xspecs]
    in_specs.append(pl.BlockSpec((wblock, bf), lambda j, k: (k, j)))
    return pl.pallas_call(
        kern, grid=(f // bf, grid_k), in_specs=in_specs,
        out_specs=pl.BlockSpec((b, bf), lambda j, k: (0, j)),
        out_shape=jax.ShapeDtypeStruct((b, f), jnp.bfloat16),
        scratch_shapes=[pltpu.VMEM((b, bf), acc_dtype)],
        interpret=True)(*args)


@pytest.mark.parametrize("mode", MODES)
def test_mirror_matches_the_pallas_body(mode):
    ref = _load_reference()
    b, d, f, bd, gdp, groups = 16, 512, 256, 256, 64, 2
    x, w = _operands(mode, 7, b, d, f, scale=3.0)
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    if mode in ("convdot", "i8dot"):
        kern = ref.k_convdot if mode == "convdot" else ref.k_i8dot
        acc = jnp.float32 if mode == "convdot" else jnp.int32
        xin = xj if mode == "convdot" else xj.astype(jnp.int8)
        want = _pallas(kern, b, f, 128, acc, d // bd, [bd], bd, xin,
                       jnp.asarray(w.numpy()))
    else:
        bdp = gdp * groups
        xq = jnp.clip(jnp.round(xj.astype(jnp.float32) * 16), -127,
                      127).astype(jnp.int8)
        kern = functools.partial(ref.k_unpack, widen=mode == "unpack32",
                                 groups=groups, gdp=gdp)
        want = _pallas(kern, b, f, 128, jnp.float32, (d // 2) // bdp,
                       [bdp, bdp], bdp, xq[:, 0::2], xq[:, 1::2],
                       jnp.asarray(w.numpy()))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = _mirror(mode, x, w, bd, gdp, groups).float().numpy()
    top = float(np.abs(want).max())
    assert top > 0
    err = float(np.abs(got - want).max())
    if mode == "i8dot":
        assert err == 0
    else:
        assert err <= BF16_STEP_RTOL * top
