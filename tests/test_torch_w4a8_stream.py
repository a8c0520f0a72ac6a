# K6's stream body (``csrc/w4a8_stream.cuh``, M <= 32: the a8 decode
# projections and lm_head) on the CPU: the rule that routes to it, the
# wrapper's grid plan, its plain version ``w4a8_matmul_stream_ref``
# against ``w4a8_matmul_ref`` and against the Pallas ``w4a8_matmul`` in
# interpret mode, and numpy mirrors of the device's integer unpacking, the
# placement of the unpacked weight in mma.m16n8k32's A fragment, xq's
# ldmatrix B fragments, the swizzled shared-memory addresses, and the whole
# body's arithmetic. The kernel itself runs only on the card (chip_smoke.py
# holds it to its plain version bit for bit).
#
# Tolerance. The plain version takes each group's exact integer product
# to f32, scales it, sums the groups of a split from zero in group order
# and the splits in split order, then multiplies by sx: with one split
# those are ``w4a8_matmul_ref``'s operations, so the two are compared bit
# for bit, and so is the mirror, which does the body's integer work
# exactly and its f32 work with the same operations in the same order.
# With the Pallas kernel's groups_per_block as the split it takes the
# Pallas kernel's order, but XLA on the CPU contracts the kernel's scale
# and add into one fused multiply-add (one rounding fewer a group): 1e-6
# of the largest output.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.ops import quant_matmul as jqm
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm

#: the int4 main path's leaves (D, F) of mistral-7b: fused q/k/v, wo,
#: fused gate/up, w_down, lm_head
MISTRAL_INT4 = {"wqkv": (4096, 6144), "wo": (4096, 4096),
                "w_gu": (4096, 28672), "w_down": (14336, 4096),
                "lm_head": (4096, 32000)}
#: the body's geometry (w4a8_stream.cuh): columns a CTA, k a stage, packed
#: rows a stage, 128-byte lines, consumer warps of 32 columns
TN, KS, KP = 128, 128, 64
LINE = 128
WARPS = 4
#: against the Pallas kernel in interpret mode, relative to the largest
#: output (see the tolerance note above)
PALLAS_RTOL = 1e-6


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 17, 32])
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT4))
def test_mistral_a8_decode_takes_the_stream_body(leaf, m, dtype):
    d, f = MISTRAL_INT4[leaf]
    assert tqm.w4a8_body(m, d, f, tquant.INT4_GROUP, dtype) == "stream"


@pytest.mark.parametrize("m", [1, 17, 32])
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT4))
def test_stream_plan_covers_columns_and_groups_once(m, leaf):
    d, f = MISTRAL_INT4[leaf]
    groups = d // tquant.INT4_GROUP
    tn, splits, per = tqm.stream_plan(m, d, f, groups)
    assert tn == TN
    tiles = -(-f // tn)
    cover = np.zeros((f, groups), dtype=np.int64)
    for tile in range(tiles):
        for split in range(splits):
            gs = range(split * per, min(groups, (split + 1) * per))
            assert len(gs) > 0                       # no empty split
            cover[tile * tn:(tile + 1) * tn, gs.start:gs.stop] += 1
    assert (cover == 1).all()
    # the f32 workspace stays within a quarter of the packed weight
    workspace = splits * m * f * 4 if splits > 1 else 0
    assert 4 * workspace <= d // 2 * f


def _operands(m, d, f, group, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(
        (rng.standard_normal((m, d)) * 2.0).astype(np.float32)).to(dtype)
    q4 = torch.from_numpy(rng.integers(-128, 128, (d // 2, f))
                          .astype(np.int8))
    scale = torch.from_numpy(
        (rng.random((d // group, f)) * 0.01 + 1e-4).astype(np.float32))
    return x, q4, scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("m", [1, 17, 32])
def test_one_split_is_the_plain_version(m, group, dtype):
    x, q4, scale = _operands(m, 6 * group, 48, group, m + group, dtype)
    want = tqm.w4a8_matmul_ref(x, q4, scale)
    got = tqm.w4a8_matmul_stream_ref(x, q4, scale, 6)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
    # and the wrapper on the CPU is that plain version, no launch counted
    launches = tqm.w4a8_matmul.launches
    assert torch.equal(tqm.w4a8_matmul(x, q4, scale), want)
    assert tqm.w4a8_matmul.launches == launches


def _groups_per_block(groups, group, block_d):
    """The Pallas wrapper's groups_per_block (quant_matmul.py of the JAX
    package): as many whole groups as block_d holds, lowered until they
    divide the group count."""
    gpb = max(1, min(groups, block_d // group))
    while groups % gpb:
        gpb -= 1
    return gpb


@pytest.mark.parametrize("block_d", [256, 512, 768, 4096])
@pytest.mark.parametrize("m", [1, 5, 32])
def test_stream_order_matches_pallas_at_its_groups_per_block(m, block_d):
    group, groups, f = 256, 6, 48
    d = group * groups
    rng = np.random.default_rng(m * 7 + block_d)
    w = (rng.standard_normal((d, f)) * 0.05).astype(np.float32)
    x = rng.standard_normal((m, d)).astype(np.float32)
    leaf = jquant.quantize_tensor_int4(jnp.asarray(w), group=group)
    q4, scale = np.array(leaf["q4"]), np.array(leaf["scale"])
    want = np.asarray(jqm.w4a8_matmul(jnp.asarray(x), jnp.asarray(q4),
                                      jnp.asarray(scale), block_f=16,
                                      block_d=block_d, interpret=True))
    per = _groups_per_block(groups, group, block_d)
    got = tqm.w4a8_matmul_stream_ref(torch.from_numpy(x),
                                     torch.from_numpy(q4),
                                     torch.from_numpy(scale), per)
    assert got.shape == (m, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PALLAS_RTOL * np.abs(want).max())


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 numpy arrays (selector values 0-7)."""
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 0x7] << (8 * i)
    return out


def _nibble_quads(w0, w1, p):
    """``qmma::nibble_quads<p>`` (quant_mma.cuh): words of packed rows r
    (w0) and r + 1 (w1), four columns each -> the A registers of columns
    2p and 2p + 1."""
    w = _byte_perm(w0, w1, 0x5410 if p == 0 else 0x7632)
    lo = ((w & 0x0F0F0F0F) ^ 0x88888888) - np.uint32(0x08080808)
    hi = (((w >> 4) & 0x0F0F0F0F) ^ 0x88888888) - np.uint32(0x08080808)
    return (_byte_perm(lo, hi, 0x6240) ^ 0x80808080,
            _byte_perm(lo, hi, 0x7351) ^ 0x80808080)


def _signed_bytes(reg):
    """uint32 registers -> their four bytes as int8 values, byte 0 first."""
    return np.stack([((reg >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8)
                     for b in range(4)], axis=-1)


@pytest.mark.parametrize("p", [0, 1])
@pytest.mark.parametrize("pos", range(8))
def test_nibble_quads_give_a_columns_nibbles_in_k_order(pos, p):
    # every byte value at byte `pos` of the two words (w0 bytes 0-3, w1
    # bytes 4-7), the other bytes random
    rng = np.random.default_rng(8 * p + pos)
    raw = rng.integers(0, 256, (8, 256)).astype(np.uint32)
    raw[pos] = np.arange(256, dtype=np.uint32)
    w0 = raw[0] | (raw[1] << 8) | (raw[2] << 16) | (raw[3] << 24)
    w1 = raw[4] | (raw[5] << 8) | (raw[6] << 16) | (raw[7] << 24)
    c0, c1 = _nibble_quads(w0, w1, p)
    assert c0.dtype == c1.dtype == np.uint32
    # packed rows r (bytes of w0) and r + 1 (of w1) at four columns
    packed = torch.from_numpy(
        raw.T.reshape(256, 2, 4).astype(np.uint8).view(np.int8).copy())
    nib = tqm.unpack_int4(packed).numpy()           # [256, 4 k, 4 columns]
    for reg, col in ((c0, 2 * p), (c1, 2 * p + 1)):
        np.testing.assert_array_equal(_signed_bytes(reg), nib[:, :, col])


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
    """Per consumer [warp, lane]: g, t, the 16-byte chunk c of its words,
    its first column and its swizzled offsets at packed rows 2t and
    2t + 1 of a k32 slice."""
    warp, lane = np.meshgrid(np.arange(WARPS), np.arange(32), indexing="ij")
    g, t = lane >> 2, lane & 3
    c = 2 * warp + (g >> 2)
    col = 16 * c + 4 * (g & 3)
    aoff0 = 2 * t * LINE + ((c ^ (2 * t)) << 4) + 4 * (g & 3)
    aoff1 = (2 * t + 1) * LINE + ((c ^ (2 * t + 1)) << 4) + 4 * (g & 3)
    return warp, g, t, col, aoff0, aoff1


def _u32(smem, off):
    return sum(smem[off + b].astype(np.uint32) << (8 * b) for b in range(4))


def _a_regs(smem, sub, aoff0, aoff1):
    """The body's A registers of k32 step ``sub`` of a stage: a[T][r]."""
    base = sub * 2048
    u0, u1 = _u32(smem, base + aoff0), _u32(smem, base + aoff1)
    u2, u3 = _u32(smem, base + 1024 + aoff0), _u32(smem, base + 1024 + aoff1)
    a = [[None] * 4 for _ in range(2)]
    a[0][0], a[0][1] = _nibble_quads(u0, u1, 0)
    a[1][0], a[1][1] = _nibble_quads(u0, u1, 1)
    a[0][2], a[0][3] = _nibble_quads(u2, u3, 0)
    a[1][2], a[1][3] = _nibble_quads(u2, u3, 1)
    return a


def _a_matrices(a, g, t):
    """mma.m16n8k32's A layout: register r of lane (g, t) holds row
    g + 8 (r % 2) at k 16 (r // 2) + 4t + byte. -> [warp, tile, 16 rows,
    32 k] and the count of writes to each element."""
    mats = np.zeros((WARPS, 2, 16, 32), dtype=np.int64)
    hits = np.zeros_like(mats)
    wi = np.broadcast_to(np.arange(WARPS)[:, None], g.shape)
    for tile in range(2):
        for r in range(4):
            vals = _signed_bytes(a[tile][r])
            for b in range(4):
                row, k = g + 8 * (r % 2), 16 * (r // 2) + 4 * t + b
                mats[wi, tile, row, k] = vals[..., b]
                np.add.at(hits, (wi, tile, row, k), 1)
    return mats, hits


def _column_of_row():
    """[warp, tile, fragment row] -> the tile column it computes: row g + 8h
    of tile T is column 32w + 16 (g // 4) + 4 (g % 4) + 2T + h."""
    w, tile, row = np.meshgrid(np.arange(WARPS), np.arange(2),
                               np.arange(16), indexing="ij")
    g, h = row % 8, row // 8
    return 32 * w + 16 * (g >> 2) + 4 * (g & 3) + 2 * tile + h


def test_fragment_rows_map_onto_the_tile_columns_once():
    cols = _column_of_row()
    assert sorted(cols.ravel().tolist()) == list(range(TN))
    # the epilogue's four columns of a lane are its fragment rows (T, h)
    # in order 2T + h, and each warp keeps to its own 32 columns
    warp, g, _, col, _, _ = _lanes()
    for w in range(WARPS):
        for lane in range(32):
            gg = g[w, lane]
            got = [cols[w, tile, gg + 8 * h] for tile in range(2)
                   for h in range(2)]
            assert got == [col[w, lane] + i for i in range(4)]
            assert 32 * w <= col[w, lane] < 32 * (w + 1)


@pytest.mark.parametrize("seed", range(3))
def test_a_fragments_rebuild_the_unpacked_stage(seed):
    # one stage of q4 (64 packed rows x 128 columns) through TMA's swizzle
    # and the lanes' loads and unpacking: in mma.m16n8k32's A layout, every
    # (row, k) exactly once, equal to unpack_int4 of the stage at the row's
    # column
    rng = np.random.default_rng(seed)
    q4 = rng.integers(-128, 128, (KP, TN)).astype(np.int8)
    smem = _swizzled(q4.view(np.uint8))
    _, g, t, _, aoff0, aoff1 = _lanes()
    want = tqm.unpack_int4(torch.from_numpy(q4)).numpy()     # [128 k, 128]
    cols = _column_of_row()
    for sub in range(KS // 32):
        mats, hits = _a_matrices(_a_regs(smem, sub, aoff0, aoff1), g, t)
        assert (hits == 1).all()
        for w in range(WARPS):
            for tile in range(2):
                np.testing.assert_array_equal(
                    mats[w, tile],
                    want[32 * sub:32 * (sub + 1), cols[w, tile]].T)


def test_weight_fragment_loads_are_conflict_free():
    # each 32-bit load of a warp: 32 lanes, 32 distinct banks, at the
    # swizzled home of the lane's four columns
    _, g, t, col, aoff0, aoff1 = _lanes()
    for w in range(WARPS):
        for base, rows in ((0, (0, 1)), (1024, (8, 9))):
            for off, dr in ((aoff0, 0), (aoff1, 1)):
                addr = base + off[w]
                row = 2 * t[w] + rows[dr]
                home = row * LINE + (((col[w] >> 4) ^ (row & 7)) << 4) \
                    + (col[w] & 15)
                np.testing.assert_array_equal(addr, home)
                assert len(set(((addr // 4) % 32).tolist())) == 32


def _xq_addresses(nt, sub):
    """Per lane, the shared address (in a stage's xq slice) ldmatrix reads
    for each x4 (or the last x2) of k32 step ``sub``: the body's xrow and
    chunk arithmetic. -> {first token tile j: [32] addresses}"""
    lane = np.arange(32)
    mi, r8 = lane >> 3, lane & 7
    xrow = (8 * (mi >> 1) + r8) * LINE
    xaddr = xrow + (((2 * sub + (mi & 1)) ^ r8) << 4)
    return {j: xaddr + j * 8 * LINE for j in range(0, nt, 2)}


def _ldmatrix(smem, addr, mats):
    """ldmatrix.m8n8.b16 .x{mats}: matrix q's row r is read at the address
    lane 8q + r gives; lane (g, t) receives 4 bytes of row g of each
    matrix at byte 4t. -> [mats, 32 lanes] uint32."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    return np.stack([_u32(smem, addr[8 * q + g] + 4 * t)
                     for q in range(mats)])


@pytest.mark.parametrize("nt", [1, 2, 3, 4])
def test_xq_ldmatrix_gives_the_b_fragments_without_conflicts(nt):
    rng = np.random.default_rng(nt)
    xq = rng.integers(-127, 128, (8 * nt, KS)).astype(np.int8)
    smem = _swizzled(xq.view(np.uint8))
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for sub in range(KS // 32):
        for j, addr in _xq_addresses(nt, sub).items():
            mats = 4 if j + 1 < nt else 2
            # each 8-row phase reads eight 16-byte rows in distinct chunks
            for q in range(mats):
                rows = addr[8 * q:8 * q + 8]
                banks = {(a // 4 + i) % 32 for a in rows for i in range(4)}
                assert len(banks) == 32
            regs = _ldmatrix(smem, addr, mats)
            for jj in range(mats // 2):
                # m16n8k32's B: b0 of lane (g, t) is token g of the tile
                # at k 4t .. 4t + 3, b1 the same at k + 16
                for r in range(2):
                    k0 = 32 * sub + 16 * r + 4 * t
                    want = np.stack([xq[8 * (j + jj) + g, k0 + b]
                                     for b in range(4)], axis=-1)
                    np.testing.assert_array_equal(
                        _signed_bytes(regs[2 * jj + r]), want)


def _mirror(x, q4, scale, per):
    """The body's arithmetic on the CPU, CTA by CTA: xq and sx from
    ``quantize_rows``; per split (``per`` whole groups), stage and k32 step,
    the A registers unpacked from the swizzled q4 stage and the B
    registers ldmatrix gives from the swizzled xq slice, their exact
    products (mma's s32 accumulators, row = fragment row, column = token);
    at a group's end the cast, scale and sum; the epilogue's lane map into
    the split's partial; the splits summed in order, times sx, stored."""
    m, d = x.shape
    f = q4.shape[1]
    groups = scale.shape[0]
    gsteps = d // groups // KS
    nt = -(-m // 8)
    xq, sx = tqm.quantize_rows(x)
    xqn = np.zeros((8 * nt, d), dtype=np.int8)
    xqn[:m] = xq.numpy()
    sx = sx.numpy()[:, 0]
    q4n, sc = q4.numpy(), scale.numpy()
    warp, g, t, col, aoff0, aoff1 = _lanes()
    cols = _column_of_row()
    splits = -(-groups // per)
    out = np.full((m, f), np.nan, dtype=np.float32)
    for n0 in range(0, f, TN):
        qt = np.zeros((d // 2, TN), dtype=np.int8)
        qt[:, :min(TN, f - n0)] = q4n[:, n0:n0 + TN]
        st = np.zeros((groups, TN), dtype=np.float32)
        st[:, :min(TN, f - n0)] = sc[:, n0:n0 + TN]
        parts = []
        for split in range(splits):
            facc = np.zeros((WARPS, 2, nt, 16, 8), dtype=np.float32)
            for gi in range(split * per, min(groups, (split + 1) * per)):
                acc = np.zeros((WARPS, 2, nt, 16, 8), dtype=np.int64)
                for k in range(gi * gsteps, (gi + 1) * gsteps):
                    wsm = _swizzled(qt[k * KP:(k + 1) * KP].view(np.uint8))
                    xsm = _swizzled(
                        xqn[:, k * KS:(k + 1) * KS].view(np.uint8))
                    for sub in range(KS // 32):
                        a, _ = _a_matrices(
                            _a_regs(wsm, sub, aoff0, aoff1), g, t)
                        b = np.zeros((nt, 32, 8), dtype=np.int64)
                        for j, addr in _xq_addresses(nt, sub).items():
                            mats = 4 if j + 1 < nt else 2
                            regs = _ldmatrix(xsm, addr, mats)
                            for q in range(mats):
                                vals = _signed_bytes(regs[q])   # [32, 4]
                                for bb in range(4):
                                    b[j + q // 2, 16 * (q % 2) + 4 * (
                                        np.arange(32) & 3) + bb,
                                      np.arange(32) >> 2] = vals[:, bb]
                        acc += np.einsum("wtrk,jkn->wtjrn", a, b)
                assert np.abs(acc).max() < 2 ** 31            # int32
                p = acc.astype(np.int32).astype(np.float32)   # cvt.rn
                s_row = st[gi][cols][:, :, None, :, None]
                facc = facc + p * s_row
            # the epilogue's lane map: accumulator e' of lane (g, t) is
            # fragment row g + 8 (e' // 2), token 8j + 2t + e' % 2; the
            # lane's token 8j + 2t + e takes e' = e and 2 + e of each tile
            part = np.full((8 * nt, TN), np.nan, dtype=np.float32)
            for w in range(WARPS):
                for lane in range(32):
                    gg, tt, c0 = g[w, lane], t[w, lane], col[w, lane]
                    for j in range(nt):
                        for e in range(2):
                            vals = [facc[w, tile, j, gg + 8 * h, 2 * tt + e]
                                    for tile in range(2) for h in range(2)]
                            tok = 8 * j + 2 * tt + e
                            assert np.isnan(part[tok, c0:c0 + 4]).all()
                            part[tok, c0:c0 + 4] = vals
            assert not np.isnan(part).any()
            parts.append(part[:m, :min(TN, f - n0)])
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        out[:, n0:n0 + TN] = total * sx[:, None]
    assert not np.isnan(out).any()
    return torch.from_numpy(out).to(x.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f,group,per", [(17, 768, 144, 128, 2),
                                             (5, 512, 256, 256, 2),
                                             (32, 256, 128, 128, 1),
                                             (8, 512, 48, 512, 1)])
def test_mirror_equals_the_stream_plain_version_bit_for_bit(m, d, f, group,
                                                            per, dtype):
    x, q4, scale = _operands(m, d, f, group, m * f + group, dtype)
    got = _mirror(x, q4, scale, per)
    want = tqm.w4a8_matmul_stream_ref(x, q4, scale, per)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)
