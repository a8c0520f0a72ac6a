# K2's stream body (``csrc/int8_stream.cuh``, bf16 x at M <= 8) on the
# CPU: the rule that routes to it, the wrapper's grid plan, its order of
# operations against the Pallas ``int8_matmul`` in interpret mode, and
# numpy mirrors of the device's integer conversion, its fragment-row to
# column map, its swizzled shared-memory addresses and one stage of its
# consumers' pass. The kernel itself runs only on the card (chip_smoke.py
# holds it against its plain version).
#
# Tolerance. The mirror and the Pallas kernel both sum the exact products
# of x and the int8 weight in f32 and scale once; they differ in the order
# of the f32 sums (splits, and the Pallas kernel's blocks): 1e-5 relative
# to the largest output at f32. At bf16 both round that f32 result once,
# so an f32 sum on the other side of a rounding boundary is one bf16 step:
# K2_RTOL, 1e-2 of the largest output. The conversion is exact: equal.
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.ops import quant_matmul as jqm
from copilot_for_consensus_tpu_torch.ops import quant_matmul as tqm

F32_RTOL = 1e-5
K2_RTOL = 1e-2
#: the int8 leaves (D, F) of mistral-7b: q, k, v, o, gate, up, down and
#: the lm_head
MISTRAL_INT8 = {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
                "wo": (4096, 4096), "w_gate": (4096, 14336),
                "w_up": (4096, 14336), "w_down": (14336, 4096),
                "lm_head": (4096, 32000)}
#: the stream body's geometry (int8_stream.cuh): 128-byte lines, four
#: consumer warps of 32 columns, 128-row stages of k16 slices
LINE = 128
WARPS = 4
KS = 128


def _operands(seed, m, d, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, d)).astype(np.float32)
    q = rng.integers(-128, 128, (d, f)).astype(np.int8)
    scale = (rng.random((1, f)) * 2 * d ** -0.5 / 73.3).astype(np.float32)
    return x, q, scale


# ---------------------------------------------------------------------------
# the route and the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT8))
def test_mistral_int8_decode_takes_the_stream_body(m, leaf):
    d, f = MISTRAL_INT8[leaf]
    assert tqm.int8_body(m, d, f, torch.bfloat16) == "stream"
    # f32 x keeps the split GEMV
    assert tqm.int8_body(m, d, f, torch.float32) == "gemv"


@pytest.mark.parametrize("m,d,f", [
    (4, 4096, 1000),        # F % 16 = 8: TMA's row pitch
    (8, 4096, 4104),
    (1, 4160, 4096),        # D % 128 = 64: not whole stages
    (4, 96, 4096),
    (8, 40, 77)])
def test_layouts_the_stream_refuses_keep_the_gemv(m, d, f):
    assert tqm.int8_body(m, d, f, torch.bfloat16) == "gemv"


def _plan_cover(m, d, f):
    """The plan's grid is (column tiles) x (splits): how often it covers
    each column and each contraction row."""
    tn, splits, rows = tqm.int8_stream_plan(m, d, f)
    tiles = -(-f // tn)
    cols = np.zeros(tiles * tn, dtype=np.int64)
    for tile in range(tiles):
        cols[tile * tn:(tile + 1) * tn] += 1
    cover = np.zeros(d, dtype=np.int64)
    for split in range(splits):
        r0, r1 = split * rows, min(d, (split + 1) * rows)
        assert r1 > r0                                # no empty split
        cover[r0:r1] += 1
    return tn, splits, rows, tiles, cols[:f], cover


@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("leaf", sorted(MISTRAL_INT8))
def test_stream_plan_covers_columns_and_rows_once(m, leaf):
    d, f = MISTRAL_INT8[leaf]
    tn, splits, rows, tiles, cols, cover = _plan_cover(m, d, f)
    assert tn == tqm.K2_STREAM_TN
    assert (cols == 1).all() and (cover == 1).all()
    # what the kernel's launch checks take: whole stages, the splits
    # covering D exactly
    assert rows % tqm.K2_STREAM_KSTEP == 0
    assert (splits - 1) * rows < d <= splits * rows
    # the f32 workspace is at most a quarter of the weight's bytes
    workspace = splits * m * f * 4 if splits > 1 else 0
    assert 4 * workspace <= d * f
    # the CTAs stay within the resident slots unless the tiles alone
    # exceed them
    assert tiles * splits <= max(tiles, tqm._K2_STREAM_SLOTS)


@pytest.mark.parametrize("m", [1, 4, 8])
def test_stream_plan_splits_narrow_leaves_only(m):
    # a leaf streams in one pass only where its column tiles alone fill
    # more than half the resident slots (the lm_head); the k/v leaves
    # (F 1024, 8 tiles) split most
    for leaf, (d, f) in MISTRAL_INT8.items():
        _, splits, _ = tqm.int8_stream_plan(m, d, f)
        tiles = -(-f // tqm.K2_STREAM_TN)
        assert (splits == 1) == (2 * tiles > tqm._K2_STREAM_SLOTS), leaf
    _, kv, _ = tqm.int8_stream_plan(m, 4096, 1024)
    _, wide, _ = tqm.int8_stream_plan(m, 4096, 14336)
    assert kv >= 16 > wide


# ---------------------------------------------------------------------------
# the order of operations against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("m", [1, 5, 8])
def test_stream_order_matches_pallas(m, splits, dtype):
    d, f = 3 * KS, 48
    x, q, scale = _operands(m * 100 + splits, m, d, f)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jqm.int8_matmul(
        jnp.asarray(x).astype(jdt), jnp.asarray(q), jnp.asarray(scale),
        block_m=8, block_f=16, block_d=KS, interpret=True
    ).astype(jnp.float32))
    rows = d // splits
    got = tqm.int8_matmul_stream_ref(torch.from_numpy(x).to(tdt),
                                     torch.from_numpy(q),
                                     torch.from_numpy(scale), rows)
    assert got.shape == (m, f) and got.dtype == tdt
    rtol = F32_RTOL if dtype == "float32" else K2_RTOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())
    if splits == 1:
        # one split is the plain version, operation for operation
        assert torch.equal(got, tqm.int8_matmul_ref(
            torch.from_numpy(x).to(tdt), torch.from_numpy(q),
            torch.from_numpy(scale)))


def test_stream_order_is_exact_on_small_integers():
    # small-integer x (|x| <= 8) against int8 weights: every product and
    # every partial sum is an integer below 2^24, so the split order gives
    # the plain version bit for bit (chip_smoke's exact cases rest on this)
    rng = np.random.default_rng(11)
    d, f = 7 * KS, 64
    x = torch.from_numpy(rng.integers(-8, 9, (8, d)).astype(np.float32)) \
        .to(torch.bfloat16)
    q = torch.from_numpy(rng.integers(-128, 128, (d, f)).astype(np.int8))
    scale = torch.from_numpy(rng.random((1, f)).astype(np.float32))
    want = tqm.int8_matmul_ref(x, q, scale)
    for rows in (KS, 2 * KS, 3 * KS, d):
        assert torch.equal(tqm.int8_matmul_stream_ref(x, q, scale, rows),
                           want)


# ---------------------------------------------------------------------------
# numpy mirrors of the device's integer work and addresses
# ---------------------------------------------------------------------------


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 numpy arrays (selector values 0-7)."""
    a, b = np.broadcast_arrays(np.asarray(a, dtype=np.uint32),
                               np.asarray(b, dtype=np.uint32))
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    out = np.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 0x7] << (8 * i)
    return out


def _pair_byte(u0, u1, j):
    """``k2s::pair_byte<j>``: byte j of u0 and u1 (already ^ 0x80) into
    the low byte of 2^23, minus 2^23 + 128 in f32, high halves paired."""
    magic = np.float32(8388736.0)
    sel = np.uint32(0x7650 + j)
    f0 = _byte_perm(u0, np.uint32(0x4B000000), sel).view(np.float32) - magic
    f1 = _byte_perm(u1, np.uint32(0x4B000000), sel).view(np.float32) - magic
    assert f0.dtype == np.float32
    return _byte_perm(f0.view(np.uint32), f1.view(np.uint32),
                      np.uint32(0x7632))


def _bf16_bits(values):
    return torch.from_numpy(np.asarray(values, dtype=np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16) \
        .astype(np.uint32)


def _bf16x2_values(words):
    lo = ((words & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (words & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo, hi


@pytest.mark.parametrize("j", range(4))
def test_pair_conversion_gives_every_int8_pair_exactly(j):
    # all 65,536 (row 2t, row 2t + 1) byte pairs at byte j of two words
    # whose other bytes vary
    rng = np.random.default_rng(j)
    b0, b1 = np.meshgrid(np.arange(256, dtype=np.uint32),
                         np.arange(256, dtype=np.uint32), indexing="ij")
    b0, b1 = b0.ravel(), b1.ravel()
    keep = np.uint32(~(0xFF << (8 * j)) & 0xFFFFFFFF)
    w0 = (rng.integers(0, 2 ** 32, b0.size, dtype=np.uint64)
          .astype(np.uint32) & keep) | (b0 << (8 * j))
    w1 = (rng.integers(0, 2 ** 32, b1.size, dtype=np.uint64)
          .astype(np.uint32) & keep) | (b1 << (8 * j))
    word = _pair_byte(w0 ^ np.uint32(0x80808080), w1 ^ np.uint32(0x80808080),
                      j)
    v0 = b0.astype(np.uint8).view(np.int8).astype(np.float32)
    v1 = b1.astype(np.uint8).view(np.int8).astype(np.float32)
    # the bf16x2 word holds the two bytes' own bf16 bits, low = row 2t
    np.testing.assert_array_equal(word & 0xFFFF, _bf16_bits(v0))
    np.testing.assert_array_equal(word >> 16, _bf16_bits(v1))
    lo, hi = _bf16x2_values(word)
    np.testing.assert_array_equal(lo, v0)
    np.testing.assert_array_equal(hi, v1)


def _lane(warp, lane):
    """What a consumer lane computes once (int8_stream.cuh): its chunk, its
    first column in the tile, and its swizzled word offsets of rows 2t and
    2t + 1 of a k16 slice."""
    g, t = lane >> 2, lane & 3
    c = 2 * warp + (g >> 2)
    col = 16 * c + 4 * (g & 3)
    aoff0 = 2 * t * LINE + ((c ^ (2 * t)) << 4) + 4 * (g & 3)
    aoff1 = (2 * t + 1) * LINE + ((c ^ (2 * t + 1)) << 4) + 4 * (g & 3)
    return c, col, aoff0, aoff1


def _swizzle_128(row, col):
    """Byte offset of (line row, byte col) in a TMA box of 128-byte lines
    with the 128-byte swizzle: chunk col // 16 sits at chunk ^ (row % 8)."""
    return row * LINE + (((col >> 4) ^ (row & 7)) << 4) + (col & 15)


def test_fragment_rows_map_onto_the_tile_columns_once():
    # fragment row (tile T, row g + 8h) of warp w is byte 2T + h of lane
    # g's words: over the tile's warps a bijection onto its 128 columns,
    # the same column for the four lanes (k pairs) that share a row; the
    # epilogue's four columns of a token are that map's image, in order
    seen = {}
    for warp in range(WARPS):
        for lane in range(32):
            g = lane >> 2
            _, col, _, _ = _lane(warp, lane)
            assert col == 32 * warp + 4 * g
            for tile in range(2):
                for h in range(2):
                    key = (warp, tile, g + 8 * h)
                    assert seen.setdefault(key, col + 2 * tile + h) == \
                        col + 2 * tile + h
    assert sorted(seen.values()) == list(range(WARPS * 32))
    # the epilogue stores acc[0][e], acc[0][2 + e], acc[1][e], acc[1][2 + e]
    # at columns col .. col + 3: accumulator e of tile T is fragment row
    # g + 8 (e // 2), so store slot s holds (T, h) = (s // 2, s % 2)
    for s, (tile, e) in enumerate([(0, 0), (0, 2), (1, 0), (1, 2)]):
        assert (tile, e // 2) == (s // 2, s % 2)


@pytest.mark.parametrize("delta", [0, 1, 8, 9])
def test_weight_word_loads_are_conflict_free(delta):
    # each of a k16 slice's four word loads (rows 2t + delta): the address
    # is the swizzled home of the lane's four columns, and the 32 lanes of
    # a warp hit 32 distinct banks
    for warp in range(WARPS):
        for sub in range(KS // 16):
            banks = set()
            for lane in range(32):
                t = lane & 3
                _, col, aoff0, aoff1 = _lane(warp, lane)
                off = sub * 2048 + (1024 if delta >= 8 else 0) + \
                    (aoff1 if delta % 2 else aoff0)
                row = 16 * sub + 2 * t + delta
                assert [off + b for b in range(4)] == [
                    _swizzle_128(row, col + b) for b in range(4)]
                banks.add((off // 4) % 32)
            assert len(banks) == 32


def _x_address(sub, lane):
    """The ldmatrix address lane ``lane`` gives for k16 slice ``sub``."""
    mi, r8 = (lane >> 3) & 1, lane & 7
    cc = 2 * (sub & 3) + mi
    return (sub >> 2) * 8 * LINE + r8 * LINE + ((cc ^ r8) << 4)


def test_x_fragment_ldmatrix_rows_are_conflict_free():
    for sub in range(KS // 16):
        for mi in range(2):
            banks = set()
            for r8 in range(8):
                off = _x_address(sub, 8 * mi + r8)
                # token r8's k values 16 sub + 8 mi .. + 7 of the stage
                k = 16 * sub + 8 * mi
                assert off == (k // 64) * 8 * LINE + _swizzle_128(
                    r8, 2 * (k % 64))
                banks.update((off // 4 + i) % 32 for i in range(4))
            assert len(banks) == 32


def _smem_image(lines):
    """A TMA box of 128-byte lines ([rows, 128] uint8) as the 128-byte
    swizzle lays it out in shared memory."""
    rows = lines.shape[0]
    img = np.zeros(rows * LINE, dtype=np.uint8)
    r, c = np.meshgrid(np.arange(rows), np.arange(LINE), indexing="ij")
    img[_swizzle_128(r, c)] = lines
    return img


def _word(img, off):
    return np.uint32(int.from_bytes(img[off:off + 4].tobytes(), "little"))


def _consumer_stage(w_tile, x_slice):
    """One stage of the consumers' pass, mirrored: w_tile int8 [128 k, 128
    columns] and x_slice [8 tokens, 128 k] (bf16 values) go into shared
    memory as TMA lays them out; each lane loads, converts and pairs its
    words and ldmatrix's its x rows at the kernel's addresses; the warp's
    m16n8k16 products are taken from the lanes' fragments; the epilogue
    writes each lane's accumulators to the columns it stores them at.
    Returns out [8, 128] (f64) and how often each entry was written."""
    wimg = _smem_image(w_tile.view(np.uint8))
    xbits = torch.from_numpy(x_slice).to(torch.bfloat16).view(
        torch.int16).numpy().view(np.uint8)             # [8, 256] bytes
    ximg = np.concatenate([_smem_image(xbits[:, 128 * b:128 * (b + 1)])
                           for b in range(2)])
    acc = np.zeros((WARPS, 32, 2, 4))
    for sub in range(KS // 16):
        for warp in range(WARPS):
            a = np.zeros((2, 16, 16))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                _, _, aoff0, aoff1 = _lane(warp, lane)
                base = sub * 2048
                # rows 2t, 2t + 1, 2t + 8, 2t + 9, each ^ 0x80808080
                u = [_word(wimg, base + off) ^ np.uint32(0x80808080)
                     for off in (aoff0, aoff1, 1024 + aoff0, 1024 + aoff1)]
                for tile in range(2):
                    regs = [_pair_byte(u[0], u[1], 2 * tile),
                            _pair_byte(u[0], u[1], 2 * tile + 1),
                            _pair_byte(u[2], u[3], 2 * tile),
                            _pair_byte(u[2], u[3], 2 * tile + 1)]
                    for r, (row, k) in enumerate([(g, 2 * t), (g + 8, 2 * t),
                                                  (g, 2 * t + 8),
                                                  (g + 8, 2 * t + 8)]):
                        lo, hi = _bf16x2_values(np.asarray([regs[r]]))
                        a[tile, row, k], a[tile, row, k + 1] = lo[0], hi[0]
            # ldmatrix x2: matrix i's rows from lanes 8i .. 8i + 7; lane
            # (g, t) receives bytes 4t .. 4t + 3 of row g of each matrix
            b = np.zeros((16, 8))
            for i in range(2):
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    word = _word(ximg, _x_address(sub, 8 * i + g) + 4 * t)
                    lo, hi = _bf16x2_values(np.asarray([word]))
                    b[8 * i + 2 * t, g], b[8 * i + 2 * t + 1, g] = lo[0], hi[0]
            for tile in range(2):
                c = a[tile] @ b                           # [16 rows, 8 tokens]
                for lane in range(32):
                    g, t = lane >> 2, lane & 3
                    acc[warp, lane, tile] += [c[g, 2 * t], c[g, 2 * t + 1],
                                              c[g + 8, 2 * t],
                                              c[g + 8, 2 * t + 1]]
    out = np.zeros((8, LINE))
    writes = np.zeros((8, LINE), dtype=np.int64)
    for warp in range(WARPS):
        for lane in range(32):
            t = lane & 3
            _, col, _, _ = _lane(warp, lane)
            for e in range(2):
                m = 2 * t + e
                out[m, col:col + 4] = [acc[warp, lane, 0, e],
                                       acc[warp, lane, 0, 2 + e],
                                       acc[warp, lane, 1, e],
                                       acc[warp, lane, 1, 2 + e]]
                writes[m, col:col + 4] += 1
    return out, writes


def test_one_stage_of_the_consumers_pass_computes_x_at_w():
    # the addresses, conversion, fragment layouts and epilogue map of the
    # body together: one 128 x 128 stage against eight tokens equals the
    # plain product
    rng = np.random.default_rng(5)
    w = rng.integers(-128, 128, (KS, LINE)).astype(np.int8)
    x = torch.from_numpy(rng.standard_normal((8, KS)).astype(np.float32)) \
        .to(torch.bfloat16).float().numpy()
    out, writes = _consumer_stage(w, x)
    assert (writes == 1).all()
    np.testing.assert_allclose(out, x.astype(np.float64)
                               @ w.astype(np.float64), rtol=1e-12,
                               atol=1e-9)
