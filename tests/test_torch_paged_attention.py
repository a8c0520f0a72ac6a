# The port's paged attention (K3's plain version, the gather helpers) and
# the flash-partial functions of ops/attention.py against the JAX package on
# the same numpy inputs: the Pallas kernel in interpret mode, and the plain
# XLA partials. Tolerance 1e-5 in float32, the JAX package's own for its
# kernel partials (tests/test_engine_kernel_route.py).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.ops.attention import (
    causal_suffix_partial as jax_suffix_partial,
    combine_partials as jax_combine,
    decode_window_partial as jax_window_partial,
)
from copilot_for_consensus_tpu.ops.paged_attention import (
    paged_attention_partial_pallas,
    paged_gather_kv as jax_gather_kv,
    paged_gather_layer as jax_gather_layer,
)
from copilot_for_consensus_tpu_torch.ops import attention as tattn
from copilot_for_consensus_tpu_torch.ops import paged_attention as tpa

TOL = 1e-5


def _t(x):
    """A JAX or numpy array as a torch tensor of the same values; fp8
    crosses as its bytes (torch.from_numpy takes no ml_dtypes)."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    if isinstance(got, (tuple, list)):
        for g, w in zip(got, want):
            _close(g, w, tol)
        return
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _pool(rng, nl, nbtot, hkv, blk, d, fp8=False):
    pk = jnp.asarray(rng.standard_normal((nl, nbtot, hkv, blk, d)),
                     jnp.float32)
    pv = jnp.asarray(rng.standard_normal((nl, nbtot, hkv, blk, d)),
                     jnp.float32)
    if fp8:
        pk, pv = pk.astype(jnp.float8_e4m3fn), pv.astype(jnp.float8_e4m3fn)
    return pk, pv


@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (8, 1)])
@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("window", [0, 5])
def test_partial_plain_matches_jax_kernel(hq, hkv, fp8, window):
    """The decode shape: R = group rows per kv head, mixed fill levels,
    pad ids in the table, a parked (length-0) row."""
    rng = np.random.default_rng(2)
    b, d, blk, nbtot, nb, nl, li = 4, 16, 8, 12, 4, 3, 2
    q = rng.standard_normal((b, hkv, hq // hkv, d)).astype(np.float32)
    pk, pv = _pool(rng, nl, nbtot, hkv, blk, d, fp8)
    tables = rng.integers(0, nbtot + 1, (b, nb)).astype(np.int32)
    lengths = np.array([0, 1, blk * nb, 17], np.int32)
    q_pos = lengths + 2
    want = paged_attention_partial_pallas(
        jnp.asarray(q), pk, pv, jnp.asarray([li], jnp.int32),
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(q_pos),
        window=window, interpret=True)
    args = (_t(q), _t(pk), _t(pv), li, _t(tables), _t(lengths), _t(q_pos))
    got = tpa.paged_attention_partial_ref(*args, window=window)
    assert all(t.dtype == torch.float32 for t in got)
    assert got[0].shape == (b, hkv, hq // hkv, d)
    assert got[1].shape == got[2].shape == (b, hkv, hq // hkv, 1)
    _close(got, want)
    # the parked row: m = -inf, l = 0, acc = 0 — and exact zeros once
    # normalised, never NaN
    assert torch.isinf(got[1][0]).all() and not got[2][0].any()
    out = tattn.combine_partials([got], torch.float32)
    assert not torch.isnan(out).any() and not out[0].any()
    # the wrapper takes the plain version on CPU tensors, launching nothing
    launches = tpa.paged_attention_partial.launches
    wrapped = tpa.paged_attention_partial(*args, window=window)
    assert tpa.paged_attention_partial.launches == launches
    for w, g in zip(wrapped, got):
        assert torch.equal(w, g)


def test_partial_plain_seeded_rows_match_jax():
    """The seeded shape (R = group·S rows, (g, s) row-major) folded with
    the causal suffix: kernel route of both packages, including a row with
    no prefix whose pool piece is fully masked."""
    rng = np.random.default_rng(3)
    b, hkv, g, d, blk, nbtot, nb, s = 2, 2, 2, 16, 8, 10, 3, 4
    hq = hkv * g
    q = rng.standard_normal((b, hq, s, d)).astype(np.float32)
    pk, pv = _pool(rng, 2, nbtot, hkv, blk, d)
    ks = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    vs = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    tables = rng.integers(0, nbtot, (b, nb)).astype(np.int32)
    pref = np.array([13, 0], np.int32)
    qr = q.reshape(b, hkv, g * s, d)
    jpart = paged_attention_partial_pallas(
        jnp.asarray(qr), pk, pv, jnp.asarray([1], jnp.int32),
        jnp.asarray(tables), jnp.asarray(pref), jnp.asarray(pref - 1),
        window=0, interpret=True)
    jsuf = jax_suffix_partial(jnp.asarray(q), jnp.asarray(ks),
                              jnp.asarray(vs))
    want = jax_combine([jpart, jsuf], jnp.float32)
    tpart = tpa.paged_attention_partial_ref(
        _t(qr), _t(pk), _t(pv), 1, _t(tables), _t(pref), _t(pref - 1))
    tsuf = tattn.causal_suffix_partial(_t(q), _t(ks), _t(vs))
    _close(tpart, jpart)
    _close(tsuf, jsuf)
    _close(tattn.combine_partials([tpart, tsuf], torch.float32), want)
    assert torch.isinf(tpart[1][1]).all()         # no prefix: masked


def test_single_piece_equals_decode_attention_over_the_gathered_view():
    """combine_partials([part]) of K3's plain version is the port's decode
    attention over the view the table describes, zeros for a parked row."""
    rng = np.random.default_rng(4)
    b, hq, hkv, d, blk, nbtot, nb = 4, 8, 2, 32, 8, 12, 4
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
    pk, pv = (_t(x) for x in _pool(rng, 1, nbtot, hkv, blk, d))
    tables = torch.from_numpy(
        rng.integers(0, nbtot + 1, (b, nb)).astype(np.int32))
    lengths = torch.tensor([5, 0, 29, 32], dtype=torch.int32)
    for window in (0, 7):
        part = tpa.paged_attention_partial_ref(
            q.reshape(b, hkv, hq // hkv, d), pk, pv, 0, tables, lengths,
            lengths - 1, window=window)
        got = tattn.combine_partials([part], torch.float32).reshape(b, hq, d)
        k, v = tpa.paged_gather_layer(pk[0], pv[0], tables)
        want = tattn.decode_attention(q, k, v, lengths, window=window)
        torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
        assert not got[1].any()


def test_gathers_match_jax():
    rng = np.random.default_rng(5)
    pk, pv = _pool(rng, 2, 6, 2, 4, 8)
    tables = rng.integers(0, 7, (3, 5)).astype(np.int32)     # 6 is a pad
    jk, jv = jax_gather_kv(pk, pv, jnp.asarray(np.minimum(tables, 5)))
    tk, tv = tpa.paged_gather_kv(_t(pk), _t(pv), _t(tables))
    _close((tk, tv), (jk, jv), 0)
    jk, jv = jax_gather_layer(pk[1], pv[1],
                              jnp.asarray(np.minimum(tables, 5)))
    tk, tv = tpa.paged_gather_layer(_t(pk)[1], _t(pv)[1], _t(tables))
    _close((tk, tv), (jk, jv), 0)


def _parts(rng, shapes):
    parts = []
    for r in shapes:
        acc = rng.standard_normal((2, 2, r, 8)).astype(np.float32)
        m = rng.standard_normal((2, 2, r, 1)).astype(np.float32)
        l = rng.uniform(0.5, 3.0, (2, 2, r, 1)).astype(np.float32)
        parts.append((acc, m, l))
    # a row masked in every piece, and one masked in the first piece only
    for i, (acc, m, l) in enumerate(parts):
        m[0, 0, 0] = -np.inf
        l[0, 0, 0] = 0.0
        acc[0, 0, 0] = 0.0
        if i == 0:
            m[1, 1, 2], l[1, 1, 2], acc[1, 1, 2] = -np.inf, 0.0, 0.0
    return parts


@pytest.mark.parametrize("n_parts", [1, 2, 3])
def test_combine_partials_matches_jax(n_parts):
    parts = _parts(np.random.default_rng(6 + n_parts), [5] * n_parts)
    want = jax_combine(
        [tuple(jnp.asarray(x) for x in p) for p in parts], jnp.float32)
    got = tattn.combine_partials(
        [tuple(torch.from_numpy(x) for x in p) for p in parts],
        torch.float32)
    _close(got, want)
    assert not got[0, 0, 0].any()


@pytest.mark.parametrize("window,w,done", [(0, 0, False), (0, 3, False),
                                           (6, 2, False), (0, 1, True),
                                           (5, 3, True)])
def test_decode_window_partial_matches_jax(window, w, done):
    rng = np.random.default_rng(7 + w)
    b, hkv, g, d, n_win, n_done = 3, 2, 2, 16, 4, 3
    arrays = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, hkv, g, d), (b, hkv, n_win, d), (b, hkv, n_win, d),
        (b, hkv, d), (b, hkv, d), (b, hkv, n_done, d), (b, hkv, n_done, d))]
    prefix = np.array([0, 9, 40], np.int32)
    extra = {} if not done else {"k_done": arrays[5], "v_done": arrays[6]}
    want = jax_window_partial(
        *(jnp.asarray(a) for a in arrays[:5]), jnp.asarray(prefix),
        jnp.int32(w), window=window,
        **{k: jnp.asarray(v) for k, v in extra.items()})
    got = tattn.decode_window_partial(
        *(torch.from_numpy(a) for a in arrays[:5]), torch.from_numpy(prefix),
        w, window=window, **{k: torch.from_numpy(v) for k, v in extra.items()})
    _close(got, want)


@pytest.mark.parametrize("lengths", [None, [4, 1]])
def test_causal_suffix_partial_matches_jax(lengths):
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 6, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 6, 16)).astype(np.float32)
    kl = None if lengths is None else np.array(lengths, np.int32)
    want = jax_suffix_partial(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_lengths=None if kl is None else jnp.asarray(kl))
    got = tattn.causal_suffix_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        kv_lengths=None if kl is None else torch.from_numpy(kl))
    _close(got, want)


def test_wrapper_refuses_other_devices():
    q = torch.zeros(1, 1, 4, 32, device="meta")
    pool = torch.zeros(1, 2, 1, 8, 32, device="meta")
    tables = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tpa.paged_attention_partial(q, pool, pool, 0, tables, [1], [0])


@pytest.mark.parametrize("lengths,q_pos,match", [
    (torch.tensor([3, 1]), torch.tensor([3, 1], dtype=torch.int32),
     "lengths"),
    (torch.tensor([3, 1], dtype=torch.int32), [3, 1], "q_pos"),
    (torch.tensor([3, 1], dtype=torch.int32),
     torch.tensor([3], dtype=torch.int32), "q_pos"),
], ids=["int64-lengths", "list-q_pos", "short-q_pos"])
def test_wrapper_refuses_row_vectors_it_would_convert(lengths, q_pos, match):
    """lengths and q_pos must arrive as the kernel reads them (int32 [B] on
    the queries' device), on either route: the wrapper converts nothing."""
    q, pk, pv, li, tables = _good_inputs()
    good = torch.tensor([3, 1], dtype=torch.int32)
    tpa.paged_attention_partial(q, pk, pv, li, tables, good, good)
    with pytest.raises(TypeError, match=match):
        tpa.paged_attention_partial(q, pk, pv, li, tables, lengths, q_pos)


def _good_inputs():
    q = torch.zeros(2, 2, 4, 32)
    pool = torch.zeros(3, 5, 2, 8, 32, dtype=torch.bfloat16)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    return q, pool, pool.clone(), 1, tables


@pytest.mark.parametrize("bad,match", [
    (lambda a: a.__setitem__(0, a[0].double()), "q_rows"),
    (lambda a: a.__setitem__(2, a[2].float()), "pools"),
    (lambda a: a.__setitem__(4, a[4].long()), "tables"),
    (lambda a: a.__setitem__(3, 3), "layer"),
    (lambda a: a.__setitem__(0, torch.zeros(2, 2, 4, 48)), "shape|head_dim"),
    (lambda a: a.__setitem__(0, torch.zeros(2, 4, 2, 32).transpose(1, 2)),
     "contiguous"),
    (lambda a: a.__setitem__(4, torch.zeros(3, 3, dtype=torch.int32)),
     "shape"),
], ids=["q-dtype", "pool-dtypes", "table-dtype", "layer", "head-dim",
        "contiguity", "rows"])
def test_kernel_input_checks_refuse(bad, match):
    """What the CUDA route refuses before it forms a pointer (checked here
    on CPU tensors: the CPU route takes the plain version before them)."""
    args = list(_good_inputs())
    tpa._check(*args)                              # the good case passes
    bad(args)
    with pytest.raises((TypeError, ValueError), match=match):
        tpa._check(*args)


# ---------------------------------------------------------------------------
# K3's bodies: the route rule, the decode body's split plan and its merge
# ---------------------------------------------------------------------------

BF16, F32, FP8 = torch.bfloat16, torch.float32, torch.float8_e4m3fn


@pytest.mark.parametrize("r,q_dtype,pool_dtype,d,blk,body", [
    (4, BF16, BF16, 128, 64, "decode"),          # paged decode (Hq 32/Hkv 8)
    (16, BF16, BF16, 128, 64, "decode"),
    (4, BF16, BF16, 64, 64, "decode"),
    (4, BF16, BF16, 128, 3, "decode"),           # any block size
    (17, BF16, BF16, 128, 64, "seeded"),
    (4 * 64, BF16, BF16, 128, 64, "seeded"),     # a seeded wave, bucket 64
    (4 * 1024, BF16, BF16, 128, 64, "seeded"),   # ... bucket 1024
    (256, BF16, BF16, 64, 16, "seeded"),
    (256, BF16, BF16, 128, 128, "seeded"),
    (256, BF16, BF16, 128, 256, "seeded"),
    (256, BF16, BF16, 128, 4, "simt"),           # less than a swizzle atom
    (256, BF16, BF16, 128, 192, "simt"),         # boxes would cross blocks
    (4, BF16, F32, 128, 64, "simt"),             # the f32 pool
    (4, BF16, FP8, 128, 64, "simt"),             # the fp8 pool
    (256, BF16, FP8, 128, 64, "simt"),
    (4, F32, F32, 128, 64, "simt"),              # f32 q_rows
    (4, BF16, BF16, 32, 64, "simt"),             # D 32
    (256, BF16, BF16, 32, 64, "simt")])
def test_paged_body_rule(r, q_dtype, pool_dtype, d, blk, body):
    # K3's body is chosen from dtypes and shape alone
    assert tpa.paged_body(r, q_dtype, pool_dtype, d, blk) == body
    assert body in tpa.K3_BODIES


def test_k3_bodies_are_fixed_and_cpu_counts_none():
    assert tpa.K3_BODIES == ("decode", "seeded", "simt")
    assert tuple(tpa.paged_attention_partial.launches_by_body) == \
        tpa.K3_BODIES
    q, pk, pv, li, tables = _good_inputs()
    lens = torch.tensor([3, 1], dtype=torch.int32)
    before = dict(tpa.paged_attention_partial.launches_by_body)
    got = tpa.paged_attention_partial(q.to(BF16), pk, pv, li, tables, lens,
                                      lens)
    want = tpa.paged_attention_partial_ref(q.to(BF16), pk, pv, li, tables,
                                           lens, lens)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tpa.paged_attention_partial.launches_by_body == before


def _attended(n, qp, window, nb, blk):
    hi = min(n, nb * blk)
    lo = max(0, qp - window + 1) if window > 0 else 0
    return set(range(lo, hi))


@pytest.mark.parametrize("nb,blk", [(64, 64), (6, 64), (40, 16), (9, 3)])
@pytest.mark.parametrize("window", [0, 100, 4096])
def test_decode_split_plan_covers_each_position_once(nb, blk, window):
    """Every attended position lies in exactly one live split, splits are
    whole blocks in ascending order, and a split that attends nothing is
    not in the plan: lengths of 0, 1, a block edge, a split edge, the whole
    table and a parked slot past it."""
    reach = nb * blk
    split_len = tpa.decode_split_len(blk)
    assert split_len % blk == 0 and 0 < split_len <= max(
        blk, tpa.DECODE_SPLIT_POSITIONS)
    lengths = [0, 1, blk, blk + 1, split_len, split_len + 1, reach - 1,
               reach, reach + 100]
    q_pos = [n + 2 for n in lengths]
    plan = tpa.decode_splits(lengths, q_pos, window, nb, blk)
    assert len(plan) == len(lengths)
    for n, qp, splits in zip(lengths, q_pos, plan):
        seen = []
        for s, first, end in splits:
            assert s * split_len <= first < end <= (s + 1) * split_len
            seen.extend(range(first, end))
        assert seen == sorted(set(seen))            # disjoint, ascending
        assert set(seen) == _attended(n, qp, window, nb, blk)
        assert [s for s, _, _ in splits] == sorted({s for s, _, _ in
                                                    splits})


@pytest.mark.parametrize("window", [0, 100, 4096])
@pytest.mark.parametrize("rows", [4, 8])
def test_split_merge_matches_jax_kernel(window, rows):
    """The decode body's algorithm (a partial per split, merged in the
    kernel's fixed order) against the Pallas kernel in interpret mode:
    normalised output within 1e-5, l within 1e-5 relative, and m equal to
    the one-pass plain version's bit for bit (a max of maxes)."""
    rng = np.random.default_rng(11)
    b, hkv, d, blk, nbtot, nb, nl, li = 6, 2, 16, 64, 20, 6, 2, 1
    q = rng.standard_normal((b, hkv, rows, d)).astype(np.float32)
    pk, pv = _pool(rng, nl, nbtot, hkv, blk, d)
    tables = rng.integers(0, nbtot + 1, (b, nb)).astype(np.int32)
    # empty, one position, a block edge, past a split edge, the whole
    # table, and a parked slot whose length passes its table's reach
    lengths = np.array([0, 1, blk, 257, nb * blk, nb * blk + 90], np.int32)
    q_pos = lengths + 2
    jacc, jm, jl = paged_attention_partial_pallas(
        jnp.asarray(q), pk, pv, jnp.asarray([li], jnp.int32),
        jnp.asarray(tables), jnp.asarray(lengths), jnp.asarray(q_pos),
        window=window, interpret=True)
    args = (_t(q), _t(pk), _t(pv), li, _t(tables), _t(lengths), _t(q_pos))
    acc, m, l = tpa.paged_attention_partial_split_ref(*args, window=window)
    assert max(len(p) for p in tpa.decode_splits(lengths, q_pos, window,
                                                  nb, blk)) > 1
    _close(tattn.combine_partials([(acc, m, l)], torch.float32),
           jax_combine([(jacc, jm, jl)], jnp.float32))
    plain = tpa.paged_attention_partial_ref(*args, window=window)
    assert torch.equal(m, plain[1])
    _close(m, jm)
    live = torch.isfinite(m)
    jl_t = _t(jl)
    assert ((l - jl_t).abs() / jl_t)[live].max() <= TOL
    # rows that attend nothing: m = -inf, l = 0, acc = 0
    assert not l[~live].any() and not acc[~live.expand_as(acc)].any()
    assert torch.isinf(m[0]).all()
