# The port's attention (K1's plain version, the prefill dispatch, decode
# attention) against the JAX package on the same numpy inputs.
#
# Tolerances are the JAX package's own for flash vs XLA attention
# (ops/flash_attention.py:10-11): 1e-5 in float32, 2e-2 in bfloat16.
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.ops.attention import (
    attention_xla,
    decode_attention,
    decode_attention_prefix_window,
)
from copilot_for_consensus_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from copilot_for_consensus_tpu_torch.ops import attention as tattn
from copilot_for_consensus_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_ref,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, b=2, hq=4, hkv=2, s_q=96, s_kv=None, d=32):
    rng = np.random.default_rng(seed)
    s_kv = s_q if s_kv is None else s_kv
    return (rng.standard_normal((b, hq, s_q, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s_kv, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s_kv, d)).astype(np.float32))


def _both(arrays, dtype):
    """The same values as jax and torch arrays of ``dtype``."""
    return ([jnp.asarray(a).astype(_JNP[dtype]) for a in arrays],
            [torch.from_numpy(a).to(_TORCH[dtype]) for a in arrays])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


# (name, shape kwargs, mask kwargs, per-row vectors or None)
CASES = [
    ("causal", dict(s_q=96), dict(causal=True, window=0), None),
    ("window", dict(s_q=96), dict(causal=True, window=24), None),
    ("padded_bidirectional", dict(s_q=80), dict(causal=False, window=0),
     dict(kv_lengths=[80, 37])),
    ("non_divisible", dict(s_q=50), dict(causal=True, window=0), None),
    ("offsets_begins", dict(b=3, s_q=40, s_kv=130, d=64),
     dict(causal=True, window=0),
     dict(q_offsets=[90, 0, 10], kv_begins=[5, 0, 3],
          kv_lengths=[130, 40, 50])),
    ("fully_masked_rows", dict(b=3, s_q=48, d=64),
     dict(causal=True, window=16),
     dict(kv_lengths=[48, 0, 1])),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,mask,rows", CASES,
                         ids=[c[0] for c in CASES])
def test_flash_plain_matches_jax_flash(name, shape, mask, rows, dtype):
    arrays = _qkv(len(name), **shape)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    rows = rows or {}
    jrows = {k: jnp.asarray(v, jnp.int32) for k, v in rows.items()}
    trows = {k: torch.tensor(v, dtype=torch.int32) for k, v in rows.items()}
    want = jax_flash(jq, jk, jv, **mask, **jrows, block_q=32, block_kv=32,
                     interpret=True)
    got = flash_attention_ref(tq, tk, tv, **mask, **trows)
    assert got.dtype == _TORCH[dtype] and got.shape == tq.shape
    _close(got, want, dtype)
    # the wrapper takes the plain version on CPU tensors, launching nothing
    launches = flash_attention.launches
    wrapped = flash_attention(tq, tk, tv, **mask, **trows)
    assert flash_attention.launches == launches
    assert torch.equal(wrapped, got)
    if name == "fully_masked_rows":
        assert not torch.isnan(got).any()
        assert torch.count_nonzero(got[1]) == 0     # kv_lengths 0: zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,shape,mask,rows",
                         [c for c in CASES if c[0] != "offsets_begins"],
                         ids=[c[0] for c in CASES if c[0] != "offsets_begins"])
def test_flash_plain_matches_attention_xla(name, shape, mask, rows, dtype):
    arrays = _qkv(len(name) + 7, **shape)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    lens = (rows or {}).get("kv_lengths")
    want = attention_xla(
        jq, jk, jv, **mask,
        kv_lengths=None if lens is None else jnp.asarray(lens))
    got = flash_attention_ref(
        tq, tk, tv, **mask,
        kv_lengths=None if lens is None else torch.tensor(lens))
    # attention_xla rounds the probabilities to bf16 before P·V; K1 keeps
    # them in f32 — within the bf16 tolerance
    _close(got, want, dtype)


@pytest.mark.parametrize("q_offset,window", [(0, 0), (16, 0), (16, 20)])
def test_attention_ref_matches_attention_xla(q_offset, window):
    q, k, v = _qkv(3, s_q=32, s_kv=64)
    lens = np.array([64, 41])
    want = attention_xla(q, k, v, causal=True, window=window,
                         q_offset=q_offset, kv_lengths=jnp.asarray(lens))
    got = tattn.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window, q_offset=q_offset,
                              kv_lengths=torch.from_numpy(lens))
    _close(got, want, "float32")


@pytest.mark.parametrize("impl", ["auto", "plain"])
def test_attention_dispatch_on_cpu(impl):
    q, k, v = (torch.from_numpy(a) for a in _qkv(4, s_q=40))
    lens = torch.tensor([40, 23])
    got = tattn.attention(q, k, v, causal=True, window=12,
                          kv_lengths=lens, q_offset=3, impl=impl)
    want = flash_attention_ref(q, k, v, causal=True, window=12,
                               kv_lengths=lens,
                               q_offsets=torch.tensor([3, 3]))
    assert torch.equal(got, want)


def test_attention_rejects_unknown_impl():
    q, k, v = (torch.from_numpy(a) for a in _qkv(5, s_q=8))
    with pytest.raises(ValueError):
        tattn.attention(q, k, v, impl="pallas")


@pytest.mark.parametrize("window,kv_len", [(0, None), (16, None), (0, 48)])
def test_decode_attention_matches_jax(window, kv_len):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((3, 4, 32)).astype(np.float32)
    kc = rng.standard_normal((3, 2, 64, 32)).astype(np.float32)
    vc = rng.standard_normal((3, 2, 64, 32)).astype(np.float32)
    lengths = np.array([33, 1, 40])
    want = decode_attention(q, kc, vc, jnp.asarray(lengths), window=window,
                            kv_len=kv_len)
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                 torch.from_numpy(vc),
                                 torch.from_numpy(lengths), window=window,
                                 kv_len=kv_len)
    _close(got, want, "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,w,kv_len", [(0, 0, None), (0, 3, 48),
                                             (20, 2, None), (8, 5, 64)])
def test_decode_prefix_window_matches_jax(window, w, kv_len, dtype):
    rng = np.random.default_rng(12 + w)
    b, hq, hkv, s, n_win, d = 3, 4, 2, 64, 6, 32
    arrays = [rng.standard_normal(sh).astype(np.float32) for sh in (
        (b, hq, d), (b, hkv, s, d), (b, hkv, s, d), (b, hkv, n_win, d),
        (b, hkv, n_win, d), (b, hkv, d), (b, hkv, d))]
    # a parked slot sits at the cache extent; a live one near the start
    prefix = np.array([30, s, 1], dtype=np.int32)
    jx, tx = _both(arrays, dtype)
    want = decode_attention_prefix_window(
        *jx, prefix_lengths=jnp.asarray(prefix), w=jnp.int32(w),
        window=window, kv_len=kv_len)
    got = tattn.decode_attention_prefix_window(
        *tx, prefix_lengths=torch.from_numpy(prefix), w=w, window=window,
        kv_len=kv_len)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype,d,body", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 32, "d32"), (torch.float32, 128, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 32, "simt")])
def test_flash_body_rule(dtype, d, body):
    # K1's body is chosen from dtype and head dim alone
    from copilot_for_consensus_tpu_torch.ops import flash_attention as tfa

    assert tfa.flash_body(dtype, d) == body
    assert body in tfa.BODIES


def test_mistral_prefill_takes_the_wgmma_body():
    from copilot_for_consensus_tpu_torch.models.configs import decoder_config
    from copilot_for_consensus_tpu_torch.ops import flash_attention as tfa

    # bf16 activations and KV: every prefill wave of every serve path
    head_dim = decoder_config("mistral-7b").head_dim
    assert tfa.flash_body(torch.bfloat16, head_dim) == "wgmma"


def test_flash_wrapper_on_cpu_counts_no_body():
    from copilot_for_consensus_tpu_torch.ops import flash_attention as tfa

    arrays = _qkv(3, b=2, s_q=40, s_kv=40, d=64)
    _, (tq, tk, tv) = _both(arrays, "bfloat16")
    before = dict(tfa.flash_attention.launches_by_body)
    got = tfa.flash_attention(tq, tk, tv, causal=True, window=16)
    assert torch.equal(got, tfa.flash_attention_ref(tq, tk, tv, causal=True,
                                                    window=16))
    assert tfa.flash_attention.launches_by_body == before
    assert sorted(before) == sorted(tfa.BODIES)


def test_flash_wrapper_at_d32_on_cpu_counts_no_body():
    from copilot_for_consensus_tpu_torch.ops import flash_attention as tfa

    # the encoder's call: bf16, head dim 32, non-causal, padded rows
    assert "d32" in tfa.BODIES and "d32" in tfa.flash_attention.launches_by_body
    _, (tq, tk, tv) = _both(_qkv(5, b=2, hq=2, hkv=2, s_q=40), "bfloat16")
    lens = torch.tensor([40, 9], dtype=torch.int32)
    before = dict(tfa.flash_attention.launches_by_body)
    launches = tfa.flash_attention.launches
    got = tfa.flash_attention(tq, tk, tv, causal=False, kv_lengths=lens)
    assert torch.equal(got, tfa.flash_attention_ref(tq, tk, tv, causal=False,
                                                    kv_lengths=lens))
    assert tfa.flash_attention.launches_by_body == before
    assert tfa.flash_attention.launches == launches


def _d32_body_mirror(q, k, v, *, causal, window=0, kv_lengths=None,
                     q_offsets=None, kv_begins=None, bn=64):
    """The arithmetic of K1's d32 body (csrc/flash_d32.cuh) in plain
    PyTorch, where it differs from ``flash_attention_ref``: kv tiles of 64
    in order with an online softmax, the running max in raw units,
    probabilities 2^(s c - m c) with c = log2(e) / sqrt(D) folded in, P
    split into bf16 hi = bf16(P) and lo = bf16(P - hi), each part times the
    bf16 V summed in f32, O / l at the end (0 for an empty row), rounded
    to bf16. Dead tiles, which the body skips, change nothing here: a
    fully masked tile leaves the max, and so the sums, as they were."""
    from copilot_for_consensus_tpu_torch.ops import flash_attention as tfa

    b, hq, s_q, d = q.shape
    hkv, s_kv = k.shape[1], k.shape[2]
    lens, offs, begins = tfa._row_params(b, s_kv, kv_lengths, q_offsets,
                                         kv_begins, "cpu")
    mask = tfa._mask(b, s_q, s_kv, lens, offs, begins, causal=causal,
                     window=window, device="cpu")[:, None]
    c = torch.tensor(1.4426950408889634 / math.sqrt(d), dtype=torch.float32)
    kf = k.float().repeat_interleave(hq // hkv, dim=1)
    vf = v.float().repeat_interleave(hq // hkv, dim=1)
    m = torch.full((b, hq, s_q), float("-inf"))
    l_sum = torch.zeros(b, hq, s_q)
    acc = torch.zeros(b, hq, s_q, d)
    for kt in range(0, s_kv, bn):
        s = q.float() @ kf[:, :, kt:kt + bn].transpose(-1, -2)
        s = s.masked_fill(~mask[..., kt:kt + bn], float("-inf"))
        mx = torch.maximum(m, s.amax(-1))
        mu = torch.where(mx == float("-inf"), torch.zeros(()), mx)
        corr = torch.exp2((m - mu) * c)
        p = torch.exp2(s * c - (mu * c)[..., None])
        l_sum = l_sum * corr + p.sum(-1)
        m = mx
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = acc * corr[..., None] + hi @ vf[:, :, kt:kt + bn] \
            + lo @ vf[:, :, kt:kt + bn]
    inv = torch.where(l_sum == 0, torch.zeros(()), 1.0 / l_sum)
    return (acc * inv[..., None]).to(torch.bfloat16)


# the d32 body's cases: the encoder's (non-causal, kv_lengths padding, a
# length-1 row, its smallest bucket), then the masks it shares with K1's
# other bodies, at head dim 32
D32_CASES = [
    ("encoder", dict(b=3, hq=2, hkv=2, s_q=100), dict(causal=False),
     dict(kv_lengths=[100, 37, 1])),
    ("encoder_bucket32", dict(b=4, hq=2, hkv=2, s_q=32), dict(causal=False),
     dict(kv_lengths=[32, 17, 2, 1])),
    ("causal_gqa", dict(s_q=150), dict(causal=True), None),
    ("window", dict(s_q=96), dict(causal=True, window=24), None),
    ("offsets_begins", dict(b=3, s_q=40, s_kv=130), dict(causal=True),
     dict(q_offsets=[90, 0, 10], kv_begins=[5, 0, 3],
          kv_lengths=[130, 40, 0])),
]


@pytest.mark.parametrize("name,shape,mask,rows", D32_CASES,
                         ids=[c[0] for c in D32_CASES])
def test_d32_body_mirror_matches_jax_flash(name, shape, mask, rows):
    # the d32 body's rounding (P as bf16 hi + lo, base-2 exponentials with
    # the scale folded in, 64-key tiles) against the JAX package's Pallas
    # kernel, run through its interpreter at bf16: within the bf16
    # tolerance, and so within it of the port's plain version too
    arrays = _qkv(len(name) + 32, **shape)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "bfloat16")
    rows = rows or {}
    jrows = {k: jnp.asarray(v, jnp.int32) for k, v in rows.items()}
    trows = {k: torch.tensor(v, dtype=torch.int32) for k, v in rows.items()}
    want = jax_flash(jq, jk, jv, **mask, **jrows, block_q=32, block_kv=32,
                     interpret=True)
    got = _d32_body_mirror(tq, tk, tv, **mask, **trows)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    _close(got, want, "bfloat16")
    _close(got, flash_attention_ref(tq, tk, tv, **mask, **trows),
           "bfloat16")
    if "kv_lengths" in rows and 0 in rows["kv_lengths"]:
        assert torch.count_nonzero(got[rows["kv_lengths"].index(0)]) == 0


def test_d32_split_carries_p_and_widens_by_bits():
    # hi = bf16(p), lo = bf16(p - hi) carry p to ~2^-16 relative (the
    # body's reason for two passes); and its widening of a packed bf16x2
    # word by bit operations (low half << 16, high half & 0xffff0000) is
    # the bf16 -> f32 conversion, with the first value in the low half as
    # __floats2bfloat162_rn packs it
    p = torch.from_numpy(np.random.default_rng(3).random(4096,
                                                         dtype=np.float32))
    hi = p.to(torch.bfloat16)
    lo = (p - hi.float()).to(torch.bfloat16)
    assert ((hi.float() + lo.float() - p).abs() <= p * 2.0 ** -16).all()
    words = hi.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32)
    packed = words[0::2] | (words[1::2] << 16)
    low = (packed << 16).view(np.float32)
    high = (packed & 0xFFFF0000).astype(np.uint32).view(np.float32)
    np.testing.assert_array_equal(low, hi.float().numpy()[0::2])
    np.testing.assert_array_equal(high, hi.float().numpy()[1::2])
