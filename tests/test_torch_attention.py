# The port's attention (K1's plain version, the prefill dispatch, decode
# attention) against the JAX package on the same numpy inputs.
#
# Tolerances are the JAX package's own for flash vs XLA attention
# (ops/flash_attention.py:10-11): 1e-5 in float32, 2e-2 in bfloat16.
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
    (torch.bfloat16, 32, "simt"), (torch.float32, 128, "simt"),
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
