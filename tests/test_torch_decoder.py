# The port's decoder passes against the JAX package's on the same weights
# (JAX params → numpy → params_from_numpy), in float32, plain and
# int8-quantized. Tolerance: 1e-4 on logits and KV.
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models import quant as jquant
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models import quant as tquant
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

TOL = 1e-4
# (config, overrides, int8): tiny-swa with an 8-token window so the window
# masks bite at these prompt lengths
MODELS = [("tiny", {}, False), ("tiny", {}, True),
          ("tiny-swa", {"sliding_window": 8}, True)]
IDS = ["tiny-plain", "tiny-int8", "tiny-swa8-int8"]


def _models(name, overrides, int8):
    jcfg = jax_config(name, **overrides)
    tcfg = decoder_config(name, **overrides)
    jp = jdec.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32)
    if int8:
        jp = jquant.quantize_params(jp)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu", "float32")
    return jcfg, jp, tcfg, tp


def _close(got, want):
    np.testing.assert_allclose(got.numpy() if isinstance(got, torch.Tensor)
                               else got, np.asarray(want), rtol=TOL,
                               atol=TOL)


TOKENS = np.random.default_rng(0).integers(3, 500, (3, 24))
LENGTHS = np.array([24, 10, 17])


def _prefill_both(jcfg, jp, tcfg, tp, max_len=32):
    jcache = jdec.init_cache(jcfg, 3, max_len, dtype=jnp.float32)
    jl, jcache = jdec.prefill(jp, jnp.asarray(TOKENS), jnp.asarray(LENGTHS),
                              jcfg, jcache)
    tcache = tdec.init_cache(tcfg, 3, max_len, dtype=torch.float32,
                             device="cpu")
    tl, tcache = tdec.prefill(tp, torch.from_numpy(TOKENS),
                              torch.from_numpy(LENGTHS), tcfg, tcache)
    return jl, jcache, tl, tcache


@pytest.mark.parametrize("name,overrides,int8", MODELS, ids=IDS)
def test_prefill_logits_and_kv_match_jax(name, overrides, int8):
    jcfg, jp, tcfg, tp = _models(name, overrides, int8)
    jl, jcache, tl, tcache = _prefill_both(jcfg, jp, tcfg, tp)
    assert tl.shape == (3, tcfg.vocab_size) and tl.dtype == torch.float32
    _close(tl, jl)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("name,overrides,int8", MODELS, ids=IDS)
def test_decode_window_and_merge_match_jax(name, overrides, int8):
    jcfg, jp, tcfg, tp = _models(name, overrides, int8)
    _, jcache, _, tcache = _prefill_both(jcfg, jp, tcfg, tp)
    n_l, w_sz, max_len = tcfg.n_layers, 4, 32
    shape = (n_l, 3, tcfg.n_kv_heads, w_sz, tcfg.head_dim)
    jk, jv = jnp.zeros(shape), jnp.zeros(shape)
    tk, tv = torch.zeros(shape), torch.zeros(shape)
    # row 1 is parked at the cache extent (a free slot): its merge drops
    positions = np.array([24, max_len, 17])
    toks = np.array([7, 8, 9])
    for w in range(3):
        jlog, jkc, jvc = jdec.decode_step_windowed(
            jp, jnp.asarray(toks), jnp.asarray(positions), jnp.int32(w),
            jcfg, jcache, jk, jv, kv_len=32)
        tlog, tkc, tvc = tdec.decode_step_windowed(
            tp, torch.from_numpy(toks), torch.from_numpy(positions), w,
            tcfg, tcache, tk, tv, kv_len=32)
        _close(tlog, jlog)
        _close(tkc, jkc)
        _close(tvc, jvc)
        jk = jk.at[:, :, :, w].set(jkc)
        jv = jv.at[:, :, :, w].set(jvc)
        tk[:, :, :, w] = tkc
        tv[:, :, :, w] = tvc
        toks = np.array(jnp.argmax(jlog, axis=-1))
    jcache = jdec.merge_window(jcache, jk, jv, jnp.asarray(positions),
                               steps=3)
    tdec.merge_window(tcache, tk, tv, torch.from_numpy(positions), steps=3)
    _close(tcache["k"], jcache["k"])
    _close(tcache["v"], jcache["v"])


@pytest.mark.parametrize("name,overrides,int8", MODELS[:2], ids=IDS[:2])
def test_forward_matches_jax(name, overrides, int8):
    jcfg, jp, tcfg, tp = _models(name, overrides, int8)
    want = jdec.forward(jp, jnp.asarray(TOKENS), jcfg,
                        lengths=jnp.asarray(LENGTHS))
    got = tdec.forward(tp, torch.from_numpy(TOKENS), tcfg,
                       lengths=torch.from_numpy(LENGTHS))
    _close(got, want)


def test_plain_impl_matches_auto_on_cpu():
    _, _, tcfg, tp = _models("tiny", {}, True)
    a = tdec.forward(tp, torch.from_numpy(TOKENS), tcfg, impl="auto")
    b = tdec.forward(tp, torch.from_numpy(TOKENS), tcfg, impl="plain")
    assert torch.equal(a, b)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else
            (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


@pytest.mark.parametrize("int8", [False, True])
def test_init_trees_match_jax_structure(int8):
    jcfg, tcfg = jax_config("tiny"), decoder_config("tiny")
    if int8:
        want = jquant.init_random_quantized(jax.random.PRNGKey(0), jcfg,
                                            dtype=jnp.float32)
        got = tquant.init_random_quantized(tcfg, seed=0, dtype=torch.float32,
                                           device="cpu")
        scale = got["layers"]["w_down"]["scale"]
        assert torch.allclose(scale, torch.full_like(
            scale, tcfg.d_ff ** -0.5 / 73.3))
    else:
        want = jdec.init_params(jax.random.PRNGKey(0), jcfg,
                                dtype=jnp.float32)
        got = tdec.init_params(tcfg, seed=0, dtype=torch.float32,
                               device="cpu")
    want_shapes = jax.tree.map(
        lambda a: (tuple(a.shape), str(a.dtype)), want)
    assert _shapes(got) == want_shapes


def test_init_is_seeded():
    cfg = decoder_config("tiny")
    a = tdec.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    b = tdec.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    c = tdec.init_params(cfg, seed=2, dtype=torch.float32, device="cpu")
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert not torch.equal(a["layers"]["wq"], c["layers"]["wq"])
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
