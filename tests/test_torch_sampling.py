# The port's sampling against its invariants and the JAX package's
# filtered distribution. torch.Generator and jax.random give different bits
# for one seed, so sampled draws are compared as distributions; filtered
# logits agree to 1e-6 (float32, one division and identical masking).
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.sampling import (
    SamplingConfig as JaxSamplingConfig,
)
from copilot_for_consensus_tpu.engine.sampling import (
    _filter_logits as jax_filter_logits,
)
from copilot_for_consensus_tpu_torch.engine.sampling import (
    SamplingConfig,
    _filter_logits,
    sample,
)


def _logits(seed, b=4, v=32):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, v)).astype(np.float32)


def test_greedy_is_argmax():
    lg = torch.from_numpy(_logits(0, b=8, v=100))
    got = sample(lg, None, SamplingConfig())
    assert torch.equal(got, lg.argmax(dim=-1))


@pytest.mark.parametrize("temp", [0.3, 1.0, 2.5])
def test_top_k_one_matches_greedy_at_any_temperature(temp):
    for seed in range(5):
        lg = torch.from_numpy(_logits(seed))
        gen = torch.Generator().manual_seed(seed)
        got = sample(lg, gen, SamplingConfig(temperature=temp, top_k=1))
        assert torch.equal(got, sample(lg, None, SamplingConfig()))


@pytest.mark.parametrize("top_p", [0.01, 0.1, 0.5, 0.9, 0.999])
def test_top_p_never_masks_the_argmax_token(top_p):
    for seed in range(5):
        lg = torch.from_numpy(_logits(seed))
        f = _filter_logits(lg, SamplingConfig(temperature=1.0, top_p=top_p))
        kept = torch.gather(f, -1, lg.argmax(-1, keepdim=True))
        assert torch.isfinite(kept).all(), (top_p, seed)


@pytest.mark.parametrize("temp,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 8, 0.6),
    (1.0, 99, 1.0), (0.5, 3, 0.05)])
def test_filtered_logits_match_jax(temp, top_k, top_p):
    lg = _logits(int(temp * 10) + top_k, b=6, v=64)
    want = np.asarray(jax_filter_logits(
        jnp.asarray(lg), JaxSamplingConfig(temperature=temp, top_k=top_k,
                                           top_p=top_p)))
    got = _filter_logits(torch.from_numpy(lg), SamplingConfig(
        temperature=temp, top_k=top_k, top_p=top_p)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


def test_draws_follow_the_filtered_distribution():
    lg = torch.from_numpy(_logits(3, b=1, v=16))
    cfg = SamplingConfig(temperature=0.8, top_k=6, top_p=0.95)
    probs = torch.softmax(_filter_logits(lg, cfg), -1)[0]
    gen = torch.Generator().manual_seed(0)
    n = 20000
    draws = sample(lg.expand(n, -1).contiguous(), gen, cfg)
    freq = torch.bincount(draws, minlength=16).float() / n
    assert (freq[probs == 0] == 0).all()            # never outside support
    # 5 standard errors of a binomial proportion
    se = (probs * (1 - probs) / n).sqrt()
    assert ((freq - probs).abs() <= 5 * se + 1e-9).all()


def test_same_seed_same_draws():
    lg = torch.from_numpy(_logits(4, b=16, v=50))
    cfg = SamplingConfig(temperature=1.0, top_p=0.9)
    a = sample(lg, torch.Generator().manual_seed(9), cfg)
    b = sample(lg, torch.Generator().manual_seed(9), cfg)
    assert torch.equal(a, b)
