# The paged engine's kv_kernel selector on the port: "auto" and "pallas"
# score the pool in place through K3, "reference" takes the gather route
# (the working-set view gathered with paged_gather_kv, the contiguous
# program over it, the merged columns scattered back). On the same weights
# in float32, the gather route's greedy streams equal the K3 route's and
# the JAX reference route's — plain decode, zero-copy prefix hits,
# speculative verify and chunked prefill — and it launches no K3 call. The
# gather itself equals the JAX package's bit for bit.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.engine.scheduler import (
    SchedulerConfig as JaxSchedulerConfig,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu.ops.paged_attention import (
    paged_gather_kv as jax_gather,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine import generation
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
)
from copilot_for_consensus_tpu_torch.engine.scheduler import SchedulerConfig
from copilot_for_consensus_tpu_torch.models.configs import decoder_config
from copilot_for_consensus_tpu_torch.ops.paged_attention import (
    paged_gather_kv,
)

CFG = decoder_config("tiny")
KW = dict(num_slots=4, max_len=256, prefill_buckets=(64, 128, 192),
          decode_window=4, prefill_chunk=64, kv_pool_blocks=16)


@functools.lru_cache(maxsize=None)
def _weights(cycle: bool = False):
    """The tiny weights; ``cycle``: the spec tests' copy-cycle fixture
    (zeroed attention and FFN outputs, one-hot embeddings and lm_head:
    greedy generation cycles t -> 3 + ((t - 2) % 7), so drafts hit)."""
    jp = jdec.init_params(jax.random.PRNGKey(7), jax_config("tiny"),
                          dtype=jnp.float32)
    tree = jax.tree.map(np.array, jp)
    if cycle:
        tree["layers"]["wo"] = np.zeros_like(tree["layers"]["wo"])
        tree["layers"]["w_down"] = np.zeros_like(tree["layers"]["w_down"])
        emb = np.zeros((CFG.vocab_size, CFG.d_model), np.float32)
        head = np.zeros((CFG.d_model, CFG.vocab_size), np.float32)
        for i in range(7):
            emb[3 + i, i] = 1.0
            head[i, 3 + (i + 1) % 7] = 1.0
        tree["tok_emb"], tree["lm_head"] = emb, head
    return jax.tree.map(jnp.asarray, tree), tree


def _port(route, cycle=False, **kw):
    return GenerationEngine(CFG, params_from_numpy(_weights(cycle)[1], "cpu",
                                                   "float32"),
                            dtype="float32", device="cpu", kv_kernel=route,
                            **{**KW, "telemetry": False, **kw})


def _jax(cycle=False, **kw):
    return JaxEngine(jax_config("tiny"), _weights(cycle)[0],
                     dtype=jnp.float32, kv_dtype=jnp.float32,
                     attn_impl="xla", kv_kernel="reference",
                     **{**KW, "telemetry": False, **kw})


@pytest.fixture
def k3_calls(monkeypatch):
    """Counts the engine's K3 calls (the wrapper the engine module
    holds)."""
    calls = []
    real = generation.paged_attention_partial

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(generation, "paged_attention_partial", counted)
    return calls


def _case(name):
    """(engine options, JAX-only options, prompts a round, rounds, new
    tokens) of the reference's kernel-route cases."""
    rng = np.random.default_rng(0)
    if name == "plain_decode":
        return {}, {}, [rng.integers(3, CFG.vocab_size, size=70).tolist()
                        for _ in range(6)], 1, 10
    if name == "prefix_zero_copy":
        shared = rng.integers(3, CFG.vocab_size, size=128).tolist()
        return dict(prefix_cache_blocks=8), {}, [
            shared + rng.integers(3, CFG.vocab_size, size=30).tolist()
            for _ in range(6)], 2, 6
    if name == "spec_decode":
        return dict(spec_decode=True, cycle=True), {}, [
            [3 + ((i + j) % 7) for j in range(14)] for i in range(4)], 1, 16
    return (dict(scheduler=SchedulerConfig(chunk_tokens=64)),
            dict(scheduler=JaxSchedulerConfig(chunk_tokens=64)),
            [rng.integers(3, CFG.vocab_size, size=180).tolist()
             for _ in range(3)], 1, 8)


@pytest.mark.parametrize("name", ["plain_decode", "prefix_zero_copy",
                                  "spec_decode", "chunked_prefill"])
def test_gather_route_equals_the_k3_route_and_jax(name, k3_calls):
    opts, jax_opts, prompts, rounds, new = _case(name)
    kernel = _port("pallas", **opts)
    gather = _port("reference", **opts)
    jref = _jax(**{**opts, **jax_opts})
    for _round in range(rounds):
        k0 = len(k3_calls)
        got = gather.generate(prompts, max_new_tokens=new)
        assert len(k3_calls) == k0            # the gather route: no K3
        want = kernel.generate(prompts, max_new_tokens=new)
        assert len(k3_calls) > k0
        ref = jref.generate(prompts, max_new_tokens=new)
        for g, w, r in zip(got, want, ref):
            assert g.tokens == w.tokens == r.tokens
            assert g.finish_reason == w.finish_reason
    st = gather.kv_pool_stats()
    assert st["free_blocks"] + (gather._prefix.node_count
                                if gather._prefix else 0) \
        == st["num_blocks"]                   # the books still balance
    if name == "prefix_zero_copy":
        assert st["zero_copy_admits"] > 0
    if name == "spec_decode":
        assert gather.spec_stats()["verify_dispatches"] > 0
    if name == "chunked_prefill":
        assert gather.chunk_dispatches > 0


def test_paged_gather_is_the_jax_gather_bit_for_bit():
    rng = np.random.default_rng(0)
    shape = (CFG.n_layers, 10, CFG.n_kv_heads, 8, CFG.head_dim)
    pk = rng.standard_normal(shape).astype(np.float32)
    pv = rng.standard_normal(shape).astype(np.float32)
    tables = np.array([[3, 1, 10, 10], [0, 9, 2, 7], [10, 10, 10, 10]],
                      np.int32)                 # 10 = the sentinel
    wk, wv = jax_gather(jnp.asarray(pk), jnp.asarray(pv),
                        jnp.asarray(tables))
    gk, gv = paged_gather_kv(torch.tensor(pk), torch.tensor(pv),
                             torch.tensor(tables))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_view_take_reads_the_merged_columns_and_clamps_parked_rows():
    rng = np.random.default_rng(1)
    view = torch.tensor(rng.standard_normal(
        (2, 3, 2, 16, 4)).astype(np.float32))
    pos = torch.tensor([3, 12, 256])               # row 2 parked
    got = GenerationEngine._view_take(view, pos, 4)
    assert got.shape == (2, 3, 2, 4, 4)
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  view[:, 0, :, 3:7].numpy())
    np.testing.assert_array_equal(got[:, 1].numpy(),
                                  view[:, 1, :, 12:16].numpy())
    assert (got[:, 2] == view[:, 2, :, 15:16]).all()   # clamped


def test_kv_kernel_selector_and_its_guards():
    with pytest.raises(ValueError, match="'auto', 'pallas' or 'reference'"):
        _port("xla")
    with pytest.raises(ValueError, match="requires kv_pool_blocks"):
        _port("reference", kv_pool_blocks=0)
    assert _port("auto")._kv_route == "kernel"
    assert _port("pallas")._kv_route == "kernel"
    assert _port("reference")._kv_route == "reference"
    contiguous = _port("auto", kv_pool_blocks=0)
    assert contiguous._kv_route == "" and contiguous.kv_kernel == "auto"


def test_the_route_reaches_the_gauge_and_the_step_records():
    eng = _port("reference", telemetry=True)
    eng.generate([[5, 9, 13, 17] * 10], max_new_tokens=6)
    assert {r.route for r in eng.telemetry.recorder.records()} \
        == {"reference"}
    text = eng.telemetry.metrics.render_prometheus()
    assert 'route="reference"' in text
