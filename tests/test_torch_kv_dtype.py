# The KV cache dtype on the port's engine (kv_dtype=), against the JAX
# engine on the same weights at f32 compute: the JAX package's bar for an
# fp8 cache (tests/test_engine_generation.py,
# test_fp8_kv_cache_close_to_full_precision) — the first decode steps agree
# with the f32 cache, and the logits of a step that reads the whole fp8
# cache stay close (cosine > 0.99) while differing — held on the
# contiguous cache and on the paged pool (K3's plain version on the CPU,
# which reads the pool in place as the CUDA-core body does on the card),
# and against the JAX engine with the same KV dtype, contiguous and paged
# (its Pallas kernel in interpret mode). The cache, the pool and the
# window buffers are held in the KV dtype; names the JAX engine does not
# know are refused with the valid set.
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from copilot_for_consensus_tpu.engine import generation as jgen
from copilot_for_consensus_tpu.engine.generation import (
    GenerationEngine as JaxEngine,
)
from copilot_for_consensus_tpu.models import decoder as jdec
from copilot_for_consensus_tpu.models.configs import (
    decoder_config as jax_config,
)
from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
)
from copilot_for_consensus_tpu_torch.engine.generation import (
    GenerationEngine,
    resolve_kv_dtype,
)
from copilot_for_consensus_tpu_torch.models import decoder as tdec
from copilot_for_consensus_tpu_torch.models.configs import decoder_config

PROMPTS = [list(range(1, 20)), list(range(5, 40))]
#: the JAX package's fp8 engine (num_slots 4, max_len 128, seed 3's
#: weights), plus a pool of blocks of 32 for the paged route
KW = dict(num_slots=4, max_len=128)
PAGED = dict(kv_pool_blocks=24, prefill_chunk=32)
KV_NAMES = ["bfloat16", "float16", "float32", "float8_e4m3fn",
            "float8_e5m2"]


@functools.lru_cache(maxsize=None)
def _weights():
    cfg = jax_config("tiny")
    jp = jdec.init_params(jax.random.PRNGKey(3), cfg, dtype=jnp.float32)
    return cfg, jp, jax.tree.map(np.asarray, jp)


def _engine(kv=None, paged=False):
    _, _, tree = _weights()
    return GenerationEngine(decoder_config("tiny"),
                            params_from_numpy(tree, "cpu", "float32"),
                            dtype="float32", kv_dtype=kv, device="cpu",
                            **KW, **(PAGED if paged else {}))


def _jax_engine(kv=None, paged=False):
    cfg, jp, _ = _weights()
    extra = dict(PAGED, kv_kernel="pallas") if paged else {}
    return JaxEngine(cfg, jp, dtype=jnp.float32,
                     kv_dtype=getattr(jnp, kv) if kv else None,
                     attn_impl="xla", telemetry=False, **KW, **extra)


def _streams(eng) -> list[list[int]]:
    return [c.tokens for c in eng.generate(PROMPTS, max_new_tokens=12)]


def _cache_read_logits(eng) -> np.ndarray:
    """Prefill one prompt into a cache of the engine's KV dtype, then one
    decode step that attends over all of it: its logits carry the
    quantization error of every cached position."""
    cfg = eng.cfg
    n = len(PROMPTS[0])
    cache = tdec.init_cache(cfg, 1, 64, dtype=eng.kv_dtype, device="cpu")
    tdec.prefill(eng.params, torch.tensor([PROMPTS[0]]), torch.tensor([n]),
                 cfg, cache)
    win = torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, 1, cfg.head_dim),
                      dtype=eng.kv_dtype)
    lg, _, _ = tdec.decode_step_windowed(
        eng.params, torch.tensor([7]), torch.tensor([n]), 0, cfg, cache,
        win, win.clone())
    return lg[0].double().numpy()


def test_fp8_kv_cache_close_to_full_precision():
    outs = {name: _streams(_engine(kv))
            for name, kv in (("f32", None), ("fp8", "float8_e4m3fn"))}
    for a, b in zip(outs["f32"], outs["fp8"]):
        assert a[:3] == b[:3], (a, b)
    x = _cache_read_logits(_engine())
    y = _cache_read_logits(_engine("float8_e4m3fn"))
    assert not np.array_equal(x, y), "fp8 cache read should perturb logits"
    cos = float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))
    assert cos > 0.99, cos


def test_paged_fp8_pool_close_to_full_precision():
    f32 = _streams(_engine(paged=True))
    eng = _engine("float8_e4m3fn", paged=True)
    fp8 = _streams(eng)
    for a, b in zip(f32, fp8):
        assert a[:3] == b[:3], (a, b)
    assert eng._pool.k.dtype == torch.float8_e4m3fn
    st = eng.kv_pool_stats()
    assert st["free_blocks"] == st["num_blocks"]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kv", ["float8_e4m3fn", "float8_e5m2", "float16"])
def test_kv_dtype_streams_against_the_jax_engine(kv, paged):
    # the same KV dtype on both engines: the bar of the fp8 test (the
    # first decode steps agree) between the port and the JAX engine,
    # contiguous and on the JAX paged kernel route
    got = _streams(_engine(kv, paged))
    want = _streams(_jax_engine(kv, paged))
    for a, b in zip(got, want):
        assert a[:3] == b[:3], (a, b)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("kv", KV_NAMES)
def test_cache_pool_and_windows_hold_the_kv_dtype(kv, paged):
    eng = _engine(kv, paged)
    want = getattr(torch, kv)
    assert eng.kv_dtype == want
    store = (eng._pool.k, eng._pool.v) if paged else \
        (eng._cache["k"], eng._cache["v"])
    for t in (*store, eng._static["k_win"], eng._static["v_win"]):
        assert t.dtype == want
    assert all(len(s) == 12 or s for s in _streams(eng))


def test_kv_dtype_names_are_the_jax_engines():
    assert sorted(KV_NAMES) == sorted(jgen._KV_DTYPES)
    for name in KV_NAMES:
        assert resolve_kv_dtype(name, torch.bfloat16) == getattr(torch, name)
    assert resolve_kv_dtype(None, torch.float32) == torch.float32
    assert resolve_kv_dtype("", torch.bfloat16) == torch.bfloat16


@pytest.mark.parametrize("bad", ["fp8", "int8", torch.int8, torch.float64])
def test_unknown_kv_dtype_is_refused_with_the_valid_set(bad):
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        GenerationEngine(decoder_config("tiny"), kv_dtype=bad, device="cpu")
