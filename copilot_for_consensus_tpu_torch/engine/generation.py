"""Continuous-batching LLM generation engine — the contiguous-cache route
of the JAX package's ``engine/generation.py``, ported to PyTorch.

* **Slot batch.** Decode state is a fixed batch of ``num_slots``
  sequences sharing one KV cache ``[L, slots, Hkv, max_len, Dh]``; every
  decode dispatch advances all slots, and requests join and leave between
  dispatches.
* **Admission waves.** Queued prompts are prefilled together, padded to
  the next prefill bucket (rows to a power of two), under an
  ``admission_token_budget``; their KV is inserted into free slots and
  the first token sampled — one host sync per wave.
* **Windowed decode.** One dispatch runs ``decode_window`` steps; fresh KV
  goes to small window buffers and is merged into the cache once per
  dispatch, so the cache is read-only during the window.

Where the JAX engine builds new arrays, this one updates the cache in
place (no second cache allocation). It has no telemetry, journal, fault
injection, scheduler, prefix cache, paged pool or speculative decoding.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import resolve_device, \
    resolve_dtype
from copilot_for_consensus_tpu_torch.engine.sampling import (
    SamplingConfig,
    sample,
)
from copilot_for_consensus_tpu_torch.models import decoder, quant
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig


@dataclass
class Request:
    request_id: int
    prompt: list[int]
    max_new_tokens: int
    submitted_at: float = field(default_factory=time.monotonic)
    decode_started_at: float = 0.0


@dataclass
class Completion:
    request_id: int
    prompt_len: int
    tokens: list[int]
    finish_reason: str            # "eos" | "length"
    prefill_s: float = 0.0
    decode_s: float = 0.0
    #: submit → first token on the host
    ttft_s: float = 0.0


def _next_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _to_device(tree: dict, device: torch.device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, dict)
            else v.to(device) for k, v in tree.items()}


class GenerationEngine:
    """Continuous-batching decoder serving on one device."""

    def __init__(
        self,
        cfg: DecoderConfig,
        params: dict | None = None,
        *,
        num_slots: int = 8,
        max_len: int = 1024,
        prefill_buckets: tuple[int, ...] = (64, 128, 256, 512, 1024),
        sampling: SamplingConfig = SamplingConfig(),
        eos_id: int = 2,
        seed: int = 0,
        dtype: str | torch.dtype = torch.bfloat16,
        quantize: bool | str = False,
        decode_window: int = 8,
        admission_token_budget: int = 16384,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        self.cfg = cfg
        self.num_slots = num_slots
        self.max_len = min(max_len, cfg.max_seq_len)
        self.buckets = tuple(sorted(set(min(b, self.max_len)
                                        for b in prefill_buckets)))
        self.sampling = sampling
        eos_list = list(eos_id) if isinstance(eos_id, (list, tuple)) \
            else [int(eos_id)]
        self.eos_id = int(eos_list[0])
        self._eos_set = frozenset(int(e) for e in eos_list)
        # one window per dispatch: the JAX engine's windows_per_dispatch=1
        self.decode_window = max(1, decode_window)
        # Prompt tokens one admission wave may prefill (rows × bucket).
        self.admission_token_budget = admission_token_budget
        if self.max_len - self.decode_window < 1:
            raise ValueError(
                f"decode_window {self.decode_window} leaves no prompt "
                f"room in max_len {self.max_len}")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        qmode = ("int8" if quantize is True else quantize) or None
        if qmode not in (None, "int8"):
            raise ValueError(f"unsupported quantize mode {qmode!r}")
        if params is None:
            if qmode:
                params = quant.init_random_quantized(
                    cfg, seed=seed, dtype=self.dtype, device=self.device)
            else:
                params = decoder.init_params(cfg, seed=seed,
                                             dtype=self.dtype,
                                             device=self.device)
        params = _to_device(params, self.device)
        if qmode and not quant.is_quantized(params["layers"]["wq"]):
            # full-precision weights given: quantize on the fly
            params = quant.quantize_params(params)
        self.params = params
        self.kv_dtype = self.dtype
        self._cache = decoder.init_cache(cfg, num_slots, self.max_len,
                                         dtype=self.kv_dtype,
                                         device=self.device)

        # ---- host-side slot state ---------------------------------------
        self._free = list(range(num_slots))
        self._active: dict[int, Request] = {}          # slot → request
        self._generated: dict[int, list[int]] = {}     # slot → new tokens
        # Free slots park at position max_len (out of range): every
        # decode dispatch advances ALL rows, and the merge drops their
        # out-of-range garbage KV.
        self._positions = np.full(num_slots, self.max_len, dtype=np.int64)
        self._next_tok = np.zeros(num_slots, dtype=np.int64)
        self._t_prefill: dict[int, float] = {}
        self._ttft: dict[int, float] = {}
        self._queue: list[Request] = []
        self._done: dict[int, Completion] = {}
        self._next_id = 0
        #: cumulative wall time of admission waves (prefill + insert +
        #: first-token sync) and of decode dispatches since engine build
        self.admitted_s = 0.0
        self.decode_s = 0.0
        self.decode_tokens = 0

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @property
    def prompt_limit(self) -> int:
        """Longest prompt served without tail-truncation (one decode
        window of cache headroom, capped by the largest prefill bucket)."""
        return min(self.max_len - self.decode_window, self.buckets[-1])

    def submit(self, prompt: list[int], max_new_tokens: int = 256) -> int:
        """Enqueue a tokenized prompt; returns a request id."""
        if not prompt:
            raise ValueError("empty prompt")
        limit = self.prompt_limit
        if len(prompt) > limit:
            # Keep the tail: instructions sit at the end of the prompt.
            prompt = prompt[-limit:]
        rid = self._next_id
        self._next_id += 1
        self._queue.append(Request(rid, list(prompt), max_new_tokens))
        return rid

    def step(self) -> list[Completion]:
        """Admit queued requests into free slots, run one decode dispatch
        for all active slots, retire finished ones. Returns completions."""
        self._admit()
        if self._active:
            self._decode_once()
        return self._drain_done()

    def generate(self, prompts: list[list[int]],
                 max_new_tokens: int = 256) -> list[Completion]:
        """Batch convenience: submit all, run to completion, return in
        submission order."""
        ids = [self.submit(p, max_new_tokens) for p in prompts]
        results: dict[int, Completion] = {}
        while len(results) < len(ids):
            for c in self.step():
                results[c.request_id] = c
        return [results[i] for i in ids]

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _admit(self) -> None:
        """Admit every queued request a free slot can take, as ONE
        batched prefill over [N, bucket]: one pass over the weights, one
        cache insert, one sample, one host fetch of the N first tokens."""
        if not (self._queue and self._free):
            return
        t0 = time.monotonic()
        batch: list[tuple[int, Request]] = []
        longest = 0
        # Cap a wave at 128 rows AND the prompt-token budget: prefill
        # scratch and activations scale with rows × bucket.
        while self._queue and self._free and len(batch) < 128:
            head = self._queue[0]
            longest = max(longest, len(head.prompt))
            if batch and (len(batch) + 1) * _next_bucket(
                    longest, self.buckets) > self.admission_token_budget:
                break
            batch.append((self._free.pop(0), self._queue.pop(0)))
        plens = [len(req.prompt) for _, req in batch]
        bucket = _next_bucket(max(plens), self.buckets)
        # Pad N to the next power of two; padded rows prefill garbage and
        # are never inserted.
        n = 1
        while n < len(batch):
            n *= 2
        tokens = np.zeros((n, bucket), dtype=np.int64)
        lengths = np.ones((n,), dtype=np.int64)
        for i, (_slot, req) in enumerate(batch):
            tokens[i, :plens[i]] = req.prompt
            lengths[i] = plens[i]
        first = self._admit_wave(tokens, lengths,
                                 [slot for slot, _ in batch])
        prefill_s = time.monotonic() - t0
        self.admitted_s += prefill_s
        now = time.monotonic()
        for i, (slot, req) in enumerate(batch):
            tok = int(first[i])
            self._active[slot] = req
            self._generated[slot] = [tok]
            self._positions[slot] = plens[i]
            self._next_tok[slot] = tok
            self._t_prefill[slot] = prefill_s
            self._ttft[slot] = now - req.submitted_at
            req.decode_started_at = now
            if tok in self._eos_set or req.max_new_tokens <= 1:
                self._retire(slot,
                             "eos" if tok in self._eos_set else "length")

    @torch.inference_mode()
    def _admit_wave(self, tokens: np.ndarray, lengths: np.ndarray,
                    slots: list[int]) -> np.ndarray:
        """Prefill + cache insert + first-token sample for one wave; the
        first ``len(slots)`` rows are real and go to ``slots``."""
        n, bucket = tokens.shape
        scratch = decoder.init_cache(self.cfg, n, bucket,
                                     dtype=self.kv_dtype, device=self.device)
        logits, scratch = decoder.prefill(
            self.params, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(lengths).to(self.device), self.cfg, scratch)
        rows = len(slots)
        sl = torch.tensor(slots, device=self.device)
        for name in ("k", "v"):
            self._cache[name][:, sl, :, :bucket] = scratch[name][:, :rows]
        first = sample(logits[:rows], self._gen, self.sampling)
        return first.cpu().numpy()                 # the ONE host sync

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _kv_bucket(self) -> int:
        """Attention extent for the next decode dispatch: the occupied
        cache prefix rounded up to 128. The dispatch's own fresh KV lives
        in the window buffers until the merge, so the extent covers only
        what was in the cache BEFORE the dispatch."""
        hi = max([int(self._positions[s]) for s in self._active] + [0])
        if hi == 0:
            return min(128, self.max_len)
        bucket = min(-(-(hi + 1) // 128) * 128, self.max_len)
        # Near the full extent the shorter read saves little; snap to the
        # whole cache (the JAX engine's rule, kept for identical reads).
        if bucket * 8 >= self.max_len * 7:
            return self.max_len
        return bucket

    @torch.inference_mode()
    def _decode_dispatch(self, kv_len: int) -> np.ndarray:
        """``decode_window`` steps — decode → sample → feed back — then
        one merge of the window's KV into the cache. Returns the sampled
        tokens [window, slots] on the host."""
        cfg, w_sz = self.cfg, self.decode_window
        b = self.num_slots
        shape = (cfg.n_layers, b, cfg.n_kv_heads, w_sz, cfg.head_dim)
        k_win = torch.zeros(shape, dtype=self.kv_dtype, device=self.device)
        v_win = torch.zeros(shape, dtype=self.kv_dtype, device=self.device)
        tok = torch.from_numpy(self._next_tok).to(self.device)
        positions = torch.from_numpy(self._positions).to(self.device)
        out = []
        for w in range(w_sz):
            logits, k_cols, v_cols = decoder.decode_step_windowed(
                self.params, tok, positions, w, cfg, self._cache, k_win,
                v_win, kv_len=kv_len)
            k_win[:, :, :, w] = k_cols
            v_win[:, :, :, w] = v_cols
            tok = sample(logits, self._gen, self.sampling)
            out.append(tok)
        decoder.merge_window(self._cache, k_win, v_win, positions,
                             steps=w_sz)
        return torch.stack(out).cpu().numpy()

    def _decode_once(self) -> None:
        window = self.decode_window
        active_before = list(self._active.items())
        t0 = time.monotonic()
        toks = self._decode_dispatch(self._kv_bucket())   # [steps, slots]
        self.decode_s += time.monotonic() - t0
        for slot, req in active_before:
            gen = self._generated[slot]
            harvested0 = len(gen)
            finished = None
            for step in range(window):
                tok = int(toks[step, slot])
                gen.append(tok)
                if tok in self._eos_set:
                    finished = "eos"
                    break
                if len(gen) >= req.max_new_tokens:
                    finished = "length"
                    break
            self.decode_tokens += len(gen) - harvested0
            self._positions[slot] += window
            self._next_tok[slot] = int(toks[window - 1, slot])
            # Keep a full window of cache headroom: the next window writes
            # positions [pos, pos+window).
            if (finished is None
                    and self._positions[slot] + window > self.max_len - 1):
                finished = "length"
            if finished:
                self._retire(slot, finished)

    # ------------------------------------------------------------------
    # retirement
    # ------------------------------------------------------------------

    def _retire(self, slot: int, reason: str) -> None:
        self._positions[slot] = self.max_len   # park out of range
        req = self._active.pop(slot)
        gen = self._generated.pop(slot)
        if gen and gen[-1] in self._eos_set:
            gen = gen[:-1]
        self._done[req.request_id] = Completion(
            request_id=req.request_id,
            prompt_len=len(req.prompt),
            tokens=gen,
            finish_reason=reason,
            prefill_s=self._t_prefill.pop(slot, 0.0),
            decode_s=time.monotonic() - req.decode_started_at,
            ttft_s=self._ttft.pop(slot, 0.0),
        )
        self._free.append(slot)

    def _drain_done(self) -> list[Completion]:
        out = list(self._done.values())
        self._done.clear()
        return out
