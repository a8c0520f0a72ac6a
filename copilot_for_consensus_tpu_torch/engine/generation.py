"""Continuous-batching LLM generation engine — the contiguous-cache route
and the paged kernel route of the JAX package's ``engine/generation.py``,
ported to PyTorch.

* **Slot batch.** Decode state is a fixed batch of ``num_slots``
  sequences; every decode dispatch advances all slots, and requests join
  and leave between dispatches.
* **Admission waves.** Queued prompts are prefilled together, padded to
  the next prefill bucket (rows to a power of two), under an
  ``admission_token_budget``; their KV is inserted and the first token
  sampled — one host sync per wave.
* **Windowed decode.** One dispatch runs ``windows_per_dispatch``
  windows of ``decode_window`` steps; fresh KV goes to small window
  buffers (the completed windows ride along as a fourth attention piece)
  and is written into the cache once per dispatch, so the cache is
  read-only during the dispatch.
* **One CUDA graph per kv bucket.** The dispatch body reads only static
  buffers the host fills before each dispatch (tokens, positions, block
  tables, write maps) and writes the window buffers, the cache or pool,
  and a static output of tokens. On the card it is captured once per kv
  bucket (``engine/graphs.py``, the counterpart of the JAX engine's
  ``jit`` per bucket; the engine's first dispatch in each
  activation-quantization mode runs eagerly as the warm-up) and
  replayed; on the CPU the same body runs eagerly. Each dispatch ends with one device-to-host fetch of its
  tokens. All of the engine's device work runs on its own CUDA stream.
* **Supervisor hooks.** Every admission wave and decode dispatch runs
  under ``_dispatch_boundary``: the fault plane's injection point
  (``faults=``, ``engine/faults.py``) and the supervisor's watchdog and
  outcome surface (``engine/supervisor.py``, attached by
  ``engine/async_runner.py``). A failed wave puts its requests back at
  the head of the queue; a failed dispatch drops the decode graphs.

Two KV layouts:

* **Contiguous** (default): one cache ``[L, slots, Hkv, max_len, Dh]``.
* **Paged** (``kv_pool_blocks`` > 0): one block pool
  ``[L, kv_pool_blocks, Hkv, block, Dh]`` (``engine/kv_pool.py``, block =
  ``prefill_chunk``) under admission and decode. Slots map positions onto
  pool blocks through per-slot block tables and take blocks on demand;
  admission reserves each request's worst-case block count against free +
  trie-evictable blocks, so a dispatch never runs the pool dry. Decode
  scores the committed blocks in place with K3
  (``ops.paged_attention.paged_attention_partial``) and folds the window
  in with ``combine_partials``. With ``prefix_cache_blocks`` > 0 a radix
  trie over the same pool (``engine/prefix_cache.py``) turns a cached
  prompt prefix into a pointer hit: the matched block ids are appended to
  the slot's table and only the suffix is prefilled, its prefix read by
  K3; a retiring request's prompt blocks are adopted by the trie. As in
  the JAX paged engine, ``prefix_cache_blocks`` is only an enable flag:
  the trie's budget is the shared pool, so every positive value behaves
  the same.

Where the JAX engine builds new arrays, this one updates the cache and the
pool in place (no second allocation). It has no telemetry, journal,
scheduler, speculative decoding, chunked prefill or disaggregated roles,
and no gather-based reference route for the paged layout.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import resolve_device, \
    resolve_dtype
from copilot_for_consensus_tpu_torch.engine.faults import resolve_faults
from copilot_for_consensus_tpu_torch.engine.graphs import DecodeGraphs
from copilot_for_consensus_tpu_torch.engine.kv_pool import (
    BLOCK_TABLE_DTYPE,
    BlockPool,
)
from copilot_for_consensus_tpu_torch.engine.prefix_cache import PrefixCache
from copilot_for_consensus_tpu_torch.engine.sampling import (
    SamplingConfig,
    sample,
)
from copilot_for_consensus_tpu_torch.models import decoder, quant
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.ops.paged_attention import (
    paged_attention_partial,
)

#: the JAX engine's verify write margin at its default draft lengths
#: (longest draft 8, plus the bonus token). Its paged admission reserves
#: at least this much past a request's generation budget even with
#: speculative decoding off; reserving the same keeps both engines'
#: admission accounting — and so their waves and hit counts — equal.
_VERIFY_MARGIN = 9


@dataclass
class Request:
    request_id: int
    prompt: list[int]
    max_new_tokens: int
    #: leading prompt tokens the prefix cache may publish (None: all)
    cache_eligible_tokens: int | None = None
    submitted_at: float = field(default_factory=time.monotonic)
    decode_started_at: float = 0.0
    #: the prompt's block digests, computed once (``_req_digests``)
    block_digests: list | None = None
    #: the pipeline event that caused the request (error reports name it)
    correlation_id: str = ""
    #: the scheduler's keys (``engine/scheduler.py``), which the async
    #: runner carries into a replayed continuation; the port's engine
    #: has no scheduler yet, so they keep their defaults
    tenant: str = ""
    priority: str = ""
    deadline_at: float = float("inf")


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
        windows_per_dispatch: int = 1,
        admission_token_budget: int = 16384,
        prefill_chunk: int = 64,
        kv_pool_blocks: int = 0,
        prefix_cache_blocks: int = 0,
        faults=None,
        cuda_graphs: bool = True,
        device: str | torch.device | None = None,
    ):
        self.device = resolve_device(device)
        # Resilience hooks (the JAX engine's): ``faults`` installs the
        # seeded fault injector at every dispatch boundary; a supervisor
        # (attached by EngineSupervisor) gets watchdog and outcome
        # callbacks there and may lower ``_slot_cap``.
        self.faults = resolve_faults(faults)
        self.supervisor = None
        self._last_failed_kind = ""
        self._slot_cap = num_slots
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
        self.decode_window = max(1, decode_window)
        # How many windows one dispatch chains: more amortizes the host
        # sync over more steps at the cost of coarser retirement and
        # admission (the JAX engine's knob, default 1).
        self.windows_per_dispatch = max(1, windows_per_dispatch)
        # Prompt tokens one admission wave may prefill (rows × bucket).
        self.admission_token_budget = admission_token_budget
        self._dispatch_steps = self.decode_window * self.windows_per_dispatch
        if self.max_len - self._dispatch_steps < 1:
            raise ValueError(
                f"decode_window {self.decode_window} x "
                f"{self.windows_per_dispatch} windows/dispatch leaves no "
                f"prompt room in max_len {self.max_len}")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # quantize: False | True ("int8") | "int8" | "int4" (packed
        # nibbles with group scales: half the int8 weight bytes again)
        qmode = ("int8" if quantize is True else quantize) or None
        if qmode is not None and qmode not in quant.QUANT_MODES:
            raise ValueError(f"unknown quantize mode {qmode!r}")
        self.quant_mode = qmode
        if params is None:
            if qmode:
                params = quant.init_random_quantized(
                    cfg, seed=seed, dtype=self.dtype, device=self.device,
                    mode=qmode)
            else:
                params = decoder.init_params(cfg, seed=seed,
                                             dtype=self.dtype,
                                             device=self.device)
        params = _to_device(params, self.device)
        layers_t = params["layers"]
        if qmode and not quant.is_quantized(
                layers_t["wq"] if "wq" in layers_t else layers_t["wqkv"]):
            # full-precision weights given: quantize on the fly
            params = quant.quantize_params(params, mode=qmode)
        if qmode == "int4":
            # q/k/v and gate/up fused: 4 kernel calls a layer instead of
            # 7. The JAX engine fuses on a single TPU chip; the port
            # serves dense decoders on one card, so always.
            params = quant.fuse_int4_projections(params)
        self.params = params
        self.kv_dtype = self.dtype

        # ---- KV layout: the contiguous slot cache, or one block pool ------
        self.paged = bool(kv_pool_blocks)
        self.prefill_chunk = max(1, prefill_chunk)
        if prefix_cache_blocks and not self.paged:
            raise ValueError(
                "prefix_cache_blocks requires kv_pool_blocks: the port's "
                "prefix cache is the paged pool's radix trie (the "
                "contiguous engine's copy-publish cache is not ported)")
        if prefix_cache_blocks and cfg.sliding_window \
                and cfg.sliding_window < self.max_len:
            raise ValueError(
                "prefix_cache_blocks requires full attention: a reused "
                "prefix under a sliding window needs absolute-timeline "
                "window masking the seeded prefill does not implement")
        self._cache = None
        self._pool: BlockPool | None = None
        self._prefix: PrefixCache | None = None
        if self.paged:
            block = self.prefill_chunk
            if 128 % block:
                raise ValueError(
                    f"kv_pool_blocks requires prefill_chunk (the block "
                    f"size) to divide 128, got {block}: decode kv "
                    f"extents bucket to 128-aligned widths and every "
                    f"bucket must be block-aligned")
            if self.max_len % block:
                raise ValueError(
                    f"kv_pool_blocks requires max_len % prefill_chunk "
                    f"== 0, got {self.max_len} % {block}")
            self._block = block
            self._max_blocks = self.max_len // block
            #: furthest a dispatch writes past a slot's committed length
            self._write_margin = max(self._dispatch_steps, _VERIFY_MARGIN)
            if kv_pool_blocks < self._max_blocks + 1:
                raise ValueError(
                    f"kv_pool_blocks={kv_pool_blocks} cannot hold even "
                    f"one max_len={self.max_len} slot "
                    f"({self._max_blocks} blocks) plus one block")
            self._pool = BlockPool(cfg, num_blocks=kv_pool_blocks,
                                   block_size=block, kv_dtype=self.kv_dtype,
                                   device=self.device)
            #: slot → block table (pool ids; position p lives at
            #: table[p // block] offset p % block) and the index where
            #: OWNED blocks start (entries before it are BORROWED from the
            #: prefix trie, pinned through the request's PrefixMatch)
            self._tables: list[list[int]] = [[] for _ in range(num_slots)]
            self._owned_from: list[int] = [0] * num_slots
            #: seeded admissions that appended matched block ids (pointer
            #: hits) / all paged admissions / most slots active at once
            self.zero_copy_admits = 0
            self.paged_admits = 0
            self.peak_active = 0
            if prefix_cache_blocks:
                # an enable flag only: the trie's budget is the shared
                # pool's, so 1 and 8 behave the same
                self._prefix = PrefixCache(shared=self._pool)
        else:
            self._cache = decoder.init_cache(cfg, num_slots, self.max_len,
                                             dtype=self.kv_dtype,
                                             device=self.device)
        self._prefix_pins: dict[int, object] = {}  # request_id → match
        #: prompt tokens prefilled / skipped through prefix hits
        self.prefill_tokens = 0
        self.prefill_tokens_saved = 0

        # ---- host-side slot state ---------------------------------------
        self._free = list(range(num_slots))
        self._active: dict[int, Request] = {}          # slot → request
        self._generated: dict[int, list[int]] = {}     # slot → new tokens
        # Free slots park at position max_len (out of range): every
        # decode dispatch advances ALL rows, and the cache write drops
        # their out-of-range garbage KV.
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

        # ---- the decode dispatch's static buffers and its graphs --------
        # One CUDA stream carries every device op of the engine: eager
        # waves, warm-ups, captures and replays run on it in order.
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._static = self._static_buffers()
        self._graphs = DecodeGraphs(
            self.device, enabled=cuda_graphs, stream=self._stream,
            generators=(self._gen,) if sampling.temperature > 0 else ())

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path, *, dtype: str | torch.dtype =
                        torch.bfloat16, device: str | torch.device | None =
                        None, **engine_kw) -> "GenerationEngine":
        """An engine over a checkpoint directory: native (quantized
        offline, mapped) or HF safetensors (converted in memory). The
        quantize mode comes from the checkpoint's metadata ("int8",
        "int4" or none; True means int8), as do the EOS ids. Leaves go
        to ``device`` (None → the card) by ``params_from_numpy``'s rules:
        ``q`` and ``q4`` stay int8, ``scale`` f32, the rest ``dtype``."""
        from copilot_for_consensus_tpu_torch.checkpoint import (
            load_checkpoint,
        )
        from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
            params_from_numpy,
        )

        dtype = resolve_dtype(dtype)
        device = resolve_device(device)
        cfg, params, meta = load_checkpoint(
            path, dtype=str(dtype).removeprefix("torch."))
        engine_kw.setdefault("eos_id", meta.get("eos_ids",
                                                meta.get("eos_id", 2)))
        return cls(cfg, params_from_numpy(params, device, dtype),
                   dtype=dtype, device=device,
                   quantize=meta.get("quantized") or False, **engine_kw)

    @property
    def prompt_limit(self) -> int:
        """Longest prompt served without tail-truncation (one dispatch of
        cache headroom, capped by the largest prefill bucket)."""
        return min(self.max_len - self._dispatch_steps, self.buckets[-1])

    def submit(self, prompt: list[int], max_new_tokens: int = 256, *,
               cache_eligible_tokens: int | None = None,
               correlation_id: str = "") -> int:
        """Enqueue a tokenized prompt; returns a request id.
        ``cache_eligible_tokens`` caps how many leading prompt tokens the
        prefix cache may publish when the request retires (None: the
        whole block-aligned prompt). ``correlation_id`` names the
        pipeline event behind the request (the async runner's error
        reports and replays carry it)."""
        if not prompt:
            raise ValueError("empty prompt")
        limit = self.prompt_limit
        if len(prompt) > limit:
            # Keep the tail: instructions sit at the end of the prompt.
            prompt = prompt[-limit:]
            # the cap indexed the ORIGINAL prompt; its head is gone
            if cache_eligible_tokens is not None:
                cache_eligible_tokens = 0
        rid = self._next_id
        self._next_id += 1
        self._queue.append(Request(rid, list(prompt), max_new_tokens,
                                   cache_eligible_tokens,
                                   correlation_id=correlation_id))
        return rid

    def step(self) -> list[Completion]:
        """Admit queued requests into free slots, run one decode dispatch
        for all active slots, retire finished ones. Returns completions."""
        with self._on_stream():
            self._admit()
            if self.paged:
                self.peak_active = max(self.peak_active, len(self._active))
            if self._active:
                self._decode_once()
        return self._drain_done()

    def generate(self, prompts: list[list[int]],
                 max_new_tokens: int = 256, *,
                 cache_eligible_tokens: int | None = None
                 ) -> list[Completion]:
        """Batch convenience: submit all, run to completion, return in
        submission order."""
        ids = [self.submit(p, max_new_tokens,
                           cache_eligible_tokens=cache_eligible_tokens)
               for p in prompts]
        results: dict[int, Completion] = {}
        while len(results) < len(ids):
            for c in self.step():
                results[c.request_id] = c
        return [results[i] for i in ids]

    def prefix_stats(self) -> dict:
        """Prefix-cache counters (the JAX engine's keys): ``hit_rate`` is
        over admission lookups; ``prefill_tokens`` / ``..._saved`` count
        prompt tokens prefilled and skipped."""
        out = {"enabled": self._prefix is not None,
               "prefill_tokens": self.prefill_tokens,
               "prefill_tokens_saved": self.prefill_tokens_saved}
        if self._prefix is not None:
            st = self._prefix.stats.as_dict()
            out.update(st)
            out["hit_rate"] = (st["hits"] / st["lookups"]
                               if st["lookups"] else 0.0)
            out["blocks_in_use"] = self._prefix.node_count
        return out

    def kv_pool_stats(self) -> dict:
        """Paged-KV counters (the JAX engine's keys): the pool's books,
        internal fragmentation of the allocated blocks, and pointer hits
        over all paged admissions."""
        out = {"enabled": self.paged}
        if not self.paged:
            return out
        pool = self._pool
        out.update({
            "num_blocks": pool.num_blocks,
            "block_size": self._block,
            "free_blocks": pool.free_blocks,
            "blocks_in_use": pool.blocks_in_use,
            "pinned_blocks": pool.pinned_blocks,
            "fragmentation_ratio": round(
                pool.fragmentation(self._used_tokens()), 4),
            "zero_copy_admits": self.zero_copy_admits,
            "paged_admits": self.paged_admits,
            "zero_copy_hit_rate": (
                self.zero_copy_admits / self.paged_admits
                if self.paged_admits else 0.0),
            "peak_active": self.peak_active,
            "headroom_blocks": self._block_headroom(),
        })
        return out

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------

    def _req_digests(self, req: Request) -> list:
        if req.block_digests is None:
            req.block_digests = self._prefix.prompt_digests(req.prompt)
        return req.block_digests

    def _admit(self) -> None:
        """Admit every queued request a free slot can take, as ONE
        batched prefill over [N, bucket]: one pass over the weights, one
        KV write, one sample, one host fetch of the N first tokens.

        Paged engines admit a request only while its worst-case block
        footprint fits the pool's headroom, look its prompt up in the
        prefix trie (pinning the match), and budget the wave by SUFFIX
        tokens: the cached span is never prefilled."""
        if not (self._queue and self._free):
            return
        t0 = time.monotonic()
        batch: list[tuple[int, Request]] = []
        matches: list = []            # PrefixMatch | None, aligned w/ batch
        longest = 0
        headroom = self._block_headroom() if self.paged else 0
        # Cap a wave at 128 rows AND the prompt-token budget: prefill
        # scratch and activations scale with rows × bucket; and the slots
        # in use at the occupancy cap the resource breaker may lower.
        while (self._queue and self._free and len(batch) < 128
               and len(self._active) + len(batch) < self._slot_cap):
            head = self._queue[0]
            match_len = 0
            if self.paged:
                # the FULL worst case, borrowed prefix included: pinning
                # the matched blocks takes them out of the evictable
                # headroom this gate was computed against
                need = self._worst_blocks_total(head)
                if need > headroom:
                    break
                if self._prefix is not None:
                    match_len = self._prefix.match_tokens(
                        head.prompt, digests=self._req_digests(head))
            longest = max(longest, len(head.prompt) - match_len)
            if batch and (len(batch) + 1) * _next_bucket(
                    longest, self.buckets) > self.admission_token_budget:
                break
            m = None
            if self._prefix is not None:
                m = self._prefix.lookup(head.prompt,
                                        digests=self._req_digests(head))
                if m.tokens == 0:       # miss: nothing pinned
                    m = None
            if self.paged:
                headroom -= need
            batch.append((self._free.pop(0), self._queue.pop(0)))
            matches.append(m)
        if not batch:
            return                      # the pool cannot take the head
        plens = [len(req.prompt) for _, req in batch]
        suffix_lens = [plens[i] - (matches[i].tokens if matches[i] else 0)
                       for i in range(len(batch))]
        bucket = _next_bucket(max(suffix_lens), self.buckets)
        # Pad N to the next power of two; padded rows prefill garbage and
        # their KV is never written.
        n = 1
        while n < len(batch):
            n *= 2
        kind = "prefill_seeded" if any(matches) else "prefill"
        try:
            with self._dispatch_boundary(kind):
                if self.paged:
                    first = self._admit_wave_paged(batch, matches,
                                                   suffix_lens, bucket, n)
                else:
                    tokens = np.zeros((n, bucket), dtype=np.int64)
                    lengths = np.ones((n,), dtype=np.int64)
                    for i, (_slot, req) in enumerate(batch):
                        tokens[i, :plens[i]] = req.prompt
                        lengths[i] = plens[i]
                    first = self._admit_wave(tokens, lengths,
                                             [slot for slot, _ in batch])
        except Exception:
            # Lossless unwind (the JAX engine's): the wave's requests were
            # taken off the queue and the free list but never activated —
            # they go back to the queue's head in order, their slots and
            # freshly allocated blocks back to the free lists, their
            # lookup pins back to the trie. A failed wave costs a retry,
            # never a request.
            for i, (slot, _req) in enumerate(batch):
                self._free.append(slot)
                if self.paged:
                    self._paged_release_slot(slot)
                if matches[i] is not None:
                    self._prefix.release(matches[i])
            self._queue[0:0] = [req for _slot, req in batch]
            raise
        prefill_s = time.monotonic() - t0
        self.admitted_s += prefill_s
        self.prefill_tokens += sum(suffix_lens)
        self.prefill_tokens_saved += sum(m.tokens for m in matches if m)
        if self.paged:
            self.paged_admits += len(batch)
            self.zero_copy_admits += sum(1 for m in matches if m)
        now = time.monotonic()
        for i, (slot, req) in enumerate(batch):
            tok = int(first[i])
            if matches[i] is not None:
                # pinned until retirement: the blocks a slot reads must
                # not be evicted under it
                self._prefix_pins[req.request_id] = matches[i]
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

    @torch.inference_mode()
    def _admit_wave_paged(self, batch, matches, suffix_lens: list[int],
                          bucket: int, n: int) -> np.ndarray:
        """One paged admission wave. Each row's table is the matched block
        ids (borrowed, by pointer) plus freshly allocated blocks for the
        rest of its prompt. A miss wave is ``decoder.prefill`` (K1); a
        wave with any hit is ``prefill_seeded_paged``, which reads the
        matched prefixes in place with K3 (window 0). Either way the fresh
        suffix KV lands in the row's own blocks in one pool scatter."""
        dev = self.device
        tokens = np.zeros((n, bucket), dtype=np.int64)
        lengths = np.ones((n,), dtype=np.int64)
        rows = []
        for i, (slot, req) in enumerate(batch):
            tbl = list(matches[i].block_ids) if matches[i] else []
            self._owned_from[slot] = len(tbl)
            need = self._pool.blocks_for(len(req.prompt)) - len(tbl)
            if need > 0:
                tbl.extend(self._alloc_blocks(need))
            self._tables[slot] = tbl
            start = len(req.prompt) - suffix_lens[i]
            tokens[i, :suffix_lens[i]] = req.prompt[start:]
            lengths[i] = suffix_lens[i]
            rows.append((i, tbl, start, suffix_lens[i]))
        sbids, soffs = self._write_maps(rows, bucket, n)
        tokens_t = torch.from_numpy(tokens).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        if any(m is not None for m in matches):
            nb = 1
            while nb < max(len(m.block_ids) for m in matches if m):
                nb *= 2
            bids = np.full((n, nb), self._pool.num_blocks,
                           dtype=BLOCK_TABLE_DTYPE)
            # int32, as K3 takes it: no conversion in any layer
            pref = np.zeros((n,), dtype=np.int32)
            for i, m in enumerate(matches):
                if m is not None:
                    bids[i, :len(m.block_ids)] = m.block_ids
                    pref[i] = m.tokens
            tables = torch.from_numpy(bids).to(dev)
            pool = self._pool

            def partial_fn(li, q_rows, lns, q_pos):
                return paged_attention_partial(q_rows, pool.k, pool.v, li,
                                               tables, lns, q_pos, window=0)

            logits, k_new, v_new = decoder.prefill_seeded_paged(
                self.params, tokens_t, lengths_t,
                torch.from_numpy(pref).to(dev), self.cfg, partial_fn)
        else:
            scratch = decoder.init_cache(self.cfg, n, bucket,
                                         dtype=self.kv_dtype, device=dev)
            logits, scratch = decoder.prefill(self.params, tokens_t,
                                              lengths_t, self.cfg, scratch)
            k_new, v_new = scratch["k"], scratch["v"]
        self._pool.scatter(k_new, v_new, sbids, soffs)
        first = sample(logits[:len(batch)], self._gen, self.sampling)
        return first.cpu().numpy()                 # the ONE host sync

    # ------------------------------------------------------------------
    # paged KV host plumbing
    # ------------------------------------------------------------------

    def _worst_blocks_total(self, req: Request) -> int:
        """Most blocks this request's slot can ever hold (borrowed +
        owned): prompt, generation budget and write margin, capped at
        the cache ceiling. Admission reserves this much headroom per
        request, which makes mid-decode pool exhaustion unreachable."""
        span = min(len(req.prompt) + req.max_new_tokens
                   + self._write_margin, self.max_len)
        return self._pool.blocks_for(span)

    def _block_headroom(self) -> int:
        """Free + trie-evictable blocks minus what admitted work may
        still allocate."""
        need = sum(max(0, self._worst_blocks_total(req)
                       - len(self._tables[slot]))
                   for slot, req in self._active.items())
        evictable = self._prefix.evictable_blocks \
            if self._prefix is not None else 0
        return self._pool.free_blocks + evictable - need

    def _alloc_blocks(self, n: int) -> list[int]:
        """Allocate ``n`` pool blocks, first reclaiming idle prefix-trie
        leaves when the free list runs short."""
        free = self._pool.free_blocks
        if n > free and self._prefix is not None:
            self._prefix.reclaim(n - free)
        return self._pool.alloc(n)

    def _ensure_blocks(self, slot: int, upto: int) -> None:
        """Grow the slot's table to cover positions [0, upto)."""
        tbl = self._tables[slot]
        need = self._pool.blocks_for(upto) - len(tbl)
        if need > 0:
            tbl.extend(self._alloc_blocks(need))

    def _paged_release_slot(self, slot: int, keep=frozenset()) -> None:
        """Return the slot's OWNED blocks to the pool (minus any the trie
        adopted) and clear its table. Borrowed entries are the trie's;
        the request's match release hands them back."""
        tbl = self._tables[slot]
        owned = [b for b in tbl[self._owned_from[slot]:] if b not in keep]
        if owned:
            self._pool.free(owned)
        self._tables[slot] = []
        self._owned_from[slot] = 0

    def _gather_bids(self, width_tokens: int) -> np.ndarray:
        """[num_slots, width/block] block-id map for a read of
        ``width_tokens`` columns per slot; rows pad with the sentinel past
        their table (clamped by K3, masked by the slot's length)."""
        nb = -(-width_tokens // self._block)
        arr = np.full((self.num_slots, nb), self._pool.num_blocks,
                      dtype=BLOCK_TABLE_DTYPE)
        for s in range(self.num_slots):
            tbl = self._tables[s][:nb]
            arr[s, :len(tbl)] = tbl
        return arr

    def _write_maps(self, rows, width: int, n_rows: int):
        """Per-(row, column) pool write maps for one dispatch: ``rows`` is
        ``[(row_idx, table, start_pos, n_valid)]``; column j of a row
        targets block ``table[(start+j) // block]`` offset
        ``(start+j) % block`` for j < n_valid. Everything else — padding,
        rows without a request, columns at or past ``max_len`` — carries
        the sentinel id and is dropped by the scatter."""
        bids = np.full((n_rows, width), self._pool.num_blocks,
                       dtype=BLOCK_TABLE_DTYPE)
        offs = np.zeros((n_rows, width), dtype=BLOCK_TABLE_DTYPE)
        for idx, tbl, start, n_valid in rows:
            n = min(n_valid, width, self.max_len - start)
            if n <= 0:
                continue
            pos = start + np.arange(n)
            bids[idx, :n] = np.asarray(tbl, dtype=BLOCK_TABLE_DTYPE)[
                pos // self._block]
            offs[idx, :n] = pos % self._block
        return bids, offs

    def _used_tokens(self) -> int:
        """Live positions in the pool: committed slot timelines minus
        their borrowed spans (counted once, as trie nodes), plus the
        published blocks (always full)."""
        used = sum(int(self._positions[s])
                   - self._owned_from[s] * self._block
                   for s in self._active)
        if self._prefix is not None:
            used += self._prefix.node_count * self._block
        return used

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _kv_bucket(self) -> int:
        """Attention extent for the next decode dispatch: the occupied
        cache prefix rounded up to 128. The dispatch's own fresh KV lives
        in the window buffers until the write, so the extent covers only
        what was in the cache BEFORE the dispatch."""
        hi = max([int(self._positions[s]) for s in self._active] + [0])
        return self._kv_extent(hi)

    def _kv_extent(self, hi: int) -> int:
        """The kv bucket of an occupied extent ``hi``: rounded up to 128,
        snapped to the whole cache near it (one graph per bucket)."""
        if hi == 0:
            return min(128, self.max_len)
        bucket = min(-(-(hi + 1) // 128) * 128, self.max_len)
        # Near the full extent the shorter read saves little; snap to the
        # whole cache (the JAX engine's rule, kept for identical reads).
        if bucket * 8 >= self.max_len * 7:
            return self.max_len
        return bucket

    def _static_buffers(self) -> dict:
        """The decode dispatch's static buffers, made once: its inputs
        (``tok``, ``pos`` — int32 on the paged engine, as K3 takes it — and,
        paged, one flat ``tables`` buffer viewed [slots, nb] per bucket,
        the write maps ``wbids``/``woffs`` and the write-back position
        ``back``), the window buffers [L, slots, Hkv, steps, Dh] and the
        output tokens [steps, slots]. A graph captured at a bucket keeps
        their addresses, so they live as long as the engine."""
        cfg, b, steps = self.cfg, self.num_slots, self._dispatch_steps
        dev = self.device
        win = (cfg.n_layers, b, cfg.n_kv_heads, steps, cfg.head_dim)
        i32 = dict(dtype=torch.int32, device=dev)
        st = {"tok": torch.zeros(b, dtype=torch.int64, device=dev),
              "pos": torch.zeros(b, dtype=torch.int32 if self.paged
                                 else torch.int64, device=dev),
              "k_win": torch.zeros(win, dtype=self.kv_dtype, device=dev),
              "v_win": torch.zeros(win, dtype=self.kv_dtype, device=dev),
              "out": torch.zeros((steps, b), dtype=torch.int64, device=dev)}
        if self.paged:
            st.update(tables=torch.zeros(b * self._max_blocks, **i32),
                      wbids=torch.zeros((b, steps), **i32),
                      woffs=torch.zeros((b, steps), **i32),
                      back=torch.zeros(2, **i32))
        return st

    @torch.inference_mode()
    def _decode_body(self, kv_len: int) -> None:
        """The decode dispatch a graph holds: ``windows_per_dispatch``
        windows of ``decode_window`` steps — decode → sample → feed back —
        then one write of the dispatch's KV into the cache or the pool.

        It reads only the static buffers and writes the window buffers,
        the output tokens and the cache or pool; nothing it allocates
        outlives it and nothing reaches the host. The window buffers are
        zeroed first, so the current window's unwritten columns are zero,
        as in the JAX engine's fresh window; the completed windows of the
        dispatch ride as the done piece. Paged: every step scores
        ``tables[:, :kv_len // block]`` in place with K3 (window = the
        model's sliding window), and the pool write drops the maps'
        sentinel on the device (``BlockPool.scatter_static``)."""
        cfg, st, w_sz = self.cfg, self._static, self.decode_window
        k_all, v_all = st["k_win"], st["v_win"]
        k_all.zero_()
        v_all.zero_()
        positions = st["pos"]
        if self.paged:
            nb = kv_len // self._block
            tables = st["tables"][:self.num_slots * nb].view(
                self.num_slots, nb)
            pool = self._pool

            def partial_fn(li, q_rows, lengths, q_pos):
                return paged_attention_partial(
                    q_rows, pool.k, pool.v, li, tables, lengths, q_pos,
                    window=cfg.sliding_window)

            def step(tok, w, k_win, v_win, k_done, v_done):
                return decoder.decode_step_windowed_paged(
                    self.params, tok, positions, w, cfg, partial_fn, k_win,
                    v_win, k_done=k_done, v_done=v_done)
        else:
            def step(tok, w, k_win, v_win, k_done, v_done):
                return decoder.decode_step_windowed(
                    self.params, tok, positions, w, cfg, self._cache, k_win,
                    v_win, kv_len=kv_len, k_done=k_done, v_done=v_done)
        tok = st["tok"]
        for widx in range(self.windows_per_dispatch):
            off = widx * w_sz
            k_win = k_all[:, :, :, off:off + w_sz]
            v_win = v_all[:, :, :, off:off + w_sz]
            done = (k_all[:, :, :, :off], v_all[:, :, :, :off]) if off \
                else (None, None)
            for w in range(w_sz):
                logits, k_cols, v_cols = step(tok, w, k_win, v_win, *done)
                k_win[:, :, :, w] = k_cols
                v_win[:, :, :, w] = v_cols
                tok = sample(logits, self._gen, self.sampling)
                st["out"][off + w] = tok
        if self.paged:
            pool.scatter_static(k_all, v_all, st["wbids"], st["woffs"],
                                st["back"])
        else:
            decoder.merge_window(self._cache, k_all, v_all, positions,
                                 steps=self._dispatch_steps)

    def _write_back(self) -> np.ndarray:
        """Where the paged dispatch's pool write sends (and writes back)
        its dropped entries: an active slot's last committed position,
        below every position the dispatch writes."""
        slot = next(iter(self._active))
        p = int(self._positions[slot]) - 1
        return np.array([self._tables[slot][p // self._block],
                         p % self._block], dtype=np.int32)

    def _decode_dispatch(self, kv_len: int) -> np.ndarray:
        """One decode dispatch at bucket ``kv_len``: the host copies the
        dispatch's inputs into the static buffers, the body runs (on the
        card, a replay of the bucket's graph once it was captured), and
        one device-to-host fetch brings its tokens back: [steps, slots]."""
        st, steps = self._static, self._dispatch_steps
        st["tok"].copy_(torch.from_numpy(self._next_tok))
        if self.paged:
            st["pos"].copy_(torch.from_numpy(
                self._positions.astype(np.int32)))
            for slot in self._active:
                self._ensure_blocks(slot, int(self._positions[slot]) + steps)
            rows = [(s, self._tables[s], int(self._positions[s]), steps)
                    for s in self._active]
            sbids, soffs = self._write_maps(rows, steps, self.num_slots)
            st["wbids"].copy_(torch.from_numpy(sbids))
            st["woffs"].copy_(torch.from_numpy(soffs))
            st["back"].copy_(torch.from_numpy(self._write_back()))
            # K3 reads the first kv_len // block entries of each row (the
            # JAX engine's kernel route slices its wider gather so too)
            nb = kv_len // self._block
            st["tables"][:self.num_slots * nb].copy_(
                torch.from_numpy(self._gather_bids(kv_len).reshape(-1)))
        else:
            st["pos"].copy_(torch.from_numpy(self._positions))
        key = self._graph_key(kv_len)
        self._graphs.run(key, lambda: self._decode_body(kv_len),
                         family=key[1])
        return st["out"].cpu().numpy()

    def _graph_key(self, kv_len: int) -> tuple:
        """What a decode graph is captured for: the kv bucket, and the
        activation-quantization mode (``quant.set_act_quant``), which
        picks each matmul's kernel when the body is captured — the
        family one eager warm-up covers."""
        return kv_len, quant.act_quant_mode()

    def _decode_once(self) -> None:
        window = self._dispatch_steps
        active_before = list(self._active.items())
        t0 = time.monotonic()
        try:
            with self._dispatch_boundary("decode"):
                toks = self._decode_dispatch(self._kv_bucket())
        except Exception:
            # A failed dispatch leaves nothing a graph can trust: drop
            # them all. With a supervisor attached, capture again only
            # once it has repaired the engine (``on_repaired``).
            self._graphs.drop(block=self.supervisor is not None)
            raise
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
            # Keep a full dispatch of cache headroom: the next dispatch
            # writes positions [pos, pos+steps).
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
        if self.paged:
            adopted: set[int] | frozenset = frozenset()
            if self._prefix is not None:
                # publish by refcount handoff: the trie adopts the slot's
                # own prompt-prefix blocks; then the request's match pins
                # go back
                adopted = self._prefix.adopt_blocks(
                    req.prompt, self._tables[slot], self._owned_from[slot],
                    eligible_tokens=req.cache_eligible_tokens)
                m = self._prefix_pins.pop(req.request_id, None)
                if m is not None:
                    self._prefix.release(m)
            # tail blocks (generated-token KV, unpublished prompt tail)
            # go straight back to the allocator
            self._paged_release_slot(slot, keep=adopted)
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

    # ------------------------------------------------------------------
    # supervisor hooks, streams, graphs
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _dispatch_boundary(self, kind: str):
        """The host-side boundary every admission wave and decode dispatch
        runs under (the JAX engine's): the fault plane's injection point,
        strictly before any device work, and the supervisor's watchdog and
        outcome surface. A failure records its kind, so containment can
        classify it without parsing tracebacks."""
        sup = self.supervisor
        if sup is not None:
            sup.begin_dispatch(kind)
        try:
            if self.faults is not None:
                self.faults.check(kind)
            yield
            if sup is not None:
                sup.on_dispatch_ok(kind)
        except Exception as exc:
            self._last_failed_kind = kind
            if sup is not None:
                sup.on_dispatch_error(kind, exc)
            raise
        finally:
            if sup is not None:
                sup.end_dispatch(kind)

    def set_slot_cap(self, cap: int) -> None:
        """Occupancy cap (≤ num_slots): admission stops filling slots past
        it. The supervisor's resource breaker lowers it after repeated
        device resource exhaustion and raises it again by half-open
        probes; active slots above a lowered cap drain naturally."""
        self._slot_cap = max(1, min(self.num_slots, int(cap)))

    def on_repaired(self) -> None:
        """The supervisor repaired the engine's host state (a repairing
        audit): the decode graphs dropped after a failed dispatch may be
        captured again."""
        self._graphs.release()

    def graph_stats(self) -> dict:
        """The decode graphs' counters: graphs held, captured, seconds
        spent capturing, replays, and dispatches that ran eagerly."""
        return self._graphs.stats()

    @contextlib.contextmanager
    def _on_stream(self):
        """Run the enclosed device work on the engine's stream, after what
        the caller's stream holds and before what it enqueues next."""
        if self._stream is None:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(caller)
        try:
            with torch.cuda.stream(self._stream):
                yield
        finally:
            caller.wait_stream(self._stream)
