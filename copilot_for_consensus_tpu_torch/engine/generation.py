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

The reference engine's control plane:

* **Telemetry** (``telemetry=True``, the default; ``engine/telemetry.py``):
  request spans, a flight recorder of every wave and dispatch, and the
  ``copilot_engine_*`` series. Every number it records is host state read
  after a dispatch's one device-to-host fetch: nothing of it lives in the
  captured dispatch body, and it adds no sync.
* **Deadlines** (``submit(deadline_s=)``): expired work is dropped at the
  head of ``step`` — queued requests uncomputed, active slots retired with
  their partial output — with ``finish_reason="deadline"``.
* **The request journal** (``journal=``, ``engine/journal.py``): submits
  are journaled before they queue, accepted tokens checkpoint every
  ``checkpoint_every`` steps, rows retire at harvest, and an engine built
  over a non-empty journal warm-restarts its unfinished requests as
  prompt + generated continuations.
* **KV dtype** (``kv_dtype=``): the cache, the pool and the window buffers
  may be held below the activation dtype (``float8_e4m3fn`` halves the KV
  bytes); KV is cast on write and read up to the compute dtype. On the
  paged route K3 reads an fp8 pool in place through its CUDA-core body.
* ``tenant`` and ``priority`` are carried on each request (journal rows,
  replays); the scheduler that would act on them is not ported yet, and
  ``scheduler=`` is refused.

Where the JAX engine builds new arrays, this one updates the cache and the
pool in place (no second allocation). It has no scheduler, speculative
decoding, chunked prefill or disaggregated roles, and no gather-based
reference route for the paged layout.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from copilot_for_consensus_tpu_torch.device import (
    resolve_device,
    resolve_dtype,
    storage_view,
    zeros,
)
from copilot_for_consensus_tpu_torch.engine.faults import (
    InjectedFault,
    resolve_faults,
)
from copilot_for_consensus_tpu_torch.engine.graphs import DecodeGraphs
from copilot_for_consensus_tpu_torch.engine.journal import resolve_journal
from copilot_for_consensus_tpu_torch.engine.kv_pool import (
    BLOCK_TABLE_DTYPE,
    BlockPool,
)
from copilot_for_consensus_tpu_torch.engine.prefix_cache import PrefixCache
from copilot_for_consensus_tpu_torch.engine.sampling import (
    SamplingConfig,
    sample,
)
from copilot_for_consensus_tpu_torch.engine.telemetry import (
    resolve_telemetry,
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
    #: the pipeline event that caused the request (telemetry spans and
    #: error reports name it)
    correlation_id: str = ""
    #: the scheduling identity (the JAX engine's defaults): the tenant
    #: ("" = the anonymous tenant) and the priority lane. The port has no
    #: scheduler yet; journal rows and replays carry them.
    tenant: str = ""
    priority: str = "interactive"
    #: absolute monotonic deadline: expired work is dropped
    #: (``finish_reason="deadline"``), never computed. inf = none.
    deadline_at: float = float("inf")


@dataclass
class Completion:
    request_id: int
    prompt_len: int
    tokens: list[int]
    finish_reason: str            # "eos" | "length" | "deadline"
    prefill_s: float = 0.0
    decode_s: float = 0.0
    #: submit → first token on the host
    ttft_s: float = 0.0


def _next_bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


#: the JAX engine's KV dtype names
_KV_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float8_e4m3fn": torch.float8_e4m3fn,
    "float8_e5m2": torch.float8_e5m2,
}


def resolve_kv_dtype(kv_dtype, default: torch.dtype) -> torch.dtype:
    """The KV cache dtype from a name (config strings included) or a torch
    dtype; None or "" (the schema default) keeps ``default``, the
    activation dtype. An unknown name fails here with the valid set."""
    if not kv_dtype:
        return default
    if isinstance(kv_dtype, str):
        try:
            return _KV_DTYPES[kv_dtype]
        except KeyError:
            raise ValueError(
                f"unknown kv_dtype {kv_dtype!r}; one of "
                f"{sorted(_KV_DTYPES)}") from None
    if kv_dtype not in _KV_DTYPES.values():
        raise ValueError(f"unsupported kv_dtype {kv_dtype}; one of "
                         f"{sorted(_KV_DTYPES)}")
    return kv_dtype


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
        kv_dtype: str | torch.dtype | None = None,
        quantize: bool | str = False,
        decode_window: int = 8,
        windows_per_dispatch: int = 1,
        admission_token_budget: int = 16384,
        prefill_chunk: int = 64,
        kv_pool_blocks: int = 0,
        prefix_cache_blocks: int = 0,
        faults=None,
        cuda_graphs: bool = True,
        telemetry=True,
        scheduler=None,
        journal=None,
        device: str | torch.device | None = None,
    ):
        if scheduler is not None:
            raise NotImplementedError(
                "scheduler=: the port's engine has no scheduler yet; it "
                "comes in the next slice with chunked prefill and "
                "spec-decode verify over decoder.verify_seeded (ROADMAP "
                "Queue 1 item 4)")
        self.device = resolve_device(device)
        # Resilience hooks (the JAX engine's): ``faults`` installs the
        # seeded fault injector at every dispatch boundary; a supervisor
        # (attached by EngineSupervisor) gets watchdog and outcome
        # callbacks there and may lower ``_slot_cap``.
        self.faults = resolve_faults(faults)
        self.supervisor = None
        self._last_failed_kind = ""
        self._slot_cap = num_slots
        # The durable request journal (the JAX engine's): submits journal
        # before they queue, accepted tokens checkpoint incrementally,
        # retire deletes at harvest; a non-empty journal at construction
        # warm-restarts (``_recover_from_journal``, last in __init__).
        self.journal = resolve_journal(journal)
        #: journal rows resubmitted at warm restart in this process
        self.journal_replayed = 0
        #: journal rows that could not be resumed (continuation past
        #: ``prompt_limit``): counted, never silent
        self.journal_abandoned = 0
        #: (new rid, correlation_id) of each row recovered at construction
        self.journal_recovered: list[tuple[int, str]] = []
        #: rid → (original prompt_len, resumed token prefix), stitched back
        #: onto the continuation's completion at harvest
        self._journal_stitch: dict[int, tuple[int, list[int]]] = {}
        #: rid → generated-token count at the last checkpoint (lag gauge)
        self._journal_ckpt: dict[int, int] = {}
        self._journal_steps = 0
        #: True while a resubmission's row comes from the journal's atomic
        #: ``supersede`` re-key instead of ``record_submit``
        self._journal_suppress = False
        #: requests dropped uncomputed because their deadline passed
        self.deadline_expired = 0
        #: set by the first submit with a deadline: engines that never see
        #: one skip the per-step expiry walk
        self._deadlines_in_use = False
        # Flight recorder, request spans and the copilot_engine_* series
        # (default on, as in the JAX engine): host bookkeeping around the
        # dispatches' own host syncs. False disables; an EngineTelemetry
        # or a MetricsCollector shares a collector.
        self.telemetry = resolve_telemetry(telemetry, engine="generation",
                                           num_slots=num_slots)
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
        # A KV dtype below the activation dtype (float8_e4m3fn halves the
        # cache bytes); None keeps the activation dtype
        self.kv_dtype = resolve_kv_dtype(kv_dtype, self.dtype)

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
            #: the paged route's label on every StepRecord and the
            #: copilot_engine_kv_route gauge: the port always reads the
            #: pool in place with K3 (the JAX engine's "kernel" route)
            self._kv_route = "kernel"
            if self.telemetry is not None:
                self.telemetry.gauge_kv_route(self._kv_route)
        else:
            self._kv_route = ""
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

        # Warm restart last: every queue and slot structure above must
        # exist before recovered requests resubmit through submit().
        if self.journal is not None and self.journal.depth():
            self._recover_from_journal()

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
        ``q`` and ``q4`` stay int8, ``scale`` f32, the rest ``dtype``.
        ``engine_kw`` reaches the engine (``kv_dtype=``, ``journal=`` and
        the rest): a journal with rows warm-restarts here."""
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
               correlation_id: str = "", tenant: str = "",
               priority: str = "interactive",
               deadline_s: float | None = None) -> int:
        """Enqueue a tokenized prompt; returns a request id.
        ``cache_eligible_tokens`` caps how many leading prompt tokens the
        prefix cache may publish when the request retires (None: the
        whole block-aligned prompt). ``correlation_id`` names the
        pipeline event behind the request (its telemetry span, the async
        runner's error reports and replays carry it). ``tenant`` and
        ``priority`` are the request's scheduling identity, journaled and
        carried into replays. ``deadline_s`` is the request's wall-clock
        budget: once it expires the request is dropped (queued) or retired
        with its partial output (active), both with
        ``finish_reason="deadline"``."""
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
        if self.journal is not None:
            if not self._journal_suppress:
                # Journal BEFORE the request enters the queue: no window
                # where admitted work is journal-invisible. A warm
                # restart's continuation takes its row by the atomic
                # supersede re-key instead, never insert-then-re-key.
                from copilot_for_consensus_tpu_torch.obs import (
                    trace as _trace,
                )

                ids = _trace.current_ids()
                self.journal.record_submit(
                    rid, prompt, max_new_tokens,
                    cache_eligible_tokens=cache_eligible_tokens,
                    correlation_id=correlation_id, tenant=tenant,
                    priority=priority,
                    deadline_wall=(time.time() + max(0.0, deadline_s)
                                   if deadline_s is not None else 0.0),
                    trace_id=ids[0] if ids else "",
                    span_id=ids[1] if ids else "")
            self._journal_ckpt[rid] = 0
        if deadline_s is not None:
            self._deadlines_in_use = True
        self._queue.append(Request(
            rid, list(prompt), max_new_tokens, cache_eligible_tokens,
            correlation_id=correlation_id, tenant=tenant,
            priority=priority,
            deadline_at=(time.monotonic() + max(0.0, deadline_s)
                         if deadline_s is not None else float("inf"))))
        if self.telemetry is not None:
            self.telemetry.on_submit(rid, len(prompt), correlation_id)
        return rid

    def step(self) -> list[Completion]:
        """Drop expired work, admit queued requests into free slots, run
        one decode dispatch for all active slots, retire finished ones.
        Returns completions."""
        with self._on_stream():
            self._expire_deadlines()
            self._admit()
            if self.paged:
                self.peak_active = max(self.peak_active, len(self._active))
            if self._active:
                self._decode_once()
        if self.journal is not None:
            self._journal_tick()
        if self.telemetry is not None:
            self.telemetry.gauge_queue(self.queue_depth, len(self._active))
            if self.paged:
                # straight off the pool's counters: kv_pool_stats() walks
                # the active slots and the trie, too heavy for every step
                self.telemetry.gauge_kv_pool(
                    self._pool.free_blocks, self._pool.pinned_blocks,
                    round(self._pool.fragmentation(
                        self._used_tokens()), 4))
        return self._drain_done()

    def generate(self, prompts: list[list[int]],
                 max_new_tokens: int = 256, *,
                 cache_eligible_tokens: int | None = None
                 ) -> list[Completion]:
        """Batch convenience: submit all, run to completion, return in
        submission order. A failure dumps the flight recorder (the
        requests in flight and the last dispatches) before it raises."""
        ids = [self.submit(p, max_new_tokens,
                           cache_eligible_tokens=cache_eligible_tokens)
               for p in prompts]
        results: dict[int, Completion] = {}
        try:
            while len(results) < len(ids):
                for c in self.step():
                    results[c.request_id] = c
        except Exception as exc:
            if self.telemetry is not None:
                self.telemetry.record_error(exc)
            raise
        return [results[i] for i in ids]

    def journal_stats(self) -> dict:
        """Journal counters (the JAX engine's keys): ``replayed`` counts
        this process's warm-restart resubmissions, ``abandoned`` the rows
        that could not be resumed; the rest come from the journal."""
        out = {"enabled": self.journal is not None,
               "replayed": self.journal_replayed,
               "abandoned": self.journal_abandoned}
        if self.journal is not None:
            st = self.journal.stats()
            for key in ("depth", "journaled", "retired", "checkpoints"):
                out[key] = st[key]
        return out

    def sched_stats(self) -> dict:
        """Scheduler counters in the JAX engine's disabled form: the port
        has no scheduler and no chunked prefill yet."""
        return {"enabled": False, "chunk_dispatches": 0,
                "chunk_prefill_tokens": 0}

    @property
    def queue_depth(self) -> int:
        """Requests submitted and not yet admitted."""
        return len(self._queue)

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
        seq = self.telemetry.next_step() if self.telemetry is not None \
            else None
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
        if self.telemetry is not None:
            self.telemetry.record_step(
                kind, prefill_s, seq=seq, rows=len(batch), batch=n,
                tokens=sum(suffix_lens), padded_tokens=n * bucket,
                route=self._kv_route)
        self.prefill_tokens += sum(suffix_lens)
        self.prefill_tokens_saved += sum(m.tokens for m in matches if m)
        if self.paged:
            self.paged_admits += len(batch)
            hits = sum(1 for m in matches if m)
            self.zero_copy_admits += hits
            if hits and self.telemetry is not None:
                self.telemetry.on_zero_copy_admits(hits)
        now = time.monotonic()
        for i, (slot, req) in enumerate(batch):
            tok = int(first[i])
            if matches[i] is not None:
                # pinned until retirement: the blocks a slot reads must
                # not be evicted under it
                self._prefix_pins[req.request_id] = matches[i]
            if self.telemetry is not None:
                self.telemetry.on_admit(
                    req.request_id, wave_start=t0,
                    admit_kind="seeded" if matches[i] is not None
                    else "wave",
                    prefix_hit_tokens=(matches[i].tokens
                                       if matches[i] is not None else 0))
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
            # fp8 caches move as bytes: index_put_ has no float8 kernel
            storage_view(self._cache[name])[:, sl, :, :bucket] = \
                storage_view(scratch[name][:, :rows])
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
              "k_win": zeros(win, self.kv_dtype, dev),
              "v_win": zeros(win, self.kv_dtype, dev),
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
        storage_view(k_all).zero_()
        storage_view(v_all).zero_()
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
        seq = self.telemetry.next_step() if self.telemetry is not None \
            else None
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
        step_s = time.monotonic() - t0
        self.decode_s += step_s
        harvested_total = 0
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
            harvested_total += len(gen) - harvested0
            self._positions[slot] += window
            self._next_tok[slot] = int(toks[window - 1, slot])
            # Keep a full dispatch of cache headroom: the next dispatch
            # writes positions [pos, pos+steps).
            if (finished is None
                    and self._positions[slot] + window > self.max_len - 1):
                finished = "length"
            if finished:
                self._retire(slot, finished)
        self.decode_tokens += harvested_total
        if self.telemetry is not None:
            # host numbers only, read after the dispatch's one fetch: the
            # captured body records nothing
            self.telemetry.record_step(
                "decode", step_s, seq=seq, rows=len(active_before),
                batch=self.num_slots, tokens=harvested_total,
                padded_tokens=window * self.num_slots, route=self._kv_route)

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
        if self.telemetry is not None:
            self.telemetry.on_retire(req.request_id, new_tokens=len(gen),
                                     finish_reason=reason)
            # the ledgers are cumulative engine-wide counters: exported at
            # retire cadence, not every step
            self.telemetry.update_ledgers(
                self.prefix_stats() if self._prefix is not None else None,
                None)
        self._free.append(slot)

    def _expire_deadlines(self) -> None:
        """Drop every request whose ``deadline_at`` has passed — queued
        work uncomputed (an empty completion), active slots retired with
        their partial output — all with ``finish_reason="deadline"``. It
        runs at the head of ``step``, between dispatches, so a retired
        slot parks exactly as an eos or length retirement parks it: the
        next dispatch's static buffers are filled from host state that no
        longer holds it, and its pool blocks are back in the pool."""
        if not self._deadlines_in_use:
            return    # no deadline ever submitted: skip the queue walk
        now = time.monotonic()
        expired = [r for r in self._queue if r.deadline_at <= now]
        if expired:
            self._queue = [r for r in self._queue if r.deadline_at > now]
        for req in expired:
            self.deadline_expired += 1
            self._done[req.request_id] = Completion(
                request_id=req.request_id, prompt_len=len(req.prompt),
                tokens=[], finish_reason="deadline")
            if self.telemetry is not None:
                self.telemetry.on_deadline_expired()
                self.telemetry.on_retire(req.request_id, new_tokens=0,
                                         finish_reason="deadline")
        # active slots: retire with what was accepted so far (the partial
        # output is real work; only future compute is dropped)
        for slot, req in list(self._active.items()):
            if req.deadline_at <= now:
                self.deadline_expired += 1
                if self.telemetry is not None:
                    self.telemetry.on_deadline_expired()
                self._retire(slot, "deadline")

    # ------------------------------------------------------------------
    # the request journal
    # ------------------------------------------------------------------

    def _journal_tick(self) -> None:
        """Incremental token checkpoints: every ``checkpoint_every``
        steps, and on any step that retired a request (the surviving
        slots' progress is durable before the finished rows delete). Also
        exports the journal gauges."""
        j = self.journal
        self._journal_steps += 1
        if self._active and (self._done
                             or self._journal_steps >= j.checkpoint_every):
            self._journal_steps = 0
            pairs = []
            for slot, req in self._active.items():
                gen = self._generated.get(slot)
                if gen:
                    pairs.append((req.request_id, gen))
                    self._journal_ckpt[req.request_id] = len(gen)
            if pairs:
                j.checkpoint_many(pairs)
        if self.telemetry is not None:
            lag = 0
            for slot, req in self._active.items():
                gen = self._generated.get(slot)
                if gen:
                    lag = max(lag, len(gen) - self._journal_ckpt.get(
                        req.request_id, 0))
            self.telemetry.gauge_journal(j.depth(), lag)

    def _drain_done(self) -> list[Completion]:
        out = []
        for c in self._done.values():
            st = self._journal_stitch.pop(c.request_id, None)
            if st is not None:
                # a recovered continuation goes back onto its original
                # identity: the original prompt length and the whole
                # token stream
                plen, prefix = st
                c = Completion(
                    request_id=c.request_id, prompt_len=plen,
                    tokens=prefix + c.tokens,
                    finish_reason=c.finish_reason, prefill_s=c.prefill_s,
                    decode_s=c.decode_s, ttft_s=c.ttft_s)
            out.append(c)
        if self.journal is not None and out:
            # Retire at harvest: the row leaves the journal in the step()
            # call that returns the completion. A kill inside this window
            # replays the request (at least once; the pipeline supersedes).
            for c in out:
                self.journal.record_retire(c.request_id)
                self._journal_ckpt.pop(c.request_id, None)
        self._done.clear()
        return out

    def _recover_from_journal(self) -> int:
        """Warm restart (at construction, one owner): resubmit every
        unfinished journaled request as a prompt + generated continuation
        through ``submit`` (telemetry spans rebuild as a side effect) and
        re-key its row onto the continuation's id. A request whose
        wall-clock deadline passed during the outage completes as a
        ``finish_reason="deadline"`` drop; a row already fully generated
        is emitted without compute; a continuation past ``prompt_limit``
        is abandoned (counted), never head-truncated into divergence."""
        from copilot_for_consensus_tpu_torch.obs import trace as _trace

        entries = self.journal.unfinished()
        if not entries:
            return 0
        # continuation ids must never collide with journaled ids, or the
        # re-key and the retire would hit the wrong row
        self._next_id = max(self._next_id,
                            max(e.request_id for e in entries) + 1)
        now_wall = time.time()
        self._journal_suppress = True
        try:
            for e in entries:
                done = min(len(e.tokens), e.max_new_tokens)
                remaining = e.max_new_tokens - done
                if e.deadline_wall and e.deadline_wall <= now_wall:
                    self.deadline_expired += 1
                    self._done[e.request_id] = Completion(
                        request_id=e.request_id, prompt_len=len(e.prompt),
                        tokens=list(e.tokens)[:done],
                        finish_reason="deadline")
                    continue
                if remaining <= 0:
                    # fully generated before the crash (between the last
                    # checkpoint and the retire): emit, don't recompute
                    self._done[e.request_id] = Completion(
                        request_id=e.request_id, prompt_len=len(e.prompt),
                        tokens=list(e.tokens)[:e.max_new_tokens],
                        finish_reason="length")
                    continue
                prompt = list(e.prompt) + list(e.tokens)
                if len(prompt) > self.prompt_limit:
                    self.journal.record_abandon(e.request_id)
                    self.journal_abandoned += 1
                    continue
                kw: dict = {}
                if e.deadline_wall:
                    kw["deadline_s"] = e.deadline_wall - now_wall
                rid = self.submit(
                    prompt, remaining,
                    cache_eligible_tokens=e.cache_eligible_tokens,
                    correlation_id=e.correlation_id, tenant=e.tenant,
                    priority=e.priority or "interactive", **kw)
                self.journal.supersede(e.request_id, rid, e.tokens)
                self._journal_stitch[rid] = (len(e.prompt), list(e.tokens))
                self._journal_ckpt[rid] = 0
                self.journal_recovered.append((rid, e.correlation_id))
                self.journal_replayed += 1
                if self.telemetry is not None:
                    self.telemetry.on_journal_replayed()
                if e.trace_id and e.span_id:
                    # an attempt-numbered replay span in the originating
                    # pipeline trace (never a fresh orphan root)
                    with _trace.span(
                            "engine_replay", kind="engine_replay",
                            service="engine",
                            correlation_id=e.correlation_id,
                            attempt=e.attempt + 1,
                            parent=(e.trace_id, e.span_id),
                            request_id=rid, restart=True):
                        pass
        finally:
            self._journal_suppress = False
        return self.journal_replayed

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
            if isinstance(exc, InjectedFault) \
                    and self.telemetry is not None:
                self.telemetry.on_fault_injected(kind, exc.mode)
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
