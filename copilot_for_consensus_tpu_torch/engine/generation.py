"""Continuous-batching LLM generation engine — the JAX package's
``engine/generation.py`` on one device, ported to PyTorch: the contiguous
cache and the paged pool (its K3 route and its gather route), prefix
caches on both, piggyback prefill, the admission holds and the
prefill/decode roles.

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
* **Profiling.** ``profile_dir`` captures a ``torch.profiler`` trace
  of each ``generate`` call (``obs/profile.py``); every admission wave,
  chunk, decode, piggyback and verify dispatch is a step annotation
  named after its kind and flight-recorder step, opened on the host
  around the dispatch (never inside the captured body, where it would run
  once at capture).
* **Supervisor hooks.** Every admission wave and decode dispatch runs
  under ``_dispatch_boundary``: the fault plane's injection point
  (``faults=``, ``engine/faults.py``) and the supervisor's watchdog and
  outcome surface (``engine/supervisor.py``, attached by
  ``engine/async_runner.py``). A failed wave puts its requests back at
  the head of the queue; a failed dispatch drops the decode graphs.

Two KV layouts:

* **Contiguous** (default): one cache ``[L, slots, Hkv, max_len, Dh]``.
  With ``prefix_cache_blocks`` > 0 a radix trie over a block pool of its
  own (``engine/prefix_cache.py``, owned mode) turns a cached prompt
  prefix into a hit: the wave gathers the matched blocks, prefills only
  the suffix against them (``decoder.prefill_seeded``) and seeds both
  into the slot; a retiring request's prompt KV is copied into the pool.
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
  the same. ``kv_kernel="reference"`` selects the gather route instead of
  K3: every pass gathers the working-set view the tables describe
  (``ops.paged_attention.paged_gather_kv``), runs the contiguous program
  over it, and scatters the freshly merged columns back into the pool. It
  is an explicit choice, never a fallback, and launches no K3 call.

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
* **The scheduler** (``scheduler=``, ``engine/scheduler.py``): with one
  configured, ``submit`` may shed with ``EngineOverloaded`` at the door
  (warm-restart resubmits bypass it), requests queue per ``tenant`` and
  ``priority`` lane, and each ``step`` releases at most one wave's token
  budget in weighted deficit-round-robin order.
* **Chunked prefill** (with a scheduler): a cache-miss prompt longer than
  ``chunk_tokens`` takes a slot and is prefilled one chunk a step, between
  the decode dispatches, by a seeded pass over the slot's own partly
  filled cache (``decoder.verify_seeded`` on the contiguous cache,
  ``decoder.prefill_seeded_paged`` over K3 on the pool); the chunk that
  completes the prompt samples its first token.
* **Speculative decoding** (``spec_decode=True``): each stream's
  prompt-lookup index (``NgramDraftIndex``) drafts up to ``k`` tokens; a
  step where any slot drafts runs one verify dispatch that scores every
  slot's next token and draft in one weight pass (the same seeded pass)
  and accepts exactly (``sampling.verify_draft``: greedy output equals
  stepwise greedy). The supervisor's ``spec_verify`` breaker can veto it;
  plain decode then serves.

* **Admission holds** (``admit_min_rows``, ``admit_max_wait_s``,
  ``admit_hold_strict``): a wave waits while too few requests are queued
  and the batch is busy, so trickling arrivals share one weight pass.
* **Piggyback prefill** (``piggyback_min_prompt``, ``prefill_rows``;
  contiguous, one window a dispatch, opt-in): whole prompts ride a decode
  dispatch in ``prefill_chunk``-token chunks across packed lanes — every
  projection takes the decode rows and the chunk rows in one matmul, and
  the chunks' attention is one K1 call a layer
  (``decoder.decode_step_piggyback``).
* **Prefill/decode roles** (``role=``, ``handoff_high``; paged): a
  prefill-role engine parks each finished prefill for a block-granular KV
  handoff (``take_prefilled``), and a decode-role engine imports it
  (``admit_prefilled``); ``engine/roles.py`` pairs them.

The verify, chunk and piggyback dispatches run eagerly (no CUDA graph);
they write the cache or the pool in place, and the decode graphs read
positions and tokens from their static buffers, refilled before every
dispatch. Where the JAX engine builds new arrays, this one updates the
cache and the pool in place (no second allocation).

**A dp×tp mesh** (``mesh=``, ``parallel/``; lockstep SPMD: every rank
builds the same engine and calls the same API with the same arguments in
the same order, as a ``torchrun`` job runs one script a rank):

* host state — the queue, the slots, the block tables, the allocator —
  is whole on every rank; only device state is sharded. Each host
  decision that reads a clock (the admission hold, the deadlines) is
  taken on rank 0 and broadcast, so no rank decides otherwise and hangs
  in the next collective;
* tp: the weights are this rank's megatron shards (``shard_pytree`` by
  ``serving_param_rules``; where tp does not divide the kv heads, the kv
  head this rank's q heads group to), the passes run at the local head
  and ffn widths of ``decoder.local_config``, whose ``TPShard`` gives
  them the all-reduces and the vocab all-gather;
* dp: slot ``s`` belongs to dp group ``s // (num_slots / dp)``, and each
  group prefills and decodes only its own rows, over its own rows of the
  cache or its own shard of the pool (block ids local to it). The rows'
  logits are all-gathered over dp before every sample, and the whole
  batch is sampled on every rank from generators seeded alike: the draws
  are the un-meshed engine's, and every rank holds every token. Where dp
  does not divide ``num_slots`` the contiguous engine replicates the
  batch over dp (the JAX engine's rule); the paged engine raises.

The features decided inside ``step()`` keep that lockstep:

* speculative verify and chunked prefill run each dp group's rows (its
  cache rows, or its pool shard through shard-local block ids) and
  all-gather the rows' logits over dp before the draw, as decode does;
* the scheduler's turn: every rank observes, then takes rank 0's overload
  level (the one signal that reads a clock and the rank's own telemetry),
  so every rank sheds alike at the door; each rank's release is held to
  rank 0's, request id by request id;
* the paged prefix cache keeps one radix trie a dp shard (every rank
  holds every trie host-side; only the shard's ranks hold its blocks'
  KV); admission places a request on a shard with a free slot and
  headroom, the longest match in that shard's trie first, so a hit never
  crosses shards. A contiguous prefix cache on a mesh raises, as in the
  JAX engine;
* piggyback prefill (contiguous) runs all of a dispatch's lanes on every
  dp group, each group merging only its own slots' rows, so the lanes'
  first tokens are drawn alike everywhere;
* the request journal lives on rank 0 alone: it journals and
  checkpoints, and at a warm restart it reads the rows and broadcasts
  them, so every rank resubmits the same rows under the same ids.

A size-1 axis has no collective: at world size 1 the mesh engine runs the
un-meshed engine's kernels in the same order. On a mesh above one rank,
roles raise (ROADMAP item 6d), as do ``pp``, ``sp`` and ``ep`` above 1 and
a callable ``attn_impl``, each naming its item; the async runner over a
mesh is refused where it is built (``engine/supervisor.py``, item 6c.1b).
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
    verify_draft,
)
from copilot_for_consensus_tpu_torch.engine.scheduler import (
    jain_index,
    resolve_scheduler,
)
from copilot_for_consensus_tpu_torch.engine.telemetry import (
    resolve_telemetry,
)
from copilot_for_consensus_tpu_torch.engine.tokenizer import NgramDraftIndex
from copilot_for_consensus_tpu_torch.models import decoder, quant
from copilot_for_consensus_tpu_torch.models.configs import DecoderConfig
from copilot_for_consensus_tpu_torch.obs.profile import (
    maybe_profile,
    step_annotation,
)
from copilot_for_consensus_tpu_torch.ops.attention import IMPLS
from copilot_for_consensus_tpu_torch.ops.paged_attention import (
    paged_attention_partial,
    paged_gather_kv,
)
from copilot_for_consensus_tpu_torch.parallel.collectives import (
    all_gather_rows,
    broadcast_decision,
    capture_supported,
)
from copilot_for_consensus_tpu_torch.parallel.sharding import (
    serving_param_rules,
    shard_pytree,
)

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
    #: ("" = the anonymous tenant), the scheduler's fairness key, and the
    #: priority lane ("interactive" > "batch"); journal rows and replays
    #: carry them.
    tenant: str = ""
    priority: str = "interactive"
    #: absolute monotonic deadline: expired work is dropped
    #: (``finish_reason="deadline"``), never computed. inf = none.
    deadline_at: float = float("inf")


@dataclass
class PrefilledHandoff:
    """One finished prefill exported for the prefill→decode KV handoff.
    ``kv_k``/``kv_v`` are the slot's pool blocks gathered dense
    ``[L, 1, Hkv, NBpad*block, Dh]`` on the prefill engine's device (the
    importing engine moves them with ``Tensor.to``); only the first
    ``prompt_len`` columns are live. Ownership moves, never aliases: the
    source slot's pins and blocks were released at export (after its trie
    adopted the prompt prefix), and the importer allocates fresh blocks
    owned by the new slot alone."""

    request: "Request"
    first_token: int
    prompt_len: int
    kv_k: torch.Tensor
    kv_v: torch.Tensor
    blocks: int                   # live (unpadded) block count
    ready_at: float               # monotonic: when the prefill parked
    prefill_s: float = 0.0


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


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _refuse_on_mesh(mesh, role: str) -> None:
    """Raise for what the mesh engine does not serve on a mesh of more
    than one rank, naming the ROADMAP item that brings it."""
    for axis, item in (("pp", "6e (pp, with training)"),
                       ("sp", "6c.2 (sp)"), ("ep", "6c.3 (ep)")):
        if mesh.shape[axis] > 1:
            raise NotImplementedError(
                f"GenerationEngine on a mesh with {axis}="
                f"{mesh.shape[axis]}: the engine serves over dp×tp; "
                f"{axis} is ROADMAP Queue 1 item {item}")
    if role != "both":
        raise NotImplementedError(
            f"GenerationEngine(role) on a mesh of {mesh.size} ranks is "
            f"not served yet: ROADMAP Queue 1 item 6d (roles over several "
            f"devices)")


class GenerationEngine:
    """Continuous-batching decoder serving on one device, or on a dp×tp
    mesh of ranks (``mesh=``)."""

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
        attn_impl: str = "auto",
        quantize: bool | str = False,
        decode_window: int = 8,
        windows_per_dispatch: int = 1,
        admission_token_budget: int = 16384,
        admit_min_rows: int = 1,
        admit_max_wait_s: float = 0.5,
        admit_hold_strict: bool = False,
        prefill_chunk: int = 64,
        prefill_rows: int = 4,
        piggyback_min_prompt: int = 10**9,
        kv_pool_blocks: int = 0,
        prefix_cache_blocks: int = 0,
        kv_kernel: str = "auto",
        role: str = "both",
        handoff_high: int = 0,
        faults=None,
        cuda_graphs: bool = True,
        telemetry=True,
        spec_decode: bool = False,
        spec_draft_lens: tuple[int, ...] = (0, 4, 8),
        spec_ngram: int = 3,
        spec_min_ngram: int = 2,
        scheduler=None,
        journal=None,
        profile_dir: str | None = None,
        device: str | torch.device | None = None,
        mesh=None,
        _params_local: bool = False,
    ):
        # A mesh of several ranks: refuse what it does not serve before
        # anything is built (every rank raises alike, before any
        # collective). ``_params_local`` (``from_checkpoint`` only):
        # ``params`` already hold this rank's shard.
        self.mesh = mesh
        if mesh is not None and prefix_cache_blocks and not kv_pool_blocks:
            # the JAX engine's refusal, on any mesh (one rank included)
            raise ValueError(
                "prefix_cache_blocks on a mesh requires the paged "
                "engine (kv_pool_blocks): the contiguous block "
                "pool and a dp-sharded slot cache would live on "
                "different shards; the paged pool shards WITH its "
                "per-shard tries")
        if mesh is not None and mesh.size > 1:
            _refuse_on_mesh(mesh, role)
            dp = mesh.shape["dp"]
            if cfg.is_moe and dp > 1 and num_slots % dp == 0:
                # expert capacity is counted over the whole batch: split
                # rows would route against a capacity of their own and
                # drop other tokens than the un-meshed engine
                raise NotImplementedError(
                    f"an MoE config on a mesh with dp={dp}: expert "
                    f"capacity spans the whole batch, which the cross-rank "
                    f"expert dispatch of ROADMAP Queue 1 item 6c.3 (ep) "
                    f"brings; serve MoE over tp")
        self.device = resolve_device(device, mesh)
        # The prefill waves' attention route: "auto" (K1 on the card, its
        # plain version on the CPU) or "plain" (K1's plain version). The
        # JAX engine also takes a callable (ring attention over a mesh).
        if callable(attn_impl):
            raise NotImplementedError(
                "GenerationEngine(attn_impl=<callable>): a custom attention "
                "(ring attention over a mesh) comes with sp, ROADMAP "
                "Queue 1 item 6c.2")
        if attn_impl not in IMPLS:
            raise ValueError(f"attn_impl must be one of {IMPLS}, got "
                             f"{attn_impl!r}")
        self.attn_impl = attn_impl
        #: where ``generate`` writes a torch.profiler trace (None: off)
        self.profile_dir = profile_dir
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
        # warm-restarts (``_recover_from_journal``, last in __init__). On
        # a mesh of several ranks the store lives on rank 0 alone: the
        # other ranks never open it, and take every step alike
        # (``_journaled``: the engine has a journal somewhere).
        self._journaled = journal is not None and journal is not False
        self.journal = resolve_journal(journal) \
            if mesh is None or mesh.is_first else None
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
        #: True while ``_recover_from_journal`` resubmits: those submits
        #: bypass the scheduler's shed gate
        self._journal_recovering = False
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
        # The admission holds (the JAX engine's wave hysteresis): with
        # admit_min_rows > 1 a wave waits while fewer requests are queued,
        # the batch is at least 3/4 occupied (or the hold is strict), and
        # the oldest has waited under admit_max_wait_s — trickling
        # arrivals then share one wave's weight pass instead of paying one
        # each.
        self.admit_min_rows = max(1, admit_min_rows)
        self.admit_max_wait_s = admit_max_wait_s
        self.admit_hold_strict = admit_hold_strict
        # Piggyback prefill (opt-in, as in the JAX engine): whole prompts
        # of [piggyback_min_prompt, decode_window * prefill_chunk] tokens
        # skip the wave and ride a decode dispatch, prefill_chunk tokens a
        # step across prefill_rows packed lanes. Single-window dispatches
        # on the contiguous cache only, and no sliding window narrower
        # than the cache (the paged test comes with the pool below).
        self.prefill_chunk = max(1, prefill_chunk)
        self.prefill_rows = max(1, prefill_rows)
        self.piggyback_min_prompt = piggyback_min_prompt
        self._piggyback_ok = (
            self.windows_per_dispatch == 1 and not cfg.is_moe
            and (cfg.sliding_window == 0
                 or cfg.sliding_window >= self.max_len))
        #: whole prompts waiting to ride a piggyback dispatch, with the
        #: time each joined the feed
        self._prefilling: list[tuple[Request, float]] = []
        self._dispatch_steps = self.decode_window * self.windows_per_dispatch
        if self.max_len - self._dispatch_steps < 1:
            raise ValueError(
                f"decode_window {self.decode_window} x "
                f"{self.windows_per_dispatch} windows/dispatch leaves no "
                f"prompt room in max_len {self.max_len}")
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

        # ---- speculative decoding (prompt-lookup drafts) ----------------
        # A verify dispatch scores every slot's next token and its draft
        # in one weight pass. Draft lengths snap to a static bucket set
        # (the JAX engine's retrace bound; here, the shapes one verify
        # pass takes); rows without a draft ride the same pass in the k=0
        # lane.
        self.spec_decode = bool(spec_decode)
        self.spec_draft_lens = tuple(sorted(
            {int(k) for k in spec_draft_lens} | {0}))
        if any(k < 0 for k in self.spec_draft_lens):
            raise ValueError(
                f"spec_draft_lens must be >= 0, got {spec_draft_lens}")
        self._spec_max_draft = max(self.spec_draft_lens)
        self.spec_ngram = int(spec_ngram)
        self.spec_min_ngram = int(spec_min_ngram)
        if self.spec_decode:
            if cfg.sliding_window and cfg.sliding_window < self.max_len:
                raise ValueError(
                    "spec_decode requires full attention: the verify "
                    "pass rides prefill_attention_seeded, which does "
                    "not implement absolute-timeline window masking")
            if self._spec_max_draft + 1 >= self.max_len:
                raise ValueError(
                    f"spec_draft_lens {spec_draft_lens} leave no cache "
                    f"room in max_len {self.max_len}")
        #: slot → NgramDraftIndex over (prompt + emitted tokens): built at
        #: activation, extended as tokens are accepted, dropped at
        #: retirement. Host state only.
        self._draft_index: dict[int, NgramDraftIndex] = {}
        #: lookups/hits count draft-index probes; drafted/accepted count
        #: draft tokens through verify; rows counts (slot, verify dispatch)
        #: pairs; emitted counts tokens harvested from verify. The
        #: ``_row_*`` pair is the per-stream weight-pass ledger across both
        #: decode paths (a verify dispatch is one pass a row, a plain
        #: dispatch one a row a step): tokens_per_weight_pass.
        self.spec_lookups = 0
        self.spec_hits = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_dispatches = 0
        self.spec_rows = 0
        self.spec_emitted_tokens = 0
        self.spec_s = 0.0
        self._row_tokens = 0
        self._row_passes = 0

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
        if mesh is None:
            params = _to_device(params, self.device)
        layers_t = params["layers"]
        if qmode and not quant.is_quantized(
                layers_t["wq"] if "wq" in layers_t else layers_t["wqkv"]):
            # full-precision weights given: quantize on the fly (on a
            # mesh, where they lie, before the shards are cut)
            params = quant.quantize_params(params, mode=qmode)
        # The mesh's axes as this engine uses them (the un-meshed engine
        # is the mesh of one rank): this rank's tp shard (None: whole
        # weights, no collective), its dp group's rows, and the group a
        # host decision is broadcast over.
        self._mcfg = cfg
        self._tp_shard = None
        self._dp, self._dp_rank, self._dp_group = 1, 0, None
        self._world = None
        if mesh is not None:
            rules = serving_param_rules(cfg, mesh)
            if not _params_local:
                params = shard_pytree(
                    params, decoder.param_logical_axes(cfg, params), mesh,
                    rules, device=self.device)
            tp = mesh.shape["tp"]
            if tp > 1:
                if rules["kv_heads"] != "tp":
                    params = decoder.select_kv_heads(params, cfg, tp,
                                                     mesh.coords["tp"])
                self._tp_shard = decoder.TPShard(
                    group=mesh.group("tp"),
                    vocab_start=mesh.coords["tp"] * (cfg.vocab_size // tp))
                self._mcfg = decoder.local_config(cfg, tp, rules,
                                                  self._tp_shard)
            dp = mesh.shape["dp"]
            if dp > 1 and kv_pool_blocks and num_slots % dp:
                raise ValueError(
                    f"kv_pool_blocks on a mesh requires num_slots "
                    f"({num_slots}) divisible by dp ({dp}): slots "
                    f"partition over the dp shards")
            if dp > 1 and num_slots % dp == 0:
                # else the contiguous batch is replicated over dp
                self._dp, self._dp_rank = dp, mesh.coords["dp"]
                self._dp_group = mesh.group("dp")
            self._world = mesh.world
        #: slots a dp group owns, and this rank's first one
        self._slots_ps = num_slots // self._dp
        self._row0 = self._dp_rank * self._slots_ps
        mcfg = self._mcfg
        if qmode == "int4" and not cfg.is_moe:
            # q/k/v and gate/up fused: 4 kernel calls a layer instead of
            # 7, as the JAX engine does on a single chip. An MoE tree
            # stays unfused, as there: its experts are called one by one
            # by name, and q, k and v take a K5 call each.
            params = quant.fuse_int4_projections(params)
        self.params = params
        # A KV dtype below the activation dtype (float8_e4m3fn halves the
        # cache bytes); None keeps the activation dtype
        self.kv_dtype = resolve_kv_dtype(kv_dtype, self.dtype)

        # ---- KV layout: the contiguous slot cache, or one block pool ------
        self.paged = bool(kv_pool_blocks)
        # The paged route (the JAX engine's kv_kernel): "auto" and
        # "pallas" score the pool in place through K3 ("kernel"),
        # "reference" gathers the working-set view the tables describe and
        # runs the contiguous decoder over it ("reference"). Only an
        # explicit "reference" selects the gather route: no failure of K3
        # ever falls back to it.
        if kv_kernel not in ("auto", "pallas", "reference"):
            raise ValueError(
                f"kv_kernel must be 'auto', 'pallas' or 'reference', "
                f"got {kv_kernel!r}")
        if kv_kernel != "auto" and not self.paged:
            raise ValueError(
                "kv_kernel selects the paged-attention dispatch route "
                "and requires kv_pool_blocks > 0")
        self.kv_kernel = kv_kernel
        # The disaggregated serving role (engine/roles.py): "prefill"
        # parks finished prefills for the KV handoff instead of decoding
        # them, "decode" also takes handed-off timelines through
        # ``admit_prefilled``. The block pool is the handoff's substrate.
        if role not in ("both", "prefill", "decode"):
            raise ValueError(
                f"role must be 'both', 'prefill' or 'decode', "
                f"got {role!r}")
        if role != "both" and not self.paged:
            raise ValueError(
                "prefill/decode roles require kv_pool_blocks: the "
                "block-granular KV handoff moves pool blocks, not "
                "contiguous slot caches")
        self.role = role
        #: slot → [request, first token, prompt_len, ready_at, prefill_s]
        #: parked for handoff (prefill role); the slot's blocks keep the
        #: prompt KV until ``take_prefilled`` exports them
        self._handoff: dict[int, list] = {}
        self.handoff_exported = 0
        self.handoff_imported = 0
        #: the prefill role stops releasing scheduler waves when this many
        #: finished prefills await handoff (parked + exported but not yet
        #: admitted downstream); parked entries are slot-keyed, so the
        #: default is half the slots
        self._handoff_high = int(handoff_high) or max(1, num_slots // 2)
        #: handoffs exported but not admitted, as the DisaggregatedEngine
        #: reports them (``set_handoff_external``)
        self._handoff_external = 0
        #: publishes that failed at retire (contained: the completion is
        #: delivered, only the cache's share is lost)
        self.prefix_publish_failures = 0
        if prefix_cache_blocks and cfg.sliding_window \
                and cfg.sliding_window < self.max_len:
            raise ValueError(
                "prefix_cache_blocks requires full attention: a reused "
                "prefix under a sliding window needs absolute-timeline "
                "window masking the seeded prefill does not implement")
        self._cache = None
        self._pool: BlockPool | None = None
        #: the prefix tries: one a dp shard on the paged pool (a hit
        #: appends ids of the slot's own shard, so cached prefixes are
        #: shard-local by construction; every rank holds every trie
        #: host-side), one over its own pool on the contiguous cache;
        #: ``_prefix`` is the first, the whole cache without dp
        self._prefixes: list[PrefixCache] = []
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
            #: furthest a dispatch (a decode window, a verify pass, a
            #: chunk) writes past a slot's committed length. The JAX
            #: engine reserves the verify margin even with speculation
            #: off; so does this one, and both engines' admission books
            #: (and so their waves and hit counts) agree.
            self._write_margin = max(
                self._dispatch_steps,
                max(spec_draft_lens, default=0) + 1)
            if kv_pool_blocks < (self._max_blocks + 1) * self._dp:
                raise ValueError(
                    f"kv_pool_blocks={kv_pool_blocks} cannot hold even "
                    f"one max_len={self.max_len} slot "
                    f"({self._max_blocks} blocks) plus one block per dp "
                    f"shard (dp={self._dp})")
            # dp splits the block axis: this rank holds its group's shard
            self._pool = BlockPool(mcfg, num_blocks=kv_pool_blocks,
                                   block_size=block, kv_dtype=self.kv_dtype,
                                   device=self.device, num_shards=self._dp,
                                   shard=self._dp_rank)
            #: the first global block id of this rank's dp shard
            self._id_base = self._dp_rank * self._pool.blocks_per_shard
            # piggyback packing binds rows to contiguous slot-cache spans;
            # the paged engine's overlap path is chunked prefill
            self._piggyback_ok = False
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
                self._prefixes = [PrefixCache(shared=self._pool)
                                  for _ in range(self._dp)]
            #: the resolved paged route, labelled on every StepRecord and
            #: the copilot_engine_kv_route gauge
            self._kv_route = "reference" if kv_kernel == "reference" \
                else "kernel"
            if self.telemetry is not None:
                self.telemetry.gauge_kv_route(self._kv_route)
        else:
            self._kv_route = ""
            self._cache = decoder.init_cache(mcfg, self._slots_ps,
                                             self.max_len,
                                             dtype=self.kv_dtype,
                                             device=self.device)
            if prefix_cache_blocks:
                # the contiguous engine's cache owns its block pool: a
                # retiring slot's prompt KV is copied in, and a hit's
                # blocks are gathered back into the admitting slot
                self._prefixes = [PrefixCache(
                    cfg, num_blocks=prefix_cache_blocks,
                    block_size=self.prefill_chunk, kv_dtype=self.kv_dtype,
                    device=self.device)]
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
        #: (decode_s, decode_tokens: plain dispatches and verify
        #: dispatches both; spec_s and spec_emitted_tokens: verify alone)
        self.admitted_s = 0.0
        self.decode_s = 0.0
        self.decode_tokens = 0
        #: piggybacked vs plain decode dispatches (their wall time and
        #: count), and the prompt rows and tokens that rode piggyback
        self.piggy_s = 0.0
        self.piggy_dispatches = 0
        self.plain_s = 0.0
        self.plain_dispatches = 0
        self.piggy_rows = 0
        self.piggy_tokens = 0

        # ---- the scheduler and chunked prefill (engine/scheduler.py) ----
        # Per-tenant weighted-DRR admission with priority lanes, load
        # shedding at the door, and chunked prefill: a long cache-miss
        # prompt takes a slot and is prefilled one chunk a step between
        # the decode dispatches, by a seeded pass over the slot's own
        # partly filled cache — bit-identical (greedy) to the monolithic
        # wave when the cache holds the compute dtype.
        self._sched = resolve_scheduler(scheduler,
                                        telemetry=self.telemetry)
        # The seeded pass does not implement absolute-timeline window
        # masking (as for speculation)
        self._chunk_ok = (cfg.sliding_window == 0
                          or cfg.sliding_window >= self.max_len)
        ct = self.prompt_limit
        if self._sched is not None:
            ct = max(1, min(self._sched.cfg.chunk_tokens,
                            self.prompt_limit))
        #: the static chunk widths (the JAX engine's retrace bound)
        self._chunk_buckets = tuple(sorted(
            {min(b, ct) for b in self.buckets} | {ct}))
        #: released long prompts waiting for a slot to start chunking
        self._chunk_pending: list[Request] = []
        #: slot → [request, tokens filled so far, chunk-start time]
        self._chunking: dict[int, list] = {}
        self.chunk_dispatches = 0
        self.chunk_prefill_tokens = 0
        self.chunk_s = 0.0

        # ---- the decode dispatch's static buffers and its graphs --------
        # One CUDA stream carries every device op of the engine: eager
        # waves, warm-ups, captures and replays run on it in order.
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._static = self._static_buffers()
        # Across ranks the captured body holds the mesh's collectives; a
        # build that cannot capture them serves eagerly, and says so
        eager_reason = ""
        if cuda_graphs and self.device.type == "cuda" and \
                mesh is not None and mesh.size > 1:
            with self._on_stream():
                ok, why = True, ""
                for group in (self._tp_shard and self._tp_shard.group,
                              self._dp_group):
                    if ok and group is not None:
                        ok, why = capture_supported(group, self.device)
            if not ok:
                cuda_graphs = False
                eager_reason = f"mesh collectives not capturable: {why}"
        self._graphs = DecodeGraphs(
            self.device, enabled=cuda_graphs, stream=self._stream,
            generators=(self._gen,) if sampling.temperature > 0 else (),
            eager_reason=eager_reason)

        # Warm restart last: every queue and slot structure above must
        # exist before recovered requests resubmit through submit(). On a
        # mesh rank 0 reads its store, and every rank follows.
        if self._journaled and self._decide(
                lambda: self.journal is not None
                and self.journal.depth() > 0):
            self._recover_from_journal()

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path, *, dtype: str | torch.dtype =
                        torch.bfloat16, device: str | torch.device | None =
                        None, mesh=None, **engine_kw) -> "GenerationEngine":
        """An engine over a checkpoint directory: native (quantized
        offline, mapped) or HF safetensors (converted in memory). The
        quantize mode comes from the checkpoint's metadata ("int8",
        "int4" or none; True means int8), as do the EOS ids. Leaves go
        to ``device`` (None → the card; with a ``mesh``, the rank's) by
        ``params_from_numpy``'s rules: ``q`` and ``q4`` stay int8,
        ``scale`` f32, the rest ``dtype``; on a mesh each mapped leaf is
        cut to this rank's shard before it is copied, so a rank's device
        never holds a whole sharded leaf. ``engine_kw`` reaches the engine
        (``kv_dtype=``, ``journal=`` and the rest): a journal with rows
        warm-restarts here."""
        from copilot_for_consensus_tpu_torch.checkpoint import (
            load_checkpoint,
        )
        from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
            params_from_numpy,
        )

        dtype = resolve_dtype(dtype)
        device = resolve_device(device, mesh)
        cfg, params, meta = load_checkpoint(
            path, dtype=str(dtype).removeprefix("torch."))
        engine_kw.setdefault("eos_id", meta.get("eos_ids",
                                                meta.get("eos_id", 2)))
        return cls(cfg, params_from_numpy(params, device, dtype, mesh=mesh,
                                          cfg=cfg),
                   dtype=dtype, device=device, mesh=mesh,
                   _params_local=mesh is not None,
                   quantize=meta.get("quantized") or False, **engine_kw)

    @property
    def _prefix(self) -> PrefixCache | None:
        """The first prefix trie (None without a prefix cache): the
        engine's one trie without dp; shard-aware paths index
        ``_prefixes`` by dp shard."""
        return self._prefixes[0] if self._prefixes else None

    def _trie(self, slot: int) -> PrefixCache:
        """The prefix trie of ``slot``'s dp shard."""
        return self._prefixes[self._slot_shard(slot)]

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
        carried into replays: with a scheduler configured they feed its
        fairness and shedding, and an overloaded scheduler raises
        ``EngineOverloaded`` here, at the door. ``deadline_s`` is the
        request's wall-clock budget: once it expires the request is
        dropped (queued) or retired with its partial output (active),
        both with ``finish_reason="deadline"``."""
        if not prompt:
            raise ValueError("empty prompt")
        limit = self.prompt_limit
        if len(prompt) > limit:
            # Keep the tail: instructions sit at the end of the prompt.
            prompt = prompt[-limit:]
            # the cap indexed the ORIGINAL prompt; its head is gone
            if cache_eligible_tokens is not None:
                cache_eligible_tokens = 0
        if self._sched is not None and not self._journal_recovering:
            # Warm-restart resubmits bypass the shed gate: journaled work
            # was admitted once, and shedding it at restart would turn a
            # crash into silent loss. They still queue through the
            # scheduler (fairness holds).
            self._sched.check_admission(
                tenant=tenant, priority=priority,
                prompt_tokens=len(prompt), correlation_id=correlation_id)
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
        req = Request(
            rid, list(prompt), max_new_tokens, cache_eligible_tokens,
            correlation_id=correlation_id, tenant=tenant,
            priority=priority,
            deadline_at=(time.monotonic() + max(0.0, deadline_s)
                         if deadline_s is not None else float("inf")))
        if self._sched is not None:
            self._sched.enqueue(req)
        else:
            self._queue.append(req)
        if self.telemetry is not None:
            self.telemetry.on_submit(rid, len(prompt), correlation_id)
        return rid

    def step(self) -> list[Completion]:
        """Drop expired work, admit queued requests into free slots, run
        one decode dispatch (or verify dispatch) for all active slots,
        retire finished ones. Returns completions.

        With a scheduler, admission is gated by it: the closed loop
        observes this step's signals, at most one wave's token budget is
        released (DRR order, interactive lane first), long prompts advance
        by ONE chunk dispatch, and only then does decode run — so one
        step's prefill work, and with it ITL, stays bounded."""
        with self._on_stream():
            self._expire_deadlines()
            if self._sched is not None:
                self._sched_pump()
            self._admit()
            if self._chunk_pending or self._chunking:
                self._chunk_step()
            if self.paged:
                self.peak_active = max(self.peak_active, self._occupied)
            if self._active or (self._prefilling and self._free):
                self._decode_once()
        if self.journal is not None:
            self._journal_tick()
        if self.telemetry is not None:
            self.telemetry.gauge_queue(self.queue_depth, len(self._active))
            if self.role != "both":
                self.telemetry.gauge_role_occupancy(
                    self.role, self._occupied / self.num_slots
                    if self.num_slots else 0.0)
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
        requests in flight and the last dispatches) before it raises.
        Captures a torch.profiler trace when the engine was built with
        ``profile_dir``."""
        ids = [self.submit(p, max_new_tokens,
                           cache_eligible_tokens=cache_eligible_tokens)
               for p in prompts]
        results: dict[int, Completion] = {}
        with maybe_profile(self.profile_dir):
            try:
                while len(results) < len(ids):
                    for c in self.step():
                        results[c.request_id] = c
            except Exception as exc:
                if self.telemetry is not None:
                    self.telemetry.record_error(exc)
                raise
        return [results[i] for i in ids]

    def generate_text(self, prompts: list[str], tokenizer,
                      max_new_tokens: int = 256) -> list[str]:
        """Text in, text out: encode each prompt (with BOS), ``generate``,
        decode. Tokenization is a host boundary of the serving path too:
        the fault plane's "tokenize" point fires first."""
        if self.faults is not None:
            self.faults.check("tokenize")
        comps = self.generate(
            [tokenizer.encode(p, add_bos=True) for p in prompts],
            max_new_tokens)
        return [tokenizer.decode(c.tokens) for c in comps]

    def journal_stats(self) -> dict:
        """Journal counters (the JAX engine's keys): ``replayed`` counts
        this process's warm-restart resubmissions, ``abandoned`` the rows
        that could not be resumed; the rest come from the journal (on a
        mesh, from rank 0's store: the other ranks report only the
        first three)."""
        out = {"enabled": self._journaled,
               "replayed": self.journal_replayed,
               "abandoned": self.journal_abandoned}
        if self.journal is not None:
            st = self.journal.stats()
            for key in ("depth", "journaled", "retired", "checkpoints"):
                out[key] = st[key]
        return out

    def sched_stats(self) -> dict:
        """Scheduler counters (the JAX engine's keys). ``shed_rate`` is
        over all admission attempts; ``fairness_jain_index`` is Jain's
        index over per-tenant admitted tokens normalized by DRR weight
        (1.0 = perfectly weighted-fair)."""
        out = {"enabled": self._sched is not None,
               "chunk_dispatches": self.chunk_dispatches,
               "chunk_prefill_tokens": self.chunk_prefill_tokens}
        if self._sched is None:
            return out
        sch = self._sched
        attempts = sch.shed_total + sch.submitted_total
        fairness = sch.fairness_snapshot()
        out.update({
            "submitted": sch.submitted_total,
            "shed": sch.shed_total,
            "shed_rate": sch.shed_total / attempts if attempts else 0.0,
            "overload_level": sch.overload_level,
            "fairness": {t: round(v, 1) for t, v in fairness.items()},
            "fairness_jain_index": round(
                jain_index(fairness.values()), 4),
            "signals": dict(sch.last_signals),
        })
        return out

    def spec_stats(self) -> dict:
        """Speculative-decoding counters (the JAX engine's keys).
        ``draft_hit_rate`` is over draft-index probes,
        ``acceptance_rate`` over drafted tokens;
        ``mean_accepted_per_step`` is the accepted draft tokens a row a
        verify dispatch; ``tokens_per_weight_pass`` is the per-stream
        ledger across both decode paths (1.0 is plain decode's wall)."""
        return {
            "enabled": self.spec_decode,
            "lookups": self.spec_lookups,
            "hits": self.spec_hits,
            "draft_hit_rate": (self.spec_hits / self.spec_lookups
                               if self.spec_lookups else 0.0),
            "drafted_tokens": self.spec_drafted_tokens,
            "accepted_tokens": self.spec_accepted_tokens,
            "acceptance_rate": (
                self.spec_accepted_tokens / self.spec_drafted_tokens
                if self.spec_drafted_tokens else 0.0),
            "verify_dispatches": self.spec_dispatches,
            "verify_rows": self.spec_rows,
            "emitted_tokens": self.spec_emitted_tokens,
            "mean_accepted_per_step": (
                self.spec_accepted_tokens / self.spec_rows
                if self.spec_rows else 0.0),
            "weight_row_passes": self._row_passes,
            "weight_row_tokens": self._row_tokens,
            "tokens_per_weight_pass": (
                self._row_tokens / self._row_passes
                if self._row_passes else 0.0),
        }

    @property
    def queue_depth(self) -> int:
        """Requests submitted and not yet decoding: queued for a wave or
        a piggyback dispatch, waiting to chunk or chunking, and held by
        the scheduler."""
        n = (len(self._queue) + len(self._prefilling)
             + len(self._chunk_pending) + len(self._chunking))
        if self._sched is not None:
            n += self._sched.queued
        return n

    @property
    def _occupied(self) -> int:
        """Slots holding a timeline: decoding, chunking, or parked for the
        KV handoff (their blocks are held until exported)."""
        return len(self._active) + len(self._chunking) + len(self._handoff)

    @property
    def active_count(self) -> int:
        """Slots decoding a request now."""
        return len(self._active)

    def prefix_stats(self) -> dict:
        """Prefix-cache counters (the JAX engine's keys): ``hit_rate`` is
        over admission lookups; ``prefill_tokens`` / ``..._saved`` count
        prompt tokens prefilled (waves, chunks and piggyback) and skipped;
        ``publish_failures`` counts contained publish failures."""
        out = {"enabled": self._prefix is not None,
               "prefill_tokens": self.prefill_tokens,
               "prefill_tokens_saved": self.prefill_tokens_saved,
               "publish_failures": self.prefix_publish_failures}
        if self._prefixes:
            # summed over the per-dp-shard tries (one without dp)
            st: dict[str, int] = {}
            for pc in self._prefixes:
                for k, v in pc.stats.as_dict().items():
                    st[k] = st.get(k, 0) + v
            out.update(st)
            out["hit_rate"] = (st["hits"] / st["lookups"]
                               if st["lookups"] else 0.0)
            out["blocks_in_use"] = sum(pc.blocks_in_use
                                       for pc in self._prefixes)
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
            "dp_shards": self._dp,
            "role": self.role,
            "handoff_parked": len(self._handoff),
            "handoff_exported": self.handoff_exported,
            "handoff_imported": self.handoff_imported,
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

        Before the wave: with piggyback on, eligible whole prompts leave
        the queue for the piggyback feed (up to about two dispatches'
        worth of backlog; prefix hits keep the seeded wave), and the
        admission holds may defer the wave. A request is admitted only
        while its worst-case block footprint fits the pool's headroom
        (paged), its prompt is looked up in the prefix trie (pinning the
        match), and the wave is budgeted by SUFFIX tokens: the cached span
        is never prefilled. A prefill-role engine parks each finished
        prefill for the KV handoff instead of decoding it."""
        if not (self._queue and self._free):
            return
        if self._piggyback_ok:
            # Eligible prompts ride the decode dispatches instead of a
            # wave, up to the piggyback grid's absorption rate (two
            # dispatches' worth); the wave takes the overflow.
            cap = self.decode_window * self.prefill_chunk
            budget = 2 * cap * self.prefill_rows - sum(
                len(r.prompt) for r, _ in self._prefilling)
            keep = []
            for req in self._queue:
                plen = len(req.prompt)
                # a prefix hit keeps the seeded wave: the chunk grid
                # attends only its own dispatch buffer, so a hit riding it
                # would prefill the cached span again
                if (self._prefix is not None
                        and self._prefix.match_tokens(
                            req.prompt,
                            digests=self._req_digests(req)) > 0):
                    keep.append(req)
                    continue
                if (self.piggyback_min_prompt <= plen <= cap
                        and plen <= budget):
                    # whole prompts only; the slot is taken at pack time
                    self._prefilling.append((req, time.monotonic()))
                    budget -= plen
                else:
                    keep.append(req)
            self._queue = keep
            if not (self._queue and self._free):
                return
        if (len(self._queue) < self.admit_min_rows
                and (self.admit_hold_strict
                     or len(self._free) * 4 <= self.num_slots)
                and self._decide(lambda: time.monotonic()
                                 - self._queue[0].submitted_at
                                 < self.admit_max_wait_s)):
            # let the wave fill while decode runs on, but only while the
            # batch is at least 3/4 occupied (or the hold is strict)
            return
        t0 = time.monotonic()
        batch: list[tuple[int, Request]] = []
        matches: list = []            # PrefixMatch | None, aligned w/ batch
        longest = 0
        # Paged: free-block accounting per dp shard; a request goes to a
        # shard with a free slot and headroom for its worst case, the
        # longest match in that shard's trie first (the lowest shard on a
        # tie), so a hit never crosses shards
        headroom = [self._shard_headroom(s) for s in range(self._dp)] \
            if self.paged else []
        # Cap a wave at 128 rows AND the prompt-token budget: prefill
        # scratch and activations scale with rows × bucket; and the slots
        # in use at the occupancy cap the resource breaker may lower.
        while (self._queue and self._free and len(batch) < 128
               and self._occupied + len(batch) < self._slot_cap):
            head = self._queue[0]
            match_len = 0
            shard = 0
            if self.paged:
                # the FULL worst case, borrowed prefix included: pinning
                # the matched blocks takes them out of the evictable
                # headroom this gate was computed against
                need = self._worst_blocks_total(head)
                cand = None
                for sh in range(self._dp):
                    if need > headroom[sh] or not any(
                            self._slot_shard(x) == sh for x in self._free):
                        continue
                    mt = self._prefixes[sh].match_tokens(
                        head.prompt, digests=self._req_digests(head)) \
                        if self._prefixes else 0
                    if cand is None or mt > cand[1]:
                        cand = (sh, mt)
                if cand is None:
                    break
                shard, match_len = cand
            elif self._prefix is not None:
                match_len = self._prefix.match_tokens(
                    head.prompt, digests=self._req_digests(head))
            longest = max(longest, len(head.prompt) - match_len)
            if batch and (len(batch) + 1) * _next_bucket(
                    longest, self.buckets) > self.admission_token_budget:
                break
            m = None
            if self._prefixes:
                m = self._prefixes[shard].lookup(
                    head.prompt, digests=self._req_digests(head))
                if m.tokens == 0:       # miss: nothing pinned
                    m = None
            if self.paged:
                headroom[shard] -= need
                slot = next(x for x in self._free
                            if self._slot_shard(x) == shard)
                self._free.remove(slot)
            else:
                slot = self._free.pop(0)
            batch.append((slot, self._queue.pop(0)))
            matches.append(m)
        if not batch:
            return                      # the pool cannot take the head
        plens = [len(req.prompt) for _, req in batch]
        suffix_lens = [plens[i] - (matches[i].tokens if matches[i] else 0)
                       for i in range(len(batch))]
        bucket = _next_bucket(max(suffix_lens), self.buckets)
        # Pad N to the next power of two; padded rows prefill garbage and
        # their KV is never written.
        n = _pow2(len(batch))
        kind = "prefill_seeded" if any(matches) else "prefill"
        seq = self.telemetry.next_step() if self.telemetry is not None \
            else None
        try:
            with step_annotation(kind, seq, self.device), \
                    self._dispatch_boundary(kind):
                if self.paged:
                    first = self._admit_wave_paged(batch, matches,
                                                   suffix_lens, bucket, n)
                elif any(matches):
                    first = self._admit_wave_seeded(batch, matches,
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
                    self._trie(slot).release(matches[i])
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
            if (self.role == "prefill" and tok not in self._eos_set
                    and req.max_new_tokens > 1):
                # the prompt KV is done and the first token sampled: park
                # for the handoff; the slot and its blocks stay held until
                # take_prefilled exports them
                self._park_handoff(slot, req, tok, plens[i], prefill_s)
                continue
            self._activate(slot, req, tok, plens[i], prefill_s, now)

    def _activate(self, slot: int, req: Request, tok: int, pos: int,
                  prefill_s: float, now: float) -> None:
        """A prefilled request starts decoding in ``slot``: its first
        token ``tok`` sampled, its committed length ``pos``. A first token
        that ends it (eos, or a one-token budget) retires it at once."""
        self._active[slot] = req
        self._generated[slot] = [tok]
        self._spec_track(slot, req, tok)
        self._positions[slot] = pos
        self._next_tok[slot] = tok
        self._t_prefill[slot] = prefill_s
        self._ttft[slot] = now - req.submitted_at
        req.decode_started_at = now
        if tok in self._eos_set or req.max_new_tokens <= 1:
            self._retire(slot, "eos" if tok in self._eos_set else "length")

    # -- a wave over dp: each group prefills its own rows ---------------

    def _wave_width(self, slots: list[int]) -> int:
        """Rows every dp group's part of a wave pads to: the most any
        group takes, to a power of two (the all-gather needs one
        shape)."""
        per = [0] * self._dp
        for s in slots:
            per[self._slot_shard(s)] += 1
        return _pow2(max(per))

    def _wave_rows(self, tokens: np.ndarray, lengths: np.ndarray,
                   slots: list[int]):
        """This dp group's rows of a contiguous wave, padded to
        :meth:`_wave_width`: (tokens, lengths, its slots)."""
        n = self._wave_width(slots)
        mine = [i for i, s in enumerate(slots)
                if self._slot_shard(s) == self._dp_rank]
        tok = np.zeros((n, tokens.shape[1]), dtype=tokens.dtype)
        lns = np.ones((n,), dtype=lengths.dtype)
        tok[:len(mine)] = tokens[mine]
        lns[:len(mine)] = lengths[mine]
        return tok, lns, [slots[i] for i in mine]

    def _no_rows(self, n: int) -> torch.Tensor:
        """The logits a dp group with no row in a wave gives the
        all-gather: it prefills nothing."""
        return torch.zeros((n, self.cfg.vocab_size), dtype=torch.float32,
                           device=self.device)

    def _wave_sample(self, logits: torch.Tensor,
                     wave: list[int]) -> np.ndarray:
        """The first tokens of the wave into slots ``wave``, in its order,
        from this group's ``logits`` [n, V]: without dp its first rows are
        the wave; with dp every group's part is all-gathered and the
        wave's rows are taken in order, so every rank samples the whole
        wave as the un-meshed engine does."""
        if self._dp == 1:
            return sample(logits[:len(wave)], self._gen,
                          self.sampling).cpu().numpy()
        n = logits.shape[0]
        every = all_gather_rows(logits, self._dp_group)
        seen = [0] * self._dp
        order = []
        for s in wave:
            g = self._slot_shard(s)
            order.append(g * n + seen[g])
            seen[g] += 1
        idx = torch.tensor(order, device=every.device)
        return sample(every[idx], self._gen, self.sampling).cpu().numpy()

    @torch.inference_mode()
    def _admit_wave(self, tokens: np.ndarray, lengths: np.ndarray,
                    slots: list[int]) -> np.ndarray:
        """Prefill + cache insert + first-token sample for one wave; the
        first ``len(slots)`` rows are real and go to ``slots``."""
        wave = slots
        if self._dp > 1:
            tokens, lengths, slots = self._wave_rows(tokens, lengths, slots)
        n, bucket = tokens.shape
        rows = len(slots)
        if rows:
            scratch = decoder.init_cache(self._mcfg, n, bucket,
                                         dtype=self.kv_dtype,
                                         device=self.device)
            logits, scratch = decoder.prefill(
                self.params, torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(lengths).to(self.device), self._mcfg,
                scratch, attn_impl=self.attn_impl)
            sl = torch.tensor(slots, device=self.device) - self._row0
            for name in ("k", "v"):
                # fp8 caches move as bytes: index_put_ has no float8 kernel
                storage_view(self._cache[name])[:, sl, :, :bucket] = \
                    storage_view(scratch[name][:, :rows])
        else:
            logits = self._no_rows(n)
        return self._wave_sample(logits, wave)     # the ONE host sync

    @torch.inference_mode()
    def _admit_wave_seeded(self, batch, matches, suffix_lens: list[int],
                           bucket: int, n: int) -> np.ndarray:
        """A contiguous admission wave with prefix-cache hits: gather each
        row's matched blocks from the cache's pool (``paged_gather_kv``),
        prefill only the suffixes against them (``decoder
        .prefill_seeded``), seed the matched blocks into the slot cache
        at [0, match) and the fresh suffix KV at the per-row offset, and
        sample the first tokens — one host sync. Miss rows (match 0) ride
        the same pass. Every write names real slots and in-range columns
        only: the JAX program's out-of-range drops are left out on the
        host."""
        dev = self.device
        pool = self._prefix.pool
        tokens = np.zeros((n, bucket), dtype=np.int64)
        lengths = np.ones((n,), dtype=np.int64)
        pref = np.zeros((n,), dtype=np.int64)
        nb = _pow2(max(len(m.block_ids) for m in matches if m))
        # padding ids are clamped by the gather and masked by pref
        bids = np.full((n, nb), self._prefix.num_blocks, dtype=np.int32)
        for i, (_slot, req) in enumerate(batch):
            start = len(req.prompt) - suffix_lens[i]
            tokens[i, :suffix_lens[i]] = req.prompt[start:]
            lengths[i] = suffix_lens[i]
            if matches[i] is not None:
                bids[i, :len(matches[i].block_ids)] = matches[i].block_ids
                pref[i] = matches[i].tokens
        pk, pv = paged_gather_kv(storage_view(pool["k"]),
                                 storage_view(pool["v"]),
                                 torch.from_numpy(bids).to(dev))
        if pk.dtype != self.kv_dtype:              # fp8 pools as bytes
            pk, pv = pk.view(self.kv_dtype), pv.view(self.kv_dtype)
        scratch = decoder.init_cache(self._mcfg, n, bucket,
                                     dtype=self.kv_dtype, device=dev)
        logits, scratch = decoder.prefill_seeded(
            self.params, torch.from_numpy(tokens).to(dev),
            torch.from_numpy(lengths).to(dev), pk, pv,
            torch.from_numpy(pref).to(dev), self._mcfg, scratch)
        for i, (slot, _req) in enumerate(batch):
            p0 = int(pref[i])
            cols = min(bucket, self.max_len - p0)
            for name, piece in (("k", pk), ("v", pv)):
                c = storage_view(self._cache[name])
                if p0:
                    c[:, slot, :, :p0] = storage_view(piece[:, i, :, :p0])
                c[:, slot, :, p0:p0 + cols] = storage_view(
                    scratch[name][:, i, :, :cols])
        first = sample(logits[:len(batch)], self._gen, self.sampling)
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
        for i, (slot, req) in enumerate(batch):
            tbl = list(matches[i].block_ids) if matches[i] else []
            self._owned_from[slot] = len(tbl)
            need = self._pool.blocks_for(len(req.prompt)) - len(tbl)
            if need > 0:
                tbl.extend(self._alloc_blocks(need, self._slot_shard(slot)))
            self._tables[slot] = tbl
        # this dp group's rows of the wave (all of them without dp)
        mine = [i for i, (slot, _) in enumerate(batch)
                if self._slot_shard(slot) == self._dp_rank]
        if self._dp > 1:
            n = self._wave_width([slot for slot, _ in batch])
        tokens = np.zeros((n, bucket), dtype=np.int64)
        lengths = np.ones((n,), dtype=np.int64)
        rows = []
        for j, i in enumerate(mine):
            slot, req = batch[i]
            start = len(req.prompt) - suffix_lens[i]
            tokens[j, :suffix_lens[i]] = req.prompt[start:]
            lengths[j] = suffix_lens[i]
            rows.append((j, self._tables[slot], start, suffix_lens[i]))
        wave = [slot for slot, _ in batch]
        if not mine:
            return self._wave_sample(self._no_rows(n), wave)
        sbids, soffs = self._write_maps(rows, bucket, n)
        tokens_t = torch.from_numpy(tokens).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        if any(m is not None for m in matches):
            nb = _pow2(max(len(m.block_ids) for m in matches if m))
            # this group's rows: the matched ids of its own shard, local
            bids = np.full((n, nb), self._pool.blocks_per_shard,
                           dtype=BLOCK_TABLE_DTYPE)
            # int32, as K3 takes it: no conversion in any layer
            pref = np.zeros((n,), dtype=np.int32)
            for j, i in enumerate(mine):
                m = matches[i]
                if m is not None:
                    bids[j, :len(m.block_ids)] = self._local_ids(m.block_ids)
                    pref[j] = m.tokens
            tables = torch.from_numpy(bids).to(dev)
            pool = self._pool
            if self._kv_route == "reference":
                # the gather route: the matched prefixes as a dense view,
                # the contiguous seeded pass over it
                pk, pv = self._gather_view(tables)
                scratch = decoder.init_cache(self._mcfg, n, bucket,
                                             dtype=self.kv_dtype, device=dev)
                logits, scratch = decoder.prefill_seeded(
                    self.params, tokens_t, lengths_t, pk, pv,
                    torch.from_numpy(pref).to(dev), self._mcfg, scratch)
                k_new, v_new = scratch["k"], scratch["v"]
            else:
                def partial_fn(li, q_rows, lns, q_pos):
                    return paged_attention_partial(q_rows, pool.k, pool.v,
                                                   li, tables, lns, q_pos,
                                                   window=0)

                logits, k_new, v_new = decoder.prefill_seeded_paged(
                    self.params, tokens_t, lengths_t,
                    torch.from_numpy(pref).to(dev), self._mcfg, partial_fn,
                    all_logits=False)
        else:
            scratch = decoder.init_cache(self._mcfg, n, bucket,
                                         dtype=self.kv_dtype, device=dev)
            logits, scratch = decoder.prefill(self.params, tokens_t,
                                              lengths_t, self._mcfg, scratch,
                                              attn_impl=self.attn_impl)
            k_new, v_new = scratch["k"], scratch["v"]
        self._pool.scatter(k_new, v_new, sbids, soffs)
        return self._wave_sample(logits, wave)     # the ONE host sync

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

    def _slot_shard(self, slot: int) -> int:
        """The dp shard a slot (and every block of its table) lives on:
        shard s owns slots [s * slots_ps, (s + 1) * slots_ps)."""
        return slot // self._slots_ps

    def _shard_headroom(self, shard: int) -> int:
        """Free + trie-evictable blocks of one dp shard minus what
        admitted work on it may still allocate (the whole pool without
        dp)."""
        need = sum(max(0, self._worst_blocks_total(req)
                       - len(self._tables[slot]))
                   for slot, req in self._active.items()
                   if self._slot_shard(slot) == shard)
        need += sum(max(0, self._worst_blocks_total(entry[0])
                        - len(self._tables[slot]))
                    for slot, entry in self._chunking.items()
                    if self._slot_shard(slot) == shard)
        evictable = self._prefixes[shard].evictable_blocks \
            if self._prefixes else 0
        return self._pool.free_blocks_shard(shard) + evictable - need

    def _block_headroom(self) -> int:
        """Free + trie-evictable blocks minus what admitted work may
        still allocate: the sum of the dp shards' headrooms."""
        return sum(self._shard_headroom(s) for s in range(self._dp))

    def _alloc_blocks(self, n: int, shard: int = 0) -> list[int]:
        """Allocate ``n`` pool blocks on dp shard ``shard``, first
        reclaiming idle leaves of that shard's prefix trie when its free
        list runs short."""
        free = self._pool.free_blocks_shard(shard)
        if n > free and self._prefixes:
            self._prefixes[shard].reclaim(n - free)
        return self._pool.alloc(n, shard=shard)

    def _ensure_blocks(self, slot: int, upto: int) -> None:
        """Grow the slot's table to cover positions [0, upto), with blocks
        of the slot's own dp shard."""
        tbl = self._tables[slot]
        need = self._pool.blocks_for(upto) - len(tbl)
        if need > 0:
            tbl.extend(self._alloc_blocks(need, self._slot_shard(slot)))

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
        """[slots, width/block] block-id map, in local ids, of this rank's
        dp group's slots for a read of ``width_tokens`` columns per slot;
        rows pad with the sentinel past their table (clamped by K3, masked
        by the slot's length)."""
        nb = -(-width_tokens // self._block)
        arr = np.full((self._slots_ps, nb), self._pool.blocks_per_shard,
                      dtype=BLOCK_TABLE_DTYPE)
        for i in range(self._slots_ps):
            tbl = self._tables[self._row0 + i][:nb]
            arr[i, :len(tbl)] = self._local_ids(tbl)
        return arr

    def _write_maps(self, rows, width: int, n_rows: int):
        """Per-(row, column) pool write maps for one dispatch: ``rows`` is
        ``[(row_idx, table, start_pos, n_valid)]``; column j of a row
        targets block ``table[(start+j) // block]`` offset
        ``(start+j) % block`` for j < n_valid. Everything else — padding,
        rows without a request, columns at or past ``max_len`` — carries
        the sentinel id and is dropped by the scatter. Ids are local to
        this rank's dp shard."""
        bids = np.full((n_rows, width), self._pool.blocks_per_shard,
                       dtype=BLOCK_TABLE_DTYPE)
        offs = np.zeros((n_rows, width), dtype=BLOCK_TABLE_DTYPE)
        for idx, tbl, start, n_valid in rows:
            n = min(n_valid, width, self.max_len - start)
            if n <= 0:
                continue
            pos = start + np.arange(n)
            bids[idx, :n] = self._local_ids(tbl)[pos // self._block]
            offs[idx, :n] = pos % self._block
        return bids, offs

    def _view_width(self, kv_len: int, steps: int) -> int:
        """The gather route's view width for a dispatch that reads
        ``kv_len`` committed columns and writes up to ``steps`` more,
        block-rounded."""
        return kv_len + -(-steps // self._block) * self._block

    def _gather_view(self, tables: torch.Tensor):
        """The gather route's working-set view ``[L, B, Hkv, NB*blk, Dh]``
        of the pool blocks ``tables`` [B, NB] names (sentinel ids clamp;
        the length masks hide their columns), in the pool's dtype (an fp8
        pool is gathered as bytes)."""
        pool = self._pool
        vk, vv = paged_gather_kv(storage_view(pool.k), storage_view(pool.v),
                                 tables)
        if vk.dtype != pool.k.dtype:
            vk, vv = vk.view(pool.k.dtype), vv.view(pool.v.dtype)
        return vk, vv

    @staticmethod
    def _view_take(view: torch.Tensor, positions: torch.Tensor,
                   steps: int) -> torch.Tensor:
        """The columns a dispatch merged into the view, read back:
        ``[L, B, Hkv, steps, Dh]`` at positions + [0, steps) a row (a
        parked row's positions clamp into the view; its write map drops
        them)."""
        b, s_v = view.shape[1], view.shape[3]
        dev = view.device
        pidx = (positions.to(dev).long()[:, None]
                + torch.arange(steps, device=dev)[None, :]).clamp(0, s_v - 1)
        bidx = torch.arange(b, device=dev)[:, None].expand(b, steps)
        # advanced indices on axes 1 and 3: [B, steps, L, Hkv, Dh]
        return storage_view(view)[:, bidx, :, pidx, :].permute(
            2, 0, 3, 1, 4).view(view.dtype)

    def _used_tokens(self) -> int:
        """Live positions in the pool: committed slot timelines minus
        their borrowed spans (counted once, as trie nodes), chunk fills,
        slots parked for the handoff, plus the published blocks (always
        full)."""
        used = sum(int(self._positions[s])
                   - self._owned_from[s] * self._block
                   for s in self._active)
        used += sum(e[1] for e in self._chunking.values())
        used += sum(h[2] - self._owned_from[s] * self._block
                    for s, h in self._handoff.items())
        used += sum(pc.node_count for pc in self._prefixes) * self._block
        return used

    # ------------------------------------------------------------------
    # the prefill/decode KV handoff (engine/roles.py)
    # ------------------------------------------------------------------

    def _park_handoff(self, slot: int, req: Request, first_tok: int,
                      prompt_len: int, prefill_s: float) -> None:
        """Prefill-role parking: the slot's blocks hold the finished
        prompt KV (its first token is sampled, on the host) until
        ``take_prefilled`` exports them. A parked slot sits out of range
        for every decode dispatch, as a free slot does."""
        self._positions[slot] = self.max_len
        self._handoff[slot] = [req, first_tok, prompt_len,
                               time.monotonic(), prefill_s]

    def set_handoff_external(self, n: int) -> None:
        """Report handoffs exported but not yet admitted downstream (the
        DisaggregatedEngine's pending list), so the release hold and the
        scheduler's ``handoff_backlog`` see the whole handoff pipeline."""
        self._handoff_external = max(0, int(n))

    @torch.inference_mode()
    def take_prefilled(self, limit: int | None = None
                       ) -> list[PrefilledHandoff]:
        """Export parked finished prefills (prefill role). Per slot: its
        blocks gathered dense in one read, its prompt prefix published to
        the trie (later same-prefix prompts still hit here), then its pins
        and owned blocks released and the slot freed. The journal row
        retires here: for this role the work is done once the handoff
        exists; the decode role journals it again on import."""
        out: list[PrefilledHandoff] = []
        for slot in list(self._handoff):
            if limit is not None and len(out) >= limit:
                break
            req, tok, plen, ready_at, prefill_s = self._handoff.pop(slot)
            tbl = list(self._tables[slot])
            nb = self._pool.blocks_for(plen)
            nbp = _pow2(nb)
            # padding ids clamp in the gather; their columns are dead
            bids = np.full((1, nbp), self._pool.num_blocks,
                           dtype=BLOCK_TABLE_DTYPE)
            bids[0, :nb] = tbl[:nb]
            with self._on_stream(), self._dispatch_boundary("kv_export"):
                kv_k, kv_v = self._gather_view(
                    torch.from_numpy(bids).to(self.device))
            adopted = self._publish(slot, req)
            self._paged_release_slot(slot, keep=adopted)
            self._free.append(slot)
            self.handoff_exported += 1
            if self.telemetry is not None:
                self.telemetry.on_retire(req.request_id, new_tokens=1,
                                         finish_reason="handoff")
            if self.journal is not None:
                self.journal.record_retire(req.request_id)
                self._journal_ckpt.pop(req.request_id, None)
            out.append(PrefilledHandoff(
                request=req, first_token=tok, prompt_len=plen,
                kv_k=kv_k, kv_v=kv_v, blocks=nb, ready_at=ready_at,
                prefill_s=prefill_s))
        return out

    @torch.inference_mode()
    def admit_prefilled(self, handoff: PrefilledHandoff, *,
                        correlation_id: str | None = None) -> int | None:
        """Decode-role import of a handed-off finished prefill: fresh
        blocks for it, its KV moved onto this engine's device
        (``Tensor.to``) and written into them, and the slot activated at
        ``prompt_len`` with the first token already sampled — decode goes
        on exactly as on a co-located engine, since the handoff moved the
        exact KV bytes. Returns the new request id, or None when no slot
        or blocks fit now (the caller re-parks the handoff: the
        backpressure signal toward the prefill role)."""
        if not self.paged:
            raise ValueError("admit_prefilled requires kv_pool_blocks")
        if self.role == "prefill":
            raise ValueError("admit_prefilled on a prefill-role engine")
        req0 = handoff.request
        plen = handoff.prompt_len
        span = min(plen + req0.max_new_tokens + self._write_margin,
                   self.max_len)
        if (not self._free or self._occupied >= self._slot_cap
                or self._pool.blocks_for(span) > self._block_headroom()):
            return None
        slot = self._free[0]
        rid = self._next_id
        self._next_id += 1
        corr = correlation_id if correlation_id is not None \
            else req0.correlation_id
        # the original submit time: the completion's TTFT spans the
        # prefill role, the handoff and this import
        req = Request(
            rid, list(req0.prompt), req0.max_new_tokens,
            cache_eligible_tokens=req0.cache_eligible_tokens,
            submitted_at=req0.submitted_at,
            correlation_id=corr, tenant=req0.tenant,
            priority=req0.priority, deadline_at=req0.deadline_at)
        if req.deadline_at != float("inf"):
            # submit() never runs on this path: arm the expiry sweep
            self._deadlines_in_use = True
        if self.journal is not None:
            self.journal.record_submit(
                rid, req.prompt, req.max_new_tokens,
                cache_eligible_tokens=req.cache_eligible_tokens,
                correlation_id=corr, tenant=req.tenant,
                priority=req.priority)
            self.journal.checkpoint_many([(rid, [handoff.first_token])])
            self._journal_ckpt[rid] = 1
        tbl = self._alloc_blocks(self._pool.blocks_for(plen))
        width = handoff.kv_k.shape[3]               # NBpad * block
        sbids, soffs = self._write_maps([(0, tbl, 0, plen)], width, 1)
        with self._on_stream(), self._dispatch_boundary("kv_import"):
            self._pool.scatter(handoff.kv_k.to(self.device),
                               handoff.kv_v.to(self.device), sbids, soffs)
        self._free.remove(slot)
        self._tables[slot] = tbl
        self._owned_from[slot] = 0
        self.handoff_imported += 1
        now = time.monotonic()
        if self.telemetry is not None:
            self.telemetry.on_submit(rid, len(req.prompt), corr)
            self.telemetry.on_admit(rid, wave_start=now,
                                    admit_kind="handoff")
        self._activate(slot, req, int(handoff.first_token), plen,
                       handoff.prefill_s, now)
        return rid

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
        cfg, b, steps = self._mcfg, self._slots_ps, self._dispatch_steps
        dev = self.device
        win = (cfg.n_layers, b, cfg.n_kv_heads, steps, cfg.head_dim)
        i32 = dict(dtype=torch.int32, device=dev)
        st = {"tok": torch.zeros(b, dtype=torch.int64, device=dev),
              "pos": torch.zeros(b, dtype=torch.int32 if self.paged
                                 else torch.int64, device=dev),
              "k_win": zeros(win, self.kv_dtype, dev),
              "v_win": zeros(win, self.kv_dtype, dev),
              "out": torch.zeros((steps, self.num_slots), dtype=torch.int64,
                                 device=dev)}
        if self.paged:
            # the gather route's view reaches a dispatch's writes past
            # the bucket (``_view_width``)
            nb = self._view_width(self.max_len, steps) // self._block
            st.update(tables=torch.zeros(b * nb, **i32),
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
        cfg, st, w_sz = self._mcfg, self._static, self.decode_window
        k_all, v_all = st["k_win"], st["v_win"]
        storage_view(k_all).zero_()
        storage_view(v_all).zero_()
        positions = st["pos"]
        view = None
        if self.paged and self._kv_route == "reference":
            # the gather route: the working-set view the tables describe,
            # wide enough for this dispatch's writes, read by the
            # contiguous step
            nb = self._view_width(kv_len, self._dispatch_steps) \
                // self._block
            vk, vv = self._gather_view(
                st["tables"][:self._slots_ps * nb].view(self._slots_ps, nb))
            view = {"k": vk, "v": vv}

            def step(tok, w, k_win, v_win, k_done, v_done):
                return decoder.decode_step_windowed(
                    self.params, tok, positions, w, cfg, view, k_win,
                    v_win, kv_len=kv_len, k_done=k_done, v_done=v_done)
        elif self.paged:
            nb = kv_len // self._block
            tables = st["tables"][:self._slots_ps * nb].view(
                self._slots_ps, nb)
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
                tok = self._sample_rows(logits)
                st["out"][off + w] = tok
                if self._dp > 1:
                    # the whole batch's tokens; this group feeds its own
                    tok = tok[self._mine()]
        if view is not None:
            # merge into the view, read the merged columns back, scatter
            # them into the pool at the write maps
            steps = self._dispatch_steps
            decoder.merge_window(view, k_all, v_all, positions, steps=steps)
            self._pool.scatter_static(
                self._view_take(view["k"], positions, steps),
                self._view_take(view["v"], positions, steps),
                st["wbids"], st["woffs"], st["back"])
        elif self.paged:
            pool.scatter_static(k_all, v_all, st["wbids"], st["woffs"],
                                st["back"])
        else:
            decoder.merge_window(self._cache, k_all, v_all, positions,
                                 steps=self._dispatch_steps)

    def _sample_rows(self, logits: torch.Tensor) -> torch.Tensor:
        """Sample a dispatch's tokens for every slot: the dp groups' rows
        of ``logits`` all-gathered first (none without dp), so every rank
        draws the whole batch from its generator as the un-meshed engine
        does. [num_slots] int64."""
        return sample(self._gather_rows(logits), self._gen, self.sampling)

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """A pass's per-row output of this dp group, all-gathered into the
        whole batch's (slot order) on every rank; ``x`` itself without
        dp."""
        return all_gather_rows(x, self._dp_group)

    def _mine(self) -> slice:
        """This dp group's rows of a whole-batch host array."""
        return slice(self._row0, self._row0 + self._slots_ps)

    def _local_rows(self, slots):
        """``(local row, slot)`` of this dp group's slots among
        ``slots``."""
        return [(s - self._row0, s) for s in self._my_slots(slots)]

    def _my_slots(self, slots):
        """The slots of ``slots`` this rank's dp group owns."""
        mine = self._mine()
        return [s for s in slots if mine.start <= s < mine.stop]

    def _local_ids(self, bids) -> np.ndarray:
        """Global block ids of this rank's dp shard as local ids into its
        slice of the pool (the identity with one shard)."""
        return np.asarray(bids, dtype=BLOCK_TABLE_DTYPE) - self._id_base

    def _write_back(self) -> np.ndarray:
        """Where the paged dispatch's pool write sends (and writes back)
        its dropped entries: an active slot's last committed position,
        below every position the dispatch writes — a slot of this rank's
        dp group (local id); with none active there, every entry of the
        group's write is dropped, and block 0's first column is written
        back as it is."""
        slot = next(iter(self._my_slots(self._active)), None)
        if slot is None:
            return np.zeros(2, dtype=np.int32)
        p = int(self._positions[slot]) - 1
        return np.array([self._tables[slot][p // self._block]
                         - self._id_base, p % self._block], dtype=np.int32)

    def _decode_dispatch(self, kv_len: int) -> np.ndarray:
        """One decode dispatch at bucket ``kv_len``: the host copies the
        dispatch's inputs into the static buffers, the body runs (on the
        card, a replay of the bucket's graph once it was captured), and
        one device-to-host fetch brings its tokens back: [steps, slots]."""
        st, steps = self._static, self._dispatch_steps
        mine = self._mine()
        st["tok"].copy_(torch.from_numpy(self._next_tok[mine]))
        if self.paged:
            st["pos"].copy_(torch.from_numpy(
                self._positions[mine].astype(np.int32)))
            for slot in self._active:
                self._ensure_blocks(slot, int(self._positions[slot]) + steps)
            rows = [(s - self._row0, self._tables[s],
                     int(self._positions[s]), steps)
                    for s in self._my_slots(self._active)]
            sbids, soffs = self._write_maps(rows, steps, self._slots_ps)
            st["wbids"].copy_(torch.from_numpy(sbids))
            st["woffs"].copy_(torch.from_numpy(soffs))
            st["back"].copy_(torch.from_numpy(self._write_back()))
            # K3 reads the first kv_len // block entries of each row (the
            # JAX engine's kernel route slices its wider gather so too);
            # the gather route's view also covers the dispatch's writes
            width = kv_len if self._kv_route == "kernel" \
                else self._view_width(kv_len, steps)
            nb = width // self._block
            st["tables"][:self._slots_ps * nb].copy_(
                torch.from_numpy(self._gather_bids(width).reshape(-1)))
        else:
            st["pos"].copy_(torch.from_numpy(self._positions[mine]))
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
        # Speculation routes a step to the verify dispatch whenever any
        # active slot's draft index hits (slots without a draft ride the
        # same pass in the k=0 lane); draft-less steps keep the plain
        # windowed dispatch, which amortizes the host sync over a window.
        # _spec_allowed consults the supervisor's spec_verify breaker:
        # open → plain decode serves, half-open → this step may probe.
        # Steps with piggyback prompts pending keep the piggyback dispatch
        # (its chunk grid and a verify pass cannot share one pass).
        if (self.spec_decode and self._active and self._spec_allowed()
                and not (self._prefilling and self._free)):
            drafts = self._spec_drafts()
            if drafts:
                self._dispatch_verify(drafts)
                return
        # Snapshot BEFORE the dispatch: rows a piggyback dispatch
        # activates were prefilling during it — their decode lanes carried
        # garbage and are not harvested this round.
        active_before = list(self._active.items())
        piggy = bool(self._prefilling and self._free)
        kind = "piggyback" if piggy else "decode"
        seq = self.telemetry.next_step() if self.telemetry is not None \
            else None
        piggy_tok0 = self.piggy_tokens
        t0 = time.monotonic()
        try:
            with step_annotation(kind, seq, self.device), \
                    self._dispatch_boundary(kind):
                if piggy:
                    toks = self._dispatch_piggyback()
                else:
                    toks = self._decode_dispatch(self._kv_bucket())
        except Exception:
            # A failed dispatch leaves nothing a graph can trust: drop
            # them all. With a supervisor attached, capture again only
            # once it has repaired the engine (``on_repaired``).
            self._graphs.drop(block=self.supervisor is not None)
            raise
        step_s = time.monotonic() - t0
        self.decode_s += step_s
        if piggy:
            self.piggy_s += step_s
            self.piggy_dispatches += 1
        else:
            self.plain_s += step_s
            self.plain_dispatches += 1
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
            if self.spec_decode:
                # weight-pass ledger and draft index upkeep: a plain
                # window costs one weight pass a row a step
                self._row_tokens += len(gen) - harvested0
                self._row_passes += window
                idx = self._draft_index.get(slot)
                if idx is not None:
                    idx.extend(gen[harvested0:])
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
            # captured body records nothing. tokens: the harvested decode
            # tokens and the prompt tokens a piggyback dispatch prefilled
            self.telemetry.record_step(
                kind, step_s, seq=seq, rows=len(active_before),
                batch=self.num_slots,
                tokens=harvested_total + (self.piggy_tokens - piggy_tok0),
                padded_tokens=window * self.num_slots, route=self._kv_route)

    # ------------------------------------------------------------------
    # the scheduler and chunked prefill
    # ------------------------------------------------------------------

    def _sched_cost(self, req: Request) -> int:
        """What this request will prefill: its prompt minus the prefix
        cache's match — the DRR charge and the chunk-or-wave size, so a
        cached prompt costs its suffix. Over dp shards: the best match of
        any shard's trie (admission places the request there)."""
        if not self._prefixes:
            return len(req.prompt)
        digs = self._req_digests(req)
        match = max(pc.match_tokens(req.prompt, digests=digs)
                    for pc in self._prefixes)
        return max(1, len(req.prompt) - match)

    def _placement_key(self, req: Request):
        """Prefix-aware placement: the first radix block digest. Requests
        sharing it open with the same block-aligned span, so releasing
        them into one wave makes the wave ride the seeded path (or publish
        one shared prefix)."""
        if self._prefix is None:
            return None
        digs = self._req_digests(req)
        return digs[0] if digs else None

    def _sched_pump(self) -> None:
        """One scheduler turn: feed the closed loop, release at most one
        wave's token budget of requests (DRR order), route long cache-miss
        prompts to chunked prefill.

        On a mesh of several ranks the closed loop reads each rank's own
        clock and telemetry (TTFT p99, queue-wait p95), so rank 0's
        overload level, Retry-After and signals are broadcast and stand
        on every rank: every rank's scheduler then sheds alike at the
        door. The release reads only host state, which is whole on every
        rank; it is held to rank 0's, request id by request id and route
        by route, and a rank whose release differs raises."""
        sched = self._sched
        backlog = len(self._handoff) + self._handoff_external
        sched.observe(queued=self.queue_depth, active=len(self._active),
                      num_slots=self.num_slots, telemetry=self.telemetry,
                      free_blocks=(self._block_headroom()
                                   if self.paged else None),
                      total_blocks=(self._pool.num_blocks
                                    if self.paged else None),
                      handoff_backlog=(backlog if self.role == "prefill"
                                       else None))
        reqs: list[Request] = []
        staged = (len(self._queue) + len(self._prefilling)
                  + len(self._chunk_pending))
        room = len(self._free) - staged
        # the release hold (prefill role): finished prefills pile up
        # faster than the decode role drains them, and more waves would
        # only pin pool blocks behind the handoff (the shed loop guards
        # the door)
        hold = self.role == "prefill" and backlog >= self._handoff_high
        if room > 0 and not hold:
            reqs = sched.select(max_requests=room,
                                token_budget=sched.cfg.prefill_wave_tokens,
                                cost_fn=self._sched_cost,
                                placement_key=self._placement_key)
        ct = sched.cfg.chunk_tokens
        # Prefix hits keep the seeded wave; long cache misses chunk. A hit
        # shows as a suffix cost below the prompt length.
        route = [(req.request_id,
                  self._chunk_ok and self._sched_cost(req) >= len(req.prompt)
                  and len(req.prompt) > ct) for req in reqs]
        level, retry, signals, want = self._decide(lambda: (
            sched.overload_level, sched.retry_after_s,
            sched.last_signals, route))
        sched.overload_level, sched.retry_after_s = level, retry
        sched.last_signals = signals
        if want != route:
            raise RuntimeError(
                f"the scheduler released {route} on this rank and "
                f"{want} on rank 0: host state diverged across the mesh")
        for req, (_rid, chunk) in zip(reqs, route):
            if chunk:
                self._chunk_pending.append(req)
            else:
                self._queue.append(req)

    def _chunk_step(self) -> None:
        """One chunked-prefill dispatch: every chunking slot advances by at
        most one chunk of its prompt; rows whose prompt completes activate
        with their first token (sampled from the last prompt position).
        Free and decoding rows park at ``max_len``: their KV write drops
        and their output is discarded."""
        while self._chunk_pending and self._free \
                and self._occupied < self._slot_cap:
            if self.paged:
                # free-block accounting per dp shard (the JAX engine's
                # rule): the first shard with a free slot and headroom
                # for the worst case; chunked prompts are cache misses,
                # so there is no prefix to chase
                need = self._worst_blocks_total(self._chunk_pending[0])
                slot = None
                for sh in range(self._dp):
                    cand = next((x for x in self._free
                                 if self._slot_shard(x) == sh), None)
                    if cand is not None \
                            and need <= self._shard_headroom(sh):
                        slot = cand
                        break
                if slot is None:
                    break       # the pool cannot take the head yet
                self._free.remove(slot)
            else:
                slot = self._free.pop(0)
            # the start time feeds telemetry and prefill_s alone: no
            # rank's clock orders or gates the work
            self._chunking[slot] = [self._chunk_pending.pop(0), 0,
                                    time.monotonic()]
        if not self._chunking:
            return
        t0 = time.monotonic()
        ct = self._chunk_buckets[-1]
        rem_max = max(len(req.prompt) - filled
                      for req, filled, _ in self._chunking.values())
        width = _next_bucket(min(rem_max, ct), self._chunk_buckets)
        tokens = np.zeros((self.num_slots, width), dtype=np.int64)
        qlens = np.ones((self.num_slots,), dtype=np.int64)
        positions = np.full((self.num_slots,), self.max_len, dtype=np.int64)
        fed: dict[int, int] = {}
        for slot, (req, filled, _started) in self._chunking.items():
            n = min(len(req.prompt) - filled, width)
            tokens[slot, :n] = req.prompt[filled:filled + n]
            qlens[slot] = n
            positions[slot] = filled
            fed[slot] = n
        kv_len = self._kv_extent(max(e[1] for e in self._chunking.values()))
        seq = self.telemetry.next_step() if self.telemetry is not None \
            else None
        # The fill offsets advance only after the host fetch: a failed
        # dispatch leaves the entries as they were, and the next step
        # retries the same chunk. Over dp each group passes its own rows.
        mine = self._mine()
        with step_annotation("prefill_chunk", seq, self.device), \
                self._dispatch_boundary("prefill_chunk"):
            if self.paged:
                for slot, n in fed.items():
                    self._ensure_blocks(slot, self._chunking[slot][1] + n)
                rows = [(r, self._tables[slot], self._chunking[slot][1],
                         fed[slot]) for r, slot in self._local_rows(fed)]
                sbids, soffs = self._write_maps(rows, width,
                                                self._slots_ps)
                first = self._chunk_paged(tokens[mine], qlens[mine],
                                          positions[mine], sbids, soffs,
                                          kv_len)
            else:
                first = self._prefill_chunk(tokens[mine], qlens[mine],
                                            positions[mine], kv_len)
        step_s = time.monotonic() - t0
        self.chunk_s += step_s
        self.chunk_dispatches += 1
        now = time.monotonic()
        for slot in list(self._chunking):
            entry = self._chunking[slot]
            req, _filled, started = entry
            entry[1] += fed[slot]
            self.prefill_tokens += fed[slot]
            self.chunk_prefill_tokens += fed[slot]
            if entry[1] < len(req.prompt):
                continue
            del self._chunking[slot]
            tok = int(first[slot])
            if self.telemetry is not None:
                self.telemetry.on_admit(req.request_id, wave_start=started,
                                        admit_kind="chunked")
            if (self.role == "prefill" and tok not in self._eos_set
                    and req.max_new_tokens > 1):
                # chunked prefills hand off exactly like wave admits
                self._park_handoff(slot, req, tok, len(req.prompt),
                                   now - started)
                continue
            self._activate(slot, req, tok, len(req.prompt), now - started,
                           now)
        if self.telemetry is not None:
            self.telemetry.record_step(
                "prefill_chunk", step_s, seq=seq, rows=len(fed),
                batch=self.num_slots, tokens=sum(fed.values()),
                padded_tokens=self.num_slots * width, route=self._kv_route)
            self.telemetry.on_prefill_chunks(len(fed))

    @torch.inference_mode()
    def _prefill_chunk(self, tokens: np.ndarray, qlens: np.ndarray,
                       positions: np.ndarray, kv_len: int) -> np.ndarray:
        """The contiguous chunk pass over this dp group's rows: every
        slot's next prompt chunk attends (its own cache prefix ++ fresh
        causal chunk) in one weight pass (``decoder.verify_seeded``), the
        fresh KV lands at the per-row fill offset (``merge_window``), and
        every slot samples a candidate first token from its last fed
        position, the groups' rows all-gathered first. Returns the
        candidates [slots] (the one host fetch)."""
        dev = self.device
        tokens_t = torch.from_numpy(tokens).to(dev)
        qlens_t = torch.from_numpy(qlens).to(dev)
        positions_t = torch.from_numpy(positions).to(dev)
        logits, k_new, v_new = decoder.verify_seeded(
            self.params, tokens_t, qlens_t, positions_t, self._mcfg,
            self._cache, kv_len=kv_len)
        decoder.merge_window(self._cache, k_new, v_new, positions_t,
                             steps=tokens.shape[1])
        last = logits[torch.arange(logits.shape[0], device=dev),
                      qlens_t - 1]
        return sample(self._gather_rows(last), self._gen,
                      self.sampling).cpu().numpy()

    def _pool_partial_fn(self, kv_len: int):
        """K3 over the pool for a seeded pass at extent ``kv_len``: each
        row's table to ``kv_len // block`` entries (sentinel-padded), full
        attention (the seeded passes refuse sliding windows)."""
        tables = torch.from_numpy(self._gather_bids(kv_len)).to(self.device)
        pool = self._pool

        def partial_fn(li, q_rows, lns, q_pos):
            return paged_attention_partial(q_rows, pool.k, pool.v, li,
                                           tables, lns, q_pos, window=0)
        return partial_fn

    @torch.inference_mode()
    def _chunk_paged(self, tokens: np.ndarray, qlens: np.ndarray,
                     positions: np.ndarray, sbids: np.ndarray,
                     soffs: np.ndarray, kv_len: int) -> np.ndarray:
        """The paged chunk pass over this dp group's rows and pool shard:
        ``decoder.prefill_seeded_paged`` with the slot's filled prefix
        scored in place by K3 and the last valid row selected before the
        lm_head (``all_logits=False``), then one pool scatter of the
        chunk's KV and the candidates' sample over every group's rows."""
        dev = self.device
        tokens_t = torch.from_numpy(tokens).to(dev)
        qlens_t = torch.from_numpy(qlens).to(dev)
        positions_t = torch.from_numpy(positions).to(dev)
        if self._kv_route == "reference":
            # the gather route: the contiguous chunk pass over the view
            logits, k_new, v_new = self._seeded_over_view(
                tokens_t, qlens_t, positions_t, kv_len)
            last = logits[torch.arange(logits.shape[0], device=dev),
                          qlens_t - 1]
        else:
            last, k_new, v_new = decoder.prefill_seeded_paged(
                self.params, tokens_t, qlens_t, positions_t, self._mcfg,
                self._pool_partial_fn(kv_len), all_logits=False)
        self._pool.scatter(k_new, v_new, sbids, soffs)
        return sample(self._gather_rows(last), self._gen,
                      self.sampling).cpu().numpy()

    def _seeded_over_view(self, tokens_t: torch.Tensor,
                          qlens_t: torch.Tensor, positions_t: torch.Tensor,
                          kv_len: int):
        """The gather route's verify and chunk pass: gather the view the
        tables describe (wide enough for the pass's writes), run the
        contiguous seeded pass (``decoder.verify_seeded``) over it, merge
        its fresh KV into the view and read the merged columns back for
        the pool scatter. Returns (logits [B, S, V], k_new, v_new)."""
        s = tokens_t.shape[1]
        tables = torch.from_numpy(self._gather_bids(
            self._view_width(kv_len, s))).to(self.device)
        vk, vv = self._gather_view(tables)
        view = {"k": vk, "v": vv}
        logits, k_new, v_new = decoder.verify_seeded(
            self.params, tokens_t, qlens_t, positions_t, self._mcfg, view,
            kv_len=kv_len)
        decoder.merge_window(view, k_new, v_new, positions_t, steps=s)
        return (logits, self._view_take(view["k"], positions_t, s),
                self._view_take(view["v"], positions_t, s))

    # ------------------------------------------------------------------
    # piggyback prefill
    # ------------------------------------------------------------------

    def _pack_prefill(self):
        """Pack whole pending prompts into the W x P chunk grid, on the
        host. Each selected row occupies one consecutive run of steps in
        one lane, so its buffer span is contiguous and K1's begin/length
        bounds describe it exactly; first fit over lanes, and rows that do
        not fit wait for the next dispatch. Returns the per-step metadata
        [W, P, ...], the completion points, the buffer→cache write maps
        (live columns only) and the placed (slot, request, started)
        rows."""
        w_sz, chunk = self.decode_window, self.prefill_chunk
        p = self.prefill_rows
        buf = w_sz * chunk
        pre_tok = np.zeros((w_sz, p, chunk), dtype=np.int64)
        rope_base = np.zeros((w_sz, p), dtype=np.int64)
        kv_begin = np.full((w_sz, p), buf, dtype=np.int32)   # idle: all
        kv_len = np.zeros((w_sz, p), dtype=np.int32)         # masked
        sel_rel = np.zeros((w_sz, p), dtype=np.int64)
        sel_w, sel_p = [], []
        lanes, cols, slots, pos = [], [], [], []
        lane_next = [0] * p
        placed = []
        deferred = []
        for req, started in self._prefilling:
            plen = len(req.prompt)
            steps = -(-plen // chunk)
            lane = min(range(p), key=lambda i: lane_next[i])
            if (lane_next[lane] + steps > w_sz or not self._free
                    or self._occupied + len(placed) >= self._slot_cap):
                deferred.append((req, started))
                continue                        # wait for next dispatch
            slot = self._free.pop(0)
            s0 = lane_next[lane]
            lane_next[lane] = s0 + steps
            flat = np.zeros(steps * chunk, dtype=np.int64)
            flat[:plen] = req.prompt
            pre_tok[s0:s0 + steps, lane] = flat.reshape(steps, chunk)
            rope_base[s0:s0 + steps, lane] = np.arange(steps) * chunk
            kv_begin[s0:s0 + steps, lane] = s0 * chunk
            kv_len[s0:s0 + steps, lane] = s0 * chunk + np.minimum(
                (np.arange(steps) + 1) * chunk, plen)
            end = s0 + steps - 1
            sel_rel[end, lane] = (plen - 1) % chunk
            sel_w.append(end)
            sel_p.append(lane)
            lanes += [lane] * plen
            cols += range(s0 * chunk, s0 * chunk + plen)
            slots += [slot] * plen
            pos += range(plen)
            placed.append((slot, req, started))
            self.piggy_rows += 1
            self.piggy_tokens += plen
            self.prefill_tokens += plen
        self._prefilling = deferred
        return (pre_tok, rope_base, kv_begin, kv_len, sel_rel,
                (sel_w, sel_p), (lanes, cols, slots, pos), placed)

    def _dispatch_piggyback(self) -> np.ndarray:
        """One decode window with packed prefill chunks riding it.
        Returns the decoded tokens [window, slots]; completed prompts are
        activated into their slots here."""
        packed = self._pack_prefill()
        placed = packed[-1]
        try:
            return self._piggy_dispatch(*packed)
        except Exception:
            # Lossless unwind: packed rows took slots and left the feed
            # but never activated — requeue them at the head, free their
            # slots, and take back the accounting the pack charged.
            for slot, _req, _started in placed:
                self._free.append(slot)
            self._queue[0:0] = [req for _s, req, _t in placed]
            n_tok = sum(len(req.prompt) for _s, req, _t in placed)
            self.piggy_rows -= len(placed)
            self.piggy_tokens -= n_tok
            self.prefill_tokens -= n_tok
            raise

    @torch.inference_mode()
    def _piggy_dispatch(self, pre_tok, rope_base, kv_begin, kv_len, sel_rel,
                        sel, maps, placed) -> np.ndarray:
        """The piggyback dispatch, eager (no CUDA graph): W steps of
        ``decoder.decode_step_piggyback`` (one weight pass over B + P·C
        rows a step, one K1 call a layer for the chunks), then the
        window's one cache write (``merge_window``; placed rows' slots are
        parked, so their garbage decode lanes drop), the chunks' write
        (``merge_prefill``), and the placed rows' first tokens sampled
        from their last prompt positions. One host fetch brings back the
        decode tokens and the first tokens together.

        Over dp each group decodes its own rows and runs every lane (the
        pack is host state, alike on every rank): the lanes' work is
        repeated on each group, each group merges only its own slots'
        chunk columns, and the lanes' last hidden states — whole on every
        rank — give every rank the same first tokens, drawn after the
        window's, as the un-meshed engine draws them."""
        cfg, dev = self._mcfg, self.device
        w_sz, chunk, p = self.decode_window, self.prefill_chunk, \
            self.prefill_rows
        mine = self._mine()
        win = (cfg.n_layers, self._slots_ps, cfg.n_kv_heads, w_sz,
               cfg.head_dim)
        bufs = (cfg.n_layers, p, cfg.n_kv_heads, w_sz * chunk, cfg.head_dim)
        k_win, v_win = zeros(win, self.kv_dtype, dev), \
            zeros(win, self.kv_dtype, dev)
        kbuf, vbuf = zeros(bufs, self.kv_dtype, dev), \
            zeros(bufs, self.kv_dtype, dev)
        positions = torch.from_numpy(self._positions[mine]).to(dev)
        tok = torch.from_numpy(self._next_tok[mine]).to(dev)
        pre_tok_t = torch.from_numpy(pre_tok).to(dev)
        rope_t = torch.from_numpy(rope_base).to(dev)
        begin_t = torch.from_numpy(kv_begin).to(dev)
        len_t = torch.from_numpy(kv_len).to(dev)
        sel_t = torch.from_numpy(sel_rel).to(dev)
        kv_ext = self._kv_bucket()
        outs, h_steps = [], []
        for w in range(w_sz):
            logits, k_cols, v_cols, _pk, _pv, h_step = \
                decoder.decode_step_piggyback(
                    self.params, tok, positions, w, cfg, self._cache,
                    k_win, v_win, pre_tok_t[w], rope_t[w], begin_t[w],
                    len_t[w], sel_t[w], kbuf, vbuf, kv_len=kv_ext)
            # the step wrote its chunk's KV into kbuf/vbuf itself
            k_win[:, :, :, w] = k_cols
            v_win[:, :, :, w] = v_cols
            tok = self._sample_rows(logits)     # the whole batch's
            outs.append(tok)
            if self._dp > 1:
                tok = tok[mine]                 # this group feeds its own
            h_steps.append(h_step)
        decoder.merge_window(self._cache, k_win, v_win, positions,
                             steps=w_sz)
        if self._dp > 1:
            # this group's slots' chunk columns, at their local rows
            lanes, cols, slots, pos = maps
            keep = [i for i, sl in enumerate(slots)
                    if mine.start <= sl < mine.stop]
            maps = ([lanes[i] for i in keep], [cols[i] for i in keep],
                    [slots[i] - mine.start for i in keep],
                    [pos[i] for i in keep])
        decoder.merge_prefill(self._cache, kbuf, vbuf, *maps)
        parts = [torch.stack(outs).reshape(-1)]
        if placed:
            sel_w, sel_p = (torch.tensor(x, dtype=torch.long, device=dev)
                            for x in sel)
            h_sel = torch.stack(h_steps)[sel_w, sel_p]           # [M, D]
            first_logits = decoder._unembed(h_sel, self.params, cfg)
            parts.append(sample(first_logits, self._gen, self.sampling))
        got = torch.cat(parts).cpu().numpy()       # the ONE host fetch
        toks = got[:w_sz * self.num_slots].reshape(w_sz, self.num_slots)
        first = got[w_sz * self.num_slots:]
        now = time.monotonic()
        for i, (slot, req, started) in enumerate(placed):
            # every placed row completed (whole prompts only)
            tok_i = int(first[i])
            if self.telemetry is not None:
                self.telemetry.on_admit(req.request_id, wave_start=started,
                                        admit_kind="piggyback")
            self._activate(slot, req, tok_i, len(req.prompt), now - started,
                           now)
        return toks

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------

    def _spec_allowed(self) -> bool:
        """The supervisor's ``spec_verify`` breaker (open after repeated
        verify failures) vetoes the verify dispatch; plain decode
        serves."""
        sup = self.supervisor
        if sup is None:
            return True
        # the breaker reads clocks: on a mesh, rank 0's verdict
        return self._decide(sup.spec_allowed)

    def _spec_track(self, slot: int, req: Request, first_tok: int) -> None:
        """Build the stream's draft index at activation (spec engines):
        once over the prompt and the first token, extended per accepted
        token from then on."""
        if not self.spec_decode:
            return
        idx = NgramDraftIndex(req.prompt, ngram=self.spec_ngram,
                              min_ngram=self.spec_min_ngram)
        idx.extend([first_tok])
        self._draft_index[slot] = idx

    def _spec_bucket(self, n: int) -> int:
        """Largest declared draft length <= n (0 = no draft)."""
        return max(k for k in self.spec_draft_lens if k <= n)

    def _spec_drafts(self) -> dict[int, list[int]]:
        """Prompt-lookup drafts for the next verify dispatch: each active
        slot's index is probed and its draft clamped to the cache room
        (the verify writes KV at [pos, pos + k]). The dispatch's width
        snaps to the declared buckets and fires only when some slot's
        draft reaches a nonzero one; shorter drafts ride the same pass
        through their row lengths. Empty: the step takes the plain
        windowed dispatch."""
        cands: dict[int, list[int]] = {}
        k_max = 0
        for slot in self._active:
            idx = self._draft_index.get(slot)
            if idx is None:
                continue
            self.spec_lookups += 1
            d = idx.draft(self._spec_max_draft)
            d = d[:max(0, self.max_len - 1 - int(self._positions[slot]))]
            if d:
                cands[slot] = d
                k_max = max(k_max, self._spec_bucket(len(d)))
        if k_max == 0:
            return {}
        drafts = {}
        for slot, d in cands.items():
            drafts[slot] = d[:k_max]
            self.spec_hits += 1
            self.spec_drafted_tokens += len(drafts[slot])
        return drafts

    def _dispatch_verify(self, drafts: dict[int, list[int]]) -> None:
        """One verify dispatch: every active slot's committed next token
        plus its (possibly empty) draft in one weight pass, exact
        acceptance, and the rewind to the accept point on the host."""
        k_max = max(len(d) for d in drafts.values())
        s = k_max + 1
        active_before = list(self._active.items())
        tokens = np.zeros((self.num_slots, s), dtype=np.int64)
        tokens[:, 0] = self._next_tok
        qlens = np.ones((self.num_slots,), dtype=np.int64)
        for slot, d in drafts.items():
            tokens[slot, 1:1 + len(d)] = d
            qlens[slot] = len(d) + 1
        t0 = time.monotonic()
        seq = self.telemetry.next_step() if self.telemetry is not None \
            else None
        with step_annotation("verify", seq, self.device), \
                self._dispatch_boundary("verify"):
            kv_len = self._kv_bucket()
            if self.paged:
                # The width is global: a near-cap row's columns past
                # max_len are dead padding, so its table grows only to
                # max_len (its admission-time reservation)
                for slot in self._active:
                    self._ensure_blocks(
                        slot, min(int(self._positions[slot]) + s,
                                  self.max_len))
                rows = [(r, self._tables[sl], int(self._positions[sl]), s)
                        for r, sl in self._local_rows(self._active)]
                sbids, soffs = self._write_maps(rows, s, self._slots_ps)
                out, acc = self._verify_paged(tokens, qlens, sbids, soffs,
                                              kv_len)
            else:
                out, acc = self._verify(tokens, qlens, kv_len)
        step_s = time.monotonic() - t0
        self.spec_s += step_s
        self.decode_s += step_s
        self.spec_dispatches += 1
        accepted0 = self.spec_accepted_tokens
        emitted0 = self.spec_emitted_tokens
        for slot, req in active_before:
            m = int(acc[slot]) + 1        # emitted: accepts + 1 sample
            self.spec_accepted_tokens += m - 1
            self.spec_rows += 1
            self._row_passes += 1
            gen = self._generated[slot]
            emitted = [int(t) for t in out[slot, :m]]
            finished = None
            kept = 0
            for tok in emitted:
                gen.append(tok)
                kept += 1
                if tok in self._eos_set:
                    finished = "eos"
                    break
                if len(gen) >= req.max_new_tokens:
                    finished = "length"
                    break
            self.spec_emitted_tokens += kept
            self._row_tokens += kept
            self._draft_index[slot].extend(emitted[:kept])
            # Rewind or advance the committed length to the accept point:
            # columns [pos + m, pos + k_max] hold rejected-draft KV, dead
            # under the strict prefix mask until the next write lands
            self._positions[slot] += m
            self._next_tok[slot] = emitted[m - 1]
            if (finished is None
                    and self._positions[slot] + self._dispatch_steps
                    > self.max_len - 1):
                finished = "length"
            if finished:
                self._retire(slot, finished)
        self.decode_tokens += self.spec_emitted_tokens - emitted0
        if self.telemetry is not None:
            self.telemetry.record_step(
                "verify", step_s, seq=seq, rows=len(active_before),
                batch=self.num_slots,
                tokens=self.spec_emitted_tokens - emitted0,
                padded_tokens=s * self.num_slots,
                draft_tokens=sum(len(d) for d in drafts.values()),
                accepted_tokens=self.spec_accepted_tokens - accepted0,
                route=self._kv_route)

    @torch.inference_mode()
    def _verify(self, tokens: np.ndarray, qlens: np.ndarray,
                kv_len: int) -> tuple[np.ndarray, np.ndarray]:
        """The contiguous verify pass over this dp group's rows:
        ``decoder.verify_seeded`` scores k+1 positions a slot against the
        slot cache read in place, the fresh KV of all fed tokens lands at
        the per-row offset in one ``merge_window`` (columns past the
        accept point are dead by the prefix mask), and ``verify_draft``
        accepts over every group's rows. ``tokens``/``qlens`` are the
        whole batch's. Returns (tokens [slots, S], accepted [slots]) from
        one host fetch."""
        dev, mine = self.device, self._mine()
        tokens_t = torch.from_numpy(tokens[mine]).to(dev)
        qlens_t = torch.from_numpy(qlens[mine]).to(dev)
        positions_t = torch.from_numpy(self._positions[mine]).to(dev)
        logits, k_new, v_new = decoder.verify_seeded(
            self.params, tokens_t, qlens_t, positions_t, self._mcfg,
            self._cache, kv_len=kv_len)
        decoder.merge_window(self._cache, k_new, v_new, positions_t,
                             steps=tokens.shape[1])
        return self._accept(logits, tokens, qlens)

    @torch.inference_mode()
    def _verify_paged(self, tokens: np.ndarray, qlens: np.ndarray,
                      sbids: np.ndarray, soffs: np.ndarray,
                      kv_len: int) -> tuple[np.ndarray, np.ndarray]:
        """The paged verify pass over this dp group's rows and pool shard:
        ``decoder.prefill_seeded_paged`` with every position's logits
        (``all_logits=True``) and each slot's committed prefix scored in
        place by K3 (R = group x (k+1) rows a kv head), one pool scatter
        of the fed tokens' KV, then ``verify_draft`` over every group's
        rows."""
        dev, mine = self.device, self._mine()
        tokens_t = torch.from_numpy(tokens[mine]).to(dev)
        qlens_t = torch.from_numpy(qlens[mine]).to(dev)
        positions_t = torch.from_numpy(self._positions[mine]).to(dev)
        if self._kv_route == "reference":
            logits, k_new, v_new = self._seeded_over_view(
                tokens_t, qlens_t, positions_t, kv_len)
        else:
            logits, k_new, v_new = decoder.prefill_seeded_paged(
                self.params, tokens_t, qlens_t, positions_t, self._mcfg,
                self._pool_partial_fn(kv_len), all_logits=True)
        self._pool.scatter(k_new, v_new, sbids, soffs)
        return self._accept(logits, tokens, qlens)

    def _accept(self, logits: torch.Tensor, tokens: np.ndarray,
                qlens: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """``verify_draft`` over a verify pass's logits (this dp group's
        rows, all-gathered into the whole batch's first, so every rank
        draws as the un-meshed engine does) against the whole batch's
        ``tokens``/``qlens``: the emitted tokens [slots, S] and accept
        counts [slots] in one host fetch."""
        dev = logits.device
        tokens_t = torch.from_numpy(tokens).to(dev)
        qlens_t = torch.from_numpy(qlens).to(dev)
        out, n_accept = verify_draft(self._gather_rows(logits),
                                     tokens_t[:, 1:], qlens_t - 1,
                                     self._gen, self.sampling)
        both = torch.cat([out, n_accept[:, None]], dim=1).cpu().numpy()
        return both[:, :-1], both[:, -1]       # the ONE host fetch

    # ------------------------------------------------------------------
    # retirement
    # ------------------------------------------------------------------

    def _publish(self, slot: int, req: Request) -> set[int] | frozenset:
        """Publish a leaving slot's prompt prefix to the prefix cache,
        then hand its match pins back. Paged: the trie adopts the slot's
        own prompt-prefix blocks by refcount (returned, so the caller
        frees the rest); contiguous: the prompt KV is copied cache→pool,
        which must happen before the slot is reused (a decode replay
        writes the cache in place). A failed publish is contained: it is
        counted and loses only the cache's share, never the completion."""
        adopted: set[int] | frozenset = frozenset()
        if not self._prefixes:
            return adopted
        pc = self._trie(slot)
        try:
            with self._dispatch_boundary("prefix_publish"):
                if self.paged:
                    adopted = pc.adopt_blocks(
                        req.prompt, self._tables[slot],
                        self._owned_from[slot],
                        eligible_tokens=req.cache_eligible_tokens)
                else:
                    pc.publish(req.prompt, self._cache, slot,
                               eligible_tokens=req.cache_eligible_tokens)
        except Exception:
            self.prefix_publish_failures += 1
        finally:
            m = self._prefix_pins.pop(req.request_id, None)
            if m is not None:
                pc.release(m)
        return adopted

    def _retire(self, slot: int, reason: str) -> None:
        self._positions[slot] = self.max_len   # park out of range
        self._draft_index.pop(slot, None)
        req = self._active.pop(slot)
        adopted = self._publish(slot, req)
        if self.paged:
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
                self.prefix_stats() if self._prefixes else None,
                self.spec_stats() if self.spec_decode else None)
        self._free.append(slot)

    def _expire_deadlines(self) -> None:
        """Drop every request whose ``deadline_at`` has passed — queued
        work uncomputed (an empty completion: the wave queue, the
        piggyback feed, the chunk queue, chunking slots, slots parked for
        the handoff and the scheduler's queues), active slots
        retired with their partial output — all with
        ``finish_reason="deadline"``. It runs at the head of ``step``,
        between dispatches, so a retired slot parks exactly as an eos or
        length retirement parks it: the next dispatch's static buffers are
        filled from host state that no longer holds it, and its pool
        blocks are back in the pool. On a mesh the clock read is rank 0's:
        it names the late requests, and every rank drops those."""
        if not self._deadlines_in_use:
            return    # no deadline ever submitted: skip the queue walk
        now = time.monotonic()
        late_ids = self._decide(lambda: {
            r.request_id for r in self._requests() + self._sched_queued()
            if r.deadline_at <= now})

        def is_late(r: Request) -> bool:
            return r.request_id in late_ids

        expired = [r for r in self._queue if is_late(r)]
        if expired:
            self._queue = [r for r in self._queue if not is_late(r)]
        late = [r for r in self._chunk_pending if is_late(r)]
        if late:
            self._chunk_pending = [r for r in self._chunk_pending
                                   if not is_late(r)]
            expired += late
        late = [r for r, _t in self._prefilling if is_late(r)]
        if late:
            self._prefilling = [(r, t) for r, t in self._prefilling
                                if not is_late(r)]
            expired += late
        for slot in list(self._chunking):
            req = self._chunking[slot][0]
            if is_late(req):
                del self._chunking[slot]
                self._positions[slot] = self.max_len
                if self.paged:
                    self._paged_release_slot(slot)
                self._free.append(slot)
                expired.append(req)
        for slot in list(self._handoff):
            req = self._handoff[slot][0]
            if is_late(req):
                del self._handoff[slot]
                m = self._prefix_pins.pop(req.request_id, None)
                if m is not None:
                    self._trie(slot).release(m)
                self._paged_release_slot(slot)
                self._free.append(slot)
                expired.append(req)
        if self._sched is not None:
            # the scheduler drops by its own clock read: stamp the late
            # requests past every clock, and drop exactly those
            for r in self._sched_queued():
                if r.request_id in late_ids:
                    r.deadline_at = float("-inf")
            expired += self._sched.drop_expired(float("-inf"))
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
            if is_late(req):
                self.deadline_expired += 1
                if self.telemetry is not None:
                    self.telemetry.on_deadline_expired()
                self._retire(slot, "deadline")

    def _requests(self) -> list[Request]:
        """Every request the engine holds: queued, in the piggyback feed,
        waiting to chunk or chunking, parked for the handoff, active."""
        return (list(self._queue) + [r for r, _ in self._prefilling]
                + list(self._chunk_pending)
                + [e[0] for e in self._chunking.values()]
                + [h[0] for h in self._handoff.values()]
                + list(self._active.values()))

    def _sched_queued(self) -> list[Request]:
        """The requests the scheduler holds, in its queues' order."""
        if self._sched is None:
            return []
        return [r for q in self._sched._queues.values() for r in q]

    def _decide(self, decide):
        """A host decision that reads a clock: ``decide()`` as rank 0 takes
        it, on every rank (no mesh: here)."""
        return broadcast_decision(decide(), self._world)

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

        # on a mesh: rank 0's rows and wall clock, on every rank, so each
        # resubmits the same rows in the same order under the same ids
        entries, now_wall = self._decide(lambda: (
            self.journal.unfinished() if self.journal is not None
            else None, time.time()))
        if not entries:
            return 0
        j = self.journal                # None on the other ranks
        # continuation ids must never collide with journaled ids, or the
        # re-key and the retire would hit the wrong row
        self._next_id = max(self._next_id,
                            max(e.request_id for e in entries) + 1)
        self._journal_recovering = True
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
                    if j is not None:
                        j.record_abandon(e.request_id)
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
                if j is not None:
                    j.supersede(e.request_id, rid, e.tokens)
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
            self._journal_recovering = False
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
        spent capturing, replays, and dispatches that ran eagerly — and,
        where a mesh's collectives could not be captured, why the engine
        serves eagerly (``eager_reason``)."""
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
