"""Disaggregated prefill/decode serving — port of the JAX package's
``engine/roles.py`` for one device a role.

A prefill wave is one weight pass over thousands of prompt tokens bound by
operations; a decode step is a weight stream over every active stream
bound by bytes. Co-located, every admission wave is an inter-token stall
for the streams already decoding. This module splits serving into a
prefill-role and a decode-role :class:`GenerationEngine`:

* **RoleConfig** partitions a device list: the first ``prefill_dp × tp``
  devices serve prefill, the rest decode. The port runs one device a role
  (dp = tp = 1); a role that spans devices waits for the port's
  ``parallel/`` package (ROADMAP Queue 1 item 6).
* **Prefill engine** (``role="prefill"``): admission waves and chunked
  prefill; a finished prefill (prompt KV and its sampled first token)
  parks instead of decoding.
* **KV handoff**: :meth:`DisaggregatedEngine.step` drains parked prefills
  with ``take_prefilled`` (one dense gather of the slot's blocks), and the
  decode engine's ``admit_prefilled`` moves the KV onto its device with
  ``Tensor.to`` and writes it into freshly allocated blocks of its own
  pool. A device list that names one card twice runs both roles on that
  card: the move is then no copy, and the handoff is a block-to-block
  write inside one card's memory.
* **Backpressure**: ``admit_prefilled`` returning None re-parks the
  handoff; the prefill engine's scheduler sees the backlog
  (``handoff_backlog`` and the engine's ``handoff_high`` release hold).

Greedy f32 outputs equal a co-located engine's: the handoff moves the
exact KV bytes and the first token was sampled by the same prefill pass.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from copilot_for_consensus_tpu_torch.device import resolve_device
from copilot_for_consensus_tpu_torch.engine.generation import (
    Completion,
    GenerationEngine,
    PrefilledHandoff,
)


@dataclass(frozen=True)
class RoleConfig:
    """How to split a device list into prefill- and decode-role devices.
    ``prefill_dp``/``decode_dp`` are dp-group counts; each role spans
    ``dp × tp`` devices. ``decode_dp=0`` takes the remainder."""

    prefill_dp: int = 1
    decode_dp: int = 0
    tp: int = 1

    def resolve(self, n_devices: int) -> "RoleConfig":
        pre = self.prefill_dp * self.tp
        if pre >= n_devices:
            raise ValueError(
                f"prefill role takes {pre} devices of {n_devices}; "
                f"nothing left for decode")
        rest = n_devices - pre
        dec = self.decode_dp
        if dec == 0:
            if rest % self.tp:
                raise ValueError(
                    f"remaining {rest} devices do not divide tp="
                    f"{self.tp}")
            dec = rest // self.tp
        if dec * self.tp != rest:
            raise ValueError(
                f"role split {pre}+{dec * self.tp} != {n_devices} "
                f"devices")
        return RoleConfig(self.prefill_dp, dec, self.tp)


class DisaggregatedEngine:
    """Prefill-role + decode-role engine pair behind the ``submit`` /
    ``step`` / ``generate`` surface. Single-owner like the engines it
    wraps: drive it from one thread.

    ``devices`` lists torch devices, one a role after ``RoleConfig
    .resolve`` (None: the card, named twice, so both roles share it).
    ``engine_kw`` is shared engine configuration (paged geometry, dtypes,
    prefill buckets ...); ``prefill_kw``/``decode_kw`` overlay it per role
    (the decode side admits by handoff only, so it gets no scheduler
    unless one is given)."""

    def __init__(self, cfg, params=None, *,
                 roles: RoleConfig = RoleConfig(),
                 devices: list | None = None,
                 engine_kw: dict | None = None,
                 prefill_kw: dict | None = None,
                 decode_kw: dict | None = None):
        devs = [resolve_device(d) for d in devices] if devices is not None \
            else [resolve_device(None)] * 2
        roles = roles.resolve(len(devs))
        if max(roles.prefill_dp, roles.decode_dp, roles.tp) > 1:
            raise NotImplementedError(
                f"a role over more than one device ({roles}) needs the "
                f"port's parallel/ package (ROADMAP Queue 1 item 6); the "
                f"port runs one device a role")
        self.roles = roles
        self.prefill_device, self.decode_device = devs
        kw = dict(engine_kw or {})
        if not kw.get("kv_pool_blocks"):
            raise ValueError(
                "DisaggregatedEngine requires kv_pool_blocks: the "
                "block pool is the KV-handoff substrate")
        pkw = {**kw, **(prefill_kw or {})}
        dkw = {**kw, **(decode_kw or {})}
        # decode-role engines admit via handoff only — a scheduler there
        # would gate a queue that never fills
        dkw.setdefault("scheduler", None)
        self.prefill = GenerationEngine(
            cfg, params, role="prefill", device=self.prefill_device, **pkw)
        self.decode = GenerationEngine(
            cfg, params, role="decode", device=self.decode_device, **dkw)
        #: handoffs exported from the prefill pool but not yet admitted
        #: into the decode pool (decode-side backpressure)
        self._pending: list[PrefilledHandoff] = []
        #: decode-engine rid → public rid (completion re-keying)
        self._rid_map: dict[int, int] = {}
        #: prefill-engine rid → public rid
        self._pre_map: dict[int, int] = {}
        self._next_public = 0
        self.handoffs = 0
        self.handoff_blocks = 0
        self.handoff_wait_s = 0.0

    # -- public surface --------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 256,
               **kw) -> int:
        rid_pre = self.prefill.submit(prompt, max_new_tokens, **kw)
        rid_pub = self._next_public
        self._next_public += 1
        self._pre_map[rid_pre] = rid_pub
        return rid_pub

    def step(self) -> list[Completion]:
        """One cooperative turn: the prefill engine steps (admission and
        chunked prefill), finished prefills hand off to the decode engine
        as far as its capacity allows, the decode engine steps.
        Completions come back under the PUBLIC request ids."""
        out: list[Completion] = []
        # requests that finished AT the prefill (first-token eos,
        # max_new_tokens <= 1, deadline) complete directly
        for c in self.prefill.step():
            out.append(self._rekey(c, self._pre_map.pop(
                c.request_id, c.request_id)))
        # Drain parked prefills only as far as the decode side could seat
        # them: an exported handoff holds a dense copy of its prompt KV,
        # and un-exported ones stay parked (blocks, not copies), where
        # the prefill engine's backlog signal sees them.
        room = max(0, len(self.decode._free) - len(self._pending))
        if room:
            self._pending.extend(self.prefill.take_prefilled(limit=room))
        self.prefill.set_handoff_external(len(self._pending))
        still: list[PrefilledHandoff] = []
        for h in self._pending:
            rid_dec = self.decode.admit_prefilled(h)
            if rid_dec is None:
                still.append(h)       # decode full: re-park
                continue
            pub = self._pre_map.pop(h.request.request_id,
                                    h.request.request_id)
            self._rid_map[rid_dec] = pub
            wait = max(0.0, time.monotonic() - h.ready_at)
            self.handoffs += 1
            self.handoff_blocks += h.blocks
            self.handoff_wait_s += wait
            tele = self.prefill.telemetry
            if tele is not None:
                tele.on_handoff(h.blocks, wait)
        self._pending = still
        for c in self.decode.step():
            out.append(self._rekey(c, self._rid_map.pop(
                c.request_id, c.request_id)))
        return out

    def generate(self, prompts: list[list[int]],
                 max_new_tokens: int = 256, **kw) -> list[Completion]:
        ids = [self.submit(p, max_new_tokens, **kw) for p in prompts]
        results: dict[int, Completion] = {}
        while len(results) < len(ids):
            for c in self.step():
                results[c.request_id] = c
        return [results[i] for i in ids]

    @property
    def queue_depth(self) -> int:
        return (self.prefill.queue_depth + len(self._pending)
                + len(self.prefill._handoff)
                + self.decode.queue_depth)

    def stats(self) -> dict:
        """Role-split ledger for benches and metrics."""
        return {
            "handoffs": self.handoffs,
            "handoff_blocks": self.handoff_blocks,
            "handoff_wait_mean_s": (self.handoff_wait_s / self.handoffs
                                    if self.handoffs else 0.0),
            "pending_handoffs": len(self._pending),
            "prefill": self.prefill.kv_pool_stats(),
            "decode": self.decode.kv_pool_stats(),
        }

    # -- internals -------------------------------------------------------

    @staticmethod
    def _rekey(c: Completion, public_id: int) -> Completion:
        if c.request_id == public_id:
            return c
        return Completion(
            request_id=public_id, prompt_len=c.prompt_len,
            tokens=c.tokens, finish_reason=c.finish_reason,
            prefill_s=c.prefill_s, decode_s=c.decode_s, ttft_s=c.ttft_s)

