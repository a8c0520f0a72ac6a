"""Process-kill chaos driver for the engine journal (engine/journal.py),
on the port's engine.

One deterministic engine storm per process, SIGKILL-able at an exact
step — the child half of a kill/resume check (``chip_smoke.py``'s
``journal`` phase on the card, and the slow real-process test
``tests/test_torch_journal.py``):

    python -m copilot_for_consensus_tpu_torch.tools.journal_storm \
        --journal /tmp/j.sqlite3 --out /tmp/completions.jsonl \
        --result /tmp/result.json [--kill-after-step 8] [--device cpu]

* Fresh journal → submit ``--requests`` deterministic prompts (seeded
  rng; correlation ids ``js-<i>``) and serve them.
* Non-empty journal → submit NOTHING: the engine warm-restarts from the
  journal at construction and this process serves only the recovered
  work. The result names, for each recovered row, the tokens it had
  checkpointed (``resumed``), so a harness can check that each resumed
  stream starts with them.
* Every completion appends one JSON line (``{"cid", "tokens",
  "finish_reason"}``) to ``--out``, flushed and fsynced per step, so a
  SIGKILL loses no record of work that retired (the journal row of a
  retired request is already gone, so the line is its only witness — the
  harness merges pre-kill and post-restart lines and gates lost 0 /
  duplicated 0 across the union).
* ``--kill-after-step N``: after the Nth ``engine.step()`` (lines
  flushed), the process SIGKILLs itself — a real, unhandled process death
  at a deterministic point mid-storm, with queued requests, active slots
  and partially checkpointed tokens all live.
* ``--spool PATH --proc NAME``: ship telemetry (metric deltas, step
  records, submit/replay spans) into a crash-safe spool (obs/ship.py),
  flushed synchronously per step BEFORE the kill check. Span ids derive
  from correlation ids, so the resume process's ``engine_replay`` spans
  parent onto the killed process's ``engine_submit`` spans.

The engine: by default the tiny storm config at f32 compute and KV, so
every child builds the bit-identical engine and greedy outputs across
kill and restart equal an uninterrupted run's exactly. ``--model`` takes
any decoder config of the port (``mistral-7b`` at full width, its depth
in-process callers may cut its depth), ``--quantize int8`` and ``--dtype
bfloat16`` the serving weights and activations; the weights are random
from seed 0, the same in every child. The engine runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys
import time

#: the storm's own tiny config (the JAX package's storm config)
TINY = "journal-storm-tiny"


def build_engine(journal, telemetry: bool = False, *, model: str = TINY,
                 layers: int = 0, quantize: str = "", dtype: str = "float32",
                 device=None):
    """The storm's deterministic engine: 4 slots, max_len 192, prefill
    buckets (32, 64), decode window 4, KV in the activation dtype, random
    weights from seed 0 (the same in every process). ``layers`` cuts the
    model's depth (0: its own). ``telemetry`` is host-side bookkeeping
    only — token streams are the same either way."""
    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.models.configs import (
        DecoderConfig,
        decoder_config,
    )

    if model == TINY:
        cfg = DecoderConfig(name=TINY, vocab_size=128, d_model=32,
                            n_layers=2, n_heads=4, n_kv_heads=2, d_ff=64,
                            max_seq_len=256)
    else:
        cfg = decoder_config(model,
                             **({"n_layers": layers} if layers else {}))
    return GenerationEngine(
        cfg, num_slots=4, max_len=192, prefill_buckets=(32, 64),
        dtype=dtype, quantize=quantize or False, seed=0,
        decode_window=4, windows_per_dispatch=1, telemetry=telemetry,
        journal=journal, device=device)


def _span_ids(cid: str) -> tuple[str, str, str]:
    """Deterministic (trace_id, submit_span_id, replay_span_id) from a
    correlation id — both sides of a kill/resume pair derive the SAME
    ids, which is what lets the replay span (resume process) parent onto
    the submit span (killed process) across spools."""
    digest = hashlib.sha256(cid.encode()).hexdigest()
    return digest[:32], digest[32:48], digest[48:64]


def storm_prompts(n: int, seed: int) -> list[list[int]]:
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(3, 120, size=16 + (i % 7)).tolist()
            for i in range(n)]


def kernel_launches() -> dict:
    """The decoder kernels' launches in this process by body (K1, K2,
    K3): what a harness that cannot see the process's counters reads."""
    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    return {"K1": dict(fa.flash_attention.launches_by_body),
            "K2": dict(qm.int8_matmul.launches_by_body),
            "K3": dict(pa.paged_attention_partial.launches_by_body)}


def _busy(eng) -> bool:
    return bool(eng._queue or eng._active or eng._done)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m copilot_for_consensus_tpu_torch.tools.journal_storm")
    ap.add_argument("--journal", required=True,
                    help="engine journal sqlite path (shared across "
                         "the kill and resume processes)")
    ap.add_argument("--out", required=True,
                    help="completions JSONL (appended; one line per "
                         "retired request)")
    ap.add_argument("--result", required=True,
                    help="end-of-run stats JSON (never written when "
                         "the process is killed — that's the point)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--kill-after-step", type=int, default=0,
                    help="SIGKILL this process after step N (0 = run "
                         "to completion)")
    ap.add_argument("--max-steps", type=int, default=2000)
    ap.add_argument("--spool", default="",
                    help="telemetry spool path (obs/ship.py); ships "
                         "metric deltas + step records + submit/"
                         "replay spans, flushed per step so committed "
                         "rows survive the SIGKILL")
    ap.add_argument("--proc", default="",
                    help="process name stamped on shipped telemetry "
                         "(default: storm-<pid>)")
    ap.add_argument("--checkpoint-every", type=int, default=2,
                    help="decode steps between the journal's token "
                         "checkpoints")
    ap.add_argument("--model", default=TINY,
                    help=f"decoder config ({TINY!r}, or one of the port's "
                         f"configs, e.g. mistral-7b)")
    ap.add_argument("--quantize", default="",
                    help="weight quantization (int8, int4; default none)")
    ap.add_argument("--dtype", default="float32",
                    help="activation and KV dtype (float32, bfloat16)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from copilot_for_consensus_tpu_torch.engine.journal import EngineJournal

    journal = EngineJournal(args.journal,
                            checkpoint_every=args.checkpoint_every)
    resume = journal.depth() > 0
    rows = journal.unfinished()
    # original-rid → cid, for completions the warm restart emits
    # directly (deadline-expired rows, fully-generated rows)
    old_cids = {e.request_id: e.correlation_id for e in rows}
    resumed = {e.correlation_id: list(e.tokens) for e in rows}
    t0 = time.monotonic()
    eng = build_engine(journal, telemetry=bool(args.spool),
                       model=args.model, quantize=args.quantize,
                       dtype=args.dtype, device=args.device)
    build_s = time.monotonic() - t0

    shipper = None
    collector = None
    if args.spool:
        from copilot_for_consensus_tpu_torch.obs.ship import (
            TelemetryShipper,
        )
        from copilot_for_consensus_tpu_torch.obs.trace import (
            Span,
            TraceCollector,
        )

        collector = TraceCollector(capacity=4096)
        proc = args.proc or f"storm-{os.getpid()}"
        shipper = TelemetryShipper(
            args.spool, proc=proc,
            role="resume" if resume else "serve",
            metrics=eng.telemetry.metrics,
            collector=collector, recorder=eng.telemetry.recorder)

    def _record_lifecycle_span(cid: str, kind: str) -> None:
        if collector is None:
            return
        trace_id, submit_id, replay_id = _span_ids(cid)
        if kind == "engine_submit":
            span_id, parent = submit_id, ""
        else:  # engine_replay parents onto the ORIGINAL submit span,
            #    which lives in the killed process's spool
            span_id, parent = replay_id, submit_id
        collector.record(Span(
            trace_id=trace_id, span_id=span_id, parent_span_id=parent,
            name="journal_storm", kind=kind, service="journal_storm",
            start_wall=time.time(), correlation_id=cid))

    cid_of: dict[int, str] = dict(old_cids)
    cid_of.update(dict(eng.journal_recovered))
    if not resume:
        for i, p in enumerate(storm_prompts(args.requests, args.seed)):
            rid = eng.submit(p, args.new_tokens,
                             correlation_id=f"js-{i}")
            cid_of[rid] = f"js-{i}"
            _record_lifecycle_span(f"js-{i}", "engine_submit")
    else:
        for _rid, cid in eng.journal_recovered:
            _record_lifecycle_span(cid, "engine_replay")

    out = open(args.out, "a", encoding="utf-8")  # noqa: SIM115
    steps = 0
    completed = 0
    t0 = time.monotonic()
    while _busy(eng) and steps < args.max_steps:
        steps += 1
        for c in eng.step():
            out.write(json.dumps({
                "cid": cid_of.get(c.request_id,
                                  f"rid-{c.request_id}"),
                "tokens": list(c.tokens),
                "finish_reason": c.finish_reason}) + "\n")
            completed += 1
        out.flush()
        os.fsync(out.fileno())
        if shipper is not None:
            # synchronous per-step flush BEFORE the kill check: every
            # step that fsynced its completions also committed its
            # telemetry — the recovery gate's invariant
            shipper.flush()
        if args.kill_after_step and steps == args.kill_after_step:
            # a REAL unhandled process death: no atexit, no flushes,
            # no journal close — exactly what the journal must survive
            os.kill(os.getpid(), signal.SIGKILL)
    out.close()
    serve_s = time.monotonic() - t0
    spool_stats = None
    if shipper is not None:
        spool_stats = shipper.stats()
        shipper.close()
    with open(args.result, "w", encoding="utf-8") as f:
        json.dump({
            "resume": resume,
            "steps": steps,
            "completed": completed,
            "journal_replayed": eng.journal_replayed,
            "journal_abandoned": eng.journal_abandoned,
            "journal_depth": journal.depth(),
            "journal_stats": journal.stats(),
            "resumed": resumed,
            "device": str(eng.device),
            "build_s": build_s,
            "serve_s": serve_s,
            "graphs": eng.graph_stats(),
            "launches_by_body": kernel_launches(),
            "spool": spool_stats,
        }, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
