#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, one output line (JSON or text) each; any failure raises and exits
non-zero before the last line:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build   — compiles every kernel of ``copilot_for_consensus_tpu_torch/
   csrc`` into ``build/cuda_kernels/``;
3. kernels — holds K1 (flash attention) and K2 (int8 matmul) against their
   plain PyTorch versions at the full Mistral-7B shapes, with the stated
   tolerances, and times kernel, plain version, and one PyTorch call of
   the same function (``library_ms``, a yardstick the port never calls);
4. model   — the full-width int8 ``mistral-7b`` (random weights from a
   seed): one 4-row admission-wave prefill through the kernels and the
   same prefill through the plain versions, last-position logits compared
   by relative L2 error;
5. serve   — ``CUDASummarizer.summarize_batch`` on 8 threads (two
   admission waves, 64 new tokens each) with the launch counts reset just
   before: every kernel of the path must have launched;
6. trace   — the same engine's steady decode with all four slots busy,
   timed on the host clock and then traced by ``torch.profiler``: device
   busy time, idle share and device time by kernel.

Then the kernel table as one JSON line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

#: tolerances of kernel vs plain version, per dtype. K1 f32: sums over up to
#: 1024 keys in another order and expf vs torch's exp; bf16: one rounding of
#: the output (2**-8 relative) on values up to ~4, the JAX package's bf16
#: flash tolerance. K2: relative to the largest output — f32 sums of up to
#: 14336 products in another order; bf16 output rounding (2**-8).
K1_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
K2_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: model consistency: relative L2 of kernel vs plain last-position logits
#: after 32 bf16 layers (rounding differences compound through depth)
LOGITS_REL_L2 = 5e-2

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, n: int = 10, flush=None) -> float:
    """Median device time of ``fn`` over ``n`` launches, each timed by its
    own CUDA events after a warm-up; ``flush`` (a large tensor) is
    rewritten before each launch so the call finds L2 cold."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def k1_cases():
    """(label, B, Sq, Skv, kv_lengths, q_offsets, kv_begins) at the Mistral
    prefill shapes: Hq 32, Hkv 8, D 128, causal, window 4096."""
    return [
        ("s512", 4, 512, 512, [512, 300, 1, 0], None, None),
        ("s1024", 4, 1024, 1024, [1024, 700, 33, 1000], None, None),
        ("offsets_begins", 4, 256, 1024, [1024, 256, 356, 0],
         [768, 0, 100, 0], [0, 0, 50, 0]),
    ]


def phase_kernels(dev, flush):
    import torch
    import torch.nn.functional as F

    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        for label, b, s_q, s_kv, lens, offs, begins in k1_cases():
            q = torch.randn(b, 32, s_q, 128, generator=g, device=dev).to(dt)
            k = torch.randn(b, 8, s_kv, 128, generator=g, device=dev).to(dt)
            v = torch.randn(b, 8, s_kv, 128, generator=g, device=dev).to(dt)

            def ivec(x):
                return None if x is None else torch.tensor(
                    x, dtype=torch.int32, device=dev)
            kw = dict(causal=True, window=4096, kv_lengths=ivec(lens),
                      q_offsets=ivec(offs), kv_begins=ivec(begins))
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ref = fa.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= K1_ATOL[dt_name]
            # work this input needs: the attended (query, key) pairs
            lv, ov, bv = fa._row_params(b, s_kv, kw["kv_lengths"],
                                        kw["q_offsets"], kw["kv_begins"],
                                        dev)
            pairs = int(fa._mask(b, s_q, s_kv, lv, ov, bv, causal=True,
                                 window=4096, device=dev).sum()) * 32
            bnd, by = bound_ms(nbytes(q, k, v, out) + 3 * 4 * b,
                               4.0 * 128 * pairs, dt_name)
            row = {"kernel": "K1", "case": label, "dtype": dt_name,
                   "shape": [b, 32, 8, s_q, s_kv, 128],
                   "max_abs_err": err, "tol": K1_ATOL[dt_name]}
            if label == "s1024":
                mask = fa._mask(b, s_q, s_kv, lv, ov, bv, causal=True,
                                window=4096, device=dev)[:, None]
                row.update(
                    ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                    plain_ms=time_ms(
                        lambda: fa.flash_attention_ref(q, k, v, **kw), n=3),
                    library_ms=time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask, enable_gqa=True)),
                    bound_ms=bnd, bound_by=by)
            emit(row)
            if not ok:
                raise AssertionError(f"K1 {label} {dt_name}: error {err}")
            rows[("K1", label, dt_name)] = row
            del q, k, v, out, ref
    shapes = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (4096, 32000)]
    # M = 4: decode and the prefill lm_head; 2048 and 4096: admission waves
    # of 4 rows × the 512 and the 1024 bucket
    cases = [(d, f, m, "bfloat16") for d, f in shapes
             for m in (4, 2048, 4096)]
    cases += [(4096, 4096, 4, "float32"), (4096, 4096, 2048, "float32")]
    for d, f, m, dt_name in cases:
        dt = getattr(torch, dt_name)
        x = torch.randn(m, d, generator=g, device=dev).to(dt)
        q = torch.randint(-127, 128, (d, f), generator=g, dtype=torch.int8,
                          device=dev)
        s = torch.rand(1, f, generator=g, device=dev) * (2 * d ** -0.5
                                                          / 73.3)
        out = qm.int8_matmul(x, q, s)
        torch.cuda.synchronize()
        ref = qm.int8_matmul_ref(x, q, s)
        scale_ref = ref.float().abs().max().item()
        err = (out.float() - ref.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and \
            err <= K2_RTOL[dt_name] * scale_ref
        bnd, by = bound_ms(nbytes(x, q, s, out), 2.0 * m * d * f, dt_name)
        row = {"kernel": "K2", "case": f"m{m}_d{d}_f{f}", "dtype": dt_name,
               "shape": [m, d, f], "max_abs_err": err,
               "tol": K2_RTOL[dt_name] * scale_ref,
               "ms": time_ms(lambda: qm.int8_matmul(x, q, s), flush=flush),
               "plain_ms": time_ms(lambda: qm.int8_matmul_ref(x, q, s), n=3,
                                   flush=flush),
               "library_ms": time_ms(lambda: x @ q.to(dt) * s,
                                     flush=flush),
               "bound_ms": bnd, "bound_by": by}
        emit(row)
        if not ok:
            raise AssertionError(f"K2 {row['case']} {dt_name}: error {err}")
        rows[("K2", row["case"], dt_name)] = row
        del x, q, s, out, ref
    torch.cuda.empty_cache()
    return rows


def phase_model(dev, cfg, params):
    import torch

    from copilot_for_consensus_tpu_torch.models import decoder

    g = torch.Generator(device=dev).manual_seed(1)
    bucket = 512
    tokens = torch.randint(3, 259, (4, bucket), generator=g, device=dev)
    lengths = torch.tensor([512, 300, 451, 77], device=dev)
    out = {}
    for impl in ("auto", "plain"):
        cache = decoder.init_cache(cfg, 4, bucket, dtype=torch.bfloat16,
                                   device=dev)
        t0 = time.monotonic()
        logits, _ = decoder.prefill(params, tokens, lengths, cfg, cache,
                                    impl=impl)
        torch.cuda.synchronize()
        out[impl] = (logits, time.monotonic() - t0)
        del cache
    a, b = out["auto"][0], out["plain"][0]
    rel = ((a - b).norm() / b.norm()).item()
    row = {"phase": "model", "config": cfg.name, "rows": 4,
           "bucket": bucket, "logits_shape": list(a.shape),
           "rel_l2": rel, "bound": LOGITS_REL_L2,
           "kernel_prefill_s": out["auto"][1],
           "plain_prefill_s": out["plain"][1]}
    emit(row)
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite prefill logits")
    if tuple(a.shape) != (4, cfg.vocab_size) or rel > LOGITS_REL_L2:
        raise AssertionError(f"kernel vs plain prefill logits: {row}")


def synthetic_threads(n: int = 8):
    from copilot_for_consensus_tpu_torch.summarization.base import (
        ThreadContext,
    )

    sentence = ("The working group discussed whether the draft should "
                "require the new extension by default. ")
    return [ThreadContext(
        thread_id=f"thread-{i}", subject=f"[wg] extension default #{i}",
        participants=[f"user{j}@example.org" for j in range(2 + i % 4)],
        message_count=3 + i,
        chunks=[{"chunk_id": f"c{i}-{j}", "message_doc_id": f"m{i}-{j}",
                 "text": sentence * (1 + (i * 3 + j) % 5),
                 "score": 1.0 / (j + 1)} for j in range(1 + i % 4)])
        for i in range(n)]


def phase_serve(dev, cfg, params, smi):
    import torch

    from copilot_for_consensus_tpu_torch.engine import generation
    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
        build_prompt,
    )

    new_tokens = 64
    summ = CUDASummarizer(cfg.name, params=params, num_slots=4,
                          max_len=4096, max_new_tokens=new_tokens,
                          device=dev)
    eng = summ.engine
    # every sampled logits row must be finite: the check accumulates on
    # the device and is read once at the end
    finite = torch.ones((), dtype=torch.bool, device=dev)
    plain_sample = generation.sample

    def checked_sample(logits, gen, sampling):
        finite.logical_and_(torch.isfinite(logits).all())
        return plain_sample(logits, gen, sampling)

    comps = []
    plain_generate = eng.generate

    def recording_generate(prompts, max_new_tokens):
        comps.extend(plain_generate(prompts, max_new_tokens))
        return comps

    generation.sample = checked_sample
    eng.generate = recording_generate
    threads = synthetic_threads(8)
    fa.flash_attention.launches = 0
    qm.int8_matmul.launches = 0
    t0 = time.monotonic()
    summaries = summ.summarize_batch(threads)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {"K1": fa.flash_attention.launches,
                "K2": qm.int8_matmul.launches}
    generation.sample = plain_sample

    prompts = [summ.tokenizer.encode(build_prompt(t), add_bos=True)
               for t in threads]
    if not bool(finite):
        raise AssertionError("non-finite logits while serving")
    for t, s, c, p in zip(threads, summaries, comps, prompts):
        if s.thread_id != t.thread_id or c.prompt_len != min(
                len(p), eng.prompt_limit):
            raise AssertionError(f"wrong prompt length for {t.thread_id}")
        # "length" is the token limit, or the cache's end one window away
        cache_end = (c.prompt_len + len(c.tokens) + 2 * eng.decode_window
                     > eng.max_len - 1)
        if (c.finish_reason == "length" and len(c.tokens) != new_tokens
                and not cache_end):
            raise AssertionError(f"{t.thread_id}: {len(c.tokens)} tokens")
        if c.finish_reason == "eos" and len(c.tokens) >= new_tokens:
            raise AssertionError(f"{t.thread_id}: eos past the limit")
        if s.completion_tokens != len(c.tokens):
            raise AssertionError(f"{t.thread_id}: summary/tokens mismatch")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    emit({"phase": "serve", "config": cfg.name, "threads": len(threads),
          "prompt_tokens": [c.prompt_len for c in comps],
          "completion_tokens": [len(c.tokens) for c in comps],
          "finish": [c.finish_reason for c in comps],
          "wall_s": wall, "prefill_s": eng.admitted_s,
          "decode_s": eng.decode_s, "decode_tokens": eng.decode_tokens,
          "decode_tok_per_s": eng.decode_tokens / eng.decode_s,
          "ttft_s": [c.ttft_s for c in comps], "launches": launches,
          "device": smi})
    return launches, prompts, eng


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def phase_trace(cfg, eng, prompts, smi, n: int = 2):
    """Device busy and idle share of steady decode: four 1024-token
    prompts fill the slots in one wave; after one warm dispatch, ``n``
    dispatches run on the host clock alone and the next ``n`` under
    ``torch.profiler`` tracing the card's activity. Idle share = 1 - (union
    of the traced device intervals) / (host wall time of the n steps)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    window = eng.decode_window
    # one token from the wave, then one window a dispatch: the slots stay
    # busy through the warm dispatch and the 2n measured ones, and finish
    # on the dispatch after them
    ids = [eng.submit(p, max_new_tokens=1 + window * (2 + 2 * n))
           for p in sorted(prompts, key=len)[-eng.num_slots:]]
    done: set[int] = set()

    def step():
        done.update(c.request_id for c in eng.step())

    step()                               # admission wave + first dispatch

    def steps():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        return time.monotonic() - t0

    plain_s = steps()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_s = steps()
    if done:
        raise AssertionError("a slot finished inside the measured decode")
    while len(done) < len(ids):
        step()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    row = {"phase": "trace", "config": cfg.name, "dispatches": n,
           "steps": n * window, "step_ms": plain_s / (n * window) * 1e3,
           "traced_step_ms": traced_s / (n * window) * 1e3,
           "device_events": len(kernels),
           "device_busy_ms": busy / 1e3 if kernels else None,
           "idle_share": (1.0 - busy / (traced_s * 1e6)) if kernels
           else None,
           "device_ms_by_kernel": {k[:80]: v / 1e3 for k, v in top},
           "device": smi}
    emit(row)
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import copilot_for_consensus_tpu_torch as port

    # the kernels must be built from this checkout's sources, not from a
    # copy of the package installed elsewhere
    here = Path(__file__).resolve().parent
    if Path(port.__file__).resolve().parent != here / port.__name__:
        raise RuntimeError(f"{port.__name__} was imported from "
                           f"{port.__file__}, not from {here}")
    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )
    from copilot_for_consensus_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.monotonic()
    _build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "kernels": {n: r["seconds"] for n, r in _build.build_log.items()}})

    # a buffer beyond the 50 MB L2, rewritten before each timed launch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    rows = phase_kernels(dev, flush)
    del flush

    cfg = decoder_config("mistral-7b")
    t0 = time.monotonic()
    params = quant.init_random_quantized(cfg, seed=0, dtype=torch.bfloat16,
                                         device=dev)
    torch.cuda.synchronize()
    emit({"phase": "weights", "config": cfg.name,
          "bytes": quant.param_bytes(params),
          "seconds": time.monotonic() - t0})
    phase_model(dev, cfg, params)
    launches, prompts, eng = phase_serve(dev, cfg, params, smi)
    phase_trace(cfg, eng, prompts, smi)

    k1 = rows[("K1", "s1024", "bfloat16")]
    k2 = rows[("K2", "m4_d4096_f14336", "bfloat16")]
    table = []
    for name, row, src, tpu in (
            ("flash_attention", k1,
             "copilot_for_consensus_tpu_torch/csrc/flash_attention.cu",
             "copilot_for_consensus_tpu/ops/flash_attention.py:119"),
            ("int8_matmul", k2,
             "copilot_for_consensus_tpu_torch/csrc/int8_matmul.cu",
             "copilot_for_consensus_tpu/ops/quant_matmul.py:50")):
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches["K1" if name == "flash_attention"
                                 else "K2"],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": row["case"], "dtype": row["dtype"]})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
