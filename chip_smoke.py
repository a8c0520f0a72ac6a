#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA H100 and check it.

Run from the repository root, on a machine with one card:

    python3 chip_smoke.py

Phases, one output line (JSON or text) each; any failure raises and exits
non-zero before the last line:

1. device  — the card's name and power limit (nvidia-smi), torch and CUDA;
2. build   — compiles every kernel of ``copilot_for_consensus_tpu_torch/
   csrc`` into ``build/cuda_kernels/``;
   then, for the seven libraries with a Hopper body (the wgmma bodies of
   K5, K1, K2, K3, K6, K4 and P, K3's split-KV decode body and the stream
   bodies of K5, K2 and K6), one ``build_info`` line each: ptxas's registers,
   spills and shared memory per kernel, the Hopper bodies' dynamic shared
   memory, and the counts of HGMMA, IGMMA, UTMALDG, LDGSTS, HMMA and IMMA
   instructions
   per kernel in the SASS (``cuobjdump -sass``; "absent" without it) — the
   wgmma bodies (K1's d32 body too) must show HGMMA (IGMMA for the int8
   ones of K6, K4 and P) and UTMALDG, the stream bodies HMMA (IMMA for
   K6's int8 one) and UTMALDG, and the bodies of K2, K3, K6, K4, P, K1's
   d32 and the stream bodies must build without spills or a ptxas
   performance note;
3. kernels — (after one ``timing_floor`` line: what ``time_ms`` gives a
   one-element kernel, L2 flushed) holds K1 (flash attention) and K2
   (int8 matmul) against their plain PyTorch versions at the full
   Mistral-7B shapes, with the stated
   tolerances, and times kernel, plain version, and one PyTorch call of
   the same function (``library_ms``, a yardstick the port never calls).
   K1's cases: the int8 waves (B4 S512, S1024), the paged miss waves'
   offsets and begins, the int4 wave (B2 S2816), a window of 256 that
   bites, and D 64 and D 32, at bf16 and f32, so each of K1's three
   bodies (wgmma for bf16 at D 64/128, d32 for bf16 at D 32, CUDA cores
   for f32) runs, each case asserting its body. K2's cases
   name their body (the stream body at M 4 and 8, wgmma for bf16 waves,
   the GEMV and CUDA cores for f32) and include three few-row waves (M 512
   and 64); four more with small integer x must equal the plain version
   bit for bit on the wgmma body and six on the stream body (M 1, 4, 8;
   both convert int8 -> bf16 exactly), two layouts the wgmma body does not
   take hold the WMMA body to its tolerance, and, untimed, the stream
   body's edges (M 1, 3, 5, 7) and a layout it refuses (F 1000, on the
   GEMV) hold theirs;
4. model   — the full-width int8 ``mistral-7b`` (random weights from a
   seed): one 4-row admission-wave prefill through the kernels and the
   same prefill through the plain versions, last-position logits compared
   by relative L2 error;
5. serve   — ``CUDASummarizer.summarize_batch`` on 8 threads (two
   admission waves, 64 new tokens each) with the launch counts reset just
   before: every kernel of the path must have launched, and every sampled
   logits row must be finite (a check patched into the engine module's
   ``sample``; the graphs captured under it are dropped after, so that no
   later phase replays the check);
6. int8 wave and trace — one 4 x 1024 admission wave of the same engine
   traced by kernel (device ms by kernel and by family, the launches of
   each body), weight-only and then again with ``set_act_quant("a8")``
   (224 launches of K4's wgmma body, K4's device ms a wave, 1 of K2's
   stream body, 32 of K1); then the engine's steady decode with all four
   slots busy, timed on the host clock and then traced by
   ``torch.profiler``: device busy time, idle share and device time by
   kernel and by family. Every decode dispatch of the serve and trace
   phases replays the engine's CUDA graph for its kv bucket
   (``engine/graphs.py``), captured at the bucket's first dispatch, but
   for the engine's first dispatch in each activation-quantization mode,
   which runs eagerly (the warm-up); the trace measures replays only
   (single dispatches run first until the next ones land on captured
   buckets), and splits the device's idle time into the gaps inside each
   replay and the time between a dispatch's token fetch and the next
   replay;
7. kernels, K3 — (run right after phase 3, on a 1024-block pool) the
   paged flash-partial kernel against its plain version at the decode
   (R = 4, a 64-entry table, bf16/f32/fp8 pools, windows 4096 and 100)
   and seeded-admission (R = 4·64, 4·1024) shapes — the normalised output
   and the raw m and l — timed likewise; bf16 decode runs the split-KV
   body, bf16 seeded the wgmma body, f32 and fp8 the CUDA-core body; then,
   untimed, the other layouts the two new bodies take (D 64, 8 and 16
   rows, pool blocks of 8, 16 and 128, a window inside a tile);
8. paged model — after the contiguous engine is freed, a paged engine
   (8 slots, max_len 4096, 1024 blocks of 64, prefix cache): four prompts
   prefilled into its pool, their last 64 tokens prefilled again with the
   prefix read from the pool by K3, logits against the full prefill;
9. paged serve — ``CUDASummarizer`` over that engine, three rounds of 8
   threads (misses, the same threads again, new threads), with the launch
   counts reset before the first: K3 must launch in admission (all on the
   seeded wgmma body) and in decode (all on the split-KV body), prefix hits
   and saved tokens must equal a host-side oracle of the trie rule, and
   the pool's books must balance;
10. paged trace — phase 6's trace on the paged engine, 8 slots busy;
11. kernels, K5/K4/K6 — (run right after phase 7) the quantized matmuls
   against their plain versions at the int4 / a8 main path's shapes: K5
   (int4 weight-only) and K6 (W4A8) on the five int4 projections at M = 32
   (decode: both stream bodies, K6's bit for bit equal to its plain
   version in its order, ``w4a8_matmul_stream_ref``, and timed beside the
   split qgemm it replaces) and 5632 (a 2 x 2816 wave: both wgmma bodies,
   K6's bit for bit equal to its plain version), K4
   (W8A8) on the four int8 layer projections at M = 4096 (its wgmma body,
   bit for bit equal to its plain version, timed beside the mma.sync
   tiling it replaces, ``mma_sync_ms``), plus one f32 case each — timed
   likewise, K6 beside K5's ``x @ w`` as a yardstick that is not its
   function; K4's edges: M = 1000 with F = 4112 (ragged against every
   tile) on the wgmma body, D = 4160 and F = 4104 on the mma.sync tiling,
   each bit for bit; K5's and K6's tiled edges: M = 33, M = 5000
   with F = 6128 (ragged against every tile) on the wgmma bodies (K6's bit
   for bit), and F = 4104 on the mma.sync tiling; and, untimed, K6's wgmma
   body at f32 x (bit for bit), K5's and K6's stream edges: M = 1, 8 and
   17 at the fused q/k/v shape (K6's bit for bit, and K6's at f32 x too),
   and F = 4104 at M = 32, a layout the stream bodies refuse, on the split
   qgemm;
12. a8 model — (run right after phase 4) one 4 x 1024 int8 wave with
   ``set_act_quant("a8")``, through K4 (224 launches, all on its wgmma
   body) and through the plain versions;
13. int4 serve — after the paged engine and the int8 weights are freed,
   an int4 engine of the JAX bench's 3072-context deployment (32 slots,
   one 2816 bucket, an 8192-token admission budget, decode window 32)
   behind ``CUDASummarizer``: 32 threads of 2000-2816 prompt tokens
   (64 new tokens each) on K5, then 8 threads with a8 on, on K6; every
   forward pass must make 4 quantized launches a layer plus the lm_head's,
   all on the wgmma body (K5's, K6's) in the waves' layers, and on the
   stream body (K5's, K6's) in decode and the waves' lm_head;
14. int4 wave and trace — one admission wave of the int4 engine (2 x
   2816) traced by kernel: device ms by kernel and by family, and the
   launches of each body; the same wave again in a8 (128 launches of K6's
   wgmma body, 1 of its stream body, 32 of K1); then phase 6 on the int4
   engine, 32 slots busy, and again in a8 once those slots are freed
   (``int4_a8_trace``: K6's device ms a decode step, every M <= 32 launch
   on its stream body);
15. probe — (run right after phase 11, before the 7B weights are made) the
   weight-stream probe P: its five modes (dma, convdot, i8dot, unpack8,
   unpack32) against their plain versions at one [128, 4096] x [4096,
   14336] layer, timed likewise, and one call of each traced by
   ``torch.profiler`` (L2 flushed): device µs by kernel. convdot, i8dot
   and unpack run the Hopper body of ``csrc/probe_wgmma.cuh`` (one launch
   of it a call, on ``"wgmma"``; i8dot, unpack8 and unpack32 bit for bit
   equal to their plain versions) and are timed beside the mma.sync body
   on the same inputs (``simple_ms``); then, untimed, the body's edges (B
   100 and 1, three contraction tiles) against the plain versions and a
   layout it refuses (F 384, on ``"simple"``); then the probe script
   (``copilot_for_consensus_tpu_torch.scripts.probe_stream``) over all five
   modes, 20 distinct layers, 10 warm and 10 timed passes, with the counts
   reset before: each mode must launch 400 times (convdot, i8dot and
   unpack all on ``"wgmma"``), and none may stream faster than 1.05 x 3.35
   TB/s;
16. graphs — (after phase 6, the serve engine freed) the serve phase's 8
   threads through two contiguous int8 engines of the same weights, one
   replaying its decode graphs and one running the same dispatch body
   eagerly (``cuda_graphs=False``), at windows_per_dispatch 1 and 2, and
   sampled (top-k, top-p, one seed) at 1: the token streams must be equal
   and so must the launches by body; the row
   gives the graphs captured, the seconds spent capturing them, the
   replays and both engines' decode seconds;
17. async_serve — ``CUDASummarizer.summarize_async`` on the same 8
   threads, submitted from two threads, through the summarizer's
   ``AsyncEngineRunner`` and its supervisor on a contiguous int8 engine
   (the dispatcher thread admits, captures and replays): every handle must
   complete with no failure contained, the serve phase's launch checks
   must hold, and the row counts the summaries that agree with
   ``summarize_batch``'s;
18. paged graphs — (after phase 10, the paged engine freed) phase 16 on
   the paged engine;
19. pipeline — (after phase 17) the pipeline entry: the seed-0 int8
   weights written as a native checkpoint (``save_native``, bytes and
   seconds) under ``build/`` and read back (``load_checkpoint``, seconds
   and GB/s; every leaf equal, ``q`` int8); a ``CUDASummarizer`` over the
   checkpoint and one over the weights in memory give equal greedy token
   streams on one synthetic thread; then ``build_pipeline`` with the cuda
   driver over the checkpoint turns ``tests/fixtures/ietf-sample.mbox``
   into cited reports, synchronous and pipelined: one archive, summaries
   = reports = threads >= 3, every citation a stored chunk, K1 and K2 the
   only kernels launched (K1's wgmma body, K2's stream and wgmma bodies),
   no plain version called, the same threads and citations in both modes
   (equal summary texts counted, not gated); the row gives each mode's
   wall time, summaries per second and the pipeline's
   ``summarization_latency_seconds``. Then a third run, ``retrieval``:
   the synchronous run with the port's ``cuda`` embedding driver
   (``minilm-l6`` at full width, seed-0 weights) and ``cuda`` vector
   store (flat, on the card): the same threads, a cited report each, K1's
   wgmma body (the decoder's waves: as many launches as in the
   synchronous run) and d32 body (the encoder: exactly 6 launches for
   each dispatch in the embedding engine's telemetry) and K2, no
   plain version; the row adds the embed and query seconds the
   pipeline's collector records. The checkpoint is deleted after;
20. encoder — (after phase 19) ``EmbeddingEngine.embed_batch`` on
   ``minilm-l6`` at full size, seed-0 weights, bf16: 512 texts of 8-512
   tokens (the seed's draw), with the counts reset before: every K1
   launch on the d32 body (head dim 32), 6 a dispatch, no plain
   version; vectors against the same engine on K1's plain version
   (cosine >= 0.999 a row, norms 1 ± 1e-3, finite); texts/s, tokens/s,
   tiles by bucket;
21. vectorstore — the repo's ANN preset uncut (``bench.py``'s
   ``ann_retrieval``: 1,000,000 vectors of dim 64 in 1,024 clusters, 256
   queries in batches of 64, top 10, nprobe 16, seed 0) in a flat and an
   IVF ``CUDAVectorStore`` on the card: the flat route's ids equal an
   exact f32 scan's for 16 queries, ties aside; IVF recall@10 against the
   flat route >= 0.95 while scanning <= 15% of the lists; ingest s, index
   build s, QPS, p50/p95 ms a route.
22. deadlines — (after phase 17) a contiguous int8 engine like the serve
   phase's, graphs warm: a request with ``deadline_s=0`` dropped at the
   next step with no tokens and no launch; a slot whose deadline passes
   after the second dispatch retired with partial tokens and
   ``finish_reason="deadline"``, the other three slots' greedy streams
   equal to a run without it (same waves, rows and kv buckets);
23. journal — (after phase 21) the request journal's warm restart through
   the port's storm driver (``tools/journal_storm.py``) in child
   processes at mistral-7b's full width (int8 weights from seed 0, bf16,
   checkpoints every 8 steps): an uninterrupted child, one SIGKILLed
   after 9 steps, one that resumes on its journal: lost 0, duplicated 0,
   replayed > 0, final depth 0, each resumed stream starting with its
   checkpointed tokens (streams equal to the uninterrupted run printed,
   not gated, at bf16); then the kill in process at f32 on 2 layers of
   mistral-7b's widths: streams equal, or a divergence only where the
   top-2 logits are within 1e-5 relative;
24. paged_fp8 — (after phase 18) the paged serve phase's first two
   rounds on a paged engine with ``kv_dtype="float8_e4m3fn"``: every K3
   call asserts the CUDA-core body (the fp8 pool read in place, admission
   and decode), no plain version; agreement with the bf16 rounds printed;
25. telemetry_cost — phase 6's trace runs with the engine's telemetry on
   (its default), then again on the same engine with it off: step ms and
   busy ms a step side by side.

The pipelined run of phase 19 serves ``deploy/config/pipeline.json``'s
llm block under the cuda driver (supervisor, ``deadline_s`` 300, the
journal under a temporary directory): the ``copilot_engine_*`` series on
the service's collector count admissions, steps and retirements, and the
journal ends empty. K3's cases include f16 and fp8 e5m2 pools and an
fp8 seeded pass on the CUDA-core body, each asserting its body.

K1's cases in phase 3 include the encoder's, non-causal: ``enc_s512``
(B 64, 12 heads of 32, S 512, lengths over 1-512) on the d32 body, timed
beside its bound and SDPA, and the same mask at D 128 on the wgmma body;
then the d32 body's edges, each held to the plain version: the encoder's
smallest bucket (B 64, S 32, lengths 1-32), a length-1 row, Sq != Skv
with ``q_offsets`` and ``kv_begins`` (and a row of length 0), and a
window of 100 that bites.

Launch counts are replay-aware: a graph's capture launches nothing, so each
graph keeps the counts its capture ticked, takes them back, and adds them on
every replay — a replayed dispatch counts what the eager body would have
launched. Every serve phase counts each kernel's launches by body (K1-K6):
the main path's K1 launches must all be the wgmma body's (the d32
body's too on the paths that run the encoder; never the CUDA-core
body's), its K2 launches
the stream body's or the wgmma body's (never the GEMV, WMMA or the
CUDA-core loop; 7 a layer and one for the lm_head a forward pass), its K3
launches the decode or seeded body's, and no K4, K5 or K6 launch may take
the split qgemm or the mma.sync (or K5's CUDA-core) tiled bodies (on the
int4 path each kernel's wgmma body makes 4 launches a layer a wave, its
stream body the rest; K4's 224 a wave all go to its wgmma body). Then
the kernel table (K1-K6; K1's wgmma and d32 bodies, K2's stream
and wgmma bodies, K3's decode and
seeded bodies, and K5's and K6's stream and tiled bodies as two rows
each; K4's wgmma body with the mma.sync tiling's time beside it; and
P's five modes, each with its launches on every path, the four on the
wgmma body with the mma.sync body's time beside them) as one JSON line —
each row's ``launches`` from its main path (K3's fp8 row, its CUDA-core
body at the decode shape on an fp8 pool: ``paged_fp8``), the pipeline phase's
synchronous run for K1's wgmma body and K2, its retrieval run for K1's
d32 body (its own row), every path's count beside it — the
nvidia-smi line, and last
``{"ok": true, "device": {...}}``. About 8 minutes on one H100 (the
host's speed varies), the build included.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

#: tolerances of kernel vs plain version, per dtype. K1 f32: sums over up to
#: 1024 keys in another order and expf vs torch's exp; bf16: one rounding of
#: the output (2**-8 relative) on values up to ~4, the JAX package's bf16
#: flash tolerance. K2: relative to the largest output — f32 sums of up to
#: 14336 products in another order; bf16 output rounding (2**-8).
K1_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
K2_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: K3 vs its plain version, compared as the normalised output
#: combine_partials([part]) in f32. Both read the same pool values and
#: convert them to f32 exactly (bf16 and fp8 included) and neither rounds
#: its output, so the only differences are f32 sums over up to 4096
#: positions taken in another order (online vs one-pass softmax) and expf
#: vs torch.exp: near f32 level for every pool dtype.
K3_ATOL = 1e-4
#: K3's raw partials, which every paged step folds with the window's piece
#: (so a wrong m would skew the joint softmax while the one-piece check
#: above stays blind to it): on rows that attend anything, m (a max of
#: scores of magnitude < ~10, each a 128-term f32 dot product summed in
#: another order) within 1e-5 absolute, and l (a sum of up to 4096 f32
#: exponentials, each off by the scores' error) within 1e-5 relative;
#: rows that attend nothing must give m = -inf and l = 0 exactly.
K3_M_ATOL = 1e-5
K3_L_RTOL = 1e-5
#: K5 (int4 weight-only) vs its plain version, relative to the largest
#: output. Both sum each group's exact products in f32 (the kernel on the
#: tensor cores, the plain version in one f32 matmul a group) in another
#: order, then scale and accumulate the groups: f32 level at f32, one output
#: rounding (2**-8) plus an f32 sum that lands on the other side of a bf16
#: rounding boundary at bf16 — K2's tolerances.
K5_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: K4 (W8A8): the kernel quantizes x as the plain version does (true
#: division, half to even), sums the int8 products exactly in int32 and
#: finishes with the same two f32 multiplies: equal bit for bit, so 0.
K4_ATOL = 0.0
#: K6 (W4A8): exact int32 group products, scaled and summed in group order
#: with the same f32 operations as the plain version on the tiled paths
#: (the wgmma body, which must equal it bit for bit, and the mma.sync
#: tiling) and as ``w4a8_matmul_stream_ref`` on the stream body (M <= 32,
#: which must equal it bit for bit too); the split qgemm, which only
#: layouts the stream body refuses take, sums its splits' partials in
#: another order: f32 level, and one bf16 output rounding at bf16.
K6_RTOL = {"float32": 1e-5, "bfloat16": 1e-2}
#: K6's yardstick: K5's ``x @ w``, timed once a case
K6_YARDSTICK = ("x @ w, w dequantized to bf16 beforehand: not the same "
                "function (bf16 weights, no activation quantization)")
#: P (the weight-stream probe) vs its plain versions at one full layer.
#: dma and i8dot sum integers exactly and finish with the same f32 addition
#: or multiply and one bf16 rounding: equal bit for bit, so 0. convdot and
#: unpack relative to the largest output: convdot sums its tile in
#: tensor-core k-steps, the plain version in cuBLAS's order, so an f32 sum
#: can land on the other side of a bf16 rounding boundary — one bf16 step,
#: at most 2**-7 of the largest output; unpack keeps the plain version's
#: order (group partial, scale, group sum, tile sum) with the same f32
#: operations, so 0 is expected, held to the same one step.
P_ATOL = {"dma": 0.0, "i8dot": 0.0}
P_RTOL = {"convdot": 2.0 ** -7, "unpack8": 2.0 ** -7, "unpack32": 2.0 ** -7}
#: a weight stream faster than this share of 3.35 TB/s dropped loads
P_MAX_HBM_SHARE = 1.05
#: P's modes on the Hopper body of csrc/probe_wgmma.cuh, and those of them
#: that must equal their plain versions bit for bit (exact integer sums,
#: then the plain version's f32 operations in its order)
P_WGMMA_MODES = ("convdot", "i8dot", "unpack8", "unpack32")
P_BIT_EQUAL = ("i8dot", "unpack8", "unpack32")
#: model consistency: relative L2 of kernel vs plain last-position logits
#: after 32 bf16 layers (rounding differences compound through depth)
LOGITS_REL_L2 = 5e-2

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float8_e4m3fn": 1979e12,
              "int8": 1979e12, "float16": 989e12, "float8_e5m2": 1979e12}
#: the int4 / a8 main path's projections (D, F) of mistral-7b: the fused
#: q/k/v and gate/up leaves, wo, w_down and the lm_head
INT4_SHAPES = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
               (4096, 32000)]
#: int8 leaves K4 takes in a8 mode (the layers' projections; the lm_head at
#: M = 4 stays on K2)
A8_SHAPES = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, n: int = 10, flush=None) -> float:
    """Median device time of ``fn`` over ``n`` launches, each timed by its
    own CUDA events after a warm-up; ``flush`` (a large tensor) is
    rewritten before each launch so the call finds L2 cold. A device-side
    sleep of ~1 ms ahead of the first event keeps the card busy while the
    host enqueues the call, so the host's enqueue time is not counted."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
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
    from copilot_for_consensus_tpu_torch.scripts.probe_stream import (
        HBM_BYTES_PER_S,
    )

    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa
    from copilot_for_consensus_tpu_torch.ops import probe_stream as ps
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    return {"K1": fa.flash_attention, "K2": qm.int8_matmul,
            "K3": pa.paged_attention_partial, "K4": qm.w8a8_matmul,
            "K5": qm.int4_matmul, "K6": qm.w4a8_matmul,
            "P_dma": ps.probe_dma, "P_convdot": ps.probe_convdot,
            "P_i8dot": ps.probe_i8dot, "P_unpack": ps.probe_unpack}


#: the probe's modes and the counter of the wrapper each one launches
P_COUNTERS = {"dma": "P_dma", "convdot": "P_convdot", "i8dot": "P_i8dot",
              "unpack8": "P_unpack", "unpack32": "P_unpack"}


def reset_launches() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0
        for body in getattr(fn, "launches_by_body", {}):
            fn.launches_by_body[body] = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def check_path(label: str, launches: dict, used) -> None:
    """Every kernel of the path launched, and no other."""
    for k, n in launches.items():
        if (n > 0) != (k in used):
            raise AssertionError(f"{label}: {k} launched {n} times; the "
                                 f"path's kernels are {sorted(used)}")


#: kernels with more than one body; each wrapper's ``launches_by_body``
#: counts each body's launches
BODY_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")


def read_bodies() -> dict:
    w = kernel_wrappers()
    return {k: dict(w[k].launches_by_body) for k in BODY_KERNELS}


def check_k2_passes(label: str, launches: dict, bodies: dict,
                    n_layers: int) -> None:
    """Every forward pass of the int8 model makes 7 K2 launches a layer and
    one for the lm_head: the waves' layers on the wgmma body, every M <= 8
    launch (decode steps, the waves' lm_head) on the stream body."""
    per_pass = 7 * n_layers + 1
    k2 = bodies["K2"]
    if (launches["K2"] % per_pass or k2["wgmma"] % (7 * n_layers)
            or k2["stream"] + k2["wgmma"] != launches["K2"]):
        raise AssertionError(f"{label}: K2 launches {launches['K2']} by body "
                             f"{k2}: not {per_pass} a forward pass")


def check_bodies(label: str, bodies: dict, k5_wgmma: int | None = None,
                 k5_stream: int | None = None, k6_wgmma: int | None = None,
                 k6_stream: int | None = None):
    """The main path's K1 launches all went to the wgmma body, its K2
    launches to the stream body (M <= 8) and the wgmma body (never the
    split GEMV, WMMA or the CUDA-core loop), its K3 launches to the decode
    and seeded bodies (never the CUDA-core one), its K4 launches (if any)
    to the wgmma body (never the mma.sync tiling), and its K5 and K6
    launches (if any) to their wgmma and stream bodies, never to the split
    qgemm or the mma.sync (or K5's CUDA-core) tiled bodies; ``k5_wgmma``,
    ``k5_stream``, ``k6_wgmma`` and ``k6_stream`` are the counts those
    bodies must have."""
    old = {"K1": ("simt",), "K2": ("gemv", "wmma", "simt"), "K3": ("simt",),
           "K4": ("mma_sync",), "K5": ("split", "mma_sync", "simt"),
           "K6": ("split", "mma_sync")}
    for k, names in old.items():
        if any(bodies[k][n] for n in names):
            raise AssertionError(f"{label}: an old {k} body launched: "
                                 f"{bodies}")
    for k, body, want in (("K5", "wgmma", k5_wgmma),
                          ("K5", "stream", k5_stream),
                          ("K6", "wgmma", k6_wgmma),
                          ("K6", "stream", k6_stream)):
        if want is not None and bodies[k][body] != want:
            raise AssertionError(f"{label}: {k}'s {body} body launched "
                                 f"{bodies[k][body]} times, expected {want}")


#: the libraries with Hopper bodies: the wgmma body's kernel (which must
#: show HGMMA and UTMALDG in its SASS) and the prefix of the library's other
#: new kernels (None where it has none)
REDESIGNED = {"int4_matmul": ("k5w::int4_wgmma", "k5s::"),
              "flash_attention": ("fa3::flash_wgmma", "fd32::"),
              "int8_matmul": ("k2w::int8_wgmma", "k2s::"),
              "paged_attention": ("k3s::paged_wgmma", "k3d::"),
              "w4a8_matmul": ("k6w::w4a8_wgmma", "k6s::"),
              "w8a8_matmul": ("k4w::w8a8_wgmma", None),
              "probe_stream": ("pw::probe_wgmma", None)}


def wgmma_smem(name: str, lib) -> dict:
    """Dynamic shared memory of a library's wgmma body, by template."""
    if name == "int4_matmul":
        return {"k5w::int4_wgmma": lib.int4_matmul_wgmma_smem(),
                **{f"k5s::int4_stream<{nt}>": lib.int4_matmul_stream_smem(nt)
                   for nt in (1, 2, 3, 4)}}
    if name == "int8_matmul":
        return {**{f"k2w::int8_wgmma<{tn}>": lib.int8_matmul_wgmma_smem(tn)
                   for tn in (128, 256)},
                "k2s::int8_stream": lib.int8_matmul_stream_smem()}
    if name == "w8a8_matmul":
        return {"k4w::w8a8_wgmma": lib.w8a8_matmul_wgmma_smem()}
    if name == "probe_stream":
        return {f"pw::probe_wgmma<{m}>": lib.probe_stream_wgmma_smem(m)
                for m in (1, 2, 3, 4)}
    if name == "w4a8_matmul":
        return {"k6w::w4a8_wgmma": lib.w4a8_matmul_wgmma_smem(),
                **{f"k6s::w4a8_stream<{nt}>": lib.w4a8_matmul_stream_smem(nt)
                   for nt in (1, 2, 3, 4)}}
    if name == "flash_attention":
        return {**{f"fa3::flash_wgmma<{d}>": lib.flash_attention_wgmma_smem(d)
                   for d in (64, 128)},
                "fd32::flash_d32": lib.flash_attention_d32_smem()}
    return {f"k3s::paged_wgmma<{d}>": lib.paged_attention_seeded_smem(d)
            for d in (64, 128)}


#: the bodies of the last slices: ptxas must report them without spills
#: and without a performance note (C75xx: serialized wgmma and the like)
NEW_BODIES = ("k2w::", "k3s::", "k3d::", "k5s::", "k2s::", "k6w::",
              "k6s::", "k4w::", "pw::", "fd32::")
#: the Hopper bodies beside a library's first wgmma body, by kernel prefix:
#: the SASS instructions each of their kernels must show (the stream bodies
#: on mma.sync, K1's d32 body on wgmma)
OTHER_BODIES = {"k5s::": ("HMMA", "UTMALDG"),
                "k2s::": ("HMMA", "UTMALDG"),
                "k6s::": ("IMMA", "UTMALDG"),
                "fd32::": ("HGMMA", "UTMALDG")}
#: (wgmma is HGMMA in the SASS on 16-bit operands, IGMMA on 8-bit integers;
#: mma.sync is HMMA on 16-bit operands, IMMA on 8-bit integers)
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "LDGSTS", "HMMA", "IMMA")


def short_name(mangled: str) -> str:
    """A kernel's demangled name without its return type and parameters
    (``qmma::qgemm<(qmma::Kind)1, 2, 4, 4, __nv_bfloat16>``), through the
    toolkit's ``cu++filt`` or binutils' ``c++filt``; the mangled name where
    neither is installed."""
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None and Path("/usr/local/cuda/bin/cu++filt").exists():
        tool = "/usr/local/cuda/bin/cu++filt"
    if tool is None:
        return mangled
    out = subprocess.run([tool, mangled], capture_output=True, text=True,
                         timeout=60).stdout.strip() or mangled
    out = re.sub(r"^void ", "", out.replace("(anonymous namespace)::", ""))
    depth = 0
    for i, ch in enumerate(out):          # cut the parameter list
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            return out[:i]
    return out


def ptxas_functions(text: str) -> dict:
    """Per kernel of one ``nvcc -Xptxas -v`` log: registers, barriers,
    static shared memory, stack, spill stores and loads, and ptxas's
    performance notes (C75xx)."""
    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = funcs.setdefault(short_name(m.group(1)), {"notes": []})
            continue
        m = re.search(r"\((C75\d\d)\).*function '([^']+)'", line)
        if m:
            funcs.setdefault(short_name(m.group(2)), {"notes": []})[
                "notes"].append(m.group(1))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers(?:, used (\d+) barriers)?"
                      r"(?:, (\d+) bytes smem)?", line)
        if m:
            cur.update(registers=int(m.group(1)),
                       barriers=int(m.group(2) or 0),
                       static_smem=int(m.group(3) or 0))
    return funcs


def sass_counts(lib_path) -> dict | str:
    """Counts of ``SASS_OPS`` per kernel in a built library, from the
    toolkit's ``cuobjdump -sass``; "absent" without the tool."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return "absent"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    counts: dict = {}
    cur = None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = counts.setdefault(short_name(m.group(1)),
                                    dict.fromkeys(SASS_OPS, 0))
            continue
        if cur is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{op}\b", line):
                    cur[op] += 1
    return counts


def phase_build_info():
    """For each library with a Hopper body: ptxas's registers, spills and
    shared memory per kernel (from the build's log), the wgmma bodies'
    dynamic shared memory, and the SASS counts per kernel. Each wgmma body
    must show HGMMA and UTMALDG (tensor-core products fed by TMA); this
    slice's bodies must build without spills and without a ptxas note."""
    from copilot_for_consensus_tpu_torch.ops import _build

    for name, (body, others) in REDESIGNED.items():
        log = _build.build_log.get(name)
        lib = _build.library(name)
        sass = sass_counts(_build._target(name))
        ptxas = ptxas_functions(log["nvcc"]) if log else None
        row = {"phase": "build_info", "library": name,
               "ptxas": ptxas if ptxas is not None else
               "not built in this run", "dynamic_smem": wgmma_smem(name, lib),
               "sass": sass}
        emit(row)
        if isinstance(sass, dict):
            mine = {f: c for f, c in sass.items() if f.startswith(body)}
            if not mine or any(c["HGMMA"] + c["IGMMA"] == 0
                               or c["UTMALDG"] == 0 for c in mine.values()):
                raise AssertionError(f"{name}: the wgmma body's SASS lacks "
                                     f"HGMMA/IGMMA or UTMALDG: {mine}")
            if others and not any(f.startswith(others) for f in sass):
                raise AssertionError(f"{name}: no kernel of {others} built")
            for prefix, ops in OTHER_BODIES.items():
                for f, c in sass.items():
                    if f.startswith(prefix) and not all(c[o] for o in ops):
                        raise AssertionError(f"{name}: {f}'s SASS lacks one "
                                             f"of {ops}: {c}")
        for f, info in (ptxas or {}).items():
            if f.startswith(NEW_BODIES) and (
                    info.get("spill_stores") or info.get("spill_loads")
                    or info["notes"]):
                raise AssertionError(f"{name}: {f} spills or carries a "
                                     f"ptxas note: {info}")


#: the encoder's K1 case: minilm-l6's attention (12 heads of 32, no kv
#: groups) over 64 texts of one 512-token tile, non-causal, each text's
#: length spread over 1-512 (the seed's draw) — the embedding engine's
#: largest dispatch
ENC_B, ENC_H, ENC_S = 64, 12, 512


def enc_lengths(s: int = ENC_S) -> list[int]:
    """The seed's draw of ``ENC_B`` text lengths over 1-``s``."""
    import numpy as np

    return np.random.default_rng(0).integers(1, s + 1, size=ENC_B).tolist()


def k1_cases():
    """(label, B, Hq, Hkv, Sq, Skv, D, window, kv_lengths, q_offsets,
    kv_begins, timed, causal). The Mistral prefill shapes (Hq 32, Hkv 8,
    D 128, window 4096), causal: the contiguous int8 waves (B4 S512 and
    S1024), the paged miss waves' offsets and begins, the int4 wave (B2
    S2816, the cap3072 deployment), and a window of 256 that bites (the
    main path's 4096 never does). Then D 64 (the wgmma body's other head
    dim) and D 32 (the d32 body's: causal, GQA 8/2). Then the encoder's,
    non-causal: ``enc_s512`` (the d32 body, timed) and the same mask at D
    128 on the wgmma body. Then the d32 body's edges: the encoder's
    smallest bucket (``enc_s32``: B 64, S 32, lengths over 1-32), a
    length-1 row, Sq 200 against Skv 700 with ``q_offsets`` and
    ``kv_begins`` (and a row of length 0, which writes zeros), and a window
    of 100 that bites. At f32 every case runs the CUDA-core body."""
    return [
        ("s512", 4, 32, 8, 512, 512, 128, 4096, [512, 300, 1, 0], None,
         None, False, True),
        ("s1024", 4, 32, 8, 1024, 1024, 128, 4096, [1024, 700, 33, 1000],
         None, None, True, True),
        ("offsets_begins", 4, 32, 8, 256, 1024, 128, 4096,
         [1024, 256, 356, 0], [768, 0, 100, 0], [0, 0, 50, 0], False, True),
        ("s2816", 2, 32, 8, 2816, 2816, 128, 4096, [2816, 2000], None, None,
         True, True),
        ("w256", 2, 32, 8, 1024, 1024, 128, 256, [1024, 900], None, None,
         True, True),
        ("d64", 2, 8, 2, 300, 300, 64, 4096, [300, 157], None, None, False,
         True),
        ("d32", 2, 8, 2, 300, 300, 32, 4096, [300, 157], None, None, False,
         True),
        ("enc_s512", ENC_B, ENC_H, ENC_H, ENC_S, ENC_S, 32, 0,
         enc_lengths(), None, None, True, False),
        ("noncausal_d128", 4, 32, 8, 512, 512, 128, 0, [512, 300, 77, 1],
         None, None, False, False),
        ("enc_s32", ENC_B, ENC_H, ENC_H, 32, 32, 32, 0, enc_lengths(32),
         None, None, False, False),
        ("d32_len1", 3, ENC_H, ENC_H, 96, 96, 32, 0, [1, 96, 50], None,
         None, False, False),
        ("d32_offsets_begins", 4, 8, 2, 200, 700, 32, 4096,
         [700, 200, 356, 0], [500, 0, 100, 0], [0, 0, 50, 0], False, True),
        ("d32_w100", 2, 8, 2, 600, 600, 32, 100, [600, 450], None, None,
         False, True),
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
        for (label, b, hq, hkv, s_q, s_kv, d, window, lens, offs, begins,
             timed, causal) in k1_cases():
            q = torch.randn(b, hq, s_q, d, generator=g, device=dev).to(dt)
            k = torch.randn(b, hkv, s_kv, d, generator=g, device=dev).to(dt)
            v = torch.randn(b, hkv, s_kv, d, generator=g, device=dev).to(dt)

            def ivec(x):
                return None if x is None else torch.tensor(
                    x, dtype=torch.int32, device=dev)
            kw = dict(causal=causal, window=window, kv_lengths=ivec(lens),
                      q_offsets=ivec(offs), kv_begins=ivec(begins))
            # bf16: wgmma at D 64/128, d32 at D 32; f32: the CUDA cores
            want = "simt" if dt_name == "float32" else \
                "wgmma" if d in fa.WGMMA_HEAD_DIMS else "d32"
            before = dict(fa.flash_attention.launches_by_body)
            out = fa.flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            ran = [n for n, c in fa.flash_attention.launches_by_body.items()
                   if c != before[n]]
            ref = fa.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= K1_ATOL[dt_name]
            # work this input needs: the attended (query, key) pairs, and
            # the K and V rows some query attends (each read once)
            lv, ov, bv = fa._row_params(b, s_kv, kw["kv_lengths"],
                                        kw["q_offsets"], kw["kv_begins"],
                                        dev)
            mask = fa._mask(b, s_q, s_kv, lv, ov, bv, causal=causal,
                            window=window, device=dev)
            pairs = int(mask.sum()) * hq
            kv_rows = int(mask.any(dim=1).sum())
            kv_bytes = 2 * hkv * d * k.element_size() * kv_rows
            bnd, by = bound_ms(nbytes(q, out) + kv_bytes + 3 * 4 * b,
                               4.0 * d * pairs, dt_name)
            row = {"kernel": "K1", "case": label, "dtype": dt_name,
                   "shape": [b, hq, hkv, s_q, s_kv, d], "window": window,
                   "causal": causal, "body": fa.flash_body(dt, d),
                   "max_abs_err": err, "tol": K1_ATOL[dt_name]}
            # the bf16 serving cases, and s1024 at f32 as before
            if timed and (dt_name == "bfloat16" or label == "s1024"):
                row.update(
                    ms=time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                    plain_ms=time_ms(
                        lambda: fa.flash_attention_ref(q, k, v, **kw), n=3),
                    library_ms=time_ms(
                        lambda: F.scaled_dot_product_attention(
                            q, k, v, attn_mask=mask[:, None],
                            enable_gqa=True)),
                    bound_ms=bnd, bound_by=by)
            emit(row)
            if not ok:
                raise AssertionError(f"K1 {label} {dt_name}: error {err}")
            if row["body"] != want or ran != [want]:
                raise AssertionError(f"K1 {label} {dt_name}: ran {ran}, "
                                     f"rule {row['body']}, want {want}")
            rows[("K1", label, dt_name)] = row
            del q, k, v, out, ref, mask
    shapes = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
              (4096, 32000)]
    # M = 4: contiguous decode and the prefill lm_head; 8: paged decode;
    # 2048 and 4096: admission waves of 4 rows × the 512 and 1024 buckets
    cases = [(d, f, m, "bfloat16") for d, f in shapes
             for m in (4, 8, 2048, 4096)]
    cases += [(4096, 4096, 4, "float32"), (4096, 4096, 2048, "float32")]
    # the small waves of the paged engine's hits (8 rows x the 64 bucket)
    # and a one-row wave: the wgmma body's 128-column tiles where 256-wide
    # ones would leave SMs idle
    cases += [(4096, 14336, 512, "bfloat16"), (4096, 4096, 512, "bfloat16"),
              (4096, 14336, 64, "bfloat16")]
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
        body = qm.int8_body(m, d, f, dt)
        if body != ("stream" if dt_name == "bfloat16" and m <= 8 else
                    "gemv" if m <= 8 else
                    "wgmma" if dt_name == "bfloat16" else "simt"):
            raise AssertionError(f"K2 m{m}_d{d}_f{f} {dt_name}: body {body}")
        row = {"kernel": "K2", "case": f"m{m}_d{d}_f{f}", "dtype": dt_name,
               "shape": [m, d, f], "body": body,
               "tile_n": qm.int8_tile_n(m, f) if body == "wgmma" else None,
               "plan": qm.int8_stream_plan(m, d, f) if body == "stream"
               else None,
               "max_abs_err": err, "tol": K2_RTOL[dt_name] * scale_ref,
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
    # the wgmma body's int8 -> bf16 conversion, exactly: with small integer
    # x every product and every f32 partial sum is an exact integer, so the
    # kernel must equal its plain version bit for bit, whatever the order
    # of its sums (at both tile widths, ragged M and F, one k-step)
    for m, d, f in ((256, 4096, 1024), (300, 128, 208), (9, 64, 16),
                    (1000, 4096, 6128)):
        x = torch.randint(-8, 9, (m, d), generator=g,
                          device=dev).to(torch.bfloat16)
        q = torch.randint(-128, 128, (d, f), generator=g, dtype=torch.int8,
                          device=dev)
        s = torch.rand(1, f, generator=g, device=dev)
        out = qm.int8_matmul(x, q, s)
        torch.cuda.synchronize()
        ref = qm.int8_matmul_ref(x, q, s)
        row = {"kernel": "K2", "case": f"exact_m{m}_d{d}_f{f}",
               "dtype": "bfloat16", "shape": [m, d, f],
               "body": qm.int8_body(m, d, f, torch.bfloat16),
               "tile_n": qm.int8_tile_n(m, f),
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "bit_equal": bool(torch.equal(out, ref))}
        emit(row)
        if not row["bit_equal"] or row["body"] != "wgmma":
            raise AssertionError(f"K2 {row['case']}: not bit-equal on the "
                                 f"wgmma body: {row}")
        del x, q, s, out, ref
    # the stream body's conversion, exactly (M 1, 4, 8; the k/v leaf split
    # 16 ways or more, w_down's 14336-deep contraction): with |x| <= 8
    # every product and partial sum is an integer below 2^24
    for m, d, f in ((1, 4096, 1024), (4, 4096, 1024), (8, 4096, 1024),
                    (1, 14336, 4096), (4, 14336, 4096), (8, 14336, 4096)):
        x = torch.randint(-8, 9, (m, d), generator=g,
                          device=dev).to(torch.bfloat16)
        q = torch.randint(-128, 128, (d, f), generator=g, dtype=torch.int8,
                          device=dev)
        s = torch.rand(1, f, generator=g, device=dev)
        before = dict(qm.int8_matmul.launches_by_body)
        out = qm.int8_matmul(x, q, s)
        torch.cuda.synchronize()
        ran = [b for b, n in qm.int8_matmul.launches_by_body.items()
               if n != before[b]]
        ref = qm.int8_matmul_ref(x, q, s)
        row = {"kernel": "K2", "case": f"exact_m{m}_d{d}_f{f}",
               "dtype": "bfloat16", "shape": [m, d, f], "body": ran,
               "plan": qm.int8_stream_plan(m, d, f),
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "bit_equal": bool(torch.equal(out, ref))}
        emit(row)
        if not row["bit_equal"] or ran != ["stream"]:
            raise AssertionError(f"K2 {row['case']}: not bit-equal on the "
                                 f"stream body: {row}")
        del x, q, s, out, ref
    # the stream body's edges, untimed: ragged token counts at the k/v leaf
    # and w_down; and F % 16 = 8, a layout it refuses, on the split GEMV
    for m, d, f, want_body in ((1, 4096, 1024, "stream"),
                               (3, 4096, 1024, "stream"),
                               (5, 4096, 1024, "stream"),
                               (7, 4096, 1024, "stream"),
                               (1, 14336, 4096, "stream"),
                               (3, 14336, 4096, "stream"),
                               (5, 14336, 4096, "stream"),
                               (7, 14336, 4096, "stream"),
                               (4, 4096, 1000, "gemv")):
        x = torch.randn(m, d, generator=g, device=dev).to(torch.bfloat16)
        q = torch.randint(-127, 128, (d, f), generator=g, dtype=torch.int8,
                          device=dev)
        s = torch.rand(1, f, generator=g, device=dev) * (2 * d ** -0.5
                                                          / 73.3)
        before = dict(qm.int8_matmul.launches_by_body)
        out = qm.int8_matmul(x, q, s)
        torch.cuda.synchronize()
        ran = [b for b, n in qm.int8_matmul.launches_by_body.items()
               if n != before[b]]
        ref = qm.int8_matmul_ref(x, q, s)
        tol = K2_RTOL["bfloat16"] * ref.float().abs().max().item()
        row = {"kernel": "K2", "case": f"edge_m{m}_d{d}_f{f}",
               "dtype": "bfloat16", "shape": [m, d, f], "body": ran,
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "tol": tol}
        emit(row)
        if ran != [want_body] or not bool(torch.isfinite(out).all()) or \
                not row["max_abs_err"] <= tol:
            raise AssertionError(f"K2 {row['case']}: {row}")
        del x, q, s, out, ref
    # layouts the wgmma body does not take (F % 16, D % 64) on the WMMA body
    for m, d, f in ((300, 4096, 1000), (300, 96, 4096)):
        x = torch.randn(m, d, generator=g, device=dev).to(torch.bfloat16)
        q = torch.randint(-127, 128, (d, f), generator=g, dtype=torch.int8,
                          device=dev)
        s = torch.rand(1, f, generator=g, device=dev) * (2 * d ** -0.5
                                                          / 73.3)
        out = qm.int8_matmul(x, q, s)
        torch.cuda.synchronize()
        ref = qm.int8_matmul_ref(x, q, s)
        tol = K2_RTOL["bfloat16"] * ref.float().abs().max().item()
        row = {"kernel": "K2", "case": f"layout_m{m}_d{d}_f{f}",
               "dtype": "bfloat16", "shape": [m, d, f],
               "body": qm.int8_body(m, d, f, torch.bfloat16),
               "max_abs_err": (out.float() - ref.float()).abs().max().item(),
               "tol": tol}
        emit(row)
        if row["body"] != "wmma" or not row["max_abs_err"] <= tol:
            raise AssertionError(f"K2 {row['case']}: {row}")
        del x, q, s, out, ref
    torch.cuda.empty_cache()
    return rows


def k6_plain(body: str, m: int, d: int, f: int):
    """K6's plain version for a call on ``body``: the stream body's order
    (``w4a8_matmul_stream_ref`` at the plan's groups a split) for
    ``"stream"``, else ``w4a8_matmul_ref``."""
    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    if body != "stream":
        return qm.w4a8_matmul_ref
    per = qm.stream_plan(m, d, f, d // quant.INT4_GROUP)[2]
    return lambda x, q4, s: qm.w4a8_matmul_stream_ref(x, q4, s, per)


def k6_split_qgemm(x, q4, s):
    """The split qgemm that K6 ran at M <= 32 before its stream body (two
    launches after ``quantize_rows``), called through its C entry for
    timing beside the stream body; the wrapper's counts do not see it."""
    import torch

    from copilot_for_consensus_tpu_torch.ops import _build
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    m, d = x.shape
    f, g = q4.shape[1], s.shape[0]
    splits = qm.stream_splits(m, g, f)
    out = torch.empty(m, f, dtype=x.dtype, device=x.device)
    xq, sx = qm._a8_scratch(x, m, d)
    ws = torch.empty((splits, m, f), dtype=torch.float32, device=x.device)
    err = _build.library("w4a8_matmul").w4a8_matmul_fwd(
        x.data_ptr(), q4.data_ptr(), s.data_ptr(), out.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), ws.data_ptr(), m, d, f, g, splits,
        int(x.dtype == torch.bfloat16), qm._stream(x))
    _build.check("w4a8_matmul", err, "w4a8_matmul launch (split qgemm)")
    return out


def k4_mma_sync(x, q, s):
    """The mma.sync tiling that K4 ran on every layout before its wgmma
    body (``quantize_rows`` and one launch), called through its C entry
    for timing beside the wgmma body; the wrapper's counts do not see
    it."""
    import torch

    from copilot_for_consensus_tpu_torch.ops import _build
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    m, d = x.shape
    f = q.shape[1]
    out = torch.empty(m, f, dtype=x.dtype, device=x.device)
    xq, sx = qm._a8_scratch(x, m, d)
    err = _build.library("w8a8_matmul").w8a8_matmul_fwd(
        x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), m, d, f,
        int(x.dtype == torch.bfloat16), qm._stream(x))
    _build.check("w8a8_matmul", err, "w8a8_matmul launch (mma.sync)")
    return out


def phase_quant_kernels(dev, flush):
    """K5, K4 and K6 against their plain versions at the int4 / a8 main
    path's shapes: K5 and K6 at M = 32 (a decode step of the 3072-context
    deployment's 32 slots: both stream bodies, K6's bit for bit equal to
    its plain version in its order and timed beside the split qgemm it
    replaces, ``split_ms``) and M = 5632 (its 2 x 2816 admission wave: both
    wgmma bodies, K6's bit for bit equal to its plain version), K4 at M =
    4096 (the 4 x 1024 wave: its wgmma body, bit for bit equal to its plain
    version and timed beside the mma.sync tiling it replaces,
    ``mma_sync_ms``), bf16 — plus one f32 case each; then K4's edges and
    K5's and K6's tiled and stream edges. Timed beside the bound, the plain
    version and a PyTorch yardstick: K5's and K6's the same ``x @ w`` (w
    dequantized to bf16 beforehand), timed once a case, which for K6 is
    not the same function."""
    import torch

    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(4)
    rows = {}

    def record(row, ok):
        emit(row)
        if not ok:
            raise AssertionError(f"{row['kernel']} {row['case']} "
                                 f"{row['dtype']}: error {row['max_abs_err']}")
        rows[(row["kernel"], row["case"], row["dtype"])] = row

    int4_cases = [(d, f, m, "bfloat16") for d, f in INT4_SHAPES
                  for m in (32, 5632)] + [(4096, 4096, 32, "float32")]
    for d, f, m, dt_name in int4_cases:
        dt = getattr(torch, dt_name)
        x = torch.randn(m, d, generator=g, device=dev).to(dt)
        q4 = torch.randint(-128, 128, (d // 2, f), generator=g,
                           dtype=torch.int8, device=dev)
        s = torch.rand(d // quant.INT4_GROUP, f, generator=g, device=dev) \
            * (2 * d ** -0.5 / 4.61)
        w = quant.dequant_int4({"q4": q4, "scale": s}, dt)
        lib_ms = time_ms(lambda: x @ w, flush=flush)
        k6_path = qm.w4a8_body(m, d, f, quant.INT4_GROUP, dt)
        k6_ref = k6_plain(k6_path, m, d, f)
        for kernel, fn, ref, rtol, peak in (
                ("K5", qm.int4_matmul, qm.int4_matmul_ref, K5_RTOL, dt_name),
                ("K6", qm.w4a8_matmul, k6_ref, K6_RTOL, "int8")):
            out = fn(x, q4, s)
            torch.cuda.synchronize()
            want = ref(x, q4, s)
            top = want.float().abs().max().item()
            err = (out.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and err <= rtol[dt_name] * top
            bnd, by = bound_ms(nbytes(x, q4, s, out), 2.0 * m * d * f, peak)
            row = {"kernel": kernel, "case": f"m{m}_d{d}_f{f}",
                   "dtype": dt_name, "shape": [m, d, f],
                   "path": qm.int4_body(m, f, quant.INT4_GROUP, dt)
                   if kernel == "K5" else k6_path,
                   "max_abs_err": err, "tol": rtol[dt_name] * top,
                   "ms": time_ms(lambda: fn(x, q4, s), flush=flush),
                   "plain_ms": time_ms(lambda: ref(x, q4, s), n=3,
                                       flush=flush),
                   "bound_ms": bnd, "bound_by": by, "library_ms": lib_ms}
            if kernel == "K5":
                if row["path"] == "stream":
                    row["plan"] = qm.stream_plan(m, d, f,
                                                 d // quant.INT4_GROUP)
                row["library"] = "x @ w, w dequantized to x's dtype " \
                                 "beforehand"
            else:
                row["bit_equal"] = bool(torch.equal(out, want))
                row["library"] = K6_YARDSTICK
                if k6_path == "stream":
                    row["plan"] = qm.stream_plan(m, d, f,
                                                 d // quant.INT4_GROUP)
                    # the split qgemm this body replaces, same inputs
                    row["split_ms"] = time_ms(
                        lambda: k6_split_qgemm(x, q4, s), flush=flush)
            record(row, ok)
            want_path = ("stream", "wgmma")[m > qm.STREAM_MAX_M]
            if (dt_name == "bfloat16" or kernel == "K6") and \
                    row["path"] != want_path:
                raise AssertionError(f"{kernel} {row['case']}: path "
                                     f"{row['path']}")
            if row.get("bit_equal") is False:
                raise AssertionError(f"K6 {row['case']}: the {k6_path} "
                                     f"body is not bit-equal to its plain "
                                     f"version")
            del out, want
        del x, q4, s, w
    # K5's and K6's tiled edges: the smallest tiled M (33) and M ragged
    # against the tiles with F ragged against the 128-column ones (5000 x
    # 6128), both on the wgmma bodies (K6's bit for bit); and F % 16 = 8, a
    # layout those bodies do not take, on the mma.sync tiling they leave to
    for m, d, f in ((33, 4096, 6144), (5000, 4096, 6128), (512, 4096, 4104)):
        x = torch.randn(m, d, generator=g, device=dev).to(torch.bfloat16)
        q4 = torch.randint(-128, 128, (d // 2, f), generator=g,
                           dtype=torch.int8, device=dev)
        s = torch.rand(d // quant.INT4_GROUP, f, generator=g, device=dev) \
            * (2 * d ** -0.5 / 4.61)
        w = quant.dequant_int4({"q4": q4, "scale": s}, torch.bfloat16)
        lib_ms = time_ms(lambda: x @ w, flush=flush)
        for kernel, fn, ref, rtol, peak, body in (
                ("K5", qm.int4_matmul, qm.int4_matmul_ref, K5_RTOL,
                 "bfloat16", qm.int4_body(m, f, quant.INT4_GROUP,
                                          torch.bfloat16)),
                ("K6", qm.w4a8_matmul, qm.w4a8_matmul_ref, K6_RTOL, "int8",
                 qm.w4a8_body(m, d, f, quant.INT4_GROUP, torch.bfloat16))):
            out = fn(x, q4, s)
            torch.cuda.synchronize()
            want = ref(x, q4, s)
            top = want.float().abs().max().item()
            err = (out.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(out).all()) and \
                err <= rtol["bfloat16"] * top
            bnd, by = bound_ms(nbytes(x, q4, s, out), 2.0 * m * d * f, peak)
            row = {"kernel": kernel, "case": f"m{m}_d{d}_f{f}",
                   "dtype": "bfloat16", "shape": [m, d, f], "path": body,
                   "max_abs_err": err, "tol": rtol["bfloat16"] * top,
                   "ms": time_ms(lambda: fn(x, q4, s), flush=flush),
                   "plain_ms": time_ms(lambda: ref(x, q4, s), n=3,
                                       flush=flush),
                   "library_ms": lib_ms,
                   "library": "x @ w, w dequantized to x's dtype beforehand"
                   if kernel == "K5" else K6_YARDSTICK,
                   "bound_ms": bnd, "bound_by": by}
            if kernel == "K6":
                row["bit_equal"] = bool(torch.equal(out, want))
            record(row, ok)
            want_path = "mma_sync" if f % 16 else "wgmma"
            if body != want_path or row.get("bit_equal") is False and \
                    body == "wgmma":
                raise AssertionError(f"{kernel} {row['case']}: {row}")
            del out, want
        del x, q4, s, w
    # K6's wgmma body at f32 x (untimed): only the store differs, so it is
    # bit-equal to the plain version too
    x = torch.randn(512, 4096, generator=g, device=dev)
    q4 = torch.randint(-128, 128, (2048, 4096), generator=g,
                       dtype=torch.int8, device=dev)
    s = torch.rand(16, 4096, generator=g, device=dev) * (2 * 4096 ** -0.5
                                                          / 4.61)
    before = dict(qm.w4a8_matmul.launches_by_body)
    out = qm.w4a8_matmul(x, q4, s)
    torch.cuda.synchronize()
    ran = [b for b, n in qm.w4a8_matmul.launches_by_body.items()
           if n != before[b]]
    want = qm.w4a8_matmul_ref(x, q4, s)
    row = {"kernel": "K6", "case": "edge_m512_d4096_f4096", "dtype":
           "float32", "shape": [512, 4096, 4096], "path": ran,
           "max_abs_err": (out - want).abs().max().item(),
           "bit_equal": bool(torch.equal(out, want))}
    emit(row)
    if ran != ["wgmma"] or not row["bit_equal"]:
        raise AssertionError(f"K6 {row['case']}: {row}")
    del x, q4, s, out, want
    # K5's stream edges, untimed: one and eight tokens and a ragged 17 at
    # the fused q/k/v shape (all split over the contraction), and F % 16 =
    # 8 at M = 32, a layout the stream body refuses, on the split qgemm
    for m, d, f, want_path in ((1, 4096, 6144, "stream"),
                               (8, 4096, 6144, "stream"),
                               (17, 4096, 6144, "stream"),
                               (32, 4096, 4104, "split")):
        x = torch.randn(m, d, generator=g, device=dev).to(torch.bfloat16)
        q4 = torch.randint(-128, 128, (d // 2, f), generator=g,
                           dtype=torch.int8, device=dev)
        s = torch.rand(d // quant.INT4_GROUP, f, generator=g, device=dev) \
            * (2 * d ** -0.5 / 4.61)
        before = dict(qm.int4_matmul.launches_by_body)
        out = qm.int4_matmul(x, q4, s)
        torch.cuda.synchronize()
        ran = [b for b, n in qm.int4_matmul.launches_by_body.items()
               if n != before[b]]
        want = qm.int4_matmul_ref(x, q4, s)
        top = want.float().abs().max().item()
        err = (out.float() - want.float()).abs().max().item()
        row = {"kernel": "K5", "case": f"edge_m{m}_d{d}_f{f}",
               "dtype": "bfloat16", "shape": [m, d, f], "path": ran,
               "plan": qm.stream_plan(m, d, f, d // quant.INT4_GROUP)
               if want_path == "stream" else None,
               "max_abs_err": err, "tol": K5_RTOL["bfloat16"] * top}
        emit(row)
        if ran != [want_path] or not bool(torch.isfinite(out).all()) or \
                not err <= K5_RTOL["bfloat16"] * top:
            raise AssertionError(f"K5 {row['case']}: {row}")
        del x, q4, s, out, want
    # K6's stream edges, untimed: one, eight and a ragged 17 tokens at the
    # fused q/k/v shape (all split over the contraction) and f32 x at M =
    # 32, each bit for bit equal to the stream body's plain version; and F
    # % 16 = 8 at M = 32, a layout the stream body refuses, on the split
    # qgemm within K6_RTOL
    for m, d, f, dt_name, want_path in (
            (1, 4096, 6144, "bfloat16", "stream"),
            (8, 4096, 6144, "bfloat16", "stream"),
            (17, 4096, 6144, "bfloat16", "stream"),
            (32, 4096, 6144, "float32", "stream"),
            (32, 4096, 4104, "bfloat16", "split")):
        dt = getattr(torch, dt_name)
        x = torch.randn(m, d, generator=g, device=dev).to(dt)
        q4 = torch.randint(-128, 128, (d // 2, f), generator=g,
                           dtype=torch.int8, device=dev)
        s = torch.rand(d // quant.INT4_GROUP, f, generator=g, device=dev) \
            * (2 * d ** -0.5 / 4.61)
        before = dict(qm.w4a8_matmul.launches_by_body)
        out = qm.w4a8_matmul(x, q4, s)
        torch.cuda.synchronize()
        ran = [b for b, n in qm.w4a8_matmul.launches_by_body.items()
               if n != before[b]]
        want = k6_plain(want_path, m, d, f)(x, q4, s)
        top = want.float().abs().max().item()
        err = (out.float() - want.float()).abs().max().item()
        row = {"kernel": "K6", "case": f"edge_m{m}_d{d}_f{f}",
               "dtype": dt_name, "shape": [m, d, f], "path": ran,
               "plan": qm.stream_plan(m, d, f, d // quant.INT4_GROUP)
               if want_path == "stream" else None,
               "max_abs_err": err, "tol": K6_RTOL[dt_name] * top,
               "bit_equal": bool(torch.equal(out, want))}
        emit(row)
        if ran != [want_path] or not bool(torch.isfinite(out).all()) or \
                not err <= K6_RTOL[dt_name] * top or \
                (want_path == "stream" and not row["bit_equal"]):
            raise AssertionError(f"K6 {row['case']}: {row}")
        del x, q4, s, out, want
    # K4 at the a8 wave's four layer shapes and f32 x, then its edges: M
    # 1000 x F 4112 (ragged against the 256-token and 128-column tiles) on
    # the wgmma body, and D 4160 and F 4104, layouts it does not take, on
    # the mma.sync tiling; every one bit for bit equal to the plain version
    a8_cases = [(d, f, 4096, "bfloat16", "wgmma") for d, f in A8_SHAPES] + \
        [(4096, 4096, 4096, "float32", "wgmma"),
         (4096, 4112, 1000, "bfloat16", "wgmma"),
         (4160, 4096, 1024, "bfloat16", "mma_sync"),
         (4096, 4104, 1024, "bfloat16", "mma_sync")]
    for d, f, m, dt_name, want_path in a8_cases:
        dt = getattr(torch, dt_name)
        x = torch.randn(m, d, generator=g, device=dev).to(dt)
        q = torch.randint(-127, 128, (d, f), generator=g, dtype=torch.int8,
                          device=dev)
        s = torch.rand(1, f, generator=g, device=dev) * (2 * d ** -0.5
                                                          / 73.3)
        before = dict(qm.w8a8_matmul.launches_by_body)
        out = qm.w8a8_matmul(x, q, s)
        torch.cuda.synchronize()
        ran = [b for b, n in qm.w8a8_matmul.launches_by_body.items()
               if n != before[b]]
        want = qm.w8a8_matmul_ref(x, q, s)
        err = (out.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(out).all()) and err <= K4_ATOL
        xq, sx = qm.quantize_rows(x)
        bnd, by = bound_ms(nbytes(x, q, s, out), 2.0 * m * d * f, "int8")
        row = {"kernel": "K4", "case": f"m{m}_d{d}_f{f}", "dtype": dt_name,
               "shape": [m, d, f], "path": qm.w8a8_body(m, d, f, dt),
               "ran": ran, "max_abs_err": err, "tol": K4_ATOL,
               "bit_equal": bool(torch.equal(out, want)),
               "ms": time_ms(lambda: qm.w8a8_matmul(x, q, s), flush=flush),
               "plain_ms": time_ms(lambda: qm.w8a8_matmul_ref(x, q, s), n=3,
                                   flush=flush),
               "library_ms": time_ms(
                   lambda: (torch._int_mm(xq, q).float() * sx * s).to(dt),
                   flush=flush),
               "library": "torch._int_mm(xq, q) then the two scales, xq "
                          "quantized beforehand",
               "bound_ms": bnd, "bound_by": by}
        if want_path == "wgmma":
            # the mma.sync tiling this body replaces, same inputs
            row["mma_sync_ms"] = time_ms(lambda: k4_mma_sync(x, q, s),
                                         flush=flush)
            row["faster_than"] = {
                "mma_sync": row["ms"] < row["mma_sync_ms"],
                "library": row["ms"] < row["library_ms"]}
        record(row, ok)
        if row["path"] != want_path or ran != [want_path] or \
                not row["bit_equal"]:
            raise AssertionError(f"K4 {row['case']}: {row}")
        del x, q, s, out, want, xq, sx
    torch.cuda.empty_cache()
    return rows


def p_body_delta(wrapper, before: dict) -> dict:
    """A P wrapper's launches by body since ``before`` (its
    ``launches_by_body`` then)."""
    return {k: n - before[k] for k, n in wrapper.launches_by_body.items()}


def p_check(mode: str, body: str, out, want, label: str) -> dict:
    """P's output against its plain version: finite, and within the mode's
    tolerance; bit for bit for ``P_BIT_EQUAL`` on the wgmma body."""
    import torch

    top = want.float().abs().max().item()
    err = (out.float() - want.float()).abs().max().item()
    tol = P_ATOL[mode] if mode in P_ATOL else P_RTOL[mode] * top
    equal = bool(torch.equal(out, want))
    ok = bool(torch.isfinite(out).all()) and err <= tol and \
        out.shape == want.shape
    if body == "wgmma" and mode in P_BIT_EQUAL:
        ok = ok and equal
    if not ok:
        raise AssertionError(f"{label} {mode} ({body}): error {err} > {tol} "
                             f"or not bit-equal ({equal})")
    return {"max_abs_err": err, "tol": tol, "bit_equal": equal}


def phase_probe_edges(dev) -> None:
    """Untimed: the Hopper body of P at B 100 (ragged against the token
    tile), B 1, and D 6144 (three contraction tiles), and a layout it
    refuses (F 384, not whole 256-column clusters, on the mma.sync body), each
    mode against its plain version."""
    import torch

    from copilot_for_consensus_tpu_torch.ops import probe_stream as ps

    for b, d, f, want_body in ((100, 4096, 512, "wgmma"),
                               (1, 2048, 256, "wgmma"),
                               (64, 6144, 1024, "wgmma"),
                               (128, 4096, 384, "simple")):
        g = torch.Generator(device=dev).manual_seed(b + d + f)
        x = torch.randn(b, d, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randint(-127, 128, (d, f), generator=g, dtype=torch.int8,
                          device=dev)
        w4 = torch.randint(-128, 128, (d // 2, f), generator=g,
                           dtype=torch.int8, device=dev)
        line = {"phase": "probe_edge", "shape": [b, d, f], "modes": {}}
        for mode in P_WGMMA_MODES:
            body = ps.probe_body(mode, b, d, f)
            if body != want_body:
                raise AssertionError(f"probe edge {b}x{d}x{f} {mode}: body "
                                     f"{body}, expected {want_body}")
            wrap = kernel_wrappers()[P_COUNTERS[mode]]
            before = dict(wrap.launches_by_body)
            if mode == "convdot":
                out, want = ps.probe_convdot(x, w), ps.convdot_ref(x, w)
            elif mode == "i8dot":
                out, want = ps.probe_i8dot(x, w), ps.i8dot_ref(x, w)
            else:
                out = ps.probe_unpack(x, w4, widen=mode == "unpack32")
                want = ps.unpack_ref(x, w4)
            torch.cuda.synchronize()
            delta = p_body_delta(wrap, before)
            if delta[body] != 1 or sum(delta.values()) != 1:
                raise AssertionError(f"probe edge {mode}: launches {delta}")
            line["modes"][mode] = {"body": body,
                                   **p_check(mode, body, out, want,
                                             "probe edge")}
        emit(line)
        del x, w, w4
    torch.cuda.empty_cache()


def phase_probe(dev, flush, smi):
    """P, the weight-stream probe: each mode's kernel against its plain
    version at one full layer ([128, 4096] x [4096, 14336], seeded inputs),
    timed beside its bound, its plain version and a PyTorch yardstick where
    one call computes the same function — convdot, i8dot and unpack (both
    unpackings) on the Hopper body, one launch of it a call, and beside PR
    4's body on the same inputs (``simple_ms``); then the Hopper body's
    edges; then the probe script over all five modes with the launch counts
    reset just before: each mode's kernel must launch 2 x n x L times
    (warm-up and timed passes), the four on the Hopper body, and no mode
    may stream faster than 1.05 x 3.35 TB/s."""
    import torch

    from copilot_for_consensus_tpu_torch.ops import probe_stream as ps
    from copilot_for_consensus_tpu_torch.scripts import probe_stream as drv

    g = torch.Generator(device=dev).manual_seed(6)
    b, d, f = drv.B, drv.D, drv.F
    x = torch.randn(b, d, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (d, f), generator=g, dtype=torch.int8,
                      device=dev)
    w4 = torch.randint(-128, 128, (d // 2, f), generator=g, dtype=torch.int8,
                       device=dev)
    xi = x.to(torch.int8)
    ops = 2.0 * b * d * f
    cases = [
        ("dma", lambda: ps.probe_dma(x, w), lambda: ps.dma_ref(x, w),
         nbytes(x[:, :1], w) + b * f * 2, (d // ps.BD + b) * f, "float32",
         None, "none: no PyTorch call reads every byte and sums one row a "
         "tile"),
        ("convdot", lambda: ps.probe_convdot(x, w),
         lambda: ps.convdot_ref(x, w), nbytes(x, w) + b * f * 2, ops,
         "bfloat16", lambda: x @ w.to(torch.bfloat16),
         "x @ w.to(bf16)"),
        ("i8dot", lambda: ps.probe_i8dot(x, w), lambda: ps.i8dot_ref(x, w),
         nbytes(x, w) + b * f * 2, ops, "int8",
         lambda: (torch._int_mm(xi, w).float() * 1e-4).to(torch.bfloat16),
         "torch._int_mm(xi, w) * 1e-4, xi truncated beforehand"),
        ("unpack8", lambda: ps.probe_unpack(x, w4),
         lambda: ps.unpack_ref(x, w4), nbytes(x, w4) + b * f * 2, ops,
         "int8", None, "none: no PyTorch call unpacks int4 and scales int32 "
         "partials per group"),
        ("unpack32", lambda: ps.probe_unpack(x, w4, widen=True),
         lambda: ps.unpack_ref(x, w4), nbytes(x, w4) + b * f * 2, ops,
         "int8", None, "none: no PyTorch call unpacks int4 and scales int32 "
         "partials per group"),
    ]
    # the mma.sync body of each mode on the same inputs (its launches are not
    # counted)
    simple = {"convdot": lambda: ps.simple_body("convdot", x, w),
              "i8dot": lambda: ps.simple_body("i8dot", x, w),
              "unpack8": lambda: ps.simple_body("unpack8", x, w4),
              "unpack32": lambda: ps.simple_body("unpack32", x, w4)}
    rows = {}
    for mode, fn, ref, nb, flops, peak, lib, lib_desc in cases:
        wrap = kernel_wrappers()[P_COUNTERS[mode]]
        before = dict(getattr(wrap, "launches_by_body", {}))
        out = fn()
        torch.cuda.synchronize()
        delta = p_body_delta(wrap, before) if before else None
        body = ps.probe_body(mode, b, d, f) if mode in simple else None
        want = ref()
        bnd, by = bound_ms(nb, flops, peak)
        row = {"kernel": "P", "case": mode, "dtype": "bfloat16",
               "shape": [b, d, f],
               **p_check(mode, body, out, want, "P"),
               "ms": time_ms(fn, flush=flush),
               "plain_ms": time_ms(ref, n=3, flush=flush),
               "library_ms": time_ms(lib, flush=flush) if lib else None,
               "library": lib_desc, "bound_ms": bnd, "bound_by": by,
               "device_us_by_kernel": traced_us(fn, flush), "device": smi}
        if body is not None:
            if body != "wgmma" or delta != {"wgmma": 1, "simple": 0}:
                raise AssertionError(f"P {mode}: body {body}, launches of "
                                     f"one call {delta}")
            old = simple[mode]()
            torch.cuda.synchronize()
            row.update(body=body, launches_a_call=delta,
                       simple_ms=time_ms(simple[mode], flush=flush),
                       simple=p_check(mode, "simple", old, want,
                                      "P (the mma.sync body)"))
            row["x_below_simple"] = row["simple_ms"] / row["ms"]
            del old
        emit(row)
        rows[("P", mode, "bfloat16")] = row
        del out, want
    del x, w, w4, xi
    torch.cuda.empty_cache()
    phase_probe_edges(dev)

    reset_launches()
    per_mode, by_body = {}, {}
    for mode in drv.MODES:
        wrap = kernel_wrappers()[P_COUNTERS[mode]]
        before = read_launches()[P_COUNTERS[mode]]
        before_body = dict(getattr(wrap, "launches_by_body", {}))
        line = drv.run(mode, device=dev)
        per_mode[mode] = read_launches()[P_COUNTERS[mode]] - before
        if before_body:
            by_body[mode] = p_body_delta(wrap, before_body)
        line.update(phase="probe", launches=per_mode[mode],
                    launches_by_body=by_body.get(mode), device=smi)
        emit(line)
        torch.cuda.empty_cache()
        if line["share_of_hbm"] > P_MAX_HBM_SHARE:
            raise AssertionError(f"probe {mode}: {line['gb_per_s']} GB/s is "
                                 f"beyond the card's memory: loads dropped")
        if not math.isfinite(line["mean_abs_out"]):
            raise AssertionError(f"probe {mode}: non-finite output")
        rows[("P", mode, "bfloat16")]["probe"] = line
    launches = read_launches()
    check_path("probe", launches, set(P_COUNTERS.values()))
    want_n = 2 * drv.N * drv.L
    if any(n != want_n for n in per_mode.values()) or \
            launches["P_unpack"] != 2 * want_n:
        raise AssertionError(f"probe launches {per_mode}, {launches}: "
                             f"{want_n} a mode expected")
    for mode in P_WGMMA_MODES:
        if by_body[mode] != {"wgmma": want_n, "simple": 0}:
            raise AssertionError(f"probe {mode}: launches by body "
                                 f"{by_body[mode]}, all {want_n} on "
                                 f"\"wgmma\" expected")
    return rows, launches, per_mode


def traced_us(fn, flush) -> dict:
    """Device µs by kernel of one call of ``fn`` under ``torch.profiler``,
    L2 flushed before it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_us_by_kernel(prof)[1]


def k3_cases():
    """(label, pool dtype, window, rows R, lengths) at the paged main
    path's shapes: B 8, Hkv 8, D 128, blocks of 64 in a 1024-block pool.
    Decode: R = 4 (the group of Hq 32 / Hkv 8), a 64-entry table. Seeded
    admission: R = 4·S query rows against prefixes read from the pool.
    bf16 pools take the decode and seeded bodies; f32, f16 and fp8 pools
    (e4m3, the fp8 KV cache's, and e5m2) the CUDA-core body."""
    dec = [0, 1, 64, 65, 1000, 4095, 2048, 777]
    return [
        ("decode", "bfloat16", 4096, 4, dec),
        ("decode_w100", "bfloat16", 100, 4, dec),
        ("decode", "float32", 4096, 4, dec),
        ("decode", "float8_e4m3fn", 4096, 4, dec),
        # the other pool dtypes K3's CUDA-core body converts on load
        ("decode", "float16", 4096, 4, dec),
        ("decode", "float8_e5m2", 4096, 4, dec),
        ("seeded_s64", "bfloat16", 0, 4 * 64,
         [0, 64, 128, 333, 512, 700, 960, 1]),
        # an fp8 pool's seeded hits (the paged_fp8 phase's admission)
        ("seeded_s64", "float8_e4m3fn", 0, 4 * 64,
         [0, 64, 128, 333, 512, 700, 960, 1]),
        ("seeded_s1024", "bfloat16", 0, 4 * 1024, [128] * 8),
    ]


def k3_errors(part, ref) -> tuple[float, float, float, bool]:
    """K3's partials against its plain version's: the normalised output's
    max error, m's on rows that attend anything, l's relative error there,
    and whether all are within tolerance with rows that attend nothing at
    m = -inf and l = 0."""
    import torch

    from copilot_for_consensus_tpu_torch.ops.attention import (
        combine_partials,
    )

    got = combine_partials([part], torch.float32)
    want = combine_partials([ref], torch.float32)
    err = (got - want).abs().max().item()
    live = torch.isfinite(ref[1])
    m_err = (part[1] - ref[1])[live].abs().max().item()
    l_err = ((part[2] - ref[2]).abs() / ref[2])[live].max().item()
    ok = (bool(torch.isfinite(got).all()) and err <= K3_ATOL
          and m_err <= K3_M_ATOL and l_err <= K3_L_RTOL
          and bool(torch.isinf(part[1][~live]).all())
          and not bool(part[2][~live].any()))
    return err, m_err, l_err, ok


def k3_layout_cases():
    """(label, head dim, pool block, rows R, window, lengths, table width,
    body): the other layouts the decode and seeded bodies take — D 64,
    8 and 16 rows (the decode body's 8-row groups), pool blocks of 8, 16
    and 128 (one box or several a K/V tile), R not a multiple of 128, a
    window that starts inside a tile — on 4 slots of 2 kv heads."""
    return [
        ("decode_r8_d64_w100", 64, 64, 8, 100, [0, 1, 300, 4000], 64,
         "decode"),
        ("decode_r16_blk16", 128, 16, 16, 0, [17, 1000, 0, 2047], 128,
         "decode"),
        ("seeded_r160_d64_blk16", 64, 16, 160, 0, [0, 100, 333, 1024], 64,
         "seeded"),
        ("seeded_r300_blk128_w300", 128, 128, 300, 300, [1000, 129, 0, 2000],
         16, "seeded"),
        ("seeded_r17_blk8", 128, 8, 17, 0, [5, 64, 200, 0], 32, "seeded"),
    ]


def phase_k3_layouts(dev):
    """K3's decode and seeded bodies held against the plain version at the
    layouts of ``k3_layout_cases`` (untimed): each must take its body and
    meet the tolerances of the main-path cases."""
    import torch

    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(7)
    b, hkv, n_l, li = 4, 2, 2, 1
    for label, d, blk, r, window, lens, nb, body in k3_layout_cases():
        nbtot = b * nb + 1
        pk, pv = (torch.randn((n_l, nbtot, hkv, blk, d), generator=g,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
        q = torch.randn(b, hkv, r, d, generator=g,
                        device=dev).to(torch.bfloat16)
        tables = torch.full((b, nb), nbtot, dtype=torch.int32, device=dev)
        perm = torch.randperm(nbtot - 1, generator=g, device=dev)
        for i, n in enumerate(lens):
            need = min(nb, -(-n // blk))
            tables[i, :need] = perm[i * nb:i * nb + need].to(torch.int32)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        args = (q, pk, pv, li, tables, lengths, lengths + 2)
        part = pa.paged_attention_partial(*args, window=window)
        torch.cuda.synchronize()
        ref = pa.paged_attention_partial_ref(*args, window=window)
        err, m_err, l_err, ok = k3_errors(part, ref)
        row = {"kernel": "K3", "case": label, "dtype": "bfloat16",
               "shape": [b, hkv, r, d, blk, nb], "window": window,
               "body": pa.paged_body(r, q.dtype, pk.dtype, d, blk),
               "max_abs_err": err, "m_err": m_err, "l_rel_err": l_err}
        emit(row)
        if not ok or row["body"] != body:
            raise AssertionError(f"K3 {label}: {row}")
        del pk, pv, q, part, ref
    torch.cuda.empty_cache()


def phase_k3(dev, flush):
    """K3 held against its plain version at the paged main path's
    shapes (normalised through combine_partials), timed beside its bound,
    its plain version and SDPA over the pre-gathered view."""
    import torch
    import torch.nn.functional as F

    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(3)
    b, hkv, d, blk, nbtot, n_l, li = 8, 8, 128, 64, 1024, 2, 1
    rows = {}
    pools = {}
    for label, pdt, window, r, lens in k3_cases():
        dt = getattr(torch, pdt)
        if pdt not in pools:
            shape = (n_l, nbtot, hkv, blk, d)
            pools[pdt] = tuple(
                torch.randn(shape, generator=g, device=dev).to(dt)
                for _ in range(2))
        pk, pv = pools[pdt]
        qdt = torch.float32 if pdt == "float32" else torch.bfloat16
        q = torch.randn(b, hkv, r, d, generator=g, device=dev).to(qdt)
        nb = 64 if label.startswith("decode") else max(
            1, -(-max(lens) // blk))
        # each row's blocks are distinct shuffled ids; the rest are pads
        tables = torch.full((b, nb), nbtot, dtype=torch.int32, device=dev)
        perm = torch.randperm(nbtot, generator=g, device=dev)
        for i, n in enumerate(lens):
            need = -(-n // blk)
            tables[i, :need] = perm[i * 64:i * 64 + need].to(torch.int32)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        q_pos = lengths + 2
        args = (q, pk, pv, li, tables, lengths, q_pos)
        body = pa.paged_body(r, qdt, dt, d, blk)
        before = pa.paged_attention_partial.launches_by_body[body]
        part = pa.paged_attention_partial(*args, window=window)
        torch.cuda.synchronize()
        want = ("decode" if r <= 16 else "seeded") if pdt == "bfloat16" \
            else "simt"
        if body != want or \
                pa.paged_attention_partial.launches_by_body[body] != before + 1:
            raise AssertionError(f"K3 {label} {pdt}: ran {body}, not {want}")
        ref = pa.paged_attention_partial_ref(*args, window=window)
        # the normalised output, and the raw (m, l) row by row
        err, m_err, l_err, ok = k3_errors(part, ref)
        # the work this input needs: positions [lo, hi) of each row, whose
        # K and V rows are read once each
        hi = lengths.clamp(max=nb * blk).long()
        lo = (q_pos.long() - window + 1).clamp(min=0) if window > 0 \
            else torch.zeros_like(hi)
        pos = (hi - lo).clamp(min=0)
        # on the CUDA-core body, the 64-position tiles the longest (slot,
        # head) block walks in turn: with B·Hkv = 64 blocks it sets the time
        tiles = int(torch.where(hi > lo, -(-hi // 64) - lo // 64, 0).max())
        elt = pk.element_size()
        kv_bytes = int(pos.sum()) * hkv * d * elt * 2
        out_bytes = sum(t.numel() * 4 for t in part)
        bnd, by = bound_ms(
            kv_bytes + nbytes(q, tables, lengths, q_pos) + out_bytes,
            4.0 * r * d * hkv * int(pos.sum()), pdt)
        # yardstick: SDPA over the pre-gathered view with the same mask
        # (normalised output; the gather is excluded from its time)
        kg, vg = pa.paged_gather_layer(pk[li], pv[li], tables)
        kg, vg = kg.to(qdt), vg.to(qdt)
        t = torch.arange(kg.shape[2], device=dev)[None]
        mask = (t < lengths.long()[:, None]) & (t >= lo[:, None])
        grp = 4
        qs = q.reshape(b, hkv * grp, r // grp, d)
        row = {"kernel": "K3", "case": label, "dtype": pdt,
               "shape": [b, hkv, r, d, blk, nb], "window": window,
               "body": body, "max_abs_err": err, "tol": K3_ATOL,
               "m_err": m_err, "m_tol": K3_M_ATOL,
               "l_rel_err": l_err, "l_rtol": K3_L_RTOL,
               "positions": int(pos.sum()),
               "ms": time_ms(lambda: pa.paged_attention_partial(
                   *args, window=window), flush=flush),
               "plain_ms": time_ms(lambda: pa.paged_attention_partial_ref(
                   *args, window=window), n=3, flush=flush),
               "library_ms": time_ms(
                   lambda: F.scaled_dot_product_attention(
                       qs, kg, vg, attn_mask=mask[:, None, None],
                       enable_gqa=True), flush=flush),
               "library": "SDPA over the pre-gathered view, normalised "
                          "output, gather excluded",
               "bound_ms": bnd, "bound_by": by}
        if body == "decode":
            # the split-KV body: the CTAs that attend anything
            plan = pa.decode_splits(lens, q_pos.tolist(), window, nb, blk)
            row.update(live_ctas=hkv * sum(len(p) for p in plan),
                       split_len=pa.decode_split_len(blk))
        elif r <= 8:
            # the CUDA-core decode tiling: one block a (slot, head)
            row.update(max_tiles=tiles, us_per_tile=row["ms"] * 1e3 / tiles)
        emit(row)
        if not ok:
            raise AssertionError(f"K3 {label} {pdt}: error {err}, m error "
                                 f"{m_err}, l relative error {l_err}")
        rows[("K3", label, pdt)] = row
        del q, part, ref, kg, vg
    del pools
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


def phase_a8_model(dev, cfg, params):
    """One 4 x 1024 admission wave of the int8 model with activation
    quantization on (``set_act_quant("a8")``): through the kernels, where
    every layer projection (M = 4096 >= 1024 rows) takes K4's wgmma body
    and the lm_head (M = 4) stays on K2, and through the plain versions;
    last-position logits compared by relative L2. The weight-only kernel
    logits of the same wave are printed beside them, not gated on: they
    show what a8 changes."""
    import torch

    from copilot_for_consensus_tpu_torch.models import decoder, quant

    g = torch.Generator(device=dev).manual_seed(5)
    rows, bucket = 4, 1024
    tokens = torch.randint(3, 259, (rows, bucket), generator=g, device=dev)
    lengths = torch.tensor([1024, 700, 333, 1000], device=dev)

    def run(impl):
        cache = decoder.init_cache(cfg, rows, bucket, dtype=torch.bfloat16,
                                   device=dev)
        t0 = time.monotonic()
        with torch.inference_mode():
            logits, _ = decoder.prefill(params, tokens, lengths, cfg, cache,
                                        impl=impl)
        torch.cuda.synchronize()
        return logits, time.monotonic() - t0

    weight_only, weight_only_s = run("auto")
    quant.set_act_quant("a8")
    try:
        reset_launches()
        a, kernel_s = run("auto")
        launches = read_launches()
        bodies = read_bodies()
        b, plain_s = run("plain")
    finally:
        quant.set_act_quant("weight_only")

    def rel(u, v):
        return ((u - v).norm() / v.norm()).item()
    row = {"phase": "a8_model", "config": cfg.name, "rows": rows,
           "bucket": bucket, "rel_l2": rel(a, b), "bound": LOGITS_REL_L2,
           "rel_l2_vs_weight_only": rel(a, weight_only),
           "launches": launches, "launches_by_body": bodies,
           "expected_k4": 7 * cfg.n_layers,
           "kernel_prefill_s": kernel_s, "plain_prefill_s": plain_s,
           "weight_only_prefill_s": weight_only_s}
    emit(row)
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("non-finite a8 prefill logits")
    if row["rel_l2"] > LOGITS_REL_L2:
        raise AssertionError(f"a8 kernel vs plain prefill logits: {row}")
    check_path("a8_model", launches, ("K1", "K2", "K4"))
    check_bodies("a8_model", bodies)
    if (launches["K4"], bodies["K4"]["wgmma"], launches["K2"],
            bodies["K2"]["stream"]) != (7 * cfg.n_layers, 7 * cfg.n_layers,
                                        1, 1):
        raise AssertionError(f"a8 wave launches {launches} by body "
                             f"{bodies}")
    return launches, bodies


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


@contextlib.contextmanager
def finite_logits(eng):
    """Check every logits row ``eng`` samples inside the block for finite
    values. The check accumulates into a flag on the device (yielded; the
    caller reads it once, after the block) from a stand-in for the engine
    module's ``sample``. A decode graph captured meanwhile records the
    check and the flag's address in its body, so on leaving the block the
    stand-in is removed and every graph of ``eng`` is dropped: later
    phases capture, and time, the engine's own body, and no replay writes
    into the flag's memory once it has been freed."""
    import torch

    from copilot_for_consensus_tpu_torch.engine import generation

    finite = torch.ones((), dtype=torch.bool, device=eng.device)
    plain_sample = generation.sample

    def checked_sample(logits, gen, sampling):
        finite.logical_and_(torch.isfinite(logits).all())
        return plain_sample(logits, gen, sampling)

    generation.sample = checked_sample
    try:
        yield finite
    finally:
        generation.sample = plain_sample
        torch.cuda.synchronize()
        eng._graphs.drop(block=False)
        if len(eng._graphs) or generation.sample is not plain_sample:
            raise AssertionError("graphs captured under the finite check "
                                 "outlived it")


def _recorded(summ) -> list:
    """The completions ``summ``'s engine returns, in order."""
    eng = summ.engine
    comps, plain_generate = [], eng.generate

    def recording_generate(prompts, max_new_tokens, **kw):
        out = plain_generate(prompts, max_new_tokens, **kw)
        comps.extend(out)
        return out

    eng.generate = recording_generate
    return comps


def phase_serve(dev, cfg, params, smi):
    import torch

    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
        build_prompt,
    )

    new_tokens = 64
    summ = CUDASummarizer(cfg.name, params=params, num_slots=4,
                          max_len=4096, max_new_tokens=new_tokens,
                          device=dev)
    eng = summ.engine
    comps = _recorded(summ)
    threads = synthetic_threads(8)
    reset_launches()
    # every sampled logits row must be finite
    with finite_logits(eng) as finite:
        t0 = time.monotonic()
        summaries = summ.summarize_batch(threads)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_launches()
        bodies = read_bodies()
        stats = eng.graph_stats()

    prompts = [summ.tokenizer.encode(build_prompt(t), add_bos=True)
               for t in threads]
    if not bool(finite):
        raise AssertionError("non-finite logits while serving")
    for t, s, c, p in zip(threads, summaries, comps, prompts):
        if s.thread_id != t.thread_id or c.prompt_len != min(
                len(p), eng.prompt_limit):
            raise AssertionError(f"wrong prompt length for {t.thread_id}")
        # "length" is the token limit, or the cache's end one dispatch away
        cache_end = (c.prompt_len + len(c.tokens) + 2 * eng._dispatch_steps
                     > eng.max_len - 1)
        if (c.finish_reason == "length" and len(c.tokens) != new_tokens
                and not cache_end):
            raise AssertionError(f"{t.thread_id}: {len(c.tokens)} tokens")
        if c.finish_reason == "eos" and len(c.tokens) >= new_tokens:
            raise AssertionError(f"{t.thread_id}: eos past the limit")
        if s.completion_tokens != len(c.tokens):
            raise AssertionError(f"{t.thread_id}: summary/tokens mismatch")
    check_path("serve", launches, ("K1", "K2"))
    check_bodies("serve", bodies)
    check_k2_passes("serve", launches, bodies, cfg.n_layers)
    emit({"phase": "serve", "config": cfg.name, "threads": len(threads),
          "prompt_tokens": [c.prompt_len for c in comps],
          "completion_tokens": [len(c.tokens) for c in comps],
          "finish": [c.finish_reason for c in comps],
          "wall_s": wall, "prefill_s": eng.admitted_s,
          "decode_s": eng.decode_s, "decode_tokens": eng.decode_tokens,
          "decode_tok_per_s": eng.decode_tokens / eng.decode_s,
          "ttft_s": [c.ttft_s for c in comps], "launches": launches,
          "launches_by_body": bodies, "graphs": stats, "device": smi})
    return launches, bodies, prompts, eng, summaries


def phase_graphs(dev, cfg, params, smi, *, paged: bool):
    """Decode through graph replays against the eager body, on the card:
    the serve phase's 8 threads (64 new tokens each) through two engines of
    the same weights and configuration, one replaying a CUDA graph per kv
    bucket (``cuda_graphs=True``, the default) and one running the same
    dispatch body eagerly (``cuda_graphs=False``), at windows_per_dispatch
    1 and 2. Both admit the same waves and launch the same kernels, so
    their greedy token streams must be equal, and so must their launches
    by body: the replayed engine's counts are its captures' deltas added
    once a replay. A third pair samples (temperature 0.8, top-k 50, top-p
    0.9, both engines from seed 0) at one window a dispatch: the replayed
    engine's graphs are registered with its generator, so each replay
    advances the generator's offset as the eager body's draws do, and the
    sampled streams must be equal too. Each row gives the graphs captured,
    the seconds spent capturing, the replays and the decode seconds of
    both engines. ``paged``: the paged engine (8 slots, 1024 blocks of 64,
    prefix cache on), else the contiguous one (4 slots)."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.sampling import (
        SamplingConfig,
    )
    from copilot_for_consensus_tpu_torch.engine.tokenizer import (
        ByteTokenizer,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        build_prompt,
    )

    tok = ByteTokenizer(max(259, cfg.vocab_size))
    prompts = [tok.encode(build_prompt(t), add_bos=True)
               for t in synthetic_threads(8)]
    kw = dict(num_slots=8, prefill_chunk=64, kv_pool_blocks=1024,
              prefix_cache_blocks=1) if paged else dict(num_slots=4)
    label = "paged_graphs" if paged else "graphs"
    used = ("K1", "K2", "K3") if paged else ("K1", "K2")
    sampled = SamplingConfig(temperature=0.8, top_k=50, top_p=0.9)
    rows = []
    for n_windows, sampling in ((1, SamplingConfig()),
                                (2, SamplingConfig()), (1, sampled)):
        runs = {}
        for graphs in (True, False):
            eng = GenerationEngine(cfg, params, max_len=4096,
                                   quantize="int8", device=dev,
                                   windows_per_dispatch=n_windows,
                                   sampling=sampling, seed=0,
                                   cuda_graphs=graphs, **kw)
            reset_launches()
            t0 = time.monotonic()
            comps = eng.generate(prompts, max_new_tokens=64)
            torch.cuda.synchronize()
            runs[graphs] = {
                "tokens": [c.tokens for c in comps],
                "launches": read_launches(), "bodies": read_bodies(),
                "stats": eng.graph_stats(), "wall_s": time.monotonic() - t0,
                "decode_s": eng.decode_s, "decode_tokens": eng.decode_tokens}
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        g, e = runs[True], runs[False]
        equal = [a == b for a, b in zip(g["tokens"], e["tokens"])]
        row = {"phase": label, "config": cfg.name,
               "windows_per_dispatch": n_windows,
               "sampling": {"temperature": sampling.temperature,
                            "top_k": sampling.top_k,
                            "top_p": sampling.top_p},
               "threads": len(prompts),
               "streams_equal": sum(equal), "graphs": g["stats"],
               "launches": g["launches"], "launches_by_body": g["bodies"],
               "launches_equal": (g["launches"], g["bodies"])
               == (e["launches"], e["bodies"]),
               "wall_s": {"replay": g["wall_s"], "eager": e["wall_s"]},
               "decode_s": {"replay": g["decode_s"], "eager": e["decode_s"]},
               "decode_tokens": g["decode_tokens"], "device": smi}
        emit(row)
        if not all(equal):
            raise AssertionError(f"{label}: replayed decode differs from the "
                                 f"eager body: {equal}")
        if not row["launches_equal"]:
            raise AssertionError(f"{label}: launches under replay "
                                 f"{g['bodies']} != eager {e['bodies']}")
        if not g["stats"]["replays"] or not g["stats"]["captured"] \
                or e["stats"]["replays"]:
            raise AssertionError(f"{label}: graphs {g['stats']} / eager "
                                 f"{e['stats']}")
        check_path(label, g["launches"], used)
        check_bodies(label, g["bodies"])
        check_k2_passes(label, g["launches"], g["bodies"], cfg.n_layers)
        rows.append(row)
    return rows


def phase_async_serve(dev, cfg, params, smi, batch_tokens):
    """``CUDASummarizer.summarize_async`` on the serve phase's 8 threads,
    submitted from two threads (4 each), through the summarizer's
    ``AsyncEngineRunner`` and its supervisor on a contiguous int8 engine
    like the serve phase's: its dispatcher thread owns the engine, admits
    the waves, captures and replays the decode graphs. Every handle must
    complete, the launch checks of the serve phase must hold, and no
    failure may have been contained; the row counts how many of the 8
    summaries (token count and text) agree with ``summarize_batch``'s
    (``batch_tokens``: the serve phase's summaries) — the runner may admit
    them in other waves, so bf16 equality is not required."""
    import threading

    import torch

    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    summ = CUDASummarizer(cfg.name, params=params, num_slots=4,
                          max_len=4096, max_new_tokens=64, supervisor=True,
                          device=dev)
    threads = synthetic_threads(8)
    waits: list = [None] * len(threads)
    errors: list = []

    def submit(idx):
        try:
            for i in idx:
                waits[i] = summ.summarize_async(threads[i],
                                                correlation_id=f"event-{i}")
        except Exception as exc:    # noqa: BLE001 — reported below
            errors.append(exc)

    reset_launches()
    t0 = time.monotonic()
    subs = [threading.Thread(target=submit, args=(range(k, 8, 2),))
            for k in (0, 1)]
    for t in subs:
        t.start()
    for t in subs:
        t.join(60)
    if errors or any(w is None for w in waits):
        raise AssertionError(f"async_serve: submits failed: {errors}")
    summaries = [w(600) for w in waits]
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, bodies = read_launches(), read_bodies()
    runner = summ._runner
    recovery = runner.recovery_stats()
    completed = runner.completed
    stats = summ.engine.graph_stats()
    drained = summ.drain(60)
    agree = sum(1 for s, b in zip(summaries, batch_tokens)
                if (s.completion_tokens, s.summary_text)
                == (b.completion_tokens, b.summary_text))
    row = {"phase": "async_serve", "config": cfg.name,
           "threads": len(threads), "submitters": len(subs),
           "completed": completed, "drained": drained,
           "agree_with_batch": agree, "wall_s": wall,
           "completion_tokens": [s.completion_tokens for s in summaries],
           "prefill_s": summ.engine.admitted_s,
           "decode_s": summ.engine.decode_s,
           "decode_tokens": summ.engine.decode_tokens,
           "graphs": stats, "recovery": recovery, "launches": launches,
           "launches_by_body": bodies, "device": smi}
    emit(row)
    if completed != len(threads) or not drained or \
            [s.thread_id for s in summaries] != [t.thread_id
                                                 for t in threads]:
        raise AssertionError(f"async_serve: {completed} of {len(threads)} "
                             f"handles completed")
    if recovery["containments"] or recovery["replayed"]:
        raise AssertionError(f"async_serve: failures contained: {recovery}")
    if not stats["replays"]:
        raise AssertionError(f"async_serve: no graph replayed: {stats}")
    check_path("async_serve", launches, ("K1", "K2"))
    check_bodies("async_serve", bodies)
    check_k2_passes("async_serve", launches, bodies, cfg.n_layers)
    return row


def phase_deadlines(dev, cfg, params, smi):
    """Per-request deadlines on a contiguous int8 engine like the serve
    phase's (4 slots, max_len 4096), its graphs warm: a request submitted
    with ``deadline_s=0`` is dropped at the next step uncomputed (no K1 or
    K2 launch); then 4 of the synthetic prompts, the shortest last, with
    48 new tokens, the shortest one's deadline moved to the present after
    the second dispatch, as a deadline that expires there would be: its
    slot retires with partial tokens and ``finish_reason="deadline"``, and
    the other three greedy streams must equal those of a run of the three
    alone on the same engine (the same waves, rows and kv buckets)."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.tokenizer import (
        ByteTokenizer,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        build_prompt,
    )

    new_tokens = 48
    eng = GenerationEngine(cfg, params, num_slots=4, max_len=4096,
                           quantize="int8", device=dev)
    tok = ByteTokenizer(max(259, cfg.vocab_size))
    prompts = sorted((tok.encode(build_prompt(t), add_bos=True)
                      for t in synthetic_threads(4)), key=len, reverse=True)
    eng.generate(prompts, 16)                  # warm: the graphs captured

    def run(reqs, expire=None):
        rids = [eng.submit(p, new_tokens, **kw) for p, kw in reqs]
        done, steps = {}, 0
        while eng._queue or eng._active or eng._done:
            steps += 1
            for c in eng.step():
                done[c.request_id] = c
            if steps == 2 and expire is not None:
                req = next(r for r in eng._active.values()
                           if r.request_id == rids[expire])
                req.deadline_at = time.monotonic()
        torch.cuda.synchronize()
        return [done[r] for r in rids]

    reset_launches()
    dropped = run([(prompts[0], {"deadline_s": 0.0})])[0]
    drop_launches = read_launches()
    reset_launches()
    with_victim = run([(p, {}) for p in prompts[:3]]
                      + [(prompts[3], {"deadline_s": 3600.0})], expire=3)
    victim_launches, victim_bodies = read_launches(), read_bodies()
    alone = run([(p, {}) for p in prompts[:3]])
    victim = with_victim[3]
    equal = [a.tokens == b.tokens for a, b in zip(with_victim[:3], alone)]
    row = {"phase": "deadlines", "config": cfg.name,
           "dropped": {"finish": dropped.finish_reason,
                       "tokens": len(dropped.tokens),
                       "launches": drop_launches},
           "victim": {"finish": victim.finish_reason,
                      "tokens": len(victim.tokens),
                      "prompt_tokens": victim.prompt_len},
           "others_equal_alone": equal,
           "other_tokens": [len(c.tokens) for c in with_victim[:3]],
           "deadline_expired": eng.deadline_expired,
           "launches": victim_launches, "launches_by_body": victim_bodies,
           "graphs": eng.graph_stats(), "device": smi}
    emit(row)
    if (dropped.finish_reason, dropped.tokens) != ("deadline", []) or \
            any(drop_launches.values()):
        raise AssertionError(f"deadlines: the expired request was not "
                             f"dropped uncomputed: {row['dropped']}")
    if victim.finish_reason != "deadline" or not \
            0 < len(victim.tokens) < new_tokens:
        raise AssertionError(f"deadlines: the victim {row['victim']}")
    if not all(equal) or eng.deadline_expired != 2:
        raise AssertionError(f"deadlines: the other slots' streams moved: "
                             f"{equal}")
    check_path("deadlines", victim_launches, ("K1", "K2"))
    check_bodies("deadlines", victim_bodies)
    check_k2_passes("deadlines", victim_launches, victim_bodies,
                    cfg.n_layers)
    return victim_launches, victim_bodies


@contextlib.contextmanager
def patched(module, name: str, fn):
    """``module.name`` replaced by ``fn`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield fn
    finally:
        setattr(module, name, saved)


@contextlib.contextmanager
def plain_calls():
    """Count the calls of every kernel's plain version inside the block
    (yielded: name → calls). A wrapper runs its plain version only for CPU
    tensors, so on the card the counts must stay 0."""
    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    calls: dict = {}
    saved = []
    for mod in (fa, pa, qm):
        for name in [n for n in vars(mod) if n.endswith("_ref")]:
            fn = getattr(mod, name)
            if not callable(fn):
                continue

            def counted(*a, _fn=fn, _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _fn(*a, **kw)

            saved.append((mod, name, fn))
            setattr(mod, name, counted)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


#: the retrieval run's drivers: the port's encoder (minilm-l6 at full
#: width, seed-0 weights, bf16) and the flat store on the card
RETRIEVAL = {"embedding": {"driver": "cuda", "model": "minilm-l6"},
             "vector_store": {"driver": "cuda"}}


def _histogram(p, name: str) -> dict:
    """Sum and count of a histogram the pipeline's collector holds, over
    its label sets."""
    total = [0.0, 0]
    for e in p.metrics.snapshot()["histograms"].get(name, {}).values():
        total[0] += e[0]
        total[1] += e[1]
    return {"sum": total[0], "count": total[1]}


def _counter(p, name: str) -> float:
    """A counter the pipeline's collector holds, summed over its label
    sets."""
    return sum(p.metrics.snapshot()["counters"].get(name, {}).values())


def deployed_llm(journal: Path) -> dict:
    """``deploy/config/pipeline.json``'s llm block (read, never written):
    its resilience keys, the journal moved to ``journal``."""
    block = json.loads((Path(__file__).resolve().parent / "deploy" /
                        "config" / "pipeline.json").read_text())["llm"]
    return {"supervisor": block["supervisor"],
            "deadline_s": block["deadline_s"],
            "journal": {**block["journal"], "path": str(journal)}}


def _pipeline_run(ckpt: Path, pipelined: bool, mbox: Path,
                  retrieval: bool = False,
                  journal: Path | None = None) -> dict:
    """``build_pipeline`` with the cuda driver over ``ckpt`` on the
    fixture mbox (with the port's cuda embedding and vector-store drivers
    where ``retrieval``, else the mock embedder and the memory store; with
    the deployed llm block's supervisor, deadline and journal, at
    ``journal``, where it is given); the launches, bodies and
    plain-version calls of its run, and what it stored."""
    import torch

    from copilot_for_consensus_tpu_torch.services.runner import (
        build_pipeline,
    )

    t0 = time.monotonic()
    p = build_pipeline({"llm": {"driver": "cuda", "model": "mistral-7b",
                                "checkpoint": str(ckpt),
                                "max_new_tokens": 64, "num_slots": 4,
                                "pipelined": pipelined,
                                **(deployed_llm(journal) if journal
                                   else {})},
                        **(RETRIEVAL if retrieval else
                           {"embedding": {"driver": "mock"}})})
    build_s = time.monotonic() - t0
    summ = p.summarization.summarizer
    p.ingestion.create_source({"source_id": "ietf", "name": "ietf",
                               "fetcher": "local", "location": str(mbox)})
    # the embedding engine's dispatches of this run are its telemetry
    # records after this step id
    embed_tel = p.embedding.provider.engine.telemetry if retrieval else None
    seq0 = max((r.seq for r in embed_tel.recorder.records()), default=0) \
        if retrieval else 0
    reset_launches()
    with plain_calls() as plain:
        t0 = time.monotonic()
        stats = p.ingest_and_run("ietf")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        # the reporting service's semantic search: an unfiltered query,
        # so the store's device route answers it (the orchestrator's
        # thread-filtered queries are few rows: the host route)
        search = p.reporting.search_reports("consensus") if retrieval \
            else None
    launches, bodies = read_launches(), read_bodies()
    reports = p.store.query_documents("reports", {})
    summaries = p.store.query_documents("summaries", {})
    run = {
        "stats": stats, "wall_s": wall, "build_s": build_s,
        "device": str(summ.engine.device), "pipelined":
        p.summarization.pipelined, "launches": launches, "bodies": bodies,
        "plain_calls": dict(plain), "graphs": summ.engine.graph_stats(),
        "in_flight": p.summarization.in_flight,
        "latency_s": _histogram(p, "summarization_latency_seconds"),
        "embed_s": _histogram(p, "embedding_batch_seconds"),
        "query_s": _histogram(p, "vectorstore_query_seconds"),
        "missing_chunks": sum(
            p.store.get_document("chunks", c["chunk_id"]) is None
            for r in reports for c in r["citations"]),
        "citations": {r["thread_id"]: sorted(c["chunk_id"]
                                             for c in r["citations"])
                      for r in reports},
        "texts": {s["thread_id"]: s["summary_text"] for s in summaries},
        "threads": sorted(t["thread_id"]
                          for t in p.store.query_documents("threads", {}))}
    if retrieval:
        store = p.vector_store
        while hasattr(store, "inner"):
            store = store.inner
        provider = p.embedding.provider
        run["retrieval"] = {
            "store": type(store).__name__, "store_device": str(store.device),
            "vectors": store.count(), "dimension": store.dimension,
            "queries_by_route": {
                "flat": p.metrics.counter_value(
                    "vectorstore_queries_total", {"route": "flat"}),
                "host": p.metrics.counter_value(
                    "vectorstore_queries_total", {"route": "host"})},
            "last_query": store.last_query_stats,
            "provider": provider.model_name,
            "embed_device": str(provider.engine.device),
            "embed_dispatches": sum(
                r.kind == "embed" and r.seq > seq0
                for r in embed_tel.recorder.records()),
            "search_threads": sorted(r["thread_id"] for r in search)}
    if journal is not None:
        # the deployed block: the engine's series on the service's
        # collector, and its journal
        eng = summ.engine
        run["deployed"] = {
            "supervisor": summ.supervisor, "deadline_s": summ.deadline_s,
            "telemetry_on_service_collector":
                eng.telemetry.metrics is p.metrics,
            "engine_series": {
                "admitted": _histogram(p, "engine_queue_wait_seconds")
                ["count"],
                "steps": _histogram(p, "engine_step_seconds")["count"],
                "retired": _counter(p, "engine_requests_total")},
            "journal": eng.journal_stats(),
            "deadline_expired": eng.deadline_expired}
    summ.close()
    return run


def _check_pipeline(label: str, run: dict, cfg,
                    k1_wgmma: int | None = None) -> None:
    """The run's reports, device, kernels and bodies; for the retrieval
    run, K1's wgmma launches must be ``k1_wgmma`` (the synchronous run's:
    the same decoder waves) and its d32 launches exactly the encoder's, 6
    a dispatch of the embedding engine."""
    stats = run["stats"]
    if stats["archives"] != 1 or not (
            stats["summaries"] == stats["reports"] == stats["threads"] >= 3):
        raise AssertionError(f"{label}: stats {stats}")
    if sorted(run["citations"]) != run["threads"] or run["missing_chunks"] \
            or not all(run["citations"].values()):
        raise AssertionError(f"{label}: reports {run['citations']} do not "
                             f"cite stored chunks of every thread "
                             f"{run['threads']}")
    if not run["device"].startswith("cuda") or run["in_flight"]:
        raise AssertionError(f"{label}: engine on {run['device']}, "
                             f"{run['in_flight']} in flight")
    dep = run.get("deployed")
    if dep is not None and not (
            dep["supervisor"] is True and dep["deadline_s"] == 300
            and dep["telemetry_on_service_collector"]
            and all(dep["engine_series"].values())
            and dep["journal"]["enabled"] and dep["journal"]["depth"] == 0
            and dep["journal"]["retired"] >= stats["summaries"]):
        raise AssertionError(f"{label}: the deployed llm block {dep}")
    if any(run["plain_calls"].values()):
        raise AssertionError(f"{label}: plain versions ran: "
                             f"{run['plain_calls']}")
    launches, bodies = run["launches"], run["bodies"]
    check_path(label, launches, ("K1", "K2"))
    retrieval = run.get("retrieval")
    if retrieval:
        # the encoder's attention: K1's d32 body, one launch a layer a
        # dispatch, and the decoder's waves on the wgmma body as in the
        # synchronous run; then the other bodies as on every path
        k1 = bodies["K1"]
        if (not retrieval["embed_dispatches"]
                or k1["d32"] != 6 * retrieval["embed_dispatches"]
                or k1["wgmma"] != k1_wgmma):
            raise AssertionError(
                f"{label}: K1 {k1} over {retrieval['embed_dispatches']} "
                f"embedding dispatches; want d32 6 a dispatch and wgmma "
                f"{k1_wgmma} (the synchronous run's)")
    elif bodies["K1"]["d32"]:
        raise AssertionError(f"{label}: K1's d32 body ran without the "
                             f"encoder: {bodies['K1']}")
    check_bodies(label, bodies)
    check_k2_passes(label, launches, bodies, cfg.n_layers)
    if not (bodies["K1"]["wgmma"] and bodies["K2"]["stream"]
            and bodies["K2"]["wgmma"]):
        raise AssertionError(f"{label}: K1 wgmma, K2 stream and K2 wgmma "
                             f"must all launch: {bodies}")
    if retrieval:
        # every chunk embedded and stored on the card
        if (retrieval["store"] != "CUDAVectorStore"
                or not retrieval["store_device"].startswith("cuda")
                or not retrieval["embed_device"].startswith("cuda")
                or retrieval["vectors"] != run["stats"]["chunks"]
                or retrieval["dimension"] != 384
                or not retrieval["queries_by_route"]["flat"]
                or not retrieval["search_threads"]):
            raise AssertionError(f"{label}: retrieval {retrieval}, "
                                 f"queries {run['query_s']}")


def phase_pipeline(dev, cfg, params, smi):
    """The pipeline entry on the card: the seed-0 int8 weights written as a
    native checkpoint with ``save_native`` (and a byte-level
    ``tokenizer.json``) into ``build/``, read back with
    ``load_checkpoint`` (every leaf equal, ``q`` int8), then a
    ``CUDASummarizer(checkpoint=)`` and one over the in-memory weights on
    one synthetic thread (equal greedy token streams), then
    ``build_pipeline`` with the cuda driver over the checkpoint on the
    fixture mbox, synchronous and pipelined (``summarize_async`` and the
    runner; the pipelined run with ``deploy/config/pipeline.json``'s llm
    block under the cuda driver — supervisor, ``deadline_s`` 300 and the
    journal, under a temporary directory, checkpointing every 8 steps —
    whose ``copilot_engine_*`` series must reach the service's collector
    with admissions, steps and retirements counted, and whose journal must
    end empty): one archive, a cited report a thread (≥ 3), every citation a
    stored chunk, the engine on the card, K1 and K2 the only kernels
    launched (K1's wgmma body, K2's stream and wgmma bodies) and no plain
    version called. The two modes must report the same threads with the
    same citations; how many summary texts agree is printed, not gated
    (the waves differ, and bf16 decoding is not bit-stable across waves).
    Then ``retrieval``: the synchronous run with the port's ``cuda``
    embedding (``minilm-l6``) and vector-store drivers, and one semantic
    search of the reports after it: the same threads, K1 on two bodies
    (the encoder's 6 d32 launches a dispatch), the chunks stored on
    the card, and the search answered by the store's device route.
    The checkpoint is deleted when the phase ends, passed or failed."""
    import torch

    from copilot_for_consensus_tpu_torch.checkpoint import (
        load_checkpoint,
        save_native,
    )
    from copilot_for_consensus_tpu_torch.checkpoint.bridge import (
        params_from_numpy,
    )
    from copilot_for_consensus_tpu_torch.checkpoint.native import (
        _flatten,
        save_byte_tokenizer,
    )
    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    here = Path(__file__).resolve().parent
    mbox = here / "tests" / "fixtures" / "ietf-sample.mbox"
    ckpt = here / "build" / "pipeline_checkpoint"
    nbytes = quant.param_bytes(params)
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(ckpt.parent).free
    if free < 1.2 * nbytes:
        raise RuntimeError(f"pipeline: {free} bytes free under "
                           f"{ckpt.parent}, the checkpoint needs {nbytes}")
    shutil.rmtree(ckpt, ignore_errors=True)
    # the deployed block's journal, under a temporary directory
    jdir = tempfile.mkdtemp(prefix="pipeline-journal-")
    try:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        written = save_native(ckpt, cfg, params)
        write_s = time.monotonic() - t0
        save_byte_tokenizer(ckpt)

        t0 = time.monotonic()
        rcfg, host, meta = load_checkpoint(ckpt)
        read = params_from_numpy(host, dev, torch.bfloat16)
        torch.cuda.synchronize()
        read_s = time.monotonic() - t0
        got, want = _flatten(read), _flatten(params)
        unequal = sorted(k for k in want if k not in got
                         or got[k].dtype != want[k].dtype
                         or not torch.equal(got[k], want[k]))
        if rcfg != cfg or meta["quantized"] != "int8" or unequal \
                or set(got) != set(want) or any(
                    got[k].dtype != torch.int8 for k in got
                    if k.endswith("/q")):
            raise AssertionError(f"pipeline: checkpoint read back unequal: "
                                 f"{unequal[:8]}, meta {meta['quantized']}")
        del read, host, got
        gc.collect()
        torch.cuda.empty_cache()

        # one thread through a summarizer over the checkpoint and one over
        # the weights in memory: equal greedy streams
        thread = synthetic_threads(1)[0]
        streams = []
        from_ckpt = CUDASummarizer(checkpoint=str(ckpt), num_slots=4,
                                   max_len=4096, max_new_tokens=64,
                                   device=dev)
        for summ in (from_ckpt, CUDASummarizer(
                cfg.name, params=params, tokenizer=from_ckpt.tokenizer,
                num_slots=4, max_len=4096, max_new_tokens=64, device=dev)):
            comps = _recorded(summ)
            summ.summarize(thread)
            streams.append(comps[0].tokens)
            del summ, comps
        del from_ckpt
        gc.collect()
        torch.cuda.empty_cache()
        if streams[0] != streams[1] or not streams[0]:
            raise AssertionError(f"pipeline: checkpoint stream "
                                 f"{streams[0][:16]} != in-memory "
                                 f"{streams[1][:16]}")

        runs = {}
        for mode in ("sync", "pipelined", "retrieval"):
            runs[mode] = _pipeline_run(
                ckpt, mode == "pipelined", mbox,
                retrieval=mode == "retrieval",
                journal=Path(jdir) / "engine-journal.sqlite3"
                if mode == "pipelined" else None)
            gc.collect()
            torch.cuda.empty_cache()
        sync, piped = runs["sync"], runs["pipelined"]
        same_texts = sum(sync["texts"].get(t) == x
                         for t, x in piped["texts"].items())
        emit({"phase": "pipeline", "config": cfg.name,
              "checkpoint": {"bytes": written, "write_s": write_s,
                             "write_gb_per_s": written / write_s / 1e9,
                             "read_s": read_s,
                             "read_gb_per_s": written / read_s / 1e9},
              "stream_tokens": len(streams[0]), "streams_equal": True,
              **{mode: {"stats": r["stats"], "wall_s": r["wall_s"],
                        "build_s": r["build_s"],
                        "summaries_per_s": r["stats"]["summaries"]
                        / r["wall_s"],
                        "summarization_latency_s": r["latency_s"],
                        "embed_s": r["embed_s"], "query_s": r["query_s"],
                        **({"retrieval": r["retrieval"]}
                           if "retrieval" in r else {}),
                        **({"deployed": r["deployed"]}
                           if "deployed" in r else {}),
                        "pipelined": r["pipelined"],
                        "launches": r["launches"],
                        "launches_by_body": r["bodies"],
                        "plain_calls": r["plain_calls"],
                        "graphs": r["graphs"]}
                 for mode, r in runs.items()},
              "texts_equal": same_texts, "device": smi})
        for mode, r in runs.items():
            _check_pipeline(f"pipeline_{mode}", r, cfg,
                            k1_wgmma=sync["bodies"]["K1"]["wgmma"])
        if not piped["pipelined"] or sync["pipelined"]:
            raise AssertionError("pipeline: the modes were not what was "
                                 "asked for")
        if sync["citations"] != piped["citations"]:
            raise AssertionError(f"pipeline: sync reports "
                                 f"{sync['citations']} != pipelined "
                                 f"{piped['citations']}")
        if runs["retrieval"]["threads"] != sync["threads"]:
            raise AssertionError(f"pipeline: the retrieval run's threads "
                                 f"{runs['retrieval']['threads']} != "
                                 f"{sync['threads']}")
        return runs
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
        shutil.rmtree(jdir, ignore_errors=True)


#: the journal phase's storm: the port's storm driver at mistral-7b's full
#: width (int8, bf16, contiguous), the deployed journal's checkpoint
#: cadence, killed after this many steps (the second wave's slots
#: checkpointed, the third queued)
STORM = dict(requests=12, new_tokens=24, seed=7, checkpoint_every=8,
             kill_after=9)
#: the in-process repeat at f32: mistral-7b's widths, this many layers
STORM_F32_LAYERS = 2
#: a stream of the f32 repeat may leave the uninterrupted run's only where
#: the top-2 logits at its first divergent token are this close (relative)
STORM_F32_GAP = 1e-5


def _storm_lines(path: Path) -> tuple[dict, int]:
    out, dup = {}, 0
    if path.exists():
        for line in path.read_text().splitlines():
            d = json.loads(line)
            dup += d["cid"] in out
            out[d["cid"]] = d["tokens"]
    return out, dup


def _storm_child(tmp: Path, name: str, journal: Path,
                 kill_after: int = 0) -> tuple[int, dict | None, float]:
    """One storm process on the card (the driver of
    ``copilot_for_consensus_tpu_torch/tools/journal_storm.py``): its exit
    code, its result (None when it was killed) and its wall seconds."""
    import os

    here = Path(__file__).resolve().parent
    cmd = [sys.executable, "-m",
           "copilot_for_consensus_tpu_torch.tools.journal_storm",
           "--journal", str(journal), "--out", str(tmp / f"{journal.stem}"
                                                   ".jsonl"),
           "--result", str(tmp / f"{name}.json"),
           "--requests", str(STORM["requests"]),
           "--new-tokens", str(STORM["new_tokens"]),
           "--seed", str(STORM["seed"]),
           "--checkpoint-every", str(STORM["checkpoint_every"]),
           "--model", "mistral-7b", "--quantize", "int8",
           "--dtype", "bfloat16", "--device", "cuda"]
    if kill_after:
        cmd += ["--kill-after-step", str(kill_after)]
    env = {**os.environ, "PYTHONPATH": str(here) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    t0 = time.monotonic()
    r = subprocess.run(cmd, cwd=here, env=env, capture_output=True,
                       text=True, timeout=300)
    wall = time.monotonic() - t0
    res = tmp / f"{name}.json"
    if r.returncode not in (0, -9) or (r.returncode == 0) != res.exists():
        raise AssertionError(f"journal: storm {name} exited {r.returncode}: "
                             f"{r.stderr[-2000:]}")
    return r.returncode, (json.loads(res.read_text()) if res.exists()
                          else None), wall


def _top2_gap(params, cfg, prompt: list[int], tokens: list[int]) -> float:
    """(top-1 - top-2) / |top-1| of the logits that chose ``tokens``'
    next token after ``prompt + tokens``."""
    import torch

    from copilot_for_consensus_tpu_torch.models import decoder

    seq = torch.tensor([prompt + tokens], device=params["tok_emb"].device)
    with torch.inference_mode():
        lg = decoder.forward(params, seq, cfg)[0, -1].double()
    top = torch.topk(lg, 2).values
    return float((top[0] - top[1]) / top[0].abs())


def phase_journal(dev, smi):
    """The request journal's warm restart on the card, through the port's
    storm driver: at mistral-7b's full width (int8 weights from seed 0,
    bf16, 4 contiguous slots, checkpoints every 8 steps, as the deployed
    journal), an uninterrupted child, a child SIGKILLed after
    ``STORM["kill_after"]`` steps, and a child that resumes on its journal
    file: lost 0, duplicated 0, replayed > 0, final depth 0, and each
    resumed stream starts with exactly the tokens its row had
    checkpointed; how many streams equal the uninterrupted run's is
    printed, not gated (bf16 prefill and decode round differently). Then
    the kill in process at f32 on ``STORM_F32_LAYERS`` layers of
    mistral-7b's widths (the engine dropped mid-storm, rebuilt on the same
    file): every stream must equal the uninterrupted run's, unless the
    top-2 logits at its first divergent token are closer than
    ``STORM_F32_GAP`` relative (printed)."""
    import tempfile

    import torch

    from copilot_for_consensus_tpu_torch.engine.journal import (
        EngineJournal,
    )
    from copilot_for_consensus_tpu_torch.tools import journal_storm

    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        rc_ref, ref_res, ref_s = _storm_child(tmp, "ref", tmp / "ref.sqlite3")
        rc_kill, _, kill_s = _storm_child(tmp, "kill", tmp / "kill.sqlite3",
                                          kill_after=STORM["kill_after"])
        before, _ = _storm_lines(tmp / "kill.jsonl")
        rc_res, res, res_s = _storm_child(tmp, "resume", tmp / "kill.sqlite3")
        ref, _ = _storm_lines(tmp / "ref.jsonl")
        got, dup = _storm_lines(tmp / "kill.jsonl")
    lost = sorted(set(ref) - set(got))
    resumed = res["resumed"]
    starts = {c: got.get(c, [])[:len(t)] == t for c, t in resumed.items()}
    row = {"phase": "journal", "config": "mistral-7b", "quantize": "int8",
           "dtype": "bfloat16", "storm": STORM,
           "exit": {"ref": rc_ref, "kill": rc_kill, "resume": rc_res},
           "wall_s": {"ref": ref_s, "kill": kill_s, "resume": res_s},
           "build_s": {"ref": ref_res["build_s"], "resume": res["build_s"]},
           "completed_before_kill": len(before),
           "replayed": res["journal_replayed"],
           "abandoned": res["journal_abandoned"],
           "final_depth": res["journal_depth"], "lost": len(lost),
           "duplicated": dup,
           "checkpointed_tokens": {c: len(t) for c, t in resumed.items()},
           "resumed_start_with_checkpoint": all(starts.values()),
           "equal_to_uninterrupted_bf16": sum(got.get(c) == t
                                              for c, t in ref.items()),
           "streams": len(ref), "device": res["device"],
           "graphs": {"ref": ref_res["graphs"], "resume": res["graphs"]},
           "launches_by_body": {"ref": ref_res["launches_by_body"],
                                "resume": res["launches_by_body"]}}
    if rc_kill != -9 or rc_ref or rc_res or lost or dup \
            or not res["journal_replayed"] or res["journal_depth"] \
            or not all(starts.values()) or not res["device"].startswith(
                "cuda") or not any(resumed.values()):
        emit(row)
        raise AssertionError(f"journal: the SIGKILL storm lost {lost}, "
                             f"duplicated {dup}, or resumed wrongly")

    # the kill in process, at f32 on a few layers of mistral-7b's widths
    kw = dict(model="mistral-7b", layers=STORM_F32_LAYERS, dtype="float32",
              device=dev)
    prompts = journal_storm.storm_prompts(STORM["requests"], STORM["seed"])
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "f32.sqlite3")
        eng = journal_storm.build_engine(None, **kw)
        want = {f"f-{i}": c.tokens for i, c in enumerate(
            eng.generate(prompts, STORM["new_tokens"]))}
        del eng
        eng = journal_storm.build_engine(
            EngineJournal(path, checkpoint_every=STORM["checkpoint_every"]),
            **kw)
        names = {eng.submit(p, STORM["new_tokens"], correlation_id=f"f-{i}"):
                 f"f-{i}" for i, p in enumerate(prompts)}
        f32_got: dict = {}
        for _ in range(STORM["kill_after"]):
            for c in eng.step():
                f32_got[names[c.request_id]] = c.tokens
        depth = eng.journal.depth()
        del eng
        torch.cuda.synchronize()
        eng = journal_storm.build_engine(
            EngineJournal(path, checkpoint_every=STORM["checkpoint_every"]),
            **kw)
        replayed = eng.journal_replayed
        names = dict(eng.journal_recovered)
        while eng._queue or eng._active or eng._done:
            for c in eng.step():
                f32_got[names[c.request_id]] = c.tokens
        f32_depth = eng.journal.depth()
        gaps = {}
        for i, p in enumerate(prompts):
            cid = f"f-{i}"
            a, b = want[cid], f32_got.get(cid)
            if a != b and b is not None:
                j = next(k for k in range(min(len(a), len(b)) + 1)
                         if k == min(len(a), len(b)) or a[k] != b[k])
                gaps[cid] = _top2_gap(eng.params, eng.cfg, p, a[:j])
        del eng
    row["f32"] = {"layers": STORM_F32_LAYERS, "depth_at_kill": depth,
                  "replayed": replayed, "final_depth": f32_depth,
                  "streams": len(want),
                  "equal": sum(f32_got.get(c) == t for c, t in want.items()),
                  "divergent_top2_gap": gaps, "gap_limit": STORM_F32_GAP}
    emit(row)
    if set(f32_got) != set(want) or not replayed or f32_depth or \
            any(g >= STORM_F32_GAP for g in gaps.values()):
        raise AssertionError(f"journal: the f32 restart diverged: "
                             f"{row['f32']}")
    gc.collect()
    torch.cuda.empty_cache()
    return row


#: the encoder phase: cosine of each vector against the same encoder with
#: K1's plain version (bf16 activations through six layers: the kernel and
#: the plain version differ by f32 sums in another order, then one bf16
#: rounding of each attention output), and the norm of each vector
ENC_MIN_COS = 0.999
ENC_NORM_TOL = 1e-3
#: texts, and their token lengths' range, in the encoder phase
ENC_TEXTS, ENC_MIN_LEN = 512, 8


def phase_encoder(dev, smi):
    """``minilm-l6`` at full size (6 layers, d 384, 12 heads of 32, d_ff
    1536, vocab 30,522, 512 positions), seed-0 weights, bf16, behind
    ``EmbeddingEngine.embed_batch``: 512 texts whose lengths the seed draws
    over 8-512 tokens, one warm call first, then the counts reset and the
    timed call. Every K1 launch must be the d32 body's (head dim 32), 6
    a dispatch, with no plain version called; the vectors are held
    against the same engine with K1's plain version (``attn_impl=
    "plain"``, same weights): cosine >= 0.999 a row, norms 1 ± 1e-3, no
    NaN."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine.embedding import (
        EmbeddingEngine,
    )
    from copilot_for_consensus_tpu_torch.models.configs import (
        encoder_config,
    )

    cfg = encoder_config("minilm-l6")
    rng = np.random.default_rng(0)
    lengths = rng.integers(ENC_MIN_LEN, cfg.max_positions + 1,
                           size=ENC_TEXTS)
    texts = [" ".join(f"w{rng.integers(0, 1 << 30)}" for _ in range(n))
             for n in lengths]
    t0 = time.monotonic()
    eng = EmbeddingEngine(cfg, seed=0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    build_s = time.monotonic() - t0
    eng.embed_batch(texts[:64])                       # warm-up
    n_warm = len(eng.telemetry.recorder.records())
    reset_launches()
    with plain_calls() as plain:
        t0 = time.monotonic()
        vecs = eng.embed_batch(texts)
        wall = time.monotonic() - t0
    launches, bodies = read_launches(), read_bodies()
    recs = eng.telemetry.recorder.records()[n_warm:]
    tiles: dict = {}
    for r in recs:
        bucket = r.padded_tokens // r.batch
        tiles.setdefault(str(bucket), []).append(r.batch)
    t0 = time.monotonic()
    for t in texts:
        eng.tokenizer.encode(t)
    tokenize_s = time.monotonic() - t0
    plain_eng = EmbeddingEngine(cfg, eng.params, dtype=torch.bfloat16,
                                attn_impl="plain", device=dev)
    want = plain_eng.embed_batch(texts)
    cos = (vecs * want).sum(1) / (np.linalg.norm(vecs, axis=1)
                                  * np.linalg.norm(want, axis=1))
    norms = np.linalg.norm(vecs, axis=1)
    tokens = int(sum(min(n, cfg.max_positions) for n in lengths))
    row = {"phase": "encoder", "config": cfg.name, "texts": ENC_TEXTS,
           "tokens": tokens, "build_s": build_s, "wall_s": wall,
           "texts_per_s": ENC_TEXTS / wall, "tokens_per_s": tokens / wall,
           # the host's hashing of the words, timed again alone, and the
           # dispatches' walls (the encode and its copy to the host)
           "tokenize_s": tokenize_s,
           "dispatch_s": sum(r.duration_s for r in recs),
           "dispatches": len(recs),
           "padded_tokens": sum(r.padded_tokens for r in recs),
           "tiles_by_bucket": tiles, "launches": launches,
           "launches_by_body": bodies, "plain_calls": dict(plain),
           "min_cos": float(cos.min()),
           "max_norm_err": float(np.abs(norms - 1).max()),
           "finite": bool(np.isfinite(vecs).all()), "device": smi}
    emit(row)
    check_path("encoder", launches, ("K1",))
    check_bodies("encoder", bodies)
    if (bodies["K1"]["wgmma"] or bodies["K1"]["d32"] != 6 * len(recs)
            or any(plain.values())):
        raise AssertionError(f"encoder: K1 {bodies['K1']} over "
                             f"{len(recs)} dispatches, plain {plain}")
    if not (row["finite"] and row["min_cos"] >= ENC_MIN_COS
            and row["max_norm_err"] <= ENC_NORM_TOL):
        raise AssertionError(f"encoder: vectors off the plain version's: "
                             f"{row}")
    del eng, plain_eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, bodies


#: the repo's ANN preset (bench.py ``PRESETS["ann_retrieval"]``), uncut
ANN = {"n": 1_000_000, "dim": 64, "clusters": 1024, "noise": 0.15,
       "queries": 256, "batch": 64, "top_k": 10, "nprobe": 16, "seed": 0}
#: IVF's gate against the flat route (bench.py ``ann_columns``)
ANN_MIN_RECALL, ANN_MAX_LISTS_FRAC = 0.95, 0.15
#: queries the flat route is held against an exact f32 scan for
ANN_EXACT_QUERIES = 16
#: "ties aside" for that check: the flat route scores a bf16 product
#: rounded to bf16 (bf16 query and matrix, each element within 2**-9, and
#: the score rounded within 2**-9 of a value <= 1), so an id may trade
#: places with one whose exact f32 score lies within 2**-7 of the exact
#: k-th score, and no other
ANN_TIE = 2.0 ** -7


def _route_run(store, queries, batch: int, top_k: int) -> dict:
    """The bench preset's measurement of one route: a warm batch outside
    the timed window (on the IVF route it trains the quantizer), the
    queries in batches, then 64 single queries for latency."""
    t0 = time.perf_counter()
    store.query_batch(list(queries[:batch]), top_k=top_k)
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    results = []
    for s in range(0, len(queries), batch):
        results.extend(store.query_batch(list(queries[s:s + batch]),
                                         top_k=top_k))
    qps = len(queries) / (time.perf_counter() - t0)
    lat = []
    for q in queries[:64]:
        t1 = time.perf_counter()
        store.query(q, top_k=top_k)
        lat.append((time.perf_counter() - t1) * 1e3)
    lat.sort()
    return {"ids": [[h.id for h in hits] for hits in results],
            "qps": qps, "warm_s": warm_s, "p50_ms": lat[len(lat) // 2],
            "p95_ms": lat[min(len(lat) - 1, int(0.95 * len(lat)))],
            "stats": dict(store.last_query_stats or {})}


def phase_vectorstore(dev, smi):
    """The repo's ANN preset uncut on the card: 1,000,000 vectors of dim 64
    in 1,024 clusters (noise 0.15), 256 queries in batches of 64, top 10,
    nprobe 16, seed 0, ingested into a flat and an IVF ``CUDAVectorStore``
    (bf16 matrices on the card). The flat route's ids must equal an exact
    f32 scan's for 16 queries, ties aside (``ANN_TIE``); IVF recall@10
    against the flat route must be >= 0.95 while scanning <= 15% of the
    lists. Ingest s, index build s (the first IVF query), QPS and p50/p95
    ms a route."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.vectorstore.cuda import (
        CUDAVectorStore,
    )

    a = ANN
    rng = np.random.default_rng(a["seed"])
    centers = rng.standard_normal((a["clusters"], a["dim"])).astype(
        np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)

    def draw(count: int) -> np.ndarray:
        which = rng.integers(0, a["clusters"], size=count)
        return centers[which] + a["noise"] * rng.standard_normal(
            (count, a["dim"]), dtype=np.float32)

    corpus = draw(a["n"])
    queries = draw(a["queries"])
    routes, stores = {}, {}
    for kind in ("flat", "ivf"):
        cfg = {"dimension": a["dim"], "index": kind, "device": str(dev)}
        if kind == "ivf":
            cfg["ivf_nprobe"] = a["nprobe"]
        store = CUDAVectorStore(cfg)
        t0 = time.perf_counter()
        store.add_embeddings((str(i), corpus[i], None)
                             for i in range(a["n"]))
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        run = _route_run(store, queries, a["batch"], a["top_k"])
        run["ingest_s"] = ingest_s
        if kind == "ivf":
            ivf = store._ivf
            run.update(nlist=ivf.nlist, pad=ivf.pad,
                       spill=ivf._spill_live, build_s=run["warm_s"])
        routes[kind], stores[kind] = run, store
    flat, ivf = routes["flat"], routes["ivf"]
    recall = float(np.mean([len(set(x) & set(y)) / len(y)
                            for x, y in zip(ivf["ids"], flat["ids"])]))
    # the flat route against an exact f32 scan of the host master
    master = torch.from_numpy(stores["flat"]._host[:a["n"]]).to(dev)
    qn = queries[:ANN_EXACT_QUERIES]
    qn = qn / np.linalg.norm(qn, axis=1, keepdims=True)
    exact = (torch.from_numpy(qn).to(dev) @ master.T)
    ex_vals, ex_idx = torch.topk(exact, a["top_k"], dim=1)
    ex_vals, ex_idx = ex_vals.cpu().numpy(), ex_idx.cpu().numpy()
    exact = exact.cpu().numpy()
    equal, off_tie = 0, []
    for qi in range(ANN_EXACT_QUERIES):
        got = [int(i) for i in flat["ids"][qi]]
        want = ex_idx[qi].tolist()
        equal += got == want
        kth = ex_vals[qi, -1]
        for i in set(got) ^ set(want):
            gap = abs(float(exact[qi, i]) - float(kth))
            if gap > ANN_TIE:
                off_tie.append((qi, i, gap))
    del master
    row = {"phase": "vectorstore", "preset": "ann_retrieval", **ANN,
           "recall_at_10": recall,
           "lists_scanned_frac": ivf["stats"].get("lists_scanned_frac"),
           "spill_fraction": ivf["stats"].get("spill_fraction"),
           "exact_queries": ANN_EXACT_QUERIES, "exact_equal": equal,
           "exact_off_tie": off_tie[:8], "tie": ANN_TIE,
           **{kind: {k: v for k, v in r.items() if k != "ids"}
              for kind, r in routes.items()},
           "device": smi}
    emit(row)
    if off_tie:
        raise AssertionError(f"vectorstore: the flat route's ids leave the "
                             f"exact scan's beyond ties: {off_tie[:8]}")
    if ivf["stats"].get("route") != "ivf" or flat["stats"].get(
            "route") != "flat":
        raise AssertionError(f"vectorstore: routes {flat['stats']}, "
                             f"{ivf['stats']}")
    if not (recall >= ANN_MIN_RECALL
            and row["lists_scanned_frac"] <= ANN_MAX_LISTS_FRAC):
        raise AssertionError(f"vectorstore: recall@10 {recall}, lists "
                             f"scanned {row['lists_scanned_frac']}")
    del stores
    gc.collect()
    torch.cuda.empty_cache()


def phase_paged_model(dev, cfg, eng):
    """The paged passes at full width, bf16, on the paged engine's pool:
    four prompts of 512-1024 tokens prefilled through a miss wave (K1)
    into pool blocks, then their last 64 tokens run again through
    ``prefill_seeded_paged`` with the prefix read from the pool by K3.
    Last-position logits against the full prefill's, by relative L2."""
    import torch

    from copilot_for_consensus_tpu_torch.models import decoder
    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa

    g = torch.Generator(device=dev).manual_seed(2)
    lens, bucket, suffix = [1024, 777, 512, 640], 1024, 64
    n = len(lens)
    tokens = torch.randint(3, 259, (n, bucket), generator=g, device=dev)
    pool = eng._pool
    tables = [pool.alloc(pool.blocks_for(ln)) for ln in lens]
    try:
        with torch.inference_mode():
            scratch = decoder.init_cache(cfg, n, bucket, dtype=eng.kv_dtype,
                                         device=dev)
            t0 = time.monotonic()
            full, scratch = decoder.prefill(
                eng.params, tokens, torch.tensor(lens, device=dev), cfg,
                scratch)
            sbids, soffs = eng._write_maps(
                [(i, tables[i], 0, ln) for i, ln in enumerate(lens)],
                bucket, n)
            pool.scatter(scratch["k"], scratch["v"], sbids, soffs)
            torch.cuda.synchronize()
            miss_s = time.monotonic() - t0
            del scratch
            pref = [ln - suffix for ln in lens]
            suf = torch.stack([tokens[i, p:p + suffix]
                               for i, p in enumerate(pref)])
            nb = max(len(t) for t in tables)
            bids = torch.tensor(
                [t + [pool.num_blocks] * (nb - len(t)) for t in tables],
                dtype=torch.int32, device=dev)

            def partial_fn(li, q_rows, lns, q_pos):
                return pa.paged_attention_partial(
                    q_rows, pool.k, pool.v, li, bids, lns, q_pos, window=0)

            k3_before = pa.paged_attention_partial.launches
            t0 = time.monotonic()
            seeded, _, _ = decoder.prefill_seeded_paged(
                eng.params, suf, torch.full((n,), suffix, device=dev),
                torch.tensor(pref, device=dev), cfg, partial_fn)
            torch.cuda.synchronize()
            seeded_s = time.monotonic() - t0
    finally:
        for t in tables:
            pool.free(t)
    rel = ((seeded - full).norm() / full.norm()).item()
    row = {"phase": "paged_model", "config": cfg.name, "rows": n,
           "prompt_lens": lens, "suffix": suffix, "prefix_lens": pref,
           "logits_shape": list(seeded.shape), "rel_l2": rel,
           "bound": LOGITS_REL_L2, "miss_wave_s": miss_s,
           "seeded_s": seeded_s,
           "k3_launches": pa.paged_attention_partial.launches - k3_before}
    emit(row)
    if not (torch.isfinite(seeded).all() and torch.isfinite(full).all()):
        raise AssertionError("non-finite paged prefill logits")
    if tuple(seeded.shape) != (n, cfg.vocab_size) or rel > LOGITS_REL_L2:
        raise AssertionError(f"seeded vs full prefill logits: {row}")
    if pool.free_blocks != pool.num_blocks:
        raise AssertionError("paged model phase leaked pool blocks")


def expected_hit(prompt: list[int], published: list[list[int]],
                 blk: int) -> int:
    """The prefix a radix trie over whole published prompts must hand
    ``prompt``, by plain list comparison: the longest run of whole blocks
    it shares from position 0 with any published prompt (which publishes
    ``len // blk`` blocks), leaving at least one prompt token to prefill."""
    cap = (len(prompt) - 1) // blk
    best = 0
    for p in published:
        n = 0
        while (n < min(cap, len(p) // blk)
               and prompt[n * blk:(n + 1) * blk] == p[n * blk:(n + 1) * blk]):
            n += 1
        best = max(best, n)
    return best * blk


def phase_paged_serve(dev, cfg, eng, smi, label: str = "paged_serve",
                      n_rounds: int = 3):
    """``CUDASummarizer`` (cache_scope "full") over the paged engine, three
    rounds of 64 new tokens with the K1/K2/K3 counts reset before the
    first: 8 threads (all misses, published on retire), the same 8 again
    (every row a pointer hit of all but its last block-aligned span), and
    8 new threads (a hit on the shared template head, 2 blocks, where the
    prompt fits ``prompt_limit``; a tail-truncated prompt has lost its
    head). Each round's admission is one wave, so a request can only hit
    prompts of earlier rounds: hits and saved tokens must equal
    ``expected_hit`` over the prompts the engine was given. Every K3 call
    asserts the body it runs (``paged_body``): on a bf16 pool the seeded
    wgmma body in admission and the split-KV body in decode; on an fp8
    pool (``kv_dtype="float8_e4m3fn"``) the CUDA-core body in both, which
    reads the fp8 bytes in place. No plain version may run. The first
    ``n_rounds`` rounds run; their completions are returned."""
    import torch

    from copilot_for_consensus_tpu_torch.engine import generation
    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
        build_prompt,
    )

    new_tokens = 64
    summ = CUDASummarizer(cfg.name, engine=eng, max_new_tokens=new_tokens)
    blk = eng._pool.block
    comps: list = []
    plain_generate = eng.generate

    def recording_generate(prompts, max_new_tokens, **kw):
        out = plain_generate(prompts, max_new_tokens, **kw)
        comps.extend(out)
        return out

    # K3 launches by where they happen, admission waves or decode, and by
    # body in each
    k3_by = {"admit": 0, "decode": 0}
    k3_bodies = {kind: dict.fromkeys(pa.K3_BODIES, 0) for kind in k3_by}

    def counted(kind, fn):
        def run(*a, **kw):
            n0 = pa.paged_attention_partial.launches
            b0 = dict(pa.paged_attention_partial.launches_by_body)
            try:
                return fn(*a, **kw)
            finally:
                k3_by[kind] += pa.paged_attention_partial.launches - n0
                for body, n in \
                        pa.paged_attention_partial.launches_by_body.items():
                    k3_bodies[kind][body] += n - b0[body]
        return run

    fp8 = eng.kv_dtype in (torch.float8_e4m3fn, torch.float8_e5m2)
    want_body = {"admit": "simt" if fp8 else "seeded",
                 "decode": "simt" if fp8 else "decode"}
    k3_call = generation.paged_attention_partial

    def asserting_k3(q_rows, pool_k, *a, **kw):
        """K3 as the engine calls it, asserting the body each launch ran
        (a graph capture's launch included; its replays replay it)."""
        body = pa.paged_body(q_rows.shape[2], q_rows.dtype, pool_k.dtype,
                             q_rows.shape[3], pool_k.shape[3])
        before = pa.paged_attention_partial.launches_by_body[body]
        out = k3_call(q_rows, pool_k, *a, **kw)
        if body not in want_body.values() or \
                pa.paged_attention_partial.launches_by_body[body] != \
                before + 1:
            raise AssertionError(f"{label}: K3 ran {body} on a "
                                 f"{pool_k.dtype} pool")
        return out

    eng._admit = counted("admit", eng._admit)
    eng._decode_once = counted("decode", eng._decode_once)
    eng.generate = recording_generate
    rounds = [("round1", synthetic_threads(8)),
              ("round2", synthetic_threads(8)),
              ("round3", synthetic_threads(16)[8:])][:n_rounds]
    reset_launches()
    published: list[list[int]] = []
    expect_saved = expect_hits = 0
    rows = []
    with patched(generation, "paged_attention_partial", asserting_k3), \
            finite_logits(eng) as finite, plain_calls() as plain:
        for rname, threads in rounds:
            prompts = [summ.tokenizer.encode(build_prompt(t), add_bos=True)
                       [-eng.prompt_limit:] for t in threads]
            hits = [expected_hit(p, published, blk) for p in prompts]
            expect_saved += sum(hits)
            expect_hits += sum(1 for h in hits if h)
            before = dict(prefill_s=eng.admitted_s, decode_s=eng.decode_s,
                          decode_tokens=eng.decode_tokens,
                          prefill_tokens=eng.prefill_tokens,
                          saved=eng.prefill_tokens_saved,
                          hits=eng.zero_copy_admits, k3=dict(k3_by))
            n0 = len(comps)
            t0 = time.monotonic()
            summaries = summ.summarize_batch(threads)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            rc = comps[n0:]
            if [s.thread_id for s in summaries] != \
                    [t.thread_id for t in threads] or \
                    any(s.completion_tokens != len(c.tokens)
                        for s, c in zip(summaries, rc)):
                raise AssertionError(f"{rname}: summaries out of order")
            if [c.prompt_len for c in rc] != [len(p) for p in prompts]:
                raise AssertionError(f"{rname}: prompt lengths differ")
            published += prompts
            dec_s = eng.decode_s - before["decode_s"]
            dec_t = eng.decode_tokens - before["decode_tokens"]
            row = {"phase": label, "round": rname,
                   "kv_dtype": str(eng.kv_dtype).removeprefix("torch."),
                   "threads": len(threads),
                   "prompt_tokens": sum(c.prompt_len for c in rc),
                   "prefill_tokens": eng.prefill_tokens
                   - before["prefill_tokens"],
                   "prefill_tokens_saved": eng.prefill_tokens_saved
                   - before["saved"],
                   "zero_copy_admits": eng.zero_copy_admits
                   - before["hits"],
                   "expected_hit_tokens": hits,
                   "truncated": sum(1 for t in threads if len(
                       summ.tokenizer.encode(build_prompt(t), add_bos=True))
                       > eng.prompt_limit),
                   "prefill_s": eng.admitted_s - before["prefill_s"],
                   "ttft_s": [c.ttft_s for c in rc],
                   "decode_s": dec_s, "decode_tokens": dec_t,
                   "decode_tok_per_s": dec_t / dec_s if dec_s else None,
                   "wall_s": wall,
                   "k3_admit": k3_by["admit"] - before["k3"]["admit"],
                   "k3_decode": k3_by["decode"] - before["k3"]["decode"],
                   "finish": [c.finish_reason for c in rc]}
            emit(row)
            rows.append(row)
    launches = read_launches()
    bodies = read_bodies()
    st, ps = eng.kv_pool_stats(), eng.prefix_stats()
    node_count = eng._prefix.node_count
    summary = {"phase": label, "config": cfg.name,
               "kv_dtype": str(eng.kv_dtype).removeprefix("torch."),
               "launches": launches, "launches_by_body": bodies,
               "plain_calls": dict(plain),
               "k3_by": k3_by, "k3_bodies": k3_bodies,
               "zero_copy_admits": st["zero_copy_admits"],
               "prefill_tokens_saved": ps["prefill_tokens_saved"],
               "expected_zero_copy_admits": expect_hits,
               "expected_saved": expect_saved,
               "free_blocks": st["free_blocks"],
               "pinned_blocks": st["pinned_blocks"],
               "num_blocks": st["num_blocks"], "trie_nodes": node_count,
               "fragmentation_ratio": st["fragmentation_ratio"],
               "device": smi}
    emit(summary)
    if not bool(finite):
        raise AssertionError("non-finite logits while serving (paged)")
    if k3_by["admit"] <= 0 or k3_by["decode"] <= 0:
        raise AssertionError(f"K3 not launched in admission and decode: "
                             f"{k3_by}")
    if any(plain.values()):
        raise AssertionError(f"{label}: plain versions ran: {plain}")
    # admission's seeded passes (R = 4 x a bucket of 64 or more) all on the
    # wgmma body, decode's 4 rows all on the split-KV body (an fp8 pool:
    # both on the CUDA-core body)
    if (k3_bodies["admit"][want_body["admit"]] != k3_by["admit"]
            or k3_bodies["decode"][want_body["decode"]] != k3_by["decode"]):
        raise AssertionError(f"K3's bodies in admission and decode: "
                             f"{k3_bodies}")
    check_path(label, launches, ("K1", "K2", "K3"))
    # the CUDA-core body is the fp8 pool's own (asserted just above); the
    # other kernels keep the main path's bodies
    check_bodies(label, {**bodies, "K3": {**bodies["K3"], "simt": 0}}
                 if fp8 else bodies)
    check_k2_passes(label, launches, bodies, cfg.n_layers)
    if rows[1]["zero_copy_admits"] != len(rounds[1][1]):
        raise AssertionError("round 2: not every row was a pointer hit")
    if (st["zero_copy_admits"], ps["prefill_tokens_saved"]) != \
            (expect_hits, expect_saved):
        raise AssertionError(
            f"zero_copy_admits {st['zero_copy_admits']} / prefill_tokens_"
            f"saved {ps['prefill_tokens_saved']} != expected "
            f"{expect_hits} / {expect_saved}")
    if (st["free_blocks"] + st["pinned_blocks"] != st["num_blocks"]
            or st["pinned_blocks"] != node_count):
        raise AssertionError(f"pool books do not balance: {summary}")
    return launches, bodies, rows, comps


def phase_paged_fp8(dev, cfg, params, smi, bf16_comps):
    """The paged serve phase's first two rounds (misses, then the same
    threads as pointer hits) on a paged engine like its own with an fp8
    KV pool (``kv_dtype="float8_e4m3fn"``): K3 reads the fp8 pool in place
    on its CUDA-core body in admission and in decode, every call asserting
    it, no plain version. The row gives the launches by body and how the
    token streams agree with the bf16 pool's same rounds (``bf16_comps``):
    streams equal, and the mean share of each stream's leading tokens that
    agree. Returns the launches and bodies."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )

    eng = GenerationEngine(cfg, params, num_slots=8, max_len=4096,
                           prefill_chunk=64, kv_pool_blocks=1024,
                           prefix_cache_blocks=1, quantize="int8",
                           kv_dtype="float8_e4m3fn", device=dev)
    if eng._pool.k.dtype != torch.float8_e4m3fn or \
            eng._static["k_win"].dtype != torch.float8_e4m3fn:
        raise AssertionError("paged_fp8: the pool is not fp8")
    launches, bodies, _rows, comps = phase_paged_serve(
        dev, cfg, eng, smi, label="paged_fp8", n_rounds=2)

    def lead(a, b):
        n = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        return n / max(1, len(a))

    pairs = list(zip(comps, bf16_comps[:len(comps)]))
    emit({"phase": "paged_fp8_agreement", "streams": len(pairs),
          "equal_to_bf16": sum(a.tokens == b.tokens for a, b in pairs),
          "mean_leading_share": sum(lead(b.tokens, a.tokens)
                                    for a, b in pairs) / len(pairs),
          "k3_launches_by_body": bodies["K3"],
          "pool_bytes": eng._pool.k.numel() * 2, "device": smi})
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, bodies


#: the long-context summarization deployment the JAX bench serves int4 in
#: (its ``cap3072`` preset, bench.py:71-79): whole threads of up to 2816
#: prompt tokens on 32 slots at a 3072-token context
CAP3072 = dict(num_slots=32, max_len=3072, prefill_buckets=(2816,),
               admission_token_budget=8192, decode_window=32)


def long_threads(tokenizer, n: int, lo: int, hi: int):
    """``n`` synthetic threads whose prompts encode to ``lo`` .. ``hi``
    tokens, spread evenly: one excerpt each, cut to the length."""
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        build_prompt,
    )

    filler = ("The working group discussed whether the draft should "
              "require the new extension by default. ") * 48
    threads = synthetic_threads(n)
    for i, t in enumerate(threads):
        target = lo + (hi - lo) * i // max(1, n - 1)
        t.chunks = [dict(t.chunks[0], text="")]
        room = target - len(tokenizer.encode(build_prompt(t), add_bos=True))
        text = filler[:room].rstrip()
        t.chunks[0]["text"] = text + "." * (room - len(text))
        if len(tokenizer.encode(build_prompt(t), add_bos=True)) != target:
            raise AssertionError(f"thread {i}: prompt is not {target} long")
    return threads


def phase_int4_serve(dev, cfg, smi):
    """An int4 engine of the 3072-context deployment (``CAP3072``, random
    packed weights from seed 0, q/k/v and gate/up fused) behind
    ``CUDASummarizer``: 32 threads of 2000-2816 prompt tokens, 64 new tokens
    each, weight-only; then ``set_act_quant("a8")`` on the same engine for
    8 threads. Launch counts are reset before each round: each forward
    pass (an admission wave or a decode step) makes 4 quantized matmuls a
    layer plus the lm_head, all on K5 in the first round and all on K6 in
    the second, and none on K2."""
    import torch

    from copilot_for_consensus_tpu_torch.engine import generation
    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
        build_prompt,
    )

    t0 = time.monotonic()
    eng = generation.GenerationEngine(cfg, None, quantize="int4",
                                      device=dev, **CAP3072)
    torch.cuda.synchronize()
    emit({"phase": "int4_weights", "config": cfg.name,
          "bytes": quant.param_bytes(eng.params),
          "fused": sorted(k for k in eng.params["layers"]
                          if quant.quant_kind(eng.params["layers"][k])),
          "seconds": time.monotonic() - t0})
    new_tokens = 64
    summ = CUDASummarizer(cfg.name, engine=eng, max_new_tokens=new_tokens)
    threads = long_threads(summ.tokenizer, 32, 2000, 2816)
    prompts = [summ.tokenizer.encode(build_prompt(t), add_bos=True)
               for t in threads]
    passes = {"waves": 0, "dispatches": 0}

    def counted(kind, fn):
        def run(*a, **kw):
            passes[kind] += 1
            return fn(*a, **kw)
        return run

    eng._admit_wave = counted("waves", eng._admit_wave)
    eng._decode_dispatch = counted("dispatches", eng._decode_dispatch)
    comps: list = []
    plain_generate = eng.generate

    def recording_generate(prompts, max_new_tokens, **kw):
        out = plain_generate(prompts, max_new_tokens, **kw)
        comps.extend(out)
        return out

    eng.generate = recording_generate
    per_pass = 4 * cfg.n_layers + 1

    def serve_round(label, round_threads, mode):
        quant.set_act_quant(mode)
        reset_launches()
        before = dict(passes, prefill_s=eng.admitted_s,
                      decode_s=eng.decode_s, decode_tokens=eng.decode_tokens)
        n0 = len(comps)
        t0 = time.monotonic()
        summaries = summ.summarize_batch(round_threads)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = read_launches()
        bodies = read_bodies()
        rc = comps[n0:]
        waves = passes["waves"] - before["waves"]
        steps = (passes["dispatches"] - before["dispatches"]) \
            * eng._dispatch_steps
        dec_s = eng.decode_s - before["decode_s"]
        dec_t = eng.decode_tokens - before["decode_tokens"]
        row = {"phase": "int4_serve", "round": label, "act_quant": mode,
               "config": cfg.name, "threads": len(round_threads),
               "prompt_tokens": [c.prompt_len for c in rc],
               "completion_tokens": [len(c.tokens) for c in rc],
               "waves": waves, "decode_steps": steps,
               "prefill_s": eng.admitted_s - before["prefill_s"],
               "ttft_s": [c.ttft_s for c in rc],
               "decode_s": dec_s, "decode_tokens": dec_t,
               "decode_tok_per_s": dec_t / dec_s if dec_s else None,
               "ms_per_step": dec_s / steps * 1e3 if steps else None,
               "wall_s": wall, "graphs": eng.graph_stats(),
               "launches": launches, "launches_by_body": bodies,
               "expected": per_pass * (waves + steps), "device": smi}
        emit(row)
        if [s.thread_id for s in summaries] != \
                [t.thread_id for t in round_threads] or any(
                    s.completion_tokens != len(c.tokens)
                    for s, c in zip(summaries, rc)):
            raise AssertionError(f"int4 {label}: summaries out of order")
        if [c.prompt_len for c in rc] != [
                len(p) for p in prompts[:len(round_threads)]]:
            raise AssertionError(f"int4 {label}: prompts were cut")
        on = "K5" if mode == "weight_only" else "K6"
        check_path(f"int4 {label}", launches, ("K1", on))
        if launches[on] != row["expected"]:
            raise AssertionError(f"int4 {label}: launches {launches}, "
                                 f"expected {row['expected']} on {on}")
        # each wave's 4 layer projections a layer take the kernel's wgmma
        # body; decode and the waves' lm_head the kernel's stream body
        wg = 4 * cfg.n_layers * waves
        if on == "K5":
            check_bodies(f"int4 {label}", bodies, wg, row["expected"] - wg,
                         0, 0)
        else:
            check_bodies(f"int4 {label}", bodies, 0, 0, wg,
                         row["expected"] - wg)
        return launches, bodies

    with finite_logits(eng) as finite:
        try:
            wo = serve_round("weight_only", threads, "weight_only")
            a8 = serve_round("a8", threads[:8], "a8")
        finally:
            quant.set_act_quant("weight_only")
    if not bool(finite):
        raise AssertionError("non-finite logits while serving int4")
    return eng, prompts, wo, a8


def phase_int4_wave(cfg, eng, prompts, smi):
    """One admission wave of the int4 engine, traced by kernel: the two
    longest prompts in one bucket (the cap3072 deployment's wave, 2 x
    2816 rows), through ``_admit_wave`` (prefill, cache insert, first-token
    sample) on the host clock, then again under ``torch.profiler``: device
    ms by kernel and by kernel family, the card's busy time, and the
    launches of each kernel body in the wave. Then the same wave with
    ``set_act_quant("a8")`` (restored to "weight_only" after), likewise:
    its layers' projections on K6's wgmma body, its lm_head on K6's
    stream body."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from copilot_for_consensus_tpu_torch.engine.generation import (
        _next_bucket,
    )
    from copilot_for_consensus_tpu_torch.models import quant

    chosen = sorted(prompts, key=len)[-2:]
    bucket = _next_bucket(max(len(p) for p in chosen), eng.buckets)
    tokens = np.zeros((len(chosen), bucket), dtype=np.int64)
    lengths = np.array([len(p) for p in chosen], dtype=np.int64)
    for i, p in enumerate(chosen):
        tokens[i, :len(p)] = p

    def wave():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng._admit_wave(tokens, lengths, list(range(len(chosen))))
        torch.cuda.synchronize()
        return time.monotonic() - t0

    def traced(mode):
        quant.set_act_quant(mode)
        try:
            plain_s = wave()
            reset_launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced_s = wave()
        finally:
            quant.set_act_quant("weight_only")
        bodies = read_bodies()
        events, by_name = device_us_by_kernel(prof)
        busy = busy_us((e.time_range.start, e.time_range.end)
                       for e in events)
        row = {"phase": "int4_wave", "act_quant": mode, "config": cfg.name,
               "rows": len(chosen), "bucket": bucket,
               "prompt_tokens": lengths.tolist(), "wave_s": plain_s,
               "traced_wave_s": traced_s, "device_busy_ms": busy / 1e3,
               "device_ms_by_family": device_ms_by_family(by_name),
               "device_ms_by_kernel": {k: v / 1e3 for k, v in
                                       list(by_name.items())[:12]},
               "launches_by_body": bodies, "device": smi}
        emit(row)
        return row, bodies

    row, bodies = traced("weight_only")
    if bodies["K5"]["wgmma"] != 4 * cfg.n_layers or \
            bodies["K5"]["stream"] != 1 or \
            bodies["K1"]["wgmma"] != cfg.n_layers:
        raise AssertionError(f"int4 wave launches by body: {bodies}")
    a8_row, bodies = traced("a8")
    if bodies["K6"]["wgmma"] != 4 * cfg.n_layers or \
            bodies["K6"]["stream"] != 1 or bodies["K6"]["split"] or \
            bodies["K6"]["mma_sync"] or \
            bodies["K1"]["wgmma"] != cfg.n_layers or \
            any(bodies["K5"].values()):
        raise AssertionError(f"int4 a8 wave launches by body: {bodies}")
    return row, a8_row


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


@contextlib.contextmanager
def replay_spans():
    """Device ms of each CUDA graph replay inside the block, untraced: a
    pair of CUDA events recorded on the replaying stream just before and
    just after each replay call. Yields the list of pairs; the caller
    reads their times after a synchronize."""
    import torch

    plain_replay = torch.cuda.CUDAGraph.replay
    pairs: list = []

    def timed(graph):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        plain_replay(graph)
        b.record()
        pairs.append((a, b))

    torch.cuda.CUDAGraph.replay = timed
    try:
        yield pairs
    finally:
        torch.cuda.CUDAGraph.replay = plain_replay


def dispatch_split(events, n: int) -> dict:
    """Where the device idles in ``n`` traced decode dispatches, from the
    trace's device events alone. Each dispatch ends with one device-to-host
    copy, the fetch of its tokens; its replay starts at the first device
    event after the previous fetch that is not a host-to-device copy (the
    host's fill of the static buffers). In replay: its span from that start
    to the fetch's end, the union of its device intervals, and the gaps
    between them (``in_replay_gap_us``, summed over the dispatches).
    Between dispatches: from a fetch's end to the next replay's start,
    averaged over the n - 1 boundaries. Only the count of fetches unless
    the trace holds exactly n. The profiler's own cost stays in both parts,
    most of it between the dispatches: ``replay_spans`` measures the
    untraced split."""
    evs = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events)
    fetch_ends = [end for _, end, name in evs if "DtoH" in name]
    if len(fetch_ends) != n:
        return {"fetches": len(fetch_ends)}
    starts, spans, busy = [], [], []
    prev = float("-inf")
    for end in fetch_ends:
        inside = [(a, b) for a, b, name in evs
                  if a >= prev and b <= end and "HtoD" not in name]
        start = min(a for a, _ in inside)
        starts.append(start)
        spans.append(end - start)
        busy.append(busy_us(inside))
        prev = end
    between = [s - e for s, e in zip(starts[1:], fetch_ends[:-1])]
    return {"fetches": n, "replay_span_us": spans, "replay_busy_us": busy,
            "in_replay_gap_us": sum(spans) - sum(busy),
            "between_us": between,
            "between_us_per_dispatch": sum(between) / len(between)
            if between else None}


def device_us_by_kernel(prof) -> tuple[list, dict]:
    """The traced device events of ``prof`` and their µs summed by kernel
    name (its first 80 characters), largest first."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + (
            e.time_range.end - e.time_range.start)
    return events, dict(sorted(by_name.items(), key=lambda kv: -kv[1]))


#: the port's kernels by body, each a family of substrings of the device
#: kernel names; any other kernel is PyTorch's own
KERNEL_FAMILIES = {
    "K1 wgmma (flash_wgmma)": ("flash_wgmma",),
    "K1 d32 (flash_d32)": ("flash_d32",),
    "K1 CUDA cores (flash_fwd_kernel)": ("flash_fwd_kernel",),
    "K2 stream (int8_stream)": ("int8_stream",),
    "K2 GEMV (gemv_partial, gemv_reduce)": ("gemv_partial", "gemv_reduce"),
    "K2 wgmma (int8_wgmma)": ("int8_wgmma",),
    "K2 WMMA, CUDA cores (gemm_wmma, gemm_simt)": ("gemm_wmma", "gemm_simt"),
    "K3 decode (paged_split, paged_merge)": ("paged_split", "paged_merge"),
    "K3 seeded (paged_wgmma)": ("paged_wgmma",),
    "K3 CUDA cores (paged_partial_kernel)": ("paged_partial_kernel",),
    "K5 wgmma (int4_wgmma)": ("int4_wgmma",),
    "K5 stream (int4_stream)": ("int4_stream",),
    "K6 wgmma (w4a8_wgmma)": ("w4a8_wgmma",),
    "K6 stream (w4a8_stream)": ("w4a8_stream",),
    "K4 wgmma (w8a8_wgmma)": ("w8a8_wgmma",),
    "K4, K6 activation rows (quantize_rows)": ("quantize_rows",),
    "K5 and K6 split, mma.sync tilings of K4-K6 (qgemm, int4_simt)":
        ("qgemm", "int4_simt"),
}


def device_ms_by_family(by_name: dict) -> dict:
    """Device ms (from µs by kernel name) summed by ``KERNEL_FAMILIES``;
    the rest under "PyTorch's own"."""
    out: dict[str, float] = {}
    for name, us in by_name.items():
        fam = next((f for f, keys in KERNEL_FAMILIES.items()
                    if any(k in name for k in keys)), "PyTorch's own")
        out[fam] = out.get(fam, 0.0) + us / 1e3
    return out


def phase_int8_wave(cfg, eng, smi):
    """One admission wave of the contiguous int8 engine, traced by kernel:
    4 rows of 1024 tokens (seeded), the deployment's largest bucket and the
    serve phase's wave, through ``_admit_wave`` (prefill, cache insert,
    first-token sample) on the host clock, then again under
    ``torch.profiler``: device ms by kernel and by family, the card's busy
    time, and the launches of each kernel body in the wave — K2's wgmma
    body 7 times a layer, its stream body once (the lm_head's 4 rows),
    K1's wgmma body once a layer. Then the same wave with
    ``set_act_quant("a8")`` (restored to "weight_only" after), likewise:
    its layers' projections on K4's wgmma body (7 a layer), its lm_head on
    K2's stream body, and K4's device ms in the wave (its wgmma body and
    its ``quantize_rows``). The engine's slots must be free; the wave
    writes their cache rows only."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from copilot_for_consensus_tpu_torch.models import quant

    rows, bucket = 4, 1024
    tokens = np.random.default_rng(7).integers(
        3, 259, (rows, bucket)).astype(np.int64)
    lengths = np.full((rows,), bucket, dtype=np.int64)

    def wave():
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng._admit_wave(tokens, lengths, list(range(rows)))
        torch.cuda.synchronize()
        return time.monotonic() - t0

    def traced(mode):
        quant.set_act_quant(mode)
        try:
            plain_s = wave()
            reset_launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced_s = wave()
        finally:
            quant.set_act_quant("weight_only")
        launches, bodies = read_launches(), read_bodies()
        events, by_name = device_us_by_kernel(prof)
        busy = busy_us((e.time_range.start, e.time_range.end)
                       for e in events)
        by_family = device_ms_by_family(by_name)
        row = {"phase": "int8_wave", "act_quant": mode, "config": cfg.name,
               "rows": rows, "bucket": bucket, "wave_s": plain_s,
               "traced_wave_s": traced_s, "device_busy_ms": busy / 1e3,
               "device_ms_by_family": by_family,
               "device_ms_by_kernel": {k: v / 1e3 for k, v in
                                       list(by_name.items())[:12]},
               "launches_by_body": bodies, "device": smi}
        if mode == "a8":
            k4 = {"w8a8_wgmma": by_family.get("K4 wgmma (w8a8_wgmma)", 0.0),
                  "quantize_rows": by_family.get(
                      "K4, K6 activation rows (quantize_rows)", 0.0)}
            row["k4_device_ms_per_wave"] = {**k4, "total": sum(k4.values())}
        emit(row)
        return row, launches, bodies

    row, _, bodies = traced("weight_only")
    if (bodies["K2"]["wgmma"], bodies["K2"]["stream"], bodies["K1"]["wgmma"]) \
            != (7 * cfg.n_layers, 1, cfg.n_layers):
        raise AssertionError(f"int8 wave launches by body: {bodies}")
    check_bodies("int8_wave", bodies)
    a8_row, launches, bodies = traced("a8")
    check_path("int8_wave_a8", launches, ("K1", "K2", "K4"))
    check_bodies("int8_wave_a8", bodies)
    if (bodies["K4"]["wgmma"], bodies["K2"]["stream"], bodies["K2"]["wgmma"],
            bodies["K1"]["wgmma"]) != (7 * cfg.n_layers, 1, 0, cfg.n_layers):
        raise AssertionError(f"int8 a8 wave launches by body: {bodies}")
    return row, a8_row


def phase_trace(cfg, eng, prompts, smi, n: int = 2, label: str = "trace"):
    """Device busy and idle share of steady decode: the longest prompts
    fill the slots, in as many admission waves as the engine's token budget
    needs (one dispatch after each); after the last, ``n`` dispatches run
    on the host clock alone and the next ``n`` under ``torch.profiler``
    tracing the card's activity. Idle share = 1 - (union of the traced
    device intervals) / (host wall time of the n steps). The measured
    dispatches are graph replays: before each run of ``n``, single
    dispatches run (``warm_dispatches``, at most n + 1) until each of the
    next ``n`` lands on a kv bucket whose graph is captured, and the slots'
    prompts are cut to leave room for them. The engine is left with its
    slots busy: the caller discards it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from copilot_for_consensus_tpu_torch.engine.generation import (
        _next_bucket,
    )
    from copilot_for_consensus_tpu_torch.models import quant

    window = eng._dispatch_steps
    chosen = sorted(prompts, key=len)[-eng.num_slots:]
    bucket = _next_bucket(min(len(chosen[-1]), eng.prompt_limit),
                          eng.buckets)
    per_wave = max(1, min(128, eng.admission_token_budget // bucket))
    waves = -(-len(chosen) // per_wave)
    # a slot of the first wave sees every admission dispatch, up to 2(n + 1)
    # warm ones and the 2n measured ones: its prompt tail and token budget
    # leave room for them and one dispatch more, so no slot finishes inside
    # the measurement
    dispatches = waves + 2 * n + 2 * (n + 1)
    room = eng.max_len - 1 - window * (dispatches + 1)
    ids = [eng.submit(p[-room:], max_new_tokens=1 + window * (dispatches + 1))
           for p in chosen]
    done: set[int] = set()

    def step():
        done.update(c.request_id for c in eng.step())

    for _ in range(waves):               # admission waves + a dispatch each
        step()
    if eng._queue or len(eng._active) != len(ids):
        raise AssertionError(f"{label}: slots not filled in {waves} waves")

    def ahead():
        """The kv buckets of the next n dispatches."""
        hi = max(int(eng._positions[s]) for s in eng._active)
        return [eng._kv_extent(hi + k * window) for k in range(n)]

    def warm_up():
        """Single dispatches until the next n land on captured buckets."""
        for _ in range(n + 1):
            if all(eng._graph_key(b) in eng._graphs for b in ahead()):
                break
            step()
            warm.append(1)
        if not all(eng._graph_key(b) in eng._graphs for b in ahead()):
            raise AssertionError(f"{label}: buckets {ahead()} not captured")

    def steps():
        """Host seconds of n dispatches, each a graph replay."""
        st0 = eng.graph_stats()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        st1 = eng.graph_stats()
        if (st1["eager"], st1["captured"]) != (st0["eager"], st0["captured"]):
            raise AssertionError(f"{label}: a measured dispatch ran eagerly "
                                 f"or was captured: {st0} -> {st1}")
        return time.monotonic() - t0

    warm: list[int] = []
    warm_up()
    with replay_spans() as pairs:
        plain_s = steps()
    spans = [a.elapsed_time(b) for a, b in pairs]
    if len(spans) != n:
        raise AssertionError(f"{label}: {len(spans)} replays timed, not {n}")
    warm_up()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_s = steps()
    if done:
        raise AssertionError("a slot finished inside the measured decode")
    kernels, by_name = device_us_by_kernel(prof)
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    split = dispatch_split(kernels, n)
    split_ok = split.get("between_us_per_dispatch") is not None
    # the untraced split: each replay's device span against the host's
    # wall per dispatch, and against the traced busy time a dispatch
    replay_ms = sum(spans) / n
    host_ms = plain_s / n * 1e3
    top = list(by_name.items())[:12]
    families = device_ms_by_family(by_name)
    n_steps = n * window
    row = {"phase": label, "config": cfg.name, "slots": len(ids),
           "kv": "paged" if eng.paged else "contiguous",
           "quantize": eng.quant_mode, "act_quant": quant.act_quant_mode(),
           "admission_waves": waves, "dispatches": n,
           "warm_dispatches": len(warm),
           "windows_per_dispatch": eng.windows_per_dispatch,
           "graphs": eng.graph_stats(),
           "steps": n_steps, "step_ms": plain_s / n_steps * 1e3,
           "traced_step_ms": traced_s / n_steps * 1e3,
           "device_events": len(kernels),
           "device_busy_ms": busy / 1e3 if kernels else None,
           "device_busy_ms_per_step": busy / 1e3 / n_steps if kernels
           else None,
           "idle_share": (1.0 - busy / (traced_s * 1e6)) if kernels
           else None,
           "replay_ms": spans,
           "untraced_split_ms_per_step": {
               "replay": replay_ms / window,
               "inside_replay_idle": (replay_ms - busy / 1e3 / n) / window
               if kernels else None,
               "between_dispatches": (host_ms - replay_ms) / window},
           "traced_split": split,
           "traced_split_ms_per_step": {
               "inside_replay_idle": split["in_replay_gap_us"] / 1e3
               / n_steps,
               "between_dispatches": split["between_us_per_dispatch"]
               / 1e3 / window} if split_ok else None,
           "device_ms_by_family": families,
           "device_ms_per_step_by_family": {k: v / n_steps
                                            for k, v in families.items()},
           "device_ms_by_kernel": {k: v / 1e3 for k, v in top},
           "device": smi}
    emit(row)
    return row


@contextlib.contextmanager
def host_seconds(obj):
    """Host seconds spent inside ``obj``'s public methods in the block
    (yielded: a dict with ``s`` and ``calls``; a call made from inside
    another counts once)."""
    acc = {"s": 0.0, "calls": 0}
    depth = [0]
    names = [n for n in dir(obj) if not n.startswith("_")
             and callable(getattr(obj, n))]

    def timed(fn):
        def run(*a, **kw):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                if not depth[0]:
                    acc["s"] += time.perf_counter() - t0
                    acc["calls"] += 1
        return run

    for n in names:
        setattr(obj, n, timed(getattr(obj, n)))
    try:
        yield acc
    finally:
        for n in names:
            delattr(obj, n)


def phase_telemetry_cost(cfg, eng, prompts, smi):
    """Phase 6's trace with the engine's telemetry on (its default), then
    on the same engine, its slots freed, with telemetry off: the step ms
    and the device's busy ms a step side by side, and the host seconds the
    telemetry's own calls took over the first trace's dispatches.
    Telemetry is host bookkeeping after each dispatch's one fetch: the
    device's busy time must not move, and the host's step is what it
    costs."""
    tele = eng.telemetry
    if tele is None:
        raise AssertionError("trace: the engine's telemetry is off")
    n0 = len(tele.recorder.records())
    with host_seconds(tele) as host:
        on = phase_trace(cfg, eng, prompts, smi)
    records = tele.recorder.records()[n0:]
    steps = sum(eng._dispatch_steps for r in records if r.kind == "decode")
    free_slots(eng)
    eng.telemetry = None
    try:
        off = phase_trace(cfg, eng, prompts, smi,
                          label="trace_telemetry_off")
    finally:
        eng.telemetry = tele
    keys = ("step_ms", "traced_step_ms", "device_busy_ms_per_step",
            "idle_share")
    row = {"phase": "telemetry_cost", "config": cfg.name,
           "on": {k: on[k] for k in keys}, "off": {k: off[k] for k in keys},
           "step_ms_on_minus_off": on["step_ms"] - off["step_ms"],
           "recorded_steps": len(records),
           "telemetry_host": {"calls": host["calls"], "s": host["s"],
                              "decode_steps": steps,
                              "ms_per_decode_step": host["s"] * 1e3 / steps
                              if steps else None},
           "device": smi}
    emit(row)
    if not row["recorded_steps"]:
        raise AssertionError("trace: telemetry recorded no step")
    return row


def free_slots(eng) -> None:
    """Retire every busy slot of ``eng`` (a trace phase leaves them busy),
    so that another trace phase can fill them again."""
    for slot in list(eng._active):
        eng._retire(slot, "length")
    eng._drain_done()


def phase_int4_a8_trace(cfg, eng, prompts, smi):
    """Phase 6's trace on the int4 engine under ``set_act_quant("a8")``
    (restored to "weight_only" after), 32 slots busy: the a8 decode step's
    busy ms, idle share and device ms by family a step (K6's stream body
    and its ``quantize_rows``). Launches are counted over the phase: its
    admission waves' layers on K6's wgmma body, every M <= 32 launch on
    its stream body, none on the split qgemm, the mma.sync tiling or K5."""
    from copilot_for_consensus_tpu_torch.models import quant

    free_slots(eng)
    quant.set_act_quant("a8")
    reset_launches()
    try:
        row = phase_trace(cfg, eng, prompts, smi, label="int4_a8_trace")
    finally:
        quant.set_act_quant("weight_only")
    bodies = read_bodies()
    emit({"phase": "int4_a8_trace_bodies", "launches_by_body": bodies})
    check_bodies("int4_a8_trace", bodies)
    if not bodies["K6"]["stream"] or any(bodies["K5"].values()) or \
            not row["device_ms_by_family"].get("K6 stream (w4a8_stream)"):
        raise AssertionError(f"int4_a8_trace: K6's stream body did not "
                             f"carry the a8 decode: {bodies}")
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
    from copilot_for_consensus_tpu_torch.scripts import probe_stream as drv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = drv.card()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.monotonic()
    _build.build_all()
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "kernels": {n: r["seconds"] for n, r in _build.build_log.items()}})
    phase_build_info()

    # a buffer beyond the 50 MB L2, rewritten before each timed launch
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    # what time_ms gives a kernel that does next to nothing: the floor under
    # the small kernels' times
    one = torch.empty(1, device=dev)
    emit({"phase": "timing_floor", "kernel": "one-element zero_",
          "ms": time_ms(one.zero_, flush=flush)})
    rows = phase_kernels(dev, flush)
    rows.update(phase_k3(dev, flush))
    phase_k3_layouts(dev)
    rows.update(phase_quant_kernels(dev, flush))
    probe_rows, probe_launches, probe_per_mode = phase_probe(dev, flush, smi)
    rows.update(probe_rows)
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
    a8_launches, a8_bodies = phase_a8_model(dev, cfg, params)
    launches, bodies, prompts, eng, batch = phase_serve(dev, cfg, params,
                                                        smi)
    phase_int8_wave(cfg, eng, smi)
    phase_telemetry_cost(cfg, eng, prompts, smi)
    # the contiguous engine's cache goes before the next engines come
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    phase_graphs(dev, cfg, params, smi, paged=False)
    phase_async_serve(dev, cfg, params, smi, batch)
    gc.collect()
    torch.cuda.empty_cache()
    deadline_launches, deadline_bodies = phase_deadlines(dev, cfg, params,
                                                         smi)
    gc.collect()
    torch.cuda.empty_cache()
    pipeline = phase_pipeline(dev, cfg, params, smi)
    encoder_launches, encoder_bodies = phase_encoder(dev, smi)
    phase_vectorstore(dev, smi)
    journal = phase_journal(dev, smi)

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    paged = GenerationEngine(cfg, params, num_slots=8, max_len=4096,
                             prefill_chunk=64, kv_pool_blocks=1024,
                             prefix_cache_blocks=1, quantize="int8",
                             device=dev)
    phase_paged_model(dev, cfg, paged)
    paged_launches, paged_bodies, _, paged_comps = phase_paged_serve(
        dev, cfg, paged, smi)
    phase_trace(cfg, paged, prompts, smi, label="paged_trace")
    del paged
    gc.collect()
    torch.cuda.empty_cache()
    phase_graphs(dev, cfg, params, smi, paged=True)
    fp8_launches, fp8_bodies = phase_paged_fp8(dev, cfg, params, smi,
                                               paged_comps)
    # the int8 weights go before the int4 engine comes
    del params
    gc.collect()
    torch.cuda.empty_cache()
    int4, int4_prompts, (int4_launches, int4_bodies), \
        (int4_a8_launches, int4_a8_bodies) = phase_int4_serve(dev, cfg, smi)
    phase_int4_wave(cfg, int4, int4_prompts, smi)
    phase_trace(cfg, int4, int4_prompts, smi, label="int4_trace")
    phase_int4_a8_trace(cfg, int4, int4_prompts, smi)
    del int4
    gc.collect()
    torch.cuda.empty_cache()

    # the journal phase's resumed child counts in its own process: its K1,
    # K2 and K3 bodies, the other kernels none
    storm = journal["launches_by_body"]["resume"]
    journal_bodies = {k: {**dict.fromkeys(kernel_wrappers()[k]
                                          .launches_by_body, 0),
                          **storm.get(k, {})} for k in BODY_KERNELS}
    journal_launches = {k: sum(journal_bodies[k].values())
                        if k in journal_bodies else 0
                        for k in kernel_wrappers()}
    by_path = {"pipeline": pipeline["sync"]["launches"],
               "pipeline_pipelined": pipeline["pipelined"]["launches"],
               "pipeline_retrieval": pipeline["retrieval"]["launches"],
               "encoder": encoder_launches,
               "serve": launches, "paged_serve": paged_launches,
               "paged_fp8": fp8_launches, "deadlines": deadline_launches,
               "journal_resume": journal_launches,
               "a8_model": a8_launches, "int4_serve": int4_launches,
               "int4_serve_a8": int4_a8_launches, "probe": probe_launches}
    bodies_by_path = {"pipeline": pipeline["sync"]["bodies"],
                      "pipeline_pipelined": pipeline["pipelined"]["bodies"],
                      "pipeline_retrieval": pipeline["retrieval"]["bodies"],
                      "encoder": encoder_bodies,
                      "serve": bodies, "paged_serve": paged_bodies,
                      "paged_fp8": fp8_bodies, "deadlines": deadline_bodies,
                      "journal_resume": journal_bodies,
                      "a8_model": a8_bodies, "int4_serve": int4_bodies,
                      "int4_serve_a8": int4_a8_bodies}
    table = []
    q = "copilot_for_consensus_tpu/ops/quant_matmul.py"
    csrc = "copilot_for_consensus_tpu_torch/csrc"
    for name, row, path, tpu in (
            ("flash_attention", rows[("K1", "s1024", "bfloat16")],
             "pipeline", "copilot_for_consensus_tpu/ops/"
             "flash_attention.py:119"),
            ("flash_attention_d32", rows[("K1", "enc_s512", "bfloat16")],
             "pipeline_retrieval", "copilot_for_consensus_tpu/ops/"
             "flash_attention.py:119"),
            ("int8_matmul", rows[("K2", "m4_d4096_f14336", "bfloat16")],
             "pipeline", f"{q}:50"),
            ("int8_matmul_tiled",
             rows[("K2", "m4096_d4096_f14336", "bfloat16")], "pipeline",
             f"{q}:50"),
            ("paged_attention", rows[("K3", "decode", "bfloat16")],
             "paged_serve", "copilot_for_consensus_tpu/ops/"
             "paged_attention.py:166"),
            ("paged_attention_seeded",
             rows[("K3", "seeded_s1024", "bfloat16")], "paged_serve",
             "copilot_for_consensus_tpu/ops/paged_attention.py:166"),
            ("paged_attention_fp8",
             rows[("K3", "decode", "float8_e4m3fn")], "paged_fp8",
             "copilot_for_consensus_tpu/ops/paged_attention.py:166"),
            ("w8a8_matmul", rows[("K4", "m4096_d4096_f14336", "bfloat16")],
             "a8_model", f"{q}:309"),
            ("int4_matmul", rows[("K5", "m32_d4096_f28672", "bfloat16")],
             "int4_serve", f"{q}:178"),
            ("int4_matmul_tiled",
             rows[("K5", "m5632_d4096_f28672", "bfloat16")], "int4_serve",
             f"{q}:178"),
            ("w4a8_matmul", rows[("K6", "m32_d4096_f28672", "bfloat16")],
             "int4_serve_a8", f"{q}:405"),
            ("w4a8_matmul_tiled",
             rows[("K6", "m5632_d4096_f28672", "bfloat16")], "int4_serve_a8",
             f"{q}:405")):
        k = row["kernel"]
        # K1-K6 count their launches by body: each of their rows is one
        # body, whose source is the body's own file, and counts that
        # body's launches on every path
        body, src = {
            "flash_attention": ("wgmma", "flash_wgmma.cuh"),
            "flash_attention_d32": ("d32", "flash_d32.cuh"),
            "int8_matmul": ("stream", "int8_stream.cuh"),
            "int8_matmul_tiled": ("wgmma", "int8_wgmma.cuh"),
            "paged_attention": ("decode", "paged_decode.cuh"),
            "paged_attention_seeded": ("seeded", "paged_wgmma.cuh"),
            "paged_attention_fp8": ("simt", "paged_attention.cu"),
            "int4_matmul": ("stream", "int4_stream.cuh"),
            "int4_matmul_tiled": ("wgmma", "int4_wgmma.cuh"),
            "w4a8_matmul": ("stream", "w4a8_stream.cuh"),
            "w4a8_matmul_tiled": ("wgmma", "w4a8_wgmma.cuh"),
            "w8a8_matmul": ("wgmma", "w8a8_wgmma.cuh"),
        }.get(name, (None, f"{name}.cu"))
        extra = {"mma_sync_ms": row["mma_sync_ms"]} \
            if "mma_sync_ms" in row else {}
        if body is not None:
            extra.update(body=body, launches_by_body={
                p: b[k] for p, b in bodies_by_path.items()})
            per_path = {p: bodies_by_path[p][k][body]
                        if p in bodies_by_path else c[k]
                        for p, c in by_path.items()}
        else:
            per_path = {p: c[k] for p, c in by_path.items()}
        table.append({
            "name": name, "route": "cuda", "source": f"{csrc}/{src}",
            "replaces": tpu,
            # the count of the path that runs the kernel on the main path;
            # every path's count beside it
            "launches": per_path[path], "launches_path": path,
            "launches_by_path": per_path,
            **extra,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": row["case"], "dtype": row["dtype"]})
    # P: one row a mode; unpack8 and unpack32 share the unpack wrapper's
    # count, so on the probe path each row gives the mode's own share. The
    # four GEMM-like modes run the Hopper body (probe_wgmma.cuh), the
    # mma.sync body's time beside them
    for mode, key in P_COUNTERS.items():
        row = rows[("P", mode, "bfloat16")]
        extra = {}
        if "simple_ms" in row:
            extra = {"body": row["body"], "simple_ms": row["simple_ms"],
                     "launches_by_body": row["probe"]["launches_by_body"]}
        table.append({
            "name": f"probe_stream_{mode}", "route": "cuda",
            "source": f"{csrc}/" + ("probe_wgmma.cuh" if extra
                                     else "probe_stream.cu"),
            "replaces": "scripts/probe_stream.py:"
                        + ("146" if mode.startswith("unpack") else "121"),
            "launches": probe_per_mode[mode], "launches_path": "probe",
            "launches_by_path": {p: probe_per_mode[mode] if p == "probe"
                                 else c[key] for p, c in by_path.items()},
            **extra,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"],
            "case": row["case"], "dtype": row["dtype"],
            "probe_ms_per_pass": row["probe"]["ms"],
            "probe_gb_per_s": row["probe"]["gb_per_s"]})
    emit({"kernels": table})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
