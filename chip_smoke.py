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
   and 64) and the verify passes' M 40 and 288 at w_gate/w_up's and the
   lm_head's shapes; four more with small integer x must equal the plain
   version bit for bit on the wgmma body and six on the stream body (M 1, 4, 8;
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
   and seeded-admission (R = 4·64, 4·1024) shapes, and the verify (R =
   4·5, 4·9) and chunk (R = 4·64, first chunks among them) passes' — the
   normalised output
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
   (32 new tokens each) on K5, then 8 threads with a8 on, on K6; every
   forward pass must make 4 quantized launches a layer plus the lm_head's,
   all on the wgmma body (K5's, K6's) in the waves' layers, and on the
   stream body (K5's, K6's) in decode and the waves' lm_head;
14. int4 wave and trace — one admission wave of the int4 engine (2 x
   2816) traced by kernel: device ms by kernel and by family, and the
   launches of each body; the same wave again in a8 (128 launches of K6's
   wgmma body, 1 of its stream body, 32 of K1); then phase 6 on the int4
   engine, 32 slots busy, and again in a8 once those slots are freed and
   filled again weight-only (``int4_a8_trace``: K6's device ms a decode
   step, every M <= 32 launch on its stream body);
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
   threads through two contiguous int8 engines of the same weights, cut to
   ``GRAPHS_LAYERS`` layers, one
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
   busy ms a step side by side;
26. spec_serve — (after phase 24) speculative decoding at the JAX bench's
   ``spec_decode`` preset: a contiguous int8 engine of 32 slots, max_len
   896, 32 copy-heavy prompts of 512 tokens, 192 new tokens, window 8,
   draft lengths (0, 4, 8), spec on and then off: ``spec_stats()``, verify
   dispatches and their ms, decode tok/s of both arms, the streams equal
   between them (bf16: counted); every K2 launch on the wgmma body, 225 a
   forward pass (waves, verify passes, decode steps), no plain version;
27. sched_serve — the scheduler at the bench's ``mixed_traffic`` shape
   (contiguous int8, fp8 KV, 32 slots, max_len 1024): 12 long batch
   prompts at step 0, 48 chats 8 a step, a 192-text ``minilm-l6`` embed
   burst at step 4 through a shared ``Scheduler``; with the scheduler
   (chunked prefill of 128, DRR chat 2 : analytics 1, shedding) and
   without: TTFT p50/p99 by class, ITL p95/p99, chunk dispatches and
   tokens, sheds, the fairness index, the embed tiles; K1 and K2 only, 225
   K2 a forward pass;
28. paged_spec and paged_chunk — the paged cell's engine (phase 9's) with
   spec decoding over copy-heavy prompts, and with chunked prefill of 64
   over cache-miss prompts of 300-1000 tokens, each beside the same engine
   with the feature off: K3's verify and chunk passes all on its seeded
   body (R 20, 36 and 256), its decode steps on the decode body, none on
   the CUDA-core body, no plain version, the pool's books balanced;
29. spec_chunk_f32 — (after phase 14) 2 layers at mistral-7b's widths at
   f32 (the lm_head cut to a 64-token alphabet the prompts share, so that
   drafts fire), greedy: spec on equals off and chunked equals monolithic
   admission, on the contiguous cache and on the paged pool, decode by
   graph replays between the verify dispatches (a divergence passes only
   where the top-2 logits are within 1e-5 relative);
30. long_s16k — (right after phase 3) K1 at the long route's prefill
   shape: B 1, 32/8 heads of 128, causal, window 4096, Sq = Skv = the
   long_serve bucket of its longest prompt (17152), kv_length that
   prompt's tokens; held against K1's plain version 1024 query rows a
   call through ``q_offsets`` (every chunk, the last valid row's among
   them; max abs within 2e-2 and each valid row's rel-L2 within 1e-2, a
   gate a window one tile short or a dropped key tile must fail), timed
   beside the chunked plain pass, SDPA with the explicit
   boolean mask and the bound by attended pairs;
31. long_serve — (after phase 28's roles, the int8 weights still on the
   card) ``scripts/bench_longctx.py``'s workload cut from 20 threads to
   4 (the fixture's threads replayed to 16,000 characters or more: 16,660
   to 17,017 tokens; 96 new, decode window 16, ctx_block 256, greedy)
   through ``CUDASummarizer(long_context=True)`` over the deployed short
   engine (4 slots, max_len 4096): every thread whole on the
   ``LongContextEngine``, which holds the short engine's tensors; prefill
   s, decode tok/s, peak memory, K1 (32 a prefill) and K2 (225 a forward
   pass) launches by body, no plain version; then the overlap: one long
   thread through ``summarize_async`` on this thread while the runner
   replays a short request's decode graphs, again and again, on its own
   thread and stream — the long summary equal to the sync route's, every
   short one to its run alone;
32. long_f32 — the long engine against the short engine on the same
   weights: 2 layers at f32 with a 6,000-token prompt (past the window),
   16 greedy tokens equal (or a divergence at a top-2 tie); then bf16 at
   full depth with a 3,000-token prompt: the first tokens equal, the
   logits of the first token and of the first decode step each within
   rel-L2 5e-2, greedy tokens that agree counted;
33. profile — ``profile_dir`` on a ``CUDASummarizer`` with the long
   engine: one torch.profiler trace a ``generate``, each holding a step
   annotation for every dispatch its engine's flight recorder holds;
34. under_load — (right after the weights, before phase 4) every ring
   body held to its own bits while another stream loads the card: each
   case (the decode and wave shapes of K1's wgmma body, K2's stream and
   wgmma bodies, K4, K5's and K6's stream and tiled bodies, P's four
   Hopper modes; Mistral-7B widths, seeded inputs) runs once for its
   reference output, ``UNDER_LOAD["idle_repeats"]`` times alone, then
   ``UNDER_LOAD["repeats"]`` times while a second thread runs the long
   route's prefill (32 int8 blocks at 16,896 tokens) on its own stream;
   every repeat must equal the reference bit for bit. A consumer that
   releases a TMA stage before its generic-proxy reads of it are ordered
   (no ``fence.proxy.async``) returns other bits only under such load;
35. moe_layer — (after phase 29, no other model resident) one
   Mixtral-8x7B MoE layer (``models/moe.py``), bf16, random int8 and then
   int4 experts: the kernel route against ``impl="plain"`` on the same
   routing at decode with 8 and 32 slots (capacity 8 and 16) and at a
   4 x 1024 wave (capacity 1280), rel-L2 within 1e-2, 3 x 8 launches of
   K2 (K5) a call on the body the capacity gives; then K2 and K5 alone at
   the experts' shapes and M 8, 16 and 1280, timed (L2 flushed) beside
   their plain versions, bounds and PyTorch yardsticks;
36. moe_serve — ``mixtral-8x7b`` at full width and depth (random weights
   from seed 0) built by the ``cuda`` LLM driver, at int8 and then, the
   int8 weights freed, at int4 (unfused): 8 threads of 600-1000 tokens on
   8 slots, 32 new tokens, under CUDA graphs, weight-only and then "a8":
   launches by body equal to what the waves and decode steps it made
   imply (3 x 8 x 32 expert products a forward pass on K2 or K5 in both
   modes: no expert launch on K4 or K6), every logits row finite; then
   ``moe_trace_int8`` / ``moe_trace_int4`` (phase_trace: step ms, idle
   share) and peak memory;
37. moe_f32 — 2 layers at Mixtral-8x7B's widths, f32, greedy: the
   contiguous engine on K1 and a paged one on K1 and K3 against
   ``attn_impl="plain"``, streams equal (or a divergence at a top-2 tie).
38. tp_shapes — (right after the probe) every shard shape a tp-2 or tp-4
   rank of a Mistral-7B mesh runs, each held against its plain version
   with the kernel phases' gates and timed beside its bound and a PyTorch
   call: K2 at every int8 leaf at M 4, M 144 and 288 (verify passes of
   16 and 32 slots at k = 8; 288 is also the piggyback dispatch's rows)
   and M 4096, K5 at the int4 leaves as the mesh engine fuses them
   (group 256; w_down at tp 4 is 14 groups) at M 32 and M 4096, K1 (B 4,
   32/tp heads over 8/tp, S 1024, and the piggyback lanes' ``piggy_s64``)
   and K3 (B 8, 8/tp kv heads over a 512-block pool shard: the decode
   step, R 4, and the seeded verify and chunk passes, R 36 and 256);
   each row names the body its wrapper's counters show it launched and
   the body the rules want (reported, not gated);
39. mesh_nccl — the collectives of ``parallel/collectives.py`` on the
   world-1 NCCL group (``initialize_multihost`` with one process is a
   no-op, so the phase joins the group itself): eagerly, then captured
   in a CUDA graph replayed 3 times, each result checked; the backend and
   NCCL's version;
40. mesh_serve / mesh_serve_paged — (after phase 14's paged graphs)
   ``GenerationEngine(mesh=build_mesh(MeshConfig()))`` at world size 1
   against the un-meshed engine on the same int8 Mistral-7B tensors, the
   deployed contiguous engine (4 slots) and the paged one (8 slots, 1024
   blocks of 64), 8 threads of 32 new tokens: streams equal, launches by
   body equal, graphs replayed, allocated bytes within 0.1 GB, and each
   arm's ms a decode step, timed plain, mesh, mesh, plain and again
   over engines built in the other order;
41. mesh_gloo2 — (right after mesh_nccl) two processes share the card as
   a world-2 gloo mesh (``python chip_smoke.py --gloo2-rank``), tp2 then
   dp2, at 2 layers of Mistral-7B's widths (int8, bf16, the lm_head cut
   to a 64-token alphabet): plain serving, spec verify, chunked prefill,
   paged prefix hits and piggyback; the ranks' streams equal, each
   feature's counter above 0, graphs off (gloo is not capturable); the
   un-meshed engine, following rank 0's draws, makes rank 0's calls in
   order, with logits within rel-L2 5e-2 of rank 0's, the first wave's
   and each feature's among them;
42. mesh_features / mesh_journal — (after mesh_serve) the mesh engine's
   features at world size 1 on the int8 Mistral-7B tensors beside the
   un-meshed engine: spec verify and chunked prefill on both caches,
   paged prefix hits, piggyback: streams and launches by body equal, the
   feature's counter above 0; then a journal on the mesh stopped after 2
   steps and warm-restarted, completions equal to an uninterrupted run's;
43. mesh_async_gloo2 — (after mesh_features) two processes share the card
   as a world-2 gloo mesh (``python chip_smoke.py --gloo2-async-rank``)
   with a 5 s groups' timeout: rank 0 serves ``summarize_async`` (8
   threads from two submitting threads, an idle gap past the timeout)
   through ``MeshEngineRunner`` and its supervisor, rank 1 follows its
   operation log (``CUDASummarizer.follow()``). tp2 at Mistral-7B's full
   width and depth (int8, bf16, 4 slots, max_len 4096): completions and
   ids equal on both ranks, the first wave's logits within rel-L2 5e-2 of
   the un-meshed engine's, K1 on wgmma and K2 on stream and wgmma on each
   rank. dp2 at 2 layers on the paged pool with the prefix cache and one
   decode fault on every rank: one containment and its replays, equal
   completions, an un-meshed replay of rank 0's log following its draws
   within rel-L2 5e-2, K3 on its decode and seeded bodies.

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
``{"ok": true, "device": {...}}``. K1's row carries ``long_s16k``, K2's
and K5's rows ``moe_cases`` (their body at the experts' shapes), and
every row the ``long_serve``, ``moe_serve_*``, ``mesh_serve*`` and
``mesh_features_*`` paths; the rows of K1's wgmma, K2's, K3's decode and
seeded and K5's bodies carry ``tp_cases`` (phase 38's shard shapes on
that body). About 16 minutes on one H100 (the host's speed varies), the
build included.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


#: the script's start: every phase line carries its ``elapsed_s`` from here
T0 = time.monotonic()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.monotonic() - T0, 3)}
        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            # what the phase leaves allocated on the card as it reports
            obj["allocated_gb"] = torch.cuda.memory_allocated() / 1e9
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
#: one pass over a SASS line finds every op of ``SASS_OPS`` in it
SASS_RE = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")


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
            for op in set(SASS_RE.findall(line)):
                cur[op] += 1
    return counts


def phase_build_info():
    """For each library with a Hopper body: ptxas's registers, spills and
    shared memory per kernel (from the build's log), the wgmma bodies'
    dynamic shared memory, and the SASS counts per kernel. Each wgmma body
    must show HGMMA and UTMALDG (tensor-core products fed by TMA); this
    slice's bodies must build without spills and without a ptxas note."""
    from concurrent.futures import ThreadPoolExecutor

    from copilot_for_consensus_tpu_torch.ops import _build

    # one cuobjdump a library, all started together
    with ThreadPoolExecutor(len(REDESIGNED)) as pool:
        all_sass = dict(zip(REDESIGNED, pool.map(
            lambda n: sass_counts(_build._target(n)), REDESIGNED)))
    for name, (body, others) in REDESIGNED.items():
        log = _build.build_log.get(name)
        lib = _build.library(name)
        sass = all_sass[name]
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
    of 100 that bites. Then the piggyback dispatch's chunk attention
    (``piggy_s64``): packed lanes, their begins and a length-0 lane. At f32
    every case runs the CUDA-core body."""
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
        # the piggyback dispatch's chunk attention at the rag2k shape: P 4
        # lanes of Sq = C = 64 at step w = 5 (q_offsets 64 w) against
        # 2048-column lane buffers — lane 0 one row from column 0, lane 1
        # a packed row from column 192, lane 2 a partial final chunk,
        # lane 3 idle (begin past the buffer, length 0: zeros)
        ("piggy_s64", 4, 32, 8, 64, 2048, 128, 0, [384, 384, 360, 0],
         [320] * 4, [0, 192, 128, 2048], True, True),
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
    # verify passes: slots x (k+1) rows — 4 x 9 + 4 (M 40) and the spec
    # preset's 32 x 9 (M 288) — at w_gate/w_up's shape and the lm_head's
    cases += [(d, f, m, "bfloat16") for d, f in ((4096, 14336),
                                                 (4096, 32000))
              for m in (40, 288)]
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
        # verify passes: R = 4 x (k+1) rows a kv head at k = 4 and 8 (one
        # 128-row tile, mostly past R), committed prefixes to ~1000
        ("verify_k4", "bfloat16", 0, 4 * 5,
         [0, 1, 64, 333, 512, 777, 960, 1000]),
        ("verify_k8", "bfloat16", 0, 4 * 9,
         [0, 1, 64, 333, 512, 777, 960, 1000]),
        # a 64-wide chunk: R = 256, first chunks (prefix 0) beside filled
        # ones
        ("chunk_s64", "bfloat16", 0, 4 * 64,
         [0, 0, 64, 128, 640, 896, 960, 0]),
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


#: new tokens a thread in the graphs phases (64 until the script outgrew
#: ~600 s: the eager engine's steps were most of their time)
GRAPHS_NEW = 32
#: the graphs phases' depth (32 until the script neared its 1200 s limit:
#: an eager step is host-bound, ~4x a replayed one; replay against eager
#: is a per-layer claim)
GRAPHS_LAYERS = 8


def cut_depth(cfg, params: dict, n_layers: int):
    """``cfg`` and ``params`` cut to their first ``n_layers`` layers (the
    stacked layer leaves sliced as views: no copy)."""
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        return x[:n_layers]

    return (decoder_config(cfg.name, n_layers=n_layers),
            {**params, "layers": cut(params["layers"])})


def phase_graphs(dev, cfg, params, smi, *, paged: bool):
    """Decode through graph replays against the eager body, on the card
    (``cfg`` and ``params`` cut to ``GRAPHS_LAYERS`` layers by the caller):
    the serve phase's 8 threads (``GRAPHS_NEW`` new tokens each) through
    two engines of the same weights and configuration, one replaying a
    CUDA graph per kv
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
            comps = eng.generate(prompts, max_new_tokens=GRAPHS_NEW)
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
    plain-version calls of its run, and what it stored. Fails if the run's
    engine outlives it (its weights would stay on the card)."""
    run, engine = _pipeline_body(ckpt, pipelined, mbox, retrieval, journal)
    gc.collect()
    if engine() is not None:
        holders = sorted({type(r).__name__
                          for r in gc.get_referrers(engine())})
        raise AssertionError(f"pipeline (pipelined {pipelined}, retrieval "
                             f"{retrieval}): the run's engine outlived it, "
                             f"held by {holders}")
    return run


def _pipeline_body(ckpt: Path, pipelined: bool, mbox: Path,
                   retrieval: bool, journal: Path | None):
    """``_pipeline_run``'s run, and a weak reference to its engine."""
    import weakref

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
    # A pipelined SummarizationService (the JAX package's, copied) keeps
    # its harvest thread for the life of the process, and the thread keeps
    # the service and, in its locals, the last summary's wait closure over
    # the summarizer: drop the service's summarizer and hand the harvester
    # a no-op item, or the run's engine (10.7 GB) outlives it on the card.
    svc = p.summarization
    svc.summarizer = None
    if pipelined:
        with svc._flight_lock:
            svc._in_flight.append((lambda: None, lambda _s: None, {}))
        svc._flight_event.set()
        svc.flush(60)
    return run, weakref.ref(summ.engine)


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
    ``CUDASummarizer``: 32 threads of 2000-2816 prompt tokens, 32 new tokens
    each (64 until the script outgrew ~600 s), weight-only; then
    ``set_act_quant("a8")`` on the same engine for 8 threads. Launch counts are reset before each round: each forward
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
    new_tokens = 32
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


def phase_trace(cfg, eng, prompts, smi, n: int = 2, label: str = "trace",
                before_measure=None):
    """Device busy and idle share of steady decode: the longest prompts
    fill the slots, in as many admission waves as the engine's token budget
    needs (one dispatch after each); after the last, ``n`` dispatches run
    on the host clock alone and the next ``n`` under ``torch.profiler``
    tracing the card's activity. Idle share = 1 - (union of the traced
    device intervals) / (host wall time of the n steps). The measured
    dispatches are graph replays: before each run of ``n``, single
    dispatches run (``warm_dispatches``, at most n + 1) until each of the
    next ``n`` lands on a kv bucket whose graph is captured, and the slots'
    prompts are cut to leave room for them. ``before_measure`` runs once
    the slots are filled, before the first warm dispatch. The engine is
    left with its slots busy: the caller discards it."""
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
    if before_measure is not None:
        before_measure()

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
    and its ``quantize_rows``). The slots fill weight-only, as the int4
    trace filled them, so the fill replays that trace's graphs; a8 starts
    with the warm dispatches, and launches are counted from there: every
    one (M <= 32) on K6's stream body, none on the split qgemm, the
    mma.sync tiling or K5."""
    from copilot_for_consensus_tpu_torch.models import quant

    def to_a8():
        quant.set_act_quant("a8")
        reset_launches()

    free_slots(eng)
    try:
        row = phase_trace(cfg, eng, prompts, smi, label="int4_a8_trace",
                          before_measure=to_a8)
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


#: the JAX bench's ``spec_decode`` preset (bench.py:92-104): contiguous
#: int8, 32 slots, max_len 896, 512-token copy-heavy prompts, 192 new
#: tokens, window 8, the engine's draft lengths
SPEC_SERVE = dict(num_slots=32, max_len=896, prefill_buckets=(512,),
                  decode_window=8, spec_draft_lens=(0, 4, 8))
SPEC_PROMPT, SPEC_NEW = 512, 192
#: the JAX bench's ``mixed_traffic`` shape (bench.py:981-1070): contiguous
#: int8 with an fp8 KV cache, 32 slots, max_len 1024, window 8, 64 new
#: tokens; 12 "analytics" batch prompts of 832 tokens at step 0, then 48
#: "chat" interactive prompts of 96 tokens, 8 a step; a 192-text embed
#: burst on minilm-l6 at step 4; the TTFT and ITL SLOs of 2.0 and 0.25 s
MIX = dict(slots=32, max_len=1024, window=8, new=64, n_long=12,
           long_len=832, n_chat=48, chat_len=96, n_embed=192, chunk=128,
           ttft_slo=2.0, itl_slo=0.25, kv="float8_e4m3fn")
#: the paged cell's engine (paged_serve's), for the paged verify and chunk
PAGED_CELL = dict(num_slots=8, max_len=4096, prefill_chunk=64,
                  kv_pool_blocks=1024, prefix_cache_blocks=1)
#: spec_chunk_f32: 2 layers at mistral-7b's widths, f32 weights and KV; the
#: lm_head keeps the columns of a 64-token alphabet the prompts are drawn
#: from, so every stream stays in its prompt's alphabet and prompt-lookup
#: drafts fire on some steps and not on others (random weights at 2 layers
#: rarely repeat a bigram over 32,000 tokens); greedy streams equal, or
#: diverging only where the top-2 logits are within STORM_F32_GAP relative
F32_LAYERS, F32_ALPHABET = 2, 64


def copy_heavy(rng, vocab: int, plen: int) -> list[int]:
    """bench.py:1401-1409's copy-heavy prompt: the back half repeats
    16-token spans of the random front half."""
    half = plen // 2
    head = rng.integers(3, vocab, size=half).tolist()
    tail: list[int] = []
    while len(tail) < plen - half:
        s0 = int(rng.integers(0, max(1, half - 16)))
        tail.extend(head[s0:s0 + 16])
    return head + tail[:plen - half]


def engine_counts(eng) -> dict:
    """The engine's dispatches so far: plain decode dispatches (graph
    replays and eager runs), verify and chunk dispatches, and its flight
    recorder's last step id."""
    g = eng.graph_stats()
    return {"plain": g["replays"] + g["eager"],
            "verify": eng.spec_dispatches, "chunk": eng.chunk_dispatches,
            "seq": eng.telemetry.recorder._seq}


def dispatches_since(eng, before: dict) -> dict:
    """Dispatches since ``before`` (``engine_counts``), with the admission
    waves by kind from the flight recorder (which must still hold every
    step since)."""
    now = engine_counts(eng)
    held = eng.telemetry.recorder.records()
    if held and held[0].seq > before["seq"] + 1:
        raise AssertionError("the flight recorder dropped steps of the "
                             "phase: raise its capacity")
    recs = [r for r in held if r.seq > before["seq"]]
    out = {k: now[k] - before[k] for k in ("plain", "verify", "chunk")}
    out["waves"] = sum(r.kind == "prefill" for r in recs)
    out["seeded_waves"] = sum(r.kind == "prefill_seeded" for r in recs)
    return out


def check_forward_passes(label: str, cfg, launches: dict, bodies: dict,
                         d: dict, window: int) -> None:
    """Every forward pass makes 7 K2 launches a layer and one for the
    lm_head: the admission waves, the verify and chunk passes, and each
    step of a plain dispatch; K1 runs once a layer in a miss wave; K3 (a
    paged engine) once a layer in each seeded wave, verify and chunk pass
    on its seeded body, and each decode step on its decode body."""
    n = cfg.n_layers
    passes = (d["waves"] + d["seeded_waves"] + d["verify"] + d["chunk"]
              + window * d["plain"])
    want = {"K2": (7 * n + 1) * passes, "K1": n * d["waves"]}
    got = {"K2": launches["K2"], "K1": bodies["K1"]["wgmma"]}
    if launches["K3"] or bodies["K3"]["seeded"] or bodies["K3"]["decode"]:
        want.update(K3_seeded=n * (d["seeded_waves"] + d["verify"]
                                   + d["chunk"]),
                    K3_decode=n * window * d["plain"])
        got.update(K3_seeded=bodies["K3"]["seeded"],
                   K3_decode=bodies["K3"]["decode"])
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want} "
                             f"from the dispatches {d}")


def _stream_stats(comps) -> dict:
    """Decode tokens and their per-request TTFT spread."""
    return {"tokens": sum(len(c.tokens) for c in comps),
            "ttft_p50_s": _pct([c.ttft_s for c in comps], 0.5),
            "ttft_p99_s": _pct([c.ttft_s for c in comps], 0.99)}


def _pct(vals, q: float) -> float:
    vals = sorted(vals)
    if not vals:
        return 0.0
    return vals[min(len(vals) - 1, max(0, round(q * (len(vals) - 1))))]


def phase_spec_serve(dev, cfg, params, smi):
    """Speculative decoding at the JAX bench's ``spec_decode`` preset
    (``SPEC_SERVE``): 32 copy-heavy prompts (numpy seed 0), 192 new tokens,
    first with ``spec_decode=True``, then on an engine of the same weights
    with it off. Per arm: ``spec_stats()``, verify dispatches and their
    seconds, plain dispatches, decode tok/s (harvested decode tokens over
    the decode and verify dispatches' seconds) and the wall. The verify
    dispatches run eagerly, the plain ones replay their graphs. The spec
    arm's launches: K1 (waves) and K2 only, every K2 launch on the wgmma
    body (M = 32 rows or more: decode 32, verify 32 x (k+1), waves), 225 a
    forward pass, no plain version. bf16 greedy is not bit-stable across
    different passes: the streams equal between the arms are counted, not
    gated. Returns the spec arm's launches and bodies."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )

    rng = np.random.default_rng(0)
    prompts = [copy_heavy(rng, cfg.vocab_size, SPEC_PROMPT)
               for _ in range(SPEC_SERVE["num_slots"])]
    arms, out = {}, {}
    for name, spec in (("spec", True), ("plain", False)):
        eng = GenerationEngine(cfg, params, quantize="int8", device=dev,
                               spec_decode=spec, **SPEC_SERVE)
        before = engine_counts(eng)
        reset_launches()
        with plain_calls() as plain:
            t0 = time.monotonic()
            comps = eng.generate(prompts, SPEC_NEW)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        launches, bodies = read_launches(), read_bodies()
        d = dispatches_since(eng, before)
        dec = eng.decode_tokens
        arms[name] = {
            "wall_s": wall, "dispatches": d,
            "decode_s": eng.decode_s, "decode_tokens": dec,
            "decode_tok_per_s": dec / eng.decode_s,
            "verify_s": eng.spec_s,
            "verify_ms_each": (eng.spec_s * 1e3 / d["verify"]
                               if d["verify"] else None),
            "plain_ms_each": ((eng.decode_s - eng.spec_s) * 1e3 / d["plain"]
                              if d["plain"] else None),
            "admitted_s": eng.admitted_s, **_stream_stats(comps),
            "spec_stats": eng.spec_stats(), "graphs": eng.graph_stats(),
            "launches": launches, "launches_by_body": bodies,
            "plain_calls": dict(plain)}
        out[name] = ([c.tokens for c in comps], launches, bodies, d,
                     eng._dispatch_steps)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    tokens, launches, bodies, d, _ = out["spec"]
    row = {"phase": "spec_serve", "config": cfg.name, **SPEC_SERVE,
           "prompt_tokens": SPEC_PROMPT, "new_tokens": SPEC_NEW,
           "arms": arms,
           "streams_equal": sum(a == b for a, b in zip(tokens,
                                                        out["plain"][0])),
           "streams": len(tokens), "device": smi}
    emit(row)
    st = arms["spec"]["spec_stats"]
    if not (st["verify_dispatches"] and st["accepted_tokens"]) or \
            arms["spec"]["plain_calls"] or arms["plain"]["plain_calls"]:
        raise AssertionError(f"spec_serve: no verify dispatch accepted a "
                             f"draft, or a plain version ran: {arms}")
    for name in arms:
        check_path(f"spec_serve {name}", out[name][1], ("K1", "K2"))
        check_bodies(f"spec_serve {name}", out[name][2])
        check_forward_passes(f"spec_serve {name}", cfg, *out[name][1:])
    if bodies["K2"]["stream"]:
        raise AssertionError(f"spec_serve: K2 launches off the wgmma body "
                             f"at 32 rows: {bodies['K2']}")
    return launches, bodies


def phase_sched_serve(dev, cfg, params, smi):
    """The scheduler at the JAX bench's ``mixed_traffic`` shape (``MIX``):
    all 12 long batch-lane prompts ("analytics") arrive at step 0, ahead
    of 48 short interactive chats ("chat", 8 a step), and a 192-text embed
    burst on ``minilm-l6`` contends at step 4. The same scripted arrivals
    run with the scheduler (chunked prefill of 128 tokens, 512 prompt
    tokens released a step, weighted DRR chat 2 : analytics 1, shedding at
    queue depths 32 / 48, the SLOs of the preset; one ``Scheduler`` shared
    with the embedding engine, which sizes its tiles) and without it
    (FIFO, monolithic waves), each after a warm request of each class.
    Per arm: chat and long TTFT p50/p99, ITL p95/p99 (the engine's
    telemetry), chunk dispatches and tokens, shed count, the fairness
    index over the timed window, the embed tiles, and decode tok/s; the
    streams of requests both arms completed are counted equal (bf16, not
    gated). Launches: K1 and K2 only, 225 K2 a forward pass, no plain
    version, no old body. Returns the scheduler arm's launches and
    bodies."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine.embedding import (
        EmbeddingEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.scheduler import (
        EngineOverloaded,
        SchedulerConfig,
        jain_index,
    )
    from copilot_for_consensus_tpu_torch.models.configs import (
        encoder_config,
    )

    m = MIX
    rng = np.random.default_rng(0)
    script = [(0, i, "analytics", "batch",
               rng.integers(3, cfg.vocab_size, size=m["long_len"]).tolist())
              for i in range(m["n_long"])]
    script += [(1 + i // 8, m["n_long"] + i, "chat", "interactive",
                rng.integers(3, cfg.vocab_size, size=m["chat_len"]).tolist())
               for i in range(m["n_chat"])]
    texts = [f"mixed traffic embed text {i} corpus chunk " * 4
             for i in range(m["n_embed"])]
    emb_cfg = encoder_config("minilm-l6")
    emb_params = None
    arms, outs, paths = {}, {}, {}
    for name, on in (("sched", True), ("fifo", False)):
        sched = SchedulerConfig(
            chunk_tokens=m["chunk"], prefill_wave_tokens=4 * m["chunk"],
            quantum_tokens=m["chunk"],
            tenant_weights={"chat": 2.0, "analytics": 1.0},
            max_queue_depth=48, batch_shed_depth=32,
            ttft_p99_slo_s=4 * m["ttft_slo"],
            queue_wait_p95_slo_s=2 * m["ttft_slo"]) if on else None
        eng = GenerationEngine(
            cfg, params, num_slots=m["slots"], max_len=m["max_len"],
            prefill_buckets=tuple(sorted({m["chat_len"], m["chunk"],
                                          m["long_len"]})),
            kv_dtype=m["kv"], quantize="int8", decode_window=m["window"],
            scheduler=sched, device=dev)
        emb = EmbeddingEngine(emb_cfg, emb_params, seed=0,
                              dtype=torch.bfloat16, batch_size=32,
                              scheduler=eng._sched if on else None,
                              device=dev)
        emb_params = emb.params
        tiles: list = []
        if on:
            admit = eng._sched.embed_admit

            def sized(*a, _admit=admit, **kw):
                tiles.append(_admit(*a, **kw))
                return tiles[-1]
            eng._sched.embed_admit = sized
        # warm: one request of each class, and the encoder
        warm = {eng.submit(rng.integers(3, cfg.vocab_size,
                                        size=plen).tolist(), m["new"],
                           tenant=tenant, priority=prio)
                for plen, tenant, prio in ((m["long_len"], "analytics",
                                            "batch"),
                                           (m["chat_len"], "chat",
                                            "interactive"))}
        while warm:
            warm -= {c.request_id for c in eng.step()}
        emb.embed_batch(texts[:4], tenant="ingest")
        tiles.clear()
        fair0 = dict(eng._sched.fairness_snapshot()) if on else {}
        n_traces0 = len(eng.telemetry.completed)
        before = engine_counts(eng)
        chunk0 = (eng.chunk_dispatches, eng.chunk_prefill_tokens,
                  eng.chunk_s)
        dec0 = (eng.decode_s, eng.decode_tokens)
        reset_launches()
        done, shed, rid_idx, comps = 0, 0, {}, {}
        pending = sorted(script, key=lambda x: x[:2])
        step, embed_s, embed_shed, enc_k1 = 0, None, False, {}
        with plain_calls() as plain:
            t0 = time.monotonic()
            while done + shed < len(script) and step < 5000:
                while pending and pending[0][0] <= step:
                    _, idx, tenant, prio, prompt = pending.pop(0)
                    try:
                        rid_idx[eng.submit(prompt, m["new"], tenant=tenant,
                                           priority=prio)] = idx
                    except EngineOverloaded:
                        shed += 1
                if step == 4:
                    # K1's d32 body runs here; its launches are the
                    # encoder's, outside the engine's accounting
                    e0 = time.monotonic()
                    k1 = dict(read_bodies()["K1"])
                    try:
                        emb.embed_batch(texts, tenant="ingest")
                    except EngineOverloaded:
                        embed_shed = True
                    torch.cuda.synchronize()
                    embed_s = time.monotonic() - e0
                    enc_k1 = {b: n - k1[b]
                              for b, n in read_bodies()["K1"].items()}
                for c in eng.step():
                    comps[rid_idx[c.request_id]] = c
                    done += 1
                step += 1
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        launches, bodies = read_launches(), read_bodies()
        # the encoder's d32 launches are its own: the engine's K1 is wgmma
        launches["K1"] -= sum(enc_k1.values())
        for b, n in enc_k1.items():
            bodies["K1"][b] -= n
        d = dispatches_since(eng, before)
        traces = list(eng.telemetry.completed)[n_traces0:]
        itls = [t.itl_s for t in traces if t.new_tokens > 1]
        long_c = [c for i, c in comps.items() if i < m["n_long"]]
        chat_c = [c for i, c in comps.items() if i >= m["n_long"]]
        row = {"wall_s": wall, "steps": step, "completed": done,
               "shed": shed, "dispatches": d,
               "chat": _stream_stats(chat_c), "long": _stream_stats(long_c),
               "itl_p95_s": _pct(itls, 0.95), "itl_p99_s": _pct(itls, 0.99),
               "chunk_dispatches": eng.chunk_dispatches - chunk0[0],
               "chunk_tokens": eng.chunk_prefill_tokens - chunk0[1],
               "chunk_s": eng.chunk_s - chunk0[2],
               "decode_tok_per_s": (eng.decode_tokens - dec0[1])
               / (eng.decode_s - dec0[0]),
               "embed_s": embed_s, "embed_shed": embed_shed,
               "embed_tiles": list(tiles),
               "encoder_k1": enc_k1, "plain_calls": dict(plain),
               "launches": launches, "launches_by_body": bodies,
               "graphs": eng.graph_stats()}
        if on:
            st = eng.sched_stats()
            fair1 = eng._sched.fairness_snapshot()
            deltas = [v - fair0.get(t, 0.0) for t, v in fair1.items()
                      if v - fair0.get(t, 0.0) > 0]
            row.update(fairness_jain_index=round(jain_index(deltas), 4),
                       sched_stats=st)
        arms[name] = row
        outs[name] = {i: c.tokens for i, c in comps.items()}
        paths[name] = (launches, bodies, d, eng._dispatch_steps)
        del eng, emb
        gc.collect()
        torch.cuda.empty_cache()
    common = set(outs["sched"]) & set(outs["fifo"])
    emit({"phase": "sched_serve", "config": cfg.name, **MIX, "arms": arms,
          "common": len(common),
          "streams_equal": sum(outs["sched"][i] == outs["fifo"][i]
                               for i in common), "device": smi})
    for name, (launches, bodies, d, steps) in paths.items():
        if arms[name]["plain_calls"]:
            raise AssertionError(f"sched_serve {name}: a plain version ran")
        check_path(f"sched_serve {name}", launches, ("K1", "K2"))
        check_bodies(f"sched_serve {name}", bodies)
        check_forward_passes(f"sched_serve {name}", cfg, launches, bodies,
                             d, steps)
    if not arms["sched"]["chunk_dispatches"] or \
            arms["sched"]["completed"] + arms["sched"]["shed"] != \
            len(script) or arms["fifo"]["completed"] != len(script):
        raise AssertionError(f"sched_serve: {arms}")
    return paths["sched"][0], paths["sched"][1]


def phase_paged_spec_chunk(dev, cfg, params, smi):
    """The paged cell's engine (``PAGED_CELL``, int8, bf16) with its two
    new dispatches, each on an engine of its own: ``paged_spec``, spec
    decoding over 8 copy-heavy prompts of 512 tokens (128 new tokens);
    ``paged_chunk``, ``SchedulerConfig(chunk_tokens=64)`` over 8 cache-miss
    prompts of 300-1000 tokens (32 new tokens), every one chunked. K3 runs
    the verify and chunk passes on its seeded body (R = 4 x (k+1) = 20 or
    36, and 4 x 64 = 256 rows a kv head: 128-row tiles mostly past R),
    decode on its decode body, never its CUDA-core body; no plain version;
    the pool's books balance after. Streams against the same engine with
    the feature off are counted (bf16, not gated). Returns {phase:
    (launches, bodies)}."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.scheduler import (
        SchedulerConfig,
    )

    rng = np.random.default_rng(1)
    runs = {
        "paged_spec": (dict(spec_decode=True), 128,
                       [copy_heavy(rng, cfg.vocab_size, 512)
                        for _ in range(8)]),
        "paged_chunk": (dict(scheduler=SchedulerConfig(chunk_tokens=64)), 32,
                        [rng.integers(3, cfg.vocab_size, size=n).tolist()
                         for n in np.linspace(300, 1000, 8).astype(int)]),
    }
    out = {}
    for label, (kw, new, prompts) in runs.items():
        rows = {}
        for arm, extra in (("on", kw), ("off", {})):
            eng = GenerationEngine(cfg, params, quantize="int8", device=dev,
                                   **PAGED_CELL, **extra)
            before = engine_counts(eng)
            reset_launches()
            with plain_calls() as plain:
                t0 = time.monotonic()
                comps = eng.generate(prompts, new)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            launches, bodies = read_launches(), read_bodies()
            d = dispatches_since(eng, before)
            pool = eng.kv_pool_stats()
            rows[arm] = {"wall_s": wall, "dispatches": d,
                         "decode_s": eng.decode_s, "verify_s": eng.spec_s,
                         "chunk_s": eng.chunk_s,
                         "decode_tok_per_s": eng.decode_tokens
                         / eng.decode_s,
                         **_stream_stats(comps),
                         "spec_stats": eng.spec_stats(),
                         "sched_stats": eng.sched_stats(),
                         "plain_calls": dict(plain),
                         "launches": launches, "launches_by_body": bodies,
                         "pool_free": pool["free_blocks"],
                         "pool_pinned": pool["pinned_blocks"],
                         "pool_blocks": pool["num_blocks"]}
            rows[arm]["_"] = ([c.tokens for c in comps], launches, bodies,
                              d, eng._prefix.node_count,
                              eng._dispatch_steps)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        tokens_on, launches, bodies, d, nodes, steps = rows["on"].pop("_")
        tokens_off = rows["off"].pop("_")[0]
        emit({"phase": label, "config": cfg.name, **{
            k: v for k, v in PAGED_CELL.items()}, "new_tokens": new,
            "prompt_tokens": [len(p) for p in prompts], "arms": rows,
            "streams_equal": sum(a == b for a, b in zip(tokens_on,
                                                         tokens_off)),
            "device": smi})
        on = rows["on"]
        fired = d["verify"] if label == "paged_spec" else d["chunk"]
        if not fired or on["plain_calls"] or bodies["K3"]["simt"] or \
                on["pool_free"] + on["pool_pinned"] != on["pool_blocks"] \
                or on["pool_pinned"] != nodes:
            raise AssertionError(f"{label}: {on}")
        used = ("K2", "K3") if label == "paged_chunk" else ("K1", "K2",
                                                             "K3")
        check_path(label, launches, used)
        check_bodies(label, bodies)
        check_forward_passes(label, cfg, launches, bodies, d, steps)
        out[label] = (launches, bodies)
    return out


def phase_spec_chunk_f32(dev, smi):
    """The reference's bit-identity claims on the card, at f32: 2 layers
    at mistral-7b's widths (seed-0 f32 weights, f32 KV; the lm_head keeps
    ``F32_ALPHABET`` columns, the prompts' alphabet, so drafts fire),
    greedy. Speculation on equals off, stream for stream, and chunked
    prefill (64 tokens) equals monolithic admission, on the contiguous
    cache and on the paged pool, every decode dispatch after the first a
    graph replay — so a replay right after a verify that rewound a slot
    must read the right tokens and positions (such replays are counted,
    ``decode_after_rewind``, and must occur). A divergence passes only
    where the top-2 logits of the diverging step are within
    ``STORM_F32_GAP`` relative (f32 sums in another order). The verify and
    chunk dispatches must fire; no plain version runs."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.scheduler import (
        SchedulerConfig,
    )
    from copilot_for_consensus_tpu_torch.models import decoder
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    cfg = decoder_config("mistral-7b", n_layers=F32_LAYERS)
    params = decoder.init_params(cfg, seed=0, dtype=torch.float32,
                                 device=dev)
    rng = np.random.default_rng(2)
    alphabet = rng.choice(np.arange(3, cfg.vocab_size), F32_ALPHABET,
                          replace=False)
    keep = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=dev)
    keep[torch.from_numpy(alphabet).to(dev)] = True
    params["lm_head"] = params["lm_head"] * keep
    spec_prompts = [rng.choice(alphabet, 320).tolist() for _ in range(8)]
    long_prompts = [rng.choice(alphabet, n).tolist()
                    for n in (300, 90, 512, 200, 700, 64, 450, 130)]
    layouts = {"contiguous": dict(num_slots=8, max_len=1024),
               "paged": dict(num_slots=8, max_len=1024, prefill_chunk=64,
                             kv_pool_blocks=8 * 16 + 16)}
    rows = {}
    with plain_calls() as plain:
        for lay, base in layouts.items():
            for feat, kw, prompts, new in (
                    ("spec", dict(spec_decode=True), spec_prompts, 96),
                    ("chunk", dict(scheduler=SchedulerConfig(
                        chunk_tokens=64)), long_prompts, 24)):
                got = GenerationEngine(cfg, params, dtype="float32",
                                       device=dev, **base, **kw)
                on = got.generate(prompts, new)
                ref = GenerationEngine(cfg, params, dtype="float32",
                                       device=dev, **base)
                off = ref.generate(prompts, new)
                # plain dispatches (replays once captured) that follow a
                # verify which rewound a slot (accepted < drafted)
                kinds = got.telemetry.recorder.as_dicts()
                after_rewind = sum(
                    cur["kind"] == "decode" and prev["kind"] == "verify"
                    and prev["accepted_tokens"] < prev["draft_tokens"]
                    for prev, cur in zip(kinds, kinds[1:]))
                gaps = {}
                for i, (a, b) in enumerate(zip(off, on)):
                    if a.tokens != b.tokens:
                        j = next(k for k in range(min(len(a.tokens),
                                                      len(b.tokens)) + 1)
                                 if k == min(len(a.tokens), len(b.tokens))
                                 or a.tokens[k] != b.tokens[k])
                        gaps[i] = _top2_gap(params, cfg, prompts[i],
                                            a.tokens[:j])
                rows[f"{lay}_{feat}"] = {
                    "streams": len(on),
                    "equal": sum(a.tokens == b.tokens
                                 for a, b in zip(off, on)),
                    "divergent_top2_gap": gaps,
                    "verify_dispatches": got.spec_dispatches,
                    "accepted": got.spec_accepted_tokens,
                    "chunk_dispatches": got.chunk_dispatches,
                    "decode_after_rewind": after_rewind,
                    "graphs": got.graph_stats()}
                del got, ref
                gc.collect()
    emit({"phase": "spec_chunk_f32", "layers": F32_LAYERS,
          "alphabet": F32_ALPHABET, "runs": rows,
          "gap_limit": STORM_F32_GAP, "plain_calls": dict(plain),
          "device": smi})
    for key, r in rows.items():
        fired = r["verify_dispatches"] if key.endswith("spec") \
            else r["chunk_dispatches"]
        if not fired or not r["graphs"]["replays"] or \
                any(g >= STORM_F32_GAP for g in r["divergent_top2_gap"]
                    .values()):
            raise AssertionError(f"spec_chunk_f32 {key}: {r}")
    if not sum(r["decode_after_rewind"] for r in rows.values()):
        raise AssertionError(f"spec_chunk_f32: no plain dispatch followed "
                             f"a verify that rewound a slot: {rows}")
    if plain:
        raise AssertionError(f"spec_chunk_f32: a plain version ran: {plain}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


#: the JAX bench's ``rag2k`` preset with ``BENCH_PIGGYBACK=1``
#: (bench.py:67-70, :2876-2882): contiguous int8, 32 slots, max_len 2304,
#: 2048-token prompts, window 32, prefill_chunk 64, prefill_rows 4, prompts
#: of 512 tokens or more piggyback; new tokens cut to 32 (one window)
PIGGY = dict(num_slots=32, max_len=2304, prefill_buckets=(2048,),
             decode_window=32, prefill_chunk=64, prefill_rows=4)
PIGGY_PROMPT, PIGGY_NEW, PIGGY_MIN = 2048, 32, 512
#: the JAX bench's ``shared_prefix`` preset (bench.py:86-91) on the
#: contiguous cache: 32 slots, max_len 768, 512-token prompts opening with
#: one shared 384-token span, a 64-block prefix pool, window 32; a cold
#: round and a repeat round of 32 new tokens each
PREFIX = dict(num_slots=32, max_len=768, prefill_buckets=(128, 512),
              decode_window=32, prefix_cache_blocks=64)
PREFIX_PROMPT, PREFIX_SHARED, PREFIX_NEW = 512, 384, 32
#: the holds phase: 8 arrivals one a step into an idle 32-slot batch, a
#: strict hold of 4 rows (the wait bound far past the phase)
HOLDS = dict(num_slots=32, max_len=1024, prefill_buckets=(256,),
             decode_window=8, admit_min_rows=4, admit_hold_strict=True,
             admit_max_wait_s=600.0)


def piggy_check(label: str, cfg, launches: dict, bodies: dict, d: dict,
                piggy: int, window: int) -> None:
    """Launch counts a piggyback run must show: a wave is one forward pass
    (7 K2 launches a layer and one for the lm_head, K1 once a layer); a
    piggyback dispatch is ``window`` steps of one forward pass over the
    decode and chunk rows each (K1 once a layer a step, for the chunks)
    and one more lm_head for the placed rows' first tokens; a plain
    dispatch ``window`` decode passes."""
    n = cfg.n_layers
    want = {"K1": n * (d["waves"] + window * piggy),
            "K2": (7 * n + 1) * (d["waves"] + window * (d["plain"] + piggy))
            + piggy}
    got = {"K1": bodies["K1"]["wgmma"], "K2": launches["K2"]}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want} "
                             f"from {d} and {piggy} piggyback dispatches")


def phase_piggy_serve(dev, cfg, params, smi):
    """Piggyback prefill at the rag2k shape (``PIGGY``): 32 prompts of 2048
    tokens (numpy seed 0) submitted at once, 32 new tokens, piggyback on
    (``piggyback_min_prompt`` 512: whole prompts ride the decode
    dispatches, up to two dispatches' backlog; the wave takes the rest)
    then off (every prompt in waves), each on an engine of its own. Per
    arm: the waves, piggyback and plain dispatches and their seconds,
    ``piggy_tokens``, admission-to-first-token (TTFT p50/p99), decode
    tok/s over the decode dispatches' seconds, the wall. The piggyback
    dispatches run eagerly: M = 32 + 4 x 64 = 288 rows a projection (K2's
    wgmma body) and one K1 call a layer a step over the lanes' 2048-column
    buffers. Streams equal between the arms are counted (bf16, not
    gated). Returns the piggyback arm's launches and bodies."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )

    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, size=PIGGY_PROMPT).tolist()
               for _ in range(PIGGY["num_slots"])]
    arms, out = {}, {}
    for name, low in (("piggyback", PIGGY_MIN), ("wave", 10**9)):
        eng = GenerationEngine(cfg, params, quantize="int8", device=dev,
                               piggyback_min_prompt=low, **PIGGY)
        before = engine_counts(eng)
        reset_launches()
        with plain_calls() as plain:
            t0 = time.monotonic()
            comps = eng.generate(prompts, PIGGY_NEW)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        launches, bodies = read_launches(), read_bodies()
        d = dispatches_since(eng, before)
        arms[name] = {
            "wall_s": wall, "dispatches": d,
            "piggy_dispatches": eng.piggy_dispatches,
            "piggy_s": eng.piggy_s, "piggy_rows": eng.piggy_rows,
            "piggy_tokens": eng.piggy_tokens,
            "piggy_ms_each": (eng.piggy_s * 1e3 / eng.piggy_dispatches
                              if eng.piggy_dispatches else None),
            "plain_ms_each": (eng.plain_s * 1e3 / eng.plain_dispatches
                              if eng.plain_dispatches else None),
            "admitted_s": eng.admitted_s, "decode_s": eng.decode_s,
            "decode_tokens": eng.decode_tokens,
            "decode_tok_per_s": eng.decode_tokens / eng.decode_s,
            "prefill_tokens": eng.prefill_tokens,
            "total_tok_per_s": (eng.prefill_tokens + eng.decode_tokens)
            / wall, **_stream_stats(comps),
            "plain_calls": dict(plain), "launches": launches,
            "launches_by_body": bodies}
        out[name] = ([c.tokens for c in comps], launches, bodies, d,
                     eng.piggy_dispatches, eng._dispatch_steps)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "piggy_serve", "config": cfg.name, **PIGGY,
          "prompt_tokens": PIGGY_PROMPT, "new_tokens": PIGGY_NEW,
          "piggyback_min_prompt": PIGGY_MIN, "arms": arms,
          "streams_equal": sum(a == b for a, b in zip(out["piggyback"][0],
                                                       out["wave"][0])),
          "streams": len(prompts), "device": smi})
    if not arms["piggyback"]["piggy_tokens"] or arms["wave"]["piggy_tokens"]:
        raise AssertionError(f"piggy_serve: piggy_tokens {arms}")
    for name in arms:
        if arms[name]["plain_calls"]:
            raise AssertionError(f"piggy_serve {name}: a plain version ran")
        _, launches, bodies, d, piggy, window = out[name]
        check_path(f"piggy_serve {name}", launches, ("K1", "K2"))
        check_bodies(f"piggy_serve {name}", bodies)
        piggy_check(f"piggy_serve {name}", cfg, launches, bodies, d, piggy,
                    window)
    return out["piggyback"][1], out["piggyback"][2]


def phase_prefix_serve(dev, cfg, params, smi):
    """The contiguous engine's prefix cache at the shared_prefix preset
    (``PREFIX``): 32 prompts of 512 tokens opening with one shared
    384-token span (numpy seed 0), a cold round then the same prompts
    again, 32 new tokens each. Per round: prompt tokens prefilled and
    saved, hits and the hit rate, the admission waves (the cold one a miss
    wave on K1, the repeat one a seeded wave: the matched blocks gathered
    from the pool, the suffix against them in plain attention, as the JAX
    engine's is plain XLA), TTFT p50/p99 (the re-summary TTFT in the
    repeat round), decode tok/s. The repeat round must hit on every row
    and save prefill tokens; the pool's books must hold. Streams equal
    between the rounds are counted (bf16: a seeded pass is not the full
    pass bit for bit). Returns the repeat round's launches and bodies."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )

    rng = np.random.default_rng(0)
    common = rng.integers(3, cfg.vocab_size, size=PREFIX_SHARED).tolist()
    prompts = [common + rng.integers(
        3, cfg.vocab_size, size=PREFIX_PROMPT - PREFIX_SHARED).tolist()
        for _ in range(PREFIX["num_slots"])]
    eng = GenerationEngine(cfg, params, quantize="int8", device=dev,
                           **PREFIX)
    rounds, out = {}, {}
    for rname in ("cold", "repeat"):
        st0, g0 = eng.prefix_stats(), eng.graph_stats()
        before = engine_counts(eng)
        dec0 = (eng.decode_s, eng.decode_tokens)
        reset_launches()
        with plain_calls() as plain:
            t0 = time.monotonic()
            comps = eng.generate(prompts, PREFIX_NEW)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        launches, bodies = read_launches(), read_bodies()
        d = dispatches_since(eng, before)
        st = eng.prefix_stats()
        delta = {k: st[k] - st0[k] for k in (
            "lookups", "hits", "prefill_tokens", "prefill_tokens_saved",
            "blocks_published", "blocks_evicted")}
        dec_s, dec_t = (eng.decode_s - dec0[0], eng.decode_tokens - dec0[1])
        rounds[rname] = {
            "wall_s": wall, "dispatches": d, **delta,
            "hit_rate": delta["hits"] / delta["lookups"],
            **_stream_stats(comps), "decode_tok_per_s": dec_t / dec_s,
            "blocks_in_use": st["blocks_in_use"],
            "publish_failures": st["publish_failures"],
            # the decode seconds hold this round's eager warm-up or
            # captures: compare tok/s only where both are replays
            "graphs": {k: eng.graph_stats()[k] - g0[k]
                       for k in ("captured", "capture_s", "eager",
                                 "replays")},
            "plain_calls": dict(plain), "launches": launches,
            "launches_by_body": bodies}
        out[rname] = ([c.tokens for c in comps], launches, bodies, d)
    emit({"phase": "prefix_serve", "config": cfg.name, **PREFIX,
          "prompt_tokens": PREFIX_PROMPT, "shared_tokens": PREFIX_SHARED,
          "new_tokens": PREFIX_NEW, "rounds": rounds,
          "streams_equal": sum(a == b for a, b in zip(out["cold"][0],
                                                       out["repeat"][0])),
          "streams": len(prompts), "device": smi})
    rep = rounds["repeat"]
    # every row hits at least the shared span's whole blocks
    shared_blocks = PREFIX_SHARED // eng.prefill_chunk * eng.prefill_chunk
    if (rep["hits"] != len(prompts) or rep["prefill_tokens_saved"] <
            len(prompts) * shared_blocks or rep["publish_failures"]
            or rep["blocks_in_use"] > PREFIX["prefix_cache_blocks"]):
        raise AssertionError(f"prefix_serve: {rounds}")
    for rname, used in (("cold", ("K1", "K2")), ("repeat", ("K2",))):
        if rounds[rname]["plain_calls"]:
            raise AssertionError(f"prefix_serve {rname}: a plain version "
                                 f"ran")
        _, launches, bodies, d = out[rname]
        check_path(f"prefix_serve {rname}", launches, used)
        check_bodies(f"prefix_serve {rname}", bodies)
        check_forward_passes(f"prefix_serve {rname}", cfg, launches, bodies,
                             d, eng._dispatch_steps)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out["repeat"][1], out["repeat"][2]


def phase_holds(dev, cfg, params, smi):
    """The admission holds (``HOLDS``): 8 prompts of 200 tokens arrive one
    a step (one ``step()`` each) into an idle batch with a strict hold of
    4 rows: the waves must take them 4 and 4. Reports the wave sizes from
    the flight recorder, each request's TTFT (the held ones wait for their
    wave) and the steps taken. Returns the launches and bodies."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )

    rng = np.random.default_rng(3)
    eng = GenerationEngine(cfg, params, quantize="int8", device=dev,
                           **HOLDS)
    before = engine_counts(eng)
    reset_launches()
    done = []
    with plain_calls() as plain:
        t0 = time.monotonic()
        for i in range(8):
            eng.submit(rng.integers(3, cfg.vocab_size, size=200).tolist(),
                       16)
            done += eng.step()
        steps = 8
        while len(done) < 8:
            done += eng.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches, bodies = read_launches(), read_bodies()
    d = dispatches_since(eng, before)
    waves = [r.rows for r in eng.telemetry.recorder.records()
             if r.kind == "prefill" and r.seq > before["seq"]]
    emit({"phase": "holds", "config": cfg.name, **HOLDS, "arrivals": 8,
          "waves": waves, "steps": steps, "wall_s": wall,
          "ttft_s": [c.ttft_s for c in sorted(done,
                                              key=lambda c: c.request_id)],
          "plain_calls": dict(plain), "launches": launches,
          "launches_by_body": bodies, "device": smi})
    if waves != [4, 4] or plain:
        raise AssertionError(f"holds: waves {waves}, plain calls {plain}")
    check_path("holds", launches, ("K1", "K2"))
    check_bodies("holds", bodies)
    check_forward_passes("holds", cfg, launches, bodies, d,
                         eng._dispatch_steps)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, bodies


@contextlib.contextmanager
def first_logits(n: int = 2):
    """The logits of the engine module's first ``n`` ``sample`` calls in
    the block, copied to the host (yielded list); later calls pass
    through. The first calls are an admission wave's and the first eager
    decode step's: no graph is captured before them."""
    from copilot_for_consensus_tpu_torch.engine import generation

    got: list = []
    plain_sample = generation.sample

    def recording(logits, gen, sampling):
        if len(got) < n:
            got.append(logits.float().cpu())
        return plain_sample(logits, gen, sampling)

    with patched(generation, "sample", recording):
        yield got


def phase_gather_route(dev, cfg, params, smi):
    """The paged cell's engine (``PAGED_CELL``, int8, bf16) on its two
    routes: ``kv_kernel="reference"`` (the gather route: every dispatch
    gathers the working-set view, runs the contiguous program over it and
    scatters the merged columns back; decode under graphs as on the K3
    route) and ``"auto"`` (K3 in place), each serving paged_serve's round
    1 (8 synthetic threads through CUDASummarizer, all misses, 64 new
    tokens), then round 2 (the same threads: every row a prefix hit, the
    seeded wave; the decode buckets already captured). Reports the
    streams equal between the routes in round 1, the rel-L2 of round 1's
    first decode step logits (the same first tokens and prompt KV on
    both: only the route differs), and per round the decode ms a step,
    the wave seconds and the graphs captured in it. The gather route must
    launch no K3 call and no plain version in either round. Returns the
    gather route's launches and bodies (both rounds)."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    threads = synthetic_threads(8)
    arms, out = {}, {}
    for name, route in (("gather", "reference"), ("k3", "auto")):
        eng = GenerationEngine(cfg, params, quantize="int8", device=dev,
                               kv_kernel=route, **PAGED_CELL)
        summ = CUDASummarizer(cfg.name, engine=eng, max_new_tokens=64)
        comps = _recorded(summ)
        before = engine_counts(eng)
        reset_launches()
        rounds = {}
        with plain_calls() as plain:
            for rname in ("round1", "round2"):
                g0, n0 = eng.graph_stats(), len(comps)
                s0 = (eng.decode_s, eng.decode_tokens, eng.admitted_s,
                      engine_counts(eng))
                # round 1's first two samples (the wave's, the first
                # decode step's) run eagerly: no capture records them
                with (first_logits() if rname == "round1"
                      else contextlib.nullcontext([])) as logits:
                    t0 = time.monotonic()
                    summ.summarize_batch(threads)
                    torch.cuda.synchronize()
                    wall = time.monotonic() - t0
                g = eng.graph_stats()
                dec_s = eng.decode_s - s0[0]
                steps = (engine_counts(eng)["plain"] - s0[3]["plain"]) \
                    * eng._dispatch_steps
                rounds[rname] = {
                    "wall_s": wall, "decode_s": dec_s,
                    "decode_ms_per_step": dec_s * 1e3 / steps,
                    "decode_tok_per_s": (eng.decode_tokens - s0[1]) / dec_s,
                    "wave_s": eng.admitted_s - s0[2],
                    "captured": g["captured"] - g0["captured"],
                    "capture_s": g["capture_s"] - g0["capture_s"],
                    "eager": g["eager"] - g0["eager"],
                    "replays": g["replays"] - g0["replays"],
                    **_stream_stats(comps[n0:])}
                if rname == "round1":
                    first = (logits, [c.tokens for c in comps[n0:]])
        launches, bodies = read_launches(), read_bodies()
        d = dispatches_since(eng, before)
        arms[name] = {"route": eng._kv_route, "rounds": rounds,
                      "dispatches": d,
                      "zero_copy_admits": eng.zero_copy_admits,
                      "plain_calls": dict(plain), "launches": launches,
                      "launches_by_body": bodies}
        out[name] = (first, launches, bodies, d, eng._dispatch_steps)
        del summ, eng
        gc.collect()
        torch.cuda.empty_cache()
    (lg_g, tok_g), (lg_k, tok_k) = out["gather"][0], out["k3"][0]
    rel = [float((a - b).norm() / b.norm()) for a, b in zip(lg_g, lg_k)]
    emit({"phase": "gather_route", "config": cfg.name, **PAGED_CELL,
          "threads": len(threads), "new_tokens": 64, "arms": arms,
          "round1_streams_equal": sum(a == b for a, b in zip(tok_g, tok_k)),
          "streams": len(threads),
          "logits_rel_l2": {"wave": rel[0], "decode_step0": rel[1]},
          "device": smi})
    if rel[1] > 5e-2 or rel[0] > 1e-6:
        raise AssertionError(f"gather_route: logits rel-L2 {rel}")
    for name, used in (("gather", ("K1", "K2")), ("k3", ("K1", "K2", "K3"))):
        if arms[name]["plain_calls"] or \
                arms[name]["zero_copy_admits"] != len(threads):
            raise AssertionError(f"gather_route {name}: {arms[name]}")
        _, launches, bodies, d, steps = out[name]
        check_path(f"gather_route {name}", launches, used)
        check_bodies(f"gather_route {name}", bodies)
        check_forward_passes(f"gather_route {name}", cfg, launches, bodies,
                             d, steps)
    return out["gather"][1], out["gather"][2]


def _roles_run(cfg, params, dev, prompts, new, engine_kw):
    """A co-located paged engine's completions, then a DisaggregatedEngine
    with both roles on ``dev`` over the same prompts: (co-located
    completions, role completions, the role engine's stats, launches,
    bodies, wall seconds of the role run)."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.roles import (
        DisaggregatedEngine,
    )

    co = GenerationEngine(cfg, params, device=dev, **engine_kw)
    want = co.generate(prompts, new)
    co_tok_per_s = co.decode_tokens / co.decode_s
    del co
    gc.collect()
    torch.cuda.empty_cache()
    dis = DisaggregatedEngine(cfg, params, devices=[dev, dev],
                              engine_kw=engine_kw)
    reset_launches()
    t0 = time.monotonic()
    got = dis.generate(prompts, new)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, bodies = read_launches(), read_bodies()
    st = dis.stats()
    st.update(colocated_decode_tok_per_s=co_tok_per_s,
              decode_s=dis.decode.decode_s,
              decode_tokens=dis.decode.decode_tokens,
              admitted_s=dis.prefill.admitted_s,
              pools_whole=all(e._pool.free_blocks + e._pool.pinned_blocks
                              == e._pool.num_blocks
                              for e in (dis.prefill, dis.decode)))
    del dis
    gc.collect()
    torch.cuda.empty_cache()
    return want, got, st, launches, bodies, wall


def phase_roles(dev, cfg, params, smi):
    """The prefill/decode roles on one card: a DisaggregatedEngine with
    both roles on ``cuda:0`` at the paged cell's geometry (``PAGED_CELL``,
    int8, bf16; 8 cache-miss prompts of 300-1000 tokens, 64 new tokens),
    against a co-located paged engine on the same prompts: handoffs, their
    blocks and mean wait, TTFT, decode tok/s, streams equal (bf16: the
    decode role's batches and kv buckets differ from the co-located
    engine's, so not gated). The prefill role runs K1 and K2 (miss waves),
    the decode role K2 and K3 (decode). Then the same at f32 over 2
    layers at mistral-7b's widths (seed-0 f32 weights and KV), which must
    be equal stream for stream: the handoff moves the exact KV bytes.
    Returns the bf16 role run's launches and bodies."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.models import decoder
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, cfg.vocab_size, size=n).tolist()
               for n in np.linspace(300, 1000, 8).astype(int)]
    with plain_calls() as plain:
        want, got, st, launches, bodies, wall = _roles_run(
            cfg, params, dev, prompts, 64, dict(PAGED_CELL,
                                                quantize="int8"))
        cfg32 = decoder_config("mistral-7b", n_layers=F32_LAYERS)
        p32 = decoder.init_params(cfg32, seed=0, dtype=torch.float32,
                                  device=dev)
        want32, got32, st32, _, _, wall32 = _roles_run(
            cfg32, p32, dev, prompts, 32, dict(PAGED_CELL, dtype="float32"))
        del p32
        gc.collect()
        torch.cuda.empty_cache()
    emit({"phase": "roles", "config": cfg.name, **PAGED_CELL,
          "devices": [str(dev), str(dev)], "new_tokens": 64,
          "prompt_tokens": [len(p) for p in prompts], "wall_s": wall,
          "handoffs": st["handoffs"], "handoff_blocks": st["handoff_blocks"],
          "handoff_wait_mean_s": st["handoff_wait_mean_s"],
          "decode_tok_per_s": st["decode_tokens"] / st["decode_s"],
          "admitted_s": st["admitted_s"], **_stream_stats(got),
          "colocated": {**_stream_stats(want), "decode_tok_per_s":
                        st["colocated_decode_tok_per_s"]},
          "streams_equal": sum(a.tokens == b.tokens
                               for a, b in zip(want, got)),
          "streams": len(prompts), "pools_whole": st["pools_whole"],
          "f32": {"layers": F32_LAYERS, "wall_s": wall32,
                  "handoffs": st32["handoffs"],
                  "streams_equal": sum(a.tokens == b.tokens
                                       for a, b in zip(want32, got32)),
                  "pools_whole": st32["pools_whole"]},
          "plain_calls": dict(plain), "launches": launches,
          "launches_by_body": bodies, "device": smi})
    if (st["handoffs"] != len(prompts) or st32["handoffs"] != len(prompts)
            or not (st["pools_whole"] and st32["pools_whole"]) or plain
            or [c.tokens for c in got32] != [c.tokens for c in want32]):
        raise AssertionError(f"roles: {st} / f32 {st32} / plain {plain}")
    check_path("roles", launches, ("K1", "K2", "K3"))
    check_bodies("roles", bodies)
    if bodies["K3"]["seeded"] or not bodies["K3"]["decode"]:
        raise AssertionError(f"roles: K3 by body {bodies['K3']}")
    return launches, bodies


# ---------------------------------------------------------------------------
# slice 21: long context on one card, and the profiler
# ---------------------------------------------------------------------------

#: the long route's workload: scripts/bench_longctx.py's defaults (the
#: fixture's threads lengthened to 16000 characters or more, decode window
#: 16, ctx_block 256, 96 new tokens, greedy), cut from its 20 threads to 4
#: for time, behind the deployed short engine (the serve phase's: 4 slots,
#: max_len 4096)
LONG_SERVE = dict(threads=4, min_chars=16000, decode_window=16,
                  ctx_block=256, new_tokens=96)
LONG_SHORT = dict(num_slots=4, max_len=4096)
#: short requests the overlap sends through the runner, one after
#: another, while the long one runs (and again alone, the control)
LONG_OVERLAP_SHORTS = 3
#: query rows a plain-version call holds when K1 is checked at the long
#: shape: [32, 1024, S] f32 scores a call (~2.2 GB at S 17152), where the
#: whole [32, S, S] would be ~38 GB
LONG_K1_CHUNK = 1024
#: long_s16k's per-row gate: the rel-L2 of each valid query row (all 32
#: heads) against the plain version. Both round the output to bf16 once
#: (~1e-3 relative); a kernel that drops one 128-key tile of a full
#: 4096-key window, or shifts the window by one tile, moves a row by
#: ~0.18-0.25. The max-abs limit alone (K1_ATOL, sized for outputs up to
#: ~4) would not see that: the rows past the first few hundred average
#: thousands of unit-variance values and sit near 0.03.
LONG_K1_ROW_REL = 1e-2
#: long_f32: the prompt past mistral-7b's 4096 window, and the greedy
#: tokens compared; then bf16 at full depth with a prompt both engines hold
LONG_F32 = dict(prompt=6000, new_tokens=16, bf16_prompt=3000)


def build_long_threads(n_threads: int, min_chars: int):
    """``scripts/bench_longctx.py``'s ``build_long_threads`` over the
    port's copies of ``text/mbox.py`` and ``text/threads.py``: the
    fixture's real messages, each thread's discussion replayed message by
    message until it holds ``min_chars`` characters, as ThreadContexts
    the way the bench builds them (one chunk a message)."""
    from copilot_for_consensus_tpu_torch.summarization.base import (
        ThreadContext,
    )
    from copilot_for_consensus_tpu_torch.text.mbox import parse_mbox_file
    from copilot_for_consensus_tpu_torch.text.threads import ThreadBuilder

    fixture = Path(__file__).resolve().parent / "tests" / "fixtures" / \
        "ietf-sample.mbox"
    messages = [m for m, _is_html in parse_mbox_file(fixture)]
    threads = ThreadBuilder().build_threads(messages)
    base = [(t, [messages[i] for i in t.message_indices])
            for t in threads.values()]
    out = []
    i = 0
    while len(out) < n_threads:
        thread, msgs = base[i % len(base)]
        i += 1
        rounds, chars = [], 0
        while chars < min_chars:
            for m in msgs:
                rounds.append(m)
                chars += len(m.body_raw)
        tid = f"{thread.thread_id}-r{i}"
        out.append(ThreadContext(
            thread_id=tid, subject=thread.subject,
            participants=sorted({m.from_addr for m in rounds}),
            message_count=len(rounds),
            chunks=[{"chunk_id": f"{tid}-m{j}", "text": m.body_raw}
                    for j, m in enumerate(rounds)]))
    return out


def long_serve_workload(cfg):
    """The long_serve threads and their prompts' token counts, with the
    summarizer's own tokenizer and template (host work only)."""
    from copilot_for_consensus_tpu_torch.engine.tokenizer import (
        ByteTokenizer,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        build_prompt,
    )

    tok = ByteTokenizer(max(259, cfg.vocab_size))
    threads = build_long_threads(LONG_SERVE["threads"],
                                 LONG_SERVE["min_chars"])
    return threads, [len(tok.encode(build_prompt(t), add_bos=True))
                     for t in threads]


#: under_load: repeats a case alone and under the load; the load is the
#: long route's prefill of its shortest fixture thread (16,660 tokens in a
#: 16,896 bucket)
UNDER_LOAD = dict(idle_repeats=20, repeats=200, load_tokens=16896,
                  load_length=16660)


def under_load_cases(dev, cfg, params):
    """(name, call) pairs: the ring bodies at their decode and wave shapes
    (K1 wgmma; K2 stream and wgmma; K4; K5 and K6 stream and tiled; P's
    Hopper modes), seed-0 inputs at Mistral-7B's widths; K2 and K4 on
    layer 0 of ``params``, K5 and K6 on one layer of seed-0 int4
    weights."""
    import torch

    from copilot_for_consensus_tpu_torch.models import decoder, quant
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )
    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.ops import probe_stream as ps
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm
    from copilot_for_consensus_tpu_torch.scripts import probe_stream as drv

    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)

    l8 = decoder.layer_params(params, 0)
    l4 = decoder.layer_params(quant.fuse_int4_projections(
        quant.init_random_quantized(
            decoder_config(cfg.name, n_layers=1), seed=0,
            dtype=torch.bfloat16, device=dev, mode="int4")), 0)
    out = []
    for s, n in ((512, 300), (1024, 900)):
        q, k, v = randn(1, 32, s, 128), randn(1, 8, s, 128), randn(1, 8, s,
                                                                   128)
        ln = torch.tensor([n], dtype=torch.int32, device=dev)
        out.append((f"K1 wgmma S{s}", lambda q=q, k=k, v=v, ln=ln:
                    fa.flash_attention(q, k, v, causal=True, window=4096,
                                       kv_lengths=ln)))
    leaves8 = {name: l8[name] for name in ("wq", "wk", "w_gate", "w_down")}
    leaves8["lm_head"] = params["lm_head"]
    for m in (1, 4, 512):
        body = "stream" if m <= 8 else "wgmma"
        for name, leaf in leaves8.items():
            if m > 8 and name == "lm_head":
                continue
            x = randn(m, leaf["q"].shape[0])
            out.append((f"K2 {body} M{m} {name}", lambda x=x, leaf=leaf:
                        qm.int8_matmul(x, leaf["q"], leaf["scale"])))
    for name in ("w_gate", "w_down"):
        leaf = l8[name]
        x = randn(1024, leaf["q"].shape[0])
        out.append((f"K4 wgmma M1024 {name}", lambda x=x, leaf=leaf:
                    qm.w8a8_matmul(x, leaf["q"], leaf["scale"])))
    for m in (4, 32, 512):
        body = "stream" if m <= 32 else "wgmma"
        for name in ("w_gu", "w_down"):
            leaf = l4[name]
            x = randn(m, leaf["q4"].shape[0] * 2)
            out.append((f"K5 {body} M{m} {name}", lambda x=x, leaf=leaf:
                        qm.int4_matmul(x, leaf["q4"], leaf["scale"])))
            out.append((f"K6 {body} M{m} {name}", lambda x=x, leaf=leaf:
                        qm.w4a8_matmul(x, leaf["q4"], leaf["scale"])))
    x = randn(drv.B, drv.D)
    w = torch.randint(-127, 128, (drv.D, drv.F), generator=g,
                      dtype=torch.int8, device=dev)
    w4 = torch.randint(-128, 128, (drv.D // 2, drv.F), generator=g,
                       dtype=torch.int8, device=dev)
    out += [("P convdot", lambda: ps.probe_convdot(x, w)),
            ("P i8dot", lambda: ps.probe_i8dot(x, w)),
            ("P unpack8", lambda: ps.probe_unpack(x, w4)),
            ("P unpack32", lambda: ps.probe_unpack(x, w4, widen=True))]
    return out


def phase_under_load(dev, cfg, params, smi):
    """Every ring body held to its own bits under another stream's load
    (``under_load_cases``): each case's first output is its reference;
    ``idle_repeats`` more alone and ``repeats`` while a second thread runs
    the long route's prefill blocks (``UNDER_LOAD``, int8 ``params``, K1
    and K2's wgmma bodies) on its own stream, every repeat compared with
    the reference bit for bit on the card. Fails on any mismatch, a load
    that raised or ran no pass, or a load thread that does not stop."""
    import threading

    import torch

    from copilot_for_consensus_tpu_torch.models import decoder

    ul = UNDER_LOAD
    t0 = time.monotonic()
    runs = under_load_cases(dev, cfg, params)
    lens = torch.tensor([ul["load_length"]], dtype=torch.int32, device=dev)
    load_stream, test_stream = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    stop = threading.Event()
    errors: list = []
    passes = [0]

    def load():
        try:
            with torch.inference_mode(), torch.cuda.stream(load_stream):
                while not stop.is_set():
                    x = params["tok_emb"][torch.zeros(
                        (1, ul["load_tokens"]), dtype=torch.long,
                        device=dev)]
                    for li in range(cfg.n_layers):
                        x, _, _ = decoder._block(
                            x, decoder.layer_params(params, li), cfg, lens,
                            "auto")
                    load_stream.synchronize()
                    passes[0] += 1
        except Exception as exc:     # noqa: BLE001 — reported below
            errors.append(repr(exc))

    cases = {}
    with torch.inference_mode():
        wants = []
        with torch.cuda.stream(test_stream):
            for name, fn in runs:
                wants.append(fn().clone())
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                for _ in range(ul["idle_repeats"]):
                    bad += (fn() != wants[-1]).any()
                cases[name] = {"idle_mismatches": bad}
            test_stream.synchronize()
        worker = threading.Thread(target=load, daemon=True)
        worker.start()
        time.sleep(0.5)
        t1 = time.monotonic()
        with torch.cuda.stream(test_stream):
            for (name, fn), want in zip(runs, wants):
                bad = torch.zeros((), dtype=torch.int64, device=dev)
                for _ in range(ul["repeats"]):
                    bad += (fn() != want).any()
                cases[name]["loaded_mismatches"] = bad
            test_stream.synchronize()
        loaded_s = time.monotonic() - t1
        stop.set()
        worker.join(300)
    torch.cuda.synchronize()
    for row in cases.values():
        for key in ("idle_mismatches", "loaded_mismatches"):
            row[key] = int(row[key])
    bad = {n: r for n, r in cases.items()
           if r["idle_mismatches"] or r["loaded_mismatches"]}
    row = {"phase": "under_load", "cases": len(cases),
           "idle_repeats": ul["idle_repeats"], "repeats": ul["repeats"],
           "mismatched_cases": bad, "load_passes": passes[0],
           "load_errors": errors, "loaded_s": loaded_s,
           "seconds": time.monotonic() - t0, "device": smi,
           "by_case": cases}
    emit(row)
    if bad or errors or passes[0] < 1 or worker.is_alive():
        raise AssertionError(f"under_load: {row}")
    del runs, wants
    gc.collect()
    torch.cuda.empty_cache()


def phase_long_k1(dev, flush, s: int, length: int):
    """K1 at the long route's prefill shape (``long_s16k``): B 1, 32/8
    heads of 128, causal, window 4096, Sq = Skv = ``s`` (the long_serve
    bucket of its longest prompt) and kv_length ``length`` (that prompt's
    tokens), on the wgmma body. Held against K1's plain version query rows
    ``LONG_K1_CHUNK`` at a time through ``q_offsets`` (every chunk, the
    last valid row's among them): max abs within ``K1_ATOL`` and every
    valid row's rel-L2 within ``LONG_K1_ROW_REL``, a gate that two wrong
    plain versions (the window one tile short, the last key tile dropped)
    must fail on the last valid row's chunk; timed (median of 10) beside the plain version's chunked pass, SDPA with the explicit
    boolean mask (K/V expanded to 32 heads beforehand; the memory-efficient
    backend, which takes a mask without forming the scores) and the bound
    by attended pairs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(0)
    b, hq, hkv, d, window = 1, 32, 8, 128, 4096
    q, k, v = (torch.randn(b, h, s, d, generator=g, device=dev)
               .to(torch.bfloat16) for h in (hq, hkv, hkv))
    lens = torch.tensor([length], dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=window, kv_lengths=lens)
    before = dict(fa.flash_attention.launches_by_body)
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    ran = [n for n, c in fa.flash_attention.launches_by_body.items()
           if c != before[n]]

    def plain_chunks():
        for r0 in range(0, s, LONG_K1_CHUNK):
            offs = torch.full((b,), r0, dtype=torch.int32, device=dev)
            yield r0, fa.flash_attention_ref(
                q[:, :, r0:r0 + LONG_K1_CHUNK].contiguous(), k, v,
                q_offsets=offs, **kw)

    def row_rel(got, want, r0):
        # per query row over heads and D; the valid rows (< length) only
        num = (got.float() - want.float()).square().sum(dim=(0, 1, 3))
        den = want.float().square().sum(dim=(0, 1, 3))
        n = max(0, min(got.shape[2], length - r0))
        return (num[:n] / den[:n].clamp_min(1e-30)).sqrt()

    err, chunks, rel_max, rels = 0.0, 0, 0.0, []
    for r0, ref in plain_chunks():
        part = out[:, :, r0:r0 + LONG_K1_CHUNK]
        err = max(err, (part.float() - ref.float()).abs().max().item())
        rel = row_rel(part, ref, r0)
        rel_max = max(rel_max, rel.max().item())
        rels.append(rel)
        chunks += 1
        del ref
    rel_median = torch.cat(rels).median().item()
    del rels
    # the gate's own negative controls on the last valid row's chunk: the
    # plain version with the window one tile shorter, and with the last
    # tile of keys dropped; each must fail the per-row gate
    r0 = (length - 1) // LONG_K1_CHUNK * LONG_K1_CHUNK
    qc = q[:, :, r0:r0 + LONG_K1_CHUNK].contiguous()
    offs = torch.full((b,), r0, dtype=torch.int32, device=dev)
    want = fa.flash_attention_ref(qc, k, v, q_offsets=offs, **kw)
    controls = {}
    for name, ckw in (("window_one_tile_short", dict(
            kw, window=window - 128)), ("last_key_tile_dropped", dict(
            kw, kv_lengths=lens - 128))):
        wrong = fa.flash_attention_ref(qc, k, v, q_offsets=offs, **ckw)
        controls[name] = row_rel(wrong, want, r0).max().item()
        del wrong
    del want, qc
    finite = bool(torch.isfinite(out).all())
    zero = torch.zeros(b, dtype=torch.int32, device=dev)
    mask = fa._mask(b, s, s, lens, zero, zero, causal=True, window=window,
                    device=dev)
    pairs = int(mask.sum()) * hq
    kv_rows = int(mask.any(dim=1).sum())
    bnd, by = bound_ms(nbytes(q, out) + 2 * hkv * d * 2 * kv_rows + 12,
                       4.0 * d * pairs, "bfloat16")
    row = {"kernel": "K1", "case": "long_s16k", "dtype": "bfloat16",
           "shape": [b, hq, hkv, s, s, d], "window": window,
           "kv_length": length, "causal": True,
           "body": fa.flash_body(torch.bfloat16, d), "ran": ran,
           "max_abs_err": err, "tol": K1_ATOL["bfloat16"],
           "row_rel_l2_max": rel_max, "row_rel_l2_median": rel_median,
           "row_rel_l2_limit": LONG_K1_ROW_REL,
           "control_row_rel_l2_max": controls,
           "plain_chunk_rows": LONG_K1_CHUNK, "chunks_checked": chunks,
           "last_valid_row_chunk": (length - 1) // LONG_K1_CHUNK,
           "attended_pairs": pairs,
           "ms": time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
           # the plain version's whole pass, chunk by chunk
           "plain_ms": time_ms(lambda: [None for _ in plain_chunks()], n=1),
           "bound_ms": bnd, "bound_by": by}
    try:
        ke = k.repeat_interleave(hq // hkv, dim=1)
        ve = v.repeat_interleave(hq // hkv, dim=1)
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, ke, ve, attn_mask=mask[:, None]))
        row["library"] = ("scaled_dot_product_attention, memory-efficient "
                          "backend, boolean [S, S] mask, K/V expanded to "
                          "32 heads beforehand")
        del ke, ve
    except (RuntimeError, torch.OutOfMemoryError) as exc:
        row["library_ms"] = None
        row["library"] = f"not measured: {type(exc).__name__}: {exc}"[:300]
    emit(row)
    if not finite or err > K1_ATOL["bfloat16"] or ran != ["wgmma"] or \
            rel_max > LONG_K1_ROW_REL or chunks * LONG_K1_CHUNK < length \
            or min(controls.values()) <= LONG_K1_ROW_REL:
        raise AssertionError(f"K1 long_s16k: {row}")
    del q, k, v, out, mask
    torch.cuda.empty_cache()
    return {("K1", "long_s16k", "bfloat16"): row}


def phase_long_serve(dev, cfg, params, smi, threads):
    """The long route (``LONG_SERVE``): ``CUDASummarizer(long_context=
    True)`` over the deployed short engine (``LONG_SHORT``, int8, the
    weights on the card) with the bench's long-engine settings. Every
    thread's prompt is over the short engine's ``prompt_limit`` and goes
    whole to the long engine (``prompt_tokens`` = the full prompt), whose
    leaves are the short engine's tensors. Per thread: prompt tokens,
    prefill s (prefill tok/s), decode tok/s, finish; the peak memory
    allocated; the launches by body with the counts reset just before: K1
    (32 a prefill, wgmma) and K2 (225 a forward pass: each prefill and
    each decode step), no plain version; the long engine's telemetry
    steps. Then the overlap: a short request through ``summarize_async``,
    the runner's first, then ``LONG_OVERLAP_SHORTS`` more (the control:
    the run without the long one), then ``LONG_OVERLAP_SHORTS`` again,
    one after another, while the first long thread goes through
    ``summarize_async`` on this thread (the runner's dispatcher thread
    replays the short engine's decode graphs on its stream; the long
    engine runs on its own stream with its own split counters): the long
    summary must equal the sync route's, every short completion (tokens
    and finish) the control's, and at least one short request must
    complete while the long one runs. Reported beside them: the first
    token at which the sync run and the runner's first request differ
    from the control, if they do.
    Returns the sync route's launches and bodies."""
    import threading

    import torch

    from copilot_for_consensus_tpu_torch.engine.sampling import (
        SamplingConfig,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    ls = LONG_SERVE
    summ = CUDASummarizer(cfg.name, params=params, device=dev,
                          max_new_tokens=ls["new_tokens"],
                          long_context=True, **LONG_SHORT)
    eng, long_eng = summ.engine, summ.long_engine
    # scripts/bench_longctx.py's long engine: window 16, ctx_block 256,
    # greedy (the summarizer's defaults are 8, 64 and greedy)
    long_eng.decode_window = ls["decode_window"]
    long_eng.ctx_quantum = ls["ctx_block"]
    long_eng.sampling = SamplingConfig(temperature=0.0)
    shared = long_eng.params is eng.params
    prompts = [summ._prompt(t) for t in threads]
    comps, plain_generate = [], long_eng.generate

    def recording_generate(prompt, max_new_tokens=256, **kw):
        c = plain_generate(prompt, max_new_tokens, **kw)
        comps.append(c)
        return c

    long_eng.generate = recording_generate
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    reset_launches()
    with plain_calls() as plain:
        t0 = time.monotonic()
        summaries = summ.summarize_batch(threads)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    launches, bodies = read_launches(), read_bodies()
    peak = torch.cuda.max_memory_allocated(dev)
    recs = long_eng.telemetry.recorder.records()
    steps = sum(r.tokens for r in recs if r.kind == "decode")
    kinds = {k: sum(r.kind == k for r in recs) for k in ("prefill",
                                                        "decode")}
    long_eng.generate = plain_generate
    rows = [{"thread_id": t.thread_id, "messages": t.message_count,
             "prompt_tokens": s.prompt_tokens,
             "completion_tokens": s.completion_tokens,
             "finish": c.finish_reason, "prefill_s": c.prefill_s,
             "prefill_tok_per_s": c.prompt_len / c.prefill_s,
             "decode_s": c.decode_s,
             "decode_tok_per_s": len(c.tokens) / c.decode_s
             if c.decode_s else None}
            for t, s, c in zip(threads, summaries, comps)]

    # the overlap: the runner's decode graphs and the long engine at once.
    # Every completion the short engine returns is recorded: the sync one
    # (no runner yet) through its generate, the runner's through _checked
    short = synthetic_threads(1)[0]
    sync_comps = _recorded(summ)
    summ.summarize_batch([short])                    # alone; warms graphs
    done, started = threading.Event(), threading.Event()
    shorts, errors, runner_comps = [], [], []
    plain_checked = summ._checked

    def recording_checked(comp):
        runner_comps.append(comp)
        return plain_checked(comp)

    summ._checked = recording_checked

    def short_loop(n):
        try:
            while not done.is_set() and len(shorts) < n:
                w = summ.summarize_async(short,
                                         correlation_id=f"s{len(shorts)}")
                started.set()
                w(600)
                shorts.append(time.monotonic())
        except Exception as exc:     # noqa: BLE001 — reported below
            errors.append(exc)
            started.set()

    # the run without the long one: the runner's first request, then the
    # control requests, one after another
    short_loop(1 + LONG_OVERLAP_SHORTS)
    first, control = runner_comps[0], runner_comps[1:]
    shorts.clear()
    runner_comps.clear()
    th = threading.Thread(target=short_loop, args=(LONG_OVERLAP_SHORTS,))
    th.start()
    started.wait(60)
    t1 = time.monotonic()
    got_long = summ.summarize_async(threads[0], correlation_id="long")()
    t2 = time.monotonic()
    done.set()
    th.join(600)
    overlap = list(runner_comps)
    graphs = eng.graph_stats()
    summ.close()

    def diff(a, b):
        """The first token at which two completions differ (None: equal)"""
        if (a.tokens, a.finish_reason) == (b.tokens, b.finish_reason):
            return None
        return next((i for i, (x, y) in enumerate(zip(a.tokens, b.tokens))
                     if x != y), min(len(a.tokens), len(b.tokens)))

    want = control[0]
    overlapped = sum(t1 < t <= t2 for t in shorts)
    shorts_equal = sum(diff(c, want) is None for c in overlap)
    long_equal = (got_long.summary_text, got_long.prompt_tokens,
                  got_long.completion_tokens) == (
        summaries[0].summary_text, summaries[0].prompt_tokens,
        summaries[0].completion_tokens)
    row = {"phase": "long_serve", "config": cfg.name, **ls,
           "cut": "scripts/bench_longctx.py's 20 threads cut to 4",
           "short_engine": LONG_SHORT, "prompt_limit": eng.prompt_limit,
           "shared_weights": shared, "threads_detail": rows,
           "wall_s": wall, "prefill_s": sum(c.prefill_s for c in comps),
           "decode_s": sum(c.decode_s for c in comps),
           "decode_tok_per_s": sum(len(c.tokens) for c in comps)
           / sum(c.decode_s for c in comps),
           "decode_steps": steps, "telemetry_steps": kinds,
           "memory_gb": {"before": mem0 / 1e9, "peak": peak / 1e9},
           "async": {"long_equal_sync": long_equal,
                     "long_wall_s": t2 - t1, "shorts": len(overlap),
                     "shorts_equal_control": shorts_equal,
                     "overlapped": overlapped,
                     "shorts_done_s": [t - t1 for t in shorts],
                     "shorts_first_diff": [diff(c, want) for c in overlap],
                     "control_first_diff": [diff(c, want) for c in control],
                     "short_tokens": len(want.tokens),
                     "short_finish": want.finish_reason,
                     "sync_first_diff": diff(sync_comps[0], want),
                     "runner_first_request_first_diff": diff(first, want),
                     "errors": [repr(e) for e in errors],
                     "graphs": graphs},
           "plain_calls": dict(plain), "launches": launches,
           "launches_by_body": bodies, "device": smi}
    emit(row)
    n_layers = cfg.n_layers
    if (not shared or plain or errors or not long_equal or not overlapped
            or shorts_equal != len(overlap)
            or any(diff(c, want) is not None for c in control)
            or kinds["prefill"] != len(threads)):
        raise AssertionError(f"long_serve: {row}")
    for p, s in zip(prompts, summaries):
        if s.prompt_tokens != len(p) or len(p) <= eng.prompt_limit:
            raise AssertionError(f"long_serve: {s.thread_id} prompt "
                                 f"{s.prompt_tokens} of {len(p)}")
    check_path("long_serve", launches, ("K1", "K2"))
    check_bodies("long_serve", bodies)
    check_k2_passes("long_serve", launches, bodies, n_layers)
    want = {"K1": n_layers * len(threads),
            "K2": (7 * n_layers + 1) * (len(threads) + steps)}
    if (bodies["K1"]["wgmma"], launches["K2"]) != (want["K1"], want["K2"]):
        raise AssertionError(f"long_serve: launches {launches} by body "
                             f"{bodies}, expected {want}")
    del summ, eng, long_eng
    gc.collect()
    torch.cuda.empty_cache()
    return launches, bodies


def phase_long_f32(dev, cfg, params, smi):
    """The long engine against the short engine on the same weights: at
    f32 over 2 layers at mistral-7b's widths (seed-0 weights), a
    ``LONG_F32["prompt"]``-token prompt (past the 4096 window, so both
    engines' window masks bite), greedy: the long engine's tokens must
    equal the short engine's (``max_len`` 6400, one 6144 bucket), or
    diverge only where the top-2 logits are within ``STORM_F32_GAP``
    relative. Then bf16 at full depth on the int8 weights, a
    ``bf16_prompt``-token prompt that both hold (the short engine's bucket
    4096): the first tokens equal, the logits of the first token and of
    the first decode step (the long engine's prefix + suffix attention
    against the short engine's decode) each within rel-L2
    ``LOGITS_REL_L2``, and the greedy tokens that agree counted."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.engine import longctx
    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.models import decoder
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    lf = LONG_F32
    new = lf["new_tokens"]
    long_kw = dict(decode_window=LONG_SERVE["decode_window"],
                   ctx_block=LONG_SERVE["ctx_block"], max_new_tokens=new,
                   device=dev)
    rng = np.random.default_rng(5)
    cfg32 = decoder_config("mistral-7b", n_layers=F32_LAYERS)
    p32 = decoder.init_params(cfg32, seed=0, dtype=torch.float32,
                              device=dev)
    prompt = rng.integers(3, cfg32.vocab_size, size=lf["prompt"]).tolist()
    with plain_calls() as plain:
        t0 = time.monotonic()
        got = longctx.LongContextEngine(
            cfg32, p32, dtype=torch.float32, eos_id=-1,
            **long_kw).generate(prompt, new)
        long_s = time.monotonic() - t0
        short = GenerationEngine(cfg32, p32, dtype="float32", eos_id=-1,
                                 num_slots=1, max_len=6400,
                                 prefill_buckets=(6144,), device=dev)
        want = short.generate([prompt], new)[0]
        del short
    gap = None
    if got.tokens != want.tokens:
        a, b = want.tokens, got.tokens
        j = next(k for k in range(min(len(a), len(b)) + 1)
                 if k == min(len(a), len(b)) or a[k] != b[k])
        gap = _top2_gap(p32, cfg32, prompt, a[:j])
    del p32
    gc.collect()
    torch.cuda.empty_cache()

    prompt16 = rng.integers(3, cfg.vocab_size,
                            size=lf["bf16_prompt"]).tolist()
    short = GenerationEngine(cfg, params, quantize="int8", num_slots=1,
                             max_len=4096, prefill_buckets=(4096,),
                             device=dev)
    # the logits of the first token (prefill) and of the first decode step
    with first_logits(2) as lg_short:
        want16 = short.generate([prompt16], new)[0]
    del short
    lg_long: list = []
    plain_sample = longctx.sample

    def recording(logits, gen, sampling):
        if len(lg_long) < 2:
            lg_long.append(logits.float().cpu())
        return plain_sample(logits, gen, sampling)

    with patched(longctx, "sample", recording):
        got16 = longctx.LongContextEngine(cfg, params,
                                          **long_kw).generate(prompt16, new)
    rel, rel_decode = (
        float((a - b).norm() / b.norm()) if a.shape == b.shape
        else float("inf") for a, b in zip(lg_long, lg_short))
    lead = next((k for k, (a, b) in enumerate(zip(want16.tokens,
                                                  got16.tokens)) if a != b),
                min(len(want16.tokens), len(got16.tokens)))
    row = {"phase": "long_f32", "layers": F32_LAYERS,
           "prompt_tokens": len(prompt), "new_tokens": new,
           "long_s": long_s, "streams_equal": got.tokens == want.tokens,
           "divergent_top2_gap": gap, "gap_limit": STORM_F32_GAP,
           "bf16": {"config": cfg.name, "prompt_tokens": len(prompt16),
                    "first_logits_rel_l2": rel,
                    "first_decode_logits_rel_l2": rel_decode,
                    "limit": LOGITS_REL_L2,
                    "tokens_equal": sum(a == b for a, b in
                                        zip(want16.tokens, got16.tokens)),
                    "leading_tokens_equal": lead,
                    "tokens": len(want16.tokens)},
           "plain_calls": dict(plain), "device": smi}
    emit(row)
    # the first decode step's logits are comparable once the first tokens
    # agree: they read the same prompt KV and the same fed-back token
    if (gap is not None and gap >= STORM_F32_GAP) or plain or \
            rel > LOGITS_REL_L2 or lead < 1 or rel_decode > LOGITS_REL_L2:
        raise AssertionError(f"long_f32: {row}")
    gc.collect()
    torch.cuda.empty_cache()


#: new tokens in the profile phase: one decode dispatch of each engine (a
#: 16-token run wrote ~100 and ~145 MB of trace and took ~35 s)
PROFILE_NEW = 4


def phase_profile(dev, cfg, params, smi):
    """``profile_dir`` on the card: a ``CUDASummarizer`` with
    ``long_context=True`` and ``profile_dir`` a temporary directory (int8
    weights, 2 slots, ``PROFILE_NEW`` new tokens) summarizes a
    ~5000-token thread (the long engine) and a short one (the short
    engine) in one ``summarize_batch``: one
    torch.profiler trace a ``generate``, each holding a step annotation
    ``<kind>:<step>`` for every dispatch its engine's flight recorder
    holds. Reports the trace files' sizes, their annotations and device
    kernel events (CUPTI), not gated."""
    import torch

    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    with tempfile.TemporaryDirectory(prefix="profile-") as tmp:
        summ = CUDASummarizer(cfg.name, params=params, num_slots=2,
                              max_len=4096, max_new_tokens=PROFILE_NEW,
                              long_context=True, profile_dir=tmp,
                              device=dev)
        (long_t,) = long_threads(summ.tokenizer, 1, 5000, 5000)
        t0 = time.monotonic()
        summ.summarize_batch([long_t, synthetic_threads(1)[0]])
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        files = sorted(Path(tmp).glob("trace-*.json"),
                       key=lambda p: int(p.stem.rsplit("-", 1)[1]))
        out, missing = {}, {}
        # the batch's long prompts run first, then the short engine's
        for name, path, eng in zip(("long", "short"), files,
                                   (summ.long_engine, summ.engine)):
            events = json.loads(path.read_text())["traceEvents"]
            names = {e.get("name") for e in events
                     if e.get("cat") == "user_annotation"}
            want = [f"{r.kind}:{r.seq}"
                    for r in eng.telemetry.recorder.records()]
            missing[name] = [w for w in want if w not in names]
            out[name] = {"bytes": path.stat().st_size,
                         "annotations": len(want),
                         "kinds": sorted({w.split(":")[0] for w in want}),
                         "kernel_events": sum(e.get("cat") == "kernel"
                                              for e in events)}
        del summ
    emit({"phase": "profile", "config": cfg.name, "files": len(files),
          "wall_s": wall, "traces": out, "missing": missing,
          "device": smi})
    if len(files) != 2 or any(missing.values()) or \
            any(not o["annotations"] for o in out.values()):
        raise AssertionError(f"profile: {len(files)} traces, {out}, "
                             f"missing {missing}")
    gc.collect()
    torch.cuda.empty_cache()


#: Mixtral-8x7B's expert products (D, F): w_gate and w_up, w_down
MOE_SHAPES = [(4096, 14336), (14336, 4096)]
#: one MoE layer's cases (rows, tokens a row): decode at 8 and 32 slots
#: (capacity 8 and 16), a 4 x 1024 wave (capacity 1280) and the 8 x 1024
#: wave ``moe_serve`` admits (capacity 2560)
MOE_LAYER_CASES = ((8, 1), (32, 1), (4, 1024), (8, 1024))
#: the experts' M of the kernel rows: those capacities
MOE_CAPS = (8, 16, 1280, 2560)
#: one MoE layer's kernel route against impl="plain", relative L2
MOE_REL_L2 = 1e-2
#: the deployment ``moe_serve`` builds through the cuda driver: 8 slots of
#: 4096, 8 threads of 600-1000 prompt tokens (one admission wave), 32 new
#: tokens each (4 dispatches of 8 steps)
MOE_SERVE = dict(num_slots=8, max_len=4096, threads=8, lo=600, hi=1000,
                 new=32)
#: the f32 phase's depth (Mixtral-8x7B's widths)
MOE_F32_LAYERS = 2
#: device memory (GB) that may be held when a Mixtral model is built:
#: less than the smallest other model (Mistral-7B int4, 3.7 GB), so none
#: is resident
MOE_RESIDENT_GB = 3.0


def moe_body(k: str, m: int, d: int, f: int) -> str:
    """The body of quantized kernel ``k`` at M = ``m`` on a bf16 x and a
    [D, F] weight (int4: group ``INT4_GROUP``), by the wrappers' rules."""
    import torch

    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    bf, g = torch.bfloat16, min(quant.INT4_GROUP, d)
    return {"K2": lambda: qm.int8_body(m, d, f, bf),
            "K4": lambda: qm.w8a8_body(m, d, f, bf),
            "K5": lambda: qm.int4_body(m, f, g, bf),
            "K6": lambda: qm.w4a8_body(m, d, f, g, bf)}[k]()


def moe_expected(cfg, passes, quant_mode: str, act: str) -> dict:
    """Launches by (kernel, body) that forward passes of an MoE engine
    make: ``passes`` lists (rows, tokens) a pass — an admission wave of n
    rows x bucket is (n, n x bucket), a decode step (slots, slots). Per
    pass and layer: the four attention projections at M = tokens and the
    3 x E expert products at M = ``moe_capacity(tokens)``; the lm_head at
    M = rows. The experts take the weight-only kernel (K2 for int8, K5 for
    int4) whatever the act-quant mode; in "a8" mode the projections and
    the lm_head take K4 (int8, from ``A8_MIN_ROWS`` rows) or K6 (int4)."""
    import collections

    from copilot_for_consensus_tpu_torch.models import layers
    from copilot_for_consensus_tpu_torch.models.moe import moe_capacity

    d, f, dh = cfg.d_model, cfg.d_ff, cfg.head_dim
    attn = [(d, cfg.n_heads * dh), (d, cfg.n_kv_heads * dh),
            (d, cfg.n_kv_heads * dh), (cfg.n_heads * dh, d)]
    experts = [(d, f), (d, f), (f, d)]
    head = [(d, cfg.vocab_size)]

    def kernel(m: int, a8: bool) -> str:
        if quant_mode == "int8":
            return "K4" if a8 and m >= layers.A8_MIN_ROWS else "K2"
        return "K6" if a8 else "K5"

    out: collections.Counter = collections.Counter()
    a8 = act == "a8"
    for rows, tokens in passes:
        for m, shapes, times, may_a8 in (
                (tokens, attn, cfg.n_layers, a8),
                (moe_capacity(tokens, cfg), experts,
                 cfg.n_layers * cfg.n_experts, False),
                (rows, head, 1, a8)):
            for dd, ff in shapes:
                k = kernel(m, may_a8)
                out[(k, moe_body(k, m, dd, ff))] += times
    return dict(out)


def check_moe_bodies(label: str, bodies: dict, launches: dict,
                     want: dict, n_waves: int, n_layers: int) -> None:
    """The quantized kernels' launches by body equal ``moe_expected``'s,
    and K1 made one wgmma launch a layer a wave."""
    for k in ("K2", "K4", "K5", "K6"):
        for b, n in bodies[k].items():
            if n != want.get((k, b), 0):
                raise AssertionError(
                    f"{label}: {k} {b} launched {n} times, expected "
                    f"{want.get((k, b), 0)} (all: {bodies}, want {want})")
    if bodies["K1"]["wgmma"] != launches["K1"] or \
            launches["K1"] != n_layers * n_waves:
        raise AssertionError(f"{label}: K1 {bodies['K1']}, expected "
                             f"{n_layers * n_waves} wgmma launches")


def phase_moe_layer(dev, smi):
    """One Mixtral-8x7B MoE layer (``models/moe.py``), bf16 activations,
    random int8 and then int4 experts born on the card from seed 3 (the
    router bf16, as the random init makes it): the kernel route against
    ``impl="plain"`` on the same input, so on the same routing, at decode
    with 8 and 32 slots (capacity 8 and 16) and at waves of 4 and 8 x 1024
    (capacity 1280 and 2560, the latter ``moe_serve``'s admission wave):
    relative L2 within ``MOE_REL_L2``, 3 x 8 launches of
    the weight-only kernel a call on the body its rule gives the capacity,
    none of another kernel; both routes timed (L2 flushed). Then K2 and K5
    alone at the experts' shapes (4096 x 14336 and 14336 x 4096) and M the
    capacities 8, 16, 1280 and 2560: max error against the plain version,
    ms, plain ms, bound, and the PyTorch yardstick — K2's ``x @ q.to(bf16) *
    s``, K5's ``x @ w`` with w dequantized beforehand. Returns the kernel
    rows."""
    import torch

    from copilot_for_consensus_tpu_torch.models import decoder, quant
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )
    from copilot_for_consensus_tpu_torch.models.moe import (
        moe_capacity,
        moe_ffn,
    )
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    cfg = decoder_config("mixtral-8x7b", n_layers=1)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    rows = {}
    for mode, k in (("int8", "K2"), ("int4", "K5")):
        params = quant.init_random_quantized(cfg, seed=3, mode=mode,
                                             device=dev)
        layer = decoder.layer_params(params, 0)
        for b, s in MOE_LAYER_CASES:
            x = torch.randn(b, s, cfg.d_model, generator=g,
                            device=dev).to(torch.bfloat16)
            cap = moe_capacity(b * s, cfg)
            reset_launches()
            out = moe_ffn(x, layer, cfg)
            torch.cuda.synchronize()
            launches, bodies = read_launches(), read_bodies()
            want = moe_ffn(x, layer, cfg, impl="plain")
            rel = ((out.float() - want.float()).norm()
                   / want.float().norm()).item()
            expect: dict = {}
            for dd, ff in (MOE_SHAPES[0], MOE_SHAPES[0], MOE_SHAPES[1]):
                key = (k, moe_body(k, cap, dd, ff))
                expect[key] = expect.get(key, 0) + cfg.n_experts
            row = {"phase": "moe_layer", "quantize": mode,
                   "shape": [b, s, cfg.d_model], "capacity": cap,
                   "rel_l2": rel, "bound": MOE_REL_L2,
                   "launches": launches, "launches_by_body": bodies[k],
                   "ms": time_ms(lambda: moe_ffn(x, layer, cfg), n=5,
                                 flush=flush),
                   "plain_ms": time_ms(
                       lambda: moe_ffn(x, layer, cfg, impl="plain"), n=3,
                       flush=flush), "device": smi}
            emit(row)
            check_path(f"moe_layer {mode} {b}x{s}", launches, (k,))
            if {(k, bb): n for bb, n in bodies[k].items() if n} != expect:
                raise AssertionError(f"moe_layer {mode} {b}x{s}: bodies "
                                     f"{bodies[k]}, expected {expect}")
            if not (torch.isfinite(out).all() and rel <= MOE_REL_L2):
                raise AssertionError(f"moe_layer {mode} {b}x{s}: rel-L2 "
                                     f"{rel}")
            del x, out, want
        del params, layer
        gc.collect()
        torch.cuda.empty_cache()
    for k, (d, f) in ((k, sh) for k in ("K2", "K5") for sh in MOE_SHAPES):
        if k == "K2":
            w = torch.randint(-127, 128, (d, f), generator=g,
                              dtype=torch.int8, device=dev)
            s = torch.rand(1, f, generator=g, device=dev) \
                * (2 * d ** -0.5 / 73.3)
            fn, ref, rtol = qm.int8_matmul, qm.int8_matmul_ref, K2_RTOL
            lib = (lambda x: x @ w.to(torch.bfloat16) * s,
                   "x @ q.to(bf16) * s")
        else:
            w = torch.randint(-128, 128, (d // 2, f), generator=g,
                              dtype=torch.int8, device=dev)
            s = torch.rand(d // min(quant.INT4_GROUP, d), f, generator=g,
                           device=dev) * (2 * d ** -0.5 / 4.61)
            wd = quant.dequant_int4({"q4": w, "scale": s}, torch.bfloat16)
            fn, ref, rtol = qm.int4_matmul, qm.int4_matmul_ref, K5_RTOL
            lib = (lambda x: x @ wd, "x @ w, w dequantized to bf16 "
                                     "beforehand")
        for m in MOE_CAPS:
            x = torch.randn(m, d, generator=g, device=dev).to(torch.bfloat16)
            out = fn(x, w, s)
            torch.cuda.synchronize()
            want = ref(x, w, s)
            top = want.float().abs().max().item()
            err = (out.float() - want.float()).abs().max().item()
            bnd, by = bound_ms(nbytes(x, w, s, out), 2.0 * m * d * f,
                               "bfloat16")
            body = moe_body(k, m, d, f)
            row = {"kernel": k, "case": f"moe_m{m}_d{d}_f{f}",
                   "dtype": "bfloat16", "shape": [m, d, f], "body": body,
                   "max_abs_err": err, "tol": rtol["bfloat16"] * top,
                   "ms": time_ms(lambda: fn(x, w, s), flush=flush),
                   "plain_ms": time_ms(lambda: ref(x, w, s), n=3,
                                       flush=flush),
                   "library_ms": time_ms(lambda: lib[0](x), flush=flush),
                   "library": lib[1], "bound_ms": bnd, "bound_by": by}
            emit(row)
            if not (torch.isfinite(out).all() and err <= row["tol"]):
                raise AssertionError(f"{k} {row['case']}: error {err}")
            rows[(k, row["case"], "bfloat16")] = row
            del x, out, want
        del w, s
    del flush
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def phase_moe_serve(dev, smi):
    """``mixtral-8x7b`` at full width and depth on the card, random weights
    from seed 0, built by the ``cuda`` LLM driver
    (``create_summarizer({"driver": "cuda", "model": "mixtral-8x7b",
    ...})``) at int8 and then, the int8 weights freed, at int4 (unfused).
    Each: ``MOE_SERVE``'s threads through ``summarize_batch`` under CUDA
    graphs (one admission wave, then graph replays), every sampled logits
    row finite, the launches by body equal to ``moe_expected`` of the
    passes the engine made (waves recorded by shape, decode steps by
    dispatch) — the 3 x 8 x 32 expert products on the weight-only kernel;
    then the same threads in "a8" mode, where only the attention
    projections and the lm_head change kernels (K4 from 1024 rows for
    int8, K6 for int4): 0 expert launches on K4 or K6; then ``phase_trace``
    of the engine's steady decode (step ms, replay ms, idle share). Peak
    device memory a model, and what was resident before it. Returns the
    paths' launches and bodies."""
    import torch

    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    cfg = decoder_config("mixtral-8x7b")
    paths = {}
    for mode in ("int8", "int4"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        paths.update(_moe_serve_model(dev, smi, cfg, mode))
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def _moe_serve_model(dev, smi, cfg, mode: str) -> dict:
    """``phase_moe_serve`` for one quantize mode; everything it builds is
    freed when it returns."""
    import torch

    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.summarization.factory import (
        create_summarizer,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        build_prompt,
    )

    paths = {}
    resident = torch.cuda.memory_allocated(dev) / 1e9
    if resident > MOE_RESIDENT_GB:
        # each phase line's allocated_gb names the phase that left it
        raise AssertionError(f"moe_serve {mode}: {resident} GB resident "
                             f"before the model is built")
    t0 = time.monotonic()
    summ = create_summarizer({
        "driver": "cuda", "model": cfg.name, "quantize": mode,
        "num_slots": MOE_SERVE["num_slots"],
        "max_len": MOE_SERVE["max_len"],
        "max_new_tokens": MOE_SERVE["new"], "device": str(dev)})
    eng = summ.engine
    torch.cuda.synchronize()
    lt = eng.params["layers"]
    emit({"phase": "moe_weights", "config": cfg.name, "quantize": mode,
          "bytes": quant.param_bytes(eng.params),
          "expert_leaf": {k: list(v.shape)
                          for k, v in lt["w_gate"].items()},
          "router": [list(lt["router"].shape), str(lt["router"].dtype)],
          "fused": "wqkv" in lt or "w_gu" in lt,
          "seconds": time.monotonic() - t0})
    if eng.cfg != cfg or eng.quant_mode != mode or "wqkv" in lt:
        raise AssertionError(f"moe_serve {mode}: engine {eng.cfg.name} "
                             f"{eng.quant_mode}, leaves {sorted(lt)}")
    threads = long_threads(summ.tokenizer, MOE_SERVE["threads"],
                           MOE_SERVE["lo"], MOE_SERVE["hi"])
    prompts = [summ.tokenizer.encode(build_prompt(t), add_bos=True)
               for t in threads]
    waves: list = []
    dispatches = [0]
    plain_wave, plain_dispatch = eng._admit_wave, eng._decode_dispatch

    def wave(tokens, *a, **kw):
        waves.append(tokens.shape)
        return plain_wave(tokens, *a, **kw)

    def dispatch(*a, **kw):
        dispatches[0] += 1
        return plain_dispatch(*a, **kw)

    eng._admit_wave, eng._decode_dispatch = wave, dispatch
    comps = _recorded(summ)
    for act in ("weight_only", "a8"):
        quant.set_act_quant(act)
        try:
            n_w, n_d, n_c = len(waves), dispatches[0], len(comps)
            before = (eng.decode_s, eng.decode_tokens, eng.admitted_s)
            reset_launches()
            with finite_logits(eng) as finite:
                t0 = time.monotonic()
                summaries = summ.summarize_batch(threads)
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
                launches, bodies = read_launches(), read_bodies()
                stats = eng.graph_stats()
        finally:
            quant.set_act_quant("weight_only")
        rc = comps[n_c:]
        steps = (dispatches[0] - n_d) * eng._dispatch_steps
        passes = [(n, n * s) for n, s in waves[n_w:]] + \
            [(eng.num_slots, eng.num_slots)] * steps
        want = moe_expected(cfg, passes, mode, act)
        dec_s = eng.decode_s - before[0]
        label = f"moe_serve {mode} {act}"
        row = {"phase": "moe_serve", "quantize": mode, "act_quant": act,
               "config": cfg.name, "threads": len(threads),
               "prompt_tokens": [c.prompt_len for c in rc],
               "completion_tokens": [len(c.tokens) for c in rc],
               "waves": [list(w) for w in waves[n_w:]],
               "decode_steps": steps, "wall_s": wall,
               "prefill_s": eng.admitted_s - before[2],
               "decode_s": dec_s,
               "decode_tokens": eng.decode_tokens - before[1],
               "ms_per_step": dec_s / steps * 1e3 if steps else None,
               "graphs": stats, "launches": launches,
               "launches_by_body": bodies,
               "expected": {f"{k} {b}": n for (k, b), n in want.items()},
               "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
               "device": smi}
        emit(row)
        if not bool(finite):
            raise AssertionError(f"{label}: non-finite logits")
        if [s.thread_id for s in summaries] != \
                [t.thread_id for t in threads] or any(
                    s.completion_tokens != len(c.tokens)
                    or c.prompt_len != len(p)
                    for s, c, p in zip(summaries, rc, prompts)):
            raise AssertionError(f"{label}: summaries or prompts off")
        if not steps or not stats["replays"]:
            raise AssertionError(f"{label}: no graph replay: {stats}")
        used = {k for (k, _b) in want} | {"K1"}
        check_path(label, launches, used)
        check_moe_bodies(label, bodies, launches, want,
                         len(waves) - n_w, cfg.n_layers)
        paths[f"moe_serve_{mode}" + ("_a8" if act == "a8" else "")] = \
            (launches, bodies)
    eng._admit_wave, eng._decode_dispatch = plain_wave, plain_dispatch
    row = phase_trace(cfg, eng, prompts, smi, label=f"moe_trace_{mode}")
    emit({"phase": "moe_memory", "quantize": mode,
          "resident_gb_before": resident,
          "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "step_ms": row["step_ms"], "idle_share": row["idle_share"],
          "device": smi})
    summ.close()
    return paths


def _moe_prompts(cfg) -> list:
    """The short MoE phases' 8 prompts, 64-700 tokens, from seed 5."""
    import numpy as np

    rng = np.random.default_rng(5)
    return [rng.integers(3, cfg.vocab_size, n).tolist()
            for n in (300, 90, 512, 200, 700, 64, 450, 130)]


def phase_moe_f32(dev, smi):
    """``MOE_F32_LAYERS`` layers at Mixtral-8x7B's widths, f32 weights from
    seed 0 (full-precision experts: batched f32 products), greedy,
    ``_moe_prompts`` and 24 new tokens: the contiguous engine on the
    kernel route (K1's CUDA-core body in every wave) against the same
    engine with ``attn_impl="plain"``, then a paged engine (K3 on the f32
    pool) against the plain one. Streams equal, or a divergence only where
    the top-2 logits of the diverging step are within ``STORM_F32_GAP``
    relative (f32 sums in another order). The kernel route's engine also
    runs its dispatch body eagerly (``cuda_graphs=False``): those streams
    must equal the replaying engine's exactly."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.models import decoder
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    cfg = decoder_config("mixtral-8x7b", n_layers=MOE_F32_LAYERS)
    params = decoder.init_params(cfg, seed=0, dtype=torch.float32,
                                 device=dev)
    prompts = _moe_prompts(cfg)
    base = dict(num_slots=8, max_len=1024)
    runs = {}
    for name, kw, used in (
            ("plain", dict(attn_impl="plain"), ()),
            ("kernel", {}, ("K1",)),
            ("eager", dict(cuda_graphs=False), ("K1",)),
            ("paged", dict(prefill_chunk=64, kv_pool_blocks=8 * 16 + 16),
             ("K1", "K3"))):
        eng = GenerationEngine(cfg, params, dtype="float32", device=dev,
                               **base, **kw)
        reset_launches()
        comps = eng.generate(prompts, 24)
        torch.cuda.synchronize()
        launches = read_launches()
        check_path(f"moe_f32 {name}", launches, used)
        runs[name] = {"tokens": [c.tokens for c in comps],
                      "launches": launches, "graphs": eng.graph_stats()}
        del eng
        gc.collect()
    rows = {}
    for name in ("kernel", "paged"):
        gaps = {}
        for i, (a, b) in enumerate(zip(runs["plain"]["tokens"],
                                       runs[name]["tokens"])):
            if a != b:
                j = next(k for k in range(min(len(a), len(b)) + 1)
                         if k == min(len(a), len(b)) or a[k] != b[k])
                gaps[i] = _top2_gap(params, cfg, prompts[i], a[:j])
        rows[name] = {"equal": sum(a == b for a, b in zip(
            runs["plain"]["tokens"], runs[name]["tokens"])),
            "divergent_top2_gap": gaps, "launches": runs[name]["launches"],
            "graphs": runs[name]["graphs"]}
    eager = {"equal_to_kernel": sum(a == b for a, b in zip(
        runs["kernel"]["tokens"], runs["eager"]["tokens"])),
        "launches": runs["eager"]["launches"],
        "graphs": runs["eager"]["graphs"]}
    emit({"phase": "moe_f32", "config": cfg.name, "layers": cfg.n_layers,
          "streams": len(prompts), "runs": rows, "eager": eager,
          "gap_limit": STORM_F32_GAP, "device": smi})
    for name, r in rows.items():
        if any(g >= STORM_F32_GAP for g in r["divergent_top2_gap"].values()) \
                or not r["graphs"]["replays"]:
            raise AssertionError(f"moe_f32 {name}: {r}")
    if eager["equal_to_kernel"] != len(prompts) or eager["graphs"]["replays"] \
            or eager["launches"] != runs["kernel"]["launches"]:
        raise AssertionError(f"moe_f32: the eager body differs from the "
                             f"replayed one: {eager}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_moe_graphs(dev, smi):
    """``MOE_F32_LAYERS`` layers at Mixtral-8x7B's widths, random int8
    experts and projections born on the card from seed 0, bf16: the
    contiguous engine replaying CUDA graphs (the default) against the same
    weights in an engine that runs its dispatch body eagerly
    (``cuda_graphs=False``), ``_moe_prompts`` and 24 greedy new tokens.
    Both admit the same waves and launch the same kernels, so the streams
    and the launches by body must be equal: a fault in the captured MoE
    body (its zeroed scratch, the slot scatter, the stable sort, the
    static capacity) shows as a difference."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    cfg = decoder_config("mixtral-8x7b", n_layers=MOE_F32_LAYERS)
    params = quant.init_random_quantized(cfg, seed=0, mode="int8",
                                         device=dev)
    prompts = _moe_prompts(cfg)
    runs = {}
    for graphs in (True, False):
        eng = GenerationEngine(cfg, params, quantize="int8", device=dev,
                               num_slots=8, max_len=1024,
                               cuda_graphs=graphs)
        reset_launches()
        comps = eng.generate(prompts, 24)
        torch.cuda.synchronize()
        runs[graphs] = {"tokens": [c.tokens for c in comps],
                        "launches": read_launches(), "bodies": read_bodies(),
                        "graphs": eng.graph_stats()}
        del eng
        gc.collect()
    g, e = runs[True], runs[False]
    row = {"phase": "moe_graphs", "config": cfg.name, "layers": cfg.n_layers,
           "quantize": "int8", "streams": len(prompts),
           "streams_equal": sum(a == b for a, b in zip(g["tokens"],
                                                       e["tokens"])),
           "launches_equal": (g["launches"], g["bodies"])
           == (e["launches"], e["bodies"]),
           "launches": g["launches"], "launches_by_body": g["bodies"],
           "graphs": {"replay": g["graphs"], "eager": e["graphs"]},
           "device": smi}
    emit(row)
    check_path("moe_graphs", g["launches"], ("K1", "K2"))
    if row["streams_equal"] != len(prompts) or not row["launches_equal"] \
            or not g["graphs"]["replays"] or e["graphs"]["replays"]:
        raise AssertionError(f"moe_graphs: the replayed MoE body differs "
                             f"from the eager one: {row}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_mesh_nccl(dev):
    """The mesh's collectives on NCCL at world size 1 (one card). One
    process makes ``initialize_multihost`` a no-op (as in the JAX
    package), so the phase joins the world-1 NCCL group itself, over a
    TCP store on localhost. Each helper of ``parallel/collectives.py``
    runs on that group eagerly, then inside a CUDA graph replayed 3 times
    on fresh inputs; every result is checked (world 1: each is its
    input). ``capture_supported`` is the engine's own probe."""
    import datetime
    import socket

    import torch
    import torch.distributed as dist

    from copilot_for_consensus_tpu_torch.parallel import collectives as C
    from copilot_for_consensus_tpu_torch.parallel.multihost import (
        initialize_multihost,
    )

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    noop = initialize_multihost({"coordinator_address": f"127.0.0.1:{port}",
                                 "num_processes": 1, "process_id": 0})
    if noop is not False:
        raise AssertionError("initialize_multihost with one process joined "
                             "a group")
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    try:
        group = dist.group.WORLD
        g = torch.Generator(device=dev).manual_seed(5)

        def fresh():
            return (torch.randn(4, 32, generator=g, device=dev),
                    torch.randn(4, 32, generator=g, device=dev),
                    torch.randn(4, 32, generator=g, device=dev))

        def run(a, b, c):
            return (C.all_reduce(a, group), C.all_gather_last(b, group),
                    C.all_gather_rows(c, group))

        checks = {}
        a, b, c = fresh()
        want = (a.clone(), b.clone(), c.clone())
        got = run(a, b, c)
        torch.cuda.synchronize()
        checks["eager"] = all(torch.equal(x, y) for x, y in zip(got, want))
        decision = C.broadcast_decision({"hold": True, "late": [3, 5]},
                                        group)
        checks["broadcast"] = decision == {"hold": True, "late": [3, 5]}
        # captured: the collectives of one decode body, replayed
        sa, sb, sc = fresh()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            outs = run(sa, sb, sc)
        replays = []
        for _ in range(3):
            a, b, c = fresh()
            for dst, src in zip((sa, sb, sc), (a, b, c)):
                dst.copy_(src)
            graph.replay()
            torch.cuda.synchronize()
            replays.append(all(torch.equal(x, y)
                               for x, y in zip(outs, (a, b, c))))
        checks["graph_replays"] = replays
        ok, why = C.capture_supported(group, dev)
        row = {"phase": "mesh_nccl", "backend": dist.get_backend(group),
               "world_size": dist.get_world_size(),
               "nccl_version": ".".join(map(str, torch.cuda.nccl.version())),
               "initialize_multihost_one_process": noop,
               "group": "world-1 NCCL group joined by the phase (one "
                        "process: initialize_multihost is a no-op)",
               "checks": checks, "capture_supported": [ok, why]}
        emit(row)
        if not (checks["eager"] and checks["broadcast"]
                and all(replays) and ok):
            raise AssertionError(f"mesh_nccl: {row}")
    finally:
        dist.destroy_process_group()


#: the mesh_serve phase's traffic: 8 threads, 32 new tokens
MESH_SERVE_NEW = 32


def phase_mesh_serve(dev, cfg, params, smi):
    """The mesh engine at world size 1 on Mistral-7B int8 at full width and
    depth, on the serve phases' param tensors (no second copy): the
    deployed contiguous engine (4 slots, ``max_len`` 4096, window 8) and
    the paged one (8 slots, 1024 blocks of 64), each built with and
    without ``mesh=build_mesh(MeshConfig())``, on 8 threads of 32 new
    tokens under CUDA graphs. The mesh engine must run the un-meshed
    engine's kernels: greedy streams equal, launches by body equal,
    graphs captured and replayed, its allocated bytes within 0.1 GB of
    the un-meshed engine's. Each arm's ms a decode step (rounds of the
    same traffic, all replays, timed plain, mesh, mesh, plain, then over
    engines built again in the other order, mesh, plain, plain, mesh) is
    reported beside the other's with the gap of each pair and the gap
    between the engines built second and first (both replay the same
    graph; not a gate). Returns the mesh arm's first-round (launches,
    bodies) by path label."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.tokenizer import (
        ByteTokenizer,
    )
    from copilot_for_consensus_tpu_torch.parallel import (
        MeshConfig,
        build_mesh,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        build_prompt,
    )

    tok = ByteTokenizer(max(259, cfg.vocab_size))
    prompts = [tok.encode(build_prompt(t), add_bos=True)
               for t in synthetic_threads(8)]
    paths = {}
    for label, kw, used in (
            ("mesh_serve", dict(num_slots=4), ("K1", "K2")),
            ("mesh_serve_paged", dict(num_slots=8, prefill_chunk=64,
                                      kv_pool_blocks=1024),
             ("K1", "K2", "K3"))):
        def build(arm):
            mesh = build_mesh(MeshConfig()) if arm == "mesh" else None
            return GenerationEngine(cfg, params, max_len=4096,
                                    quantize="int8", device=dev, mesh=mesh,
                                    **kw)

        def timed_round(eng):
            """ms a decode step over one round of the traffic, every
            dispatch a replay of a bucket the first round captured."""
            dec0, n0 = eng.decode_s, eng.plain_dispatches
            eng.generate(prompts, max_new_tokens=MESH_SERVE_NEW)
            torch.cuda.synchronize()
            steps = (eng.plain_dispatches - n0) * eng._dispatch_steps
            return (eng.decode_s - dec0) / steps * 1e3

        runs, engines = {}, {}
        for arm in ("plain", "mesh"):
            t_arm = time.monotonic()
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            eng = build(arm)
            if arm == "mesh" and (
                    eng.params["layers"]["wq"]["q"] is not
                    params["layers"]["wq"]["q"]):
                raise AssertionError(f"{label}: the mesh engine copied the "
                                     f"weights")
            built = torch.cuda.memory_allocated() - base
            reset_launches()
            t0 = time.monotonic()
            comps = eng.generate(prompts, max_new_tokens=MESH_SERVE_NEW)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            runs[arm] = {
                "tokens": [c.tokens for c in comps],
                "launches": read_launches(), "bodies": read_bodies(),
                "allocated_gb": built / 1e9,
                "allocated_after_gb":
                    (torch.cuda.memory_allocated() - base) / 1e9,
                "wall_s": wall, "decode_tokens": eng.decode_tokens}
            engines[arm] = eng
            runs[arm]["arm_s"] = time.monotonic() - t_arm
        # ms a step, each arm timed first in one pair and second in the
        # other (plain, mesh, mesh, plain), then again over engines built
        # in the other order (mesh first), so that an order of timing or
        # of building shows apart from the mesh: (arm, built first, ms)
        rounds = [(arm, arm == "plain", timed_round(engines[arm]))
                  for arm in ("plain", "mesh", "mesh", "plain")]
        for arm, eng in engines.items():
            runs[arm]["graphs"] = eng.graph_stats()
        del eng, engines
        gc.collect()
        torch.cuda.empty_cache()
        engines = {arm: build(arm) for arm in ("mesh", "plain")}
        rebuilt_equal = 0
        for arm, eng in engines.items():
            comps = eng.generate(prompts, max_new_tokens=MESH_SERVE_NEW)
            rebuilt_equal += [c.tokens for c in comps] == \
                runs["plain"]["tokens"]
        rounds += [(arm, arm == "mesh", timed_round(engines[arm]))
                   for arm in ("mesh", "plain", "plain", "mesh")]
        del eng, engines
        p, m = runs["plain"], runs["mesh"]
        equal = [a == b for a, b in zip(p["tokens"], m["tokens"])]

        def mean_ms(pick):
            got = [t for arm, first, t in rounds if pick(arm, first)]
            return sum(got) / len(got)

        ms = {"plain": mean_ms(lambda a, f: a == "plain"),
              "mesh": mean_ms(lambda a, f: a == "mesh"),
              "built_first": mean_ms(lambda a, f: f),
              "built_second": mean_ms(lambda a, f: not f)}
        # each pair's gap, mesh over plain
        pair_gaps = []
        for i in range(0, len(rounds), 2):
            (a1, _, t1), (_, _, t2) = rounds[i], rounds[i + 1]
            pair_gaps.append(t2 / t1 - 1.0 if a1 == "plain"
                             else t1 / t2 - 1.0)
        row = {"phase": label, "config": cfg.name, "threads": len(prompts),
               "new_tokens": MESH_SERVE_NEW, "world_size": 1,
               "streams_equal": sum(equal),
               "launches_equal": (p["launches"], p["bodies"])
               == (m["launches"], m["bodies"]),
               "launches": m["launches"], "launches_by_body": m["bodies"],
               "graphs": {"plain": p["graphs"], "mesh": m["graphs"]},
               "engine_allocated_gb": {"plain": p["allocated_gb"],
                                       "mesh": m["allocated_gb"]},
               "allocated_after_gb": {"plain": p["allocated_after_gb"],
                                      "mesh": m["allocated_after_gb"]},
               "rebuilt_streams_equal": rebuilt_equal == 2,
               "rounds": [{"arm": arm, "built_first": first, "ms": t}
                          for arm, first, t in rounds],
               "ms_per_step": ms,
               "ms_per_step_gap": ms["mesh"] / ms["plain"] - 1.0,
               "pair_gaps": pair_gaps,
               "built_second_gap":
                   ms["built_second"] / ms["built_first"] - 1.0,
               "wall_s": {"plain": p["wall_s"], "mesh": m["wall_s"]},
               "arm_s": {"plain": p["arm_s"], "mesh": m["arm_s"]},
               "decode_tokens": m["decode_tokens"], "device": smi}
        emit(row)
        if not all(equal) or not row["rebuilt_streams_equal"]:
            raise AssertionError(f"{label}: mesh streams differ from the "
                                 f"un-meshed engine's: {equal}, rebuilt "
                                 f"{row['rebuilt_streams_equal']}")
        if not row["launches_equal"]:
            raise AssertionError(f"{label}: launches {m['bodies']} != "
                                 f"un-meshed {p['bodies']}")
        if not m["graphs"]["captured"] or not m["graphs"]["replays"]:
            raise AssertionError(f"{label}: graphs {m['graphs']}")
        if m["allocated_gb"] > p["allocated_gb"] + 0.1 or \
                m["allocated_after_gb"] > p["allocated_after_gb"] + 0.1:
            raise AssertionError(f"{label}: the mesh engine holds more: "
                                 f"{row['engine_allocated_gb']} "
                                 f"{row['allocated_after_gb']}")
        check_path(label, m["launches"], used)
        check_bodies(label, m["bodies"])
        check_k2_passes(label, m["launches"], m["bodies"], cfg.n_layers)
        paths[label] = (m["launches"], m["bodies"])
    gc.collect()
    torch.cuda.empty_cache()
    return paths


#: the mesh_features phase: each feature's traffic cut to 8 slots and at
#: most 8 threads (4 for the chunk and piggyback arms, whose eager
#: dispatches dominate), new tokens as given, on the mesh engine at world
#: size 1 beside the un-meshed one
MF_THREADS = 8


def _mf_arms(cfg):
    """The mesh_features arms: label → (engine keywords, rounds of
    prompts, new tokens, the counter that shows the feature ran, the
    kernels of the path). Spec reuses spec_serve's preset and prompts (32
    new tokens; 64 on the paged cell, whose first window of 32 decodes
    before any draft), the chunk arms paged_chunk's prompts (4 of 200–600
    tokens, 8 new), the prefix arm shared_prefix's shape on the paged
    cell (16 new), piggyback rag2k's (4 prompts: one piggyback dispatch,
    one window of 32 new); each cut to 8 slots."""
    import numpy as np

    from copilot_for_consensus_tpu_torch.engine.scheduler import (
        SchedulerConfig,
    )

    v = cfg.vocab_size
    rng = np.random.default_rng(4)
    spec_p = [copy_heavy(rng, v, SPEC_PROMPT) for _ in range(MF_THREADS)]
    chunk_p = [rng.integers(3, v, size=n).tolist()
               for n in np.linspace(200, 600, MF_THREADS // 2).astype(int)]
    common = rng.integers(3, v, size=PREFIX_SHARED).tolist()
    prefix_p = [common + rng.integers(3, v, size=PREFIX_PROMPT
                                      - PREFIX_SHARED).tolist()
                for _ in range(MF_THREADS)]
    piggy_p = [rng.integers(3, v, size=PIGGY_PROMPT).tolist()
               for _ in range(MF_THREADS // 2)]
    chunk = dict(scheduler=SchedulerConfig(chunk_tokens=64))
    return {
        "spec": ({**SPEC_SERVE, "num_slots": MF_THREADS,
                  "spec_decode": True}, [spec_p], 32, "spec_dispatches",
                 ("K1", "K2")),
        "spec_paged": ({**PAGED_CELL, "spec_decode": True}, [spec_p], 64,
                       "spec_dispatches", ("K1", "K2", "K3")),
        "chunk": ({"num_slots": MF_THREADS, "max_len": 2048, **chunk},
                  [chunk_p], 8, "chunk_dispatches", ("K2",)),
        "chunk_paged": ({**PAGED_CELL, **chunk}, [chunk_p], 8,
                        "chunk_dispatches", ("K2", "K3")),
        "prefix_paged": (dict(PAGED_CELL), [prefix_p, prefix_p], 16,
                         "zero_copy_admits", ("K1", "K2", "K3")),
        "piggy": ({**PIGGY, "num_slots": MF_THREADS,
                   "piggyback_min_prompt": PIGGY_MIN}, [piggy_p], 32,
                  "piggy_dispatches", ("K1", "K2")),
    }


def _mf_counter(eng, name: str) -> int:
    if name == "zero_copy_admits":
        return eng.kv_pool_stats()["zero_copy_admits"]
    return getattr(eng, name)


def phase_mesh_features(dev, cfg, params, smi):
    """The mesh engine's features at world size 1 on Mistral-7B int8 at
    full width and depth (``_mf_arms``): spec-decode verify and chunked
    prefill under the scheduler on the contiguous cache and the paged
    pool, paged prefix hits (a cold round, then the same prompts), and
    piggyback prefill on the contiguous cache, each arm on an engine built
    with ``mesh=build_mesh(MeshConfig())`` and on one built without, in
    turn (the mesh engine first). The mesh engine must run the un-meshed
    engine's kernels: greedy streams equal, launches by body equal, the
    feature's own counter above 0 (verify dispatches with accepted tokens,
    chunk dispatches, zero-copy admissions, piggyback dispatches), only the
    path's kernels, on their Hopper bodies. Then the journal arm: a mesh
    engine over the paged cell journals the chunk arms' 4 prompts (32 new
    tokens), stops after 2 steps without retiring, and a new mesh engine
    over the same journal warm-restarts them; the completions must equal an
    uninterrupted run's (the rows hold no checkpoint yet, so each
    continuation is its whole request again). Returns the mesh arms'
    (launches, bodies) by path."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.parallel import (
        MeshConfig,
        build_mesh,
    )

    paths = {}
    for label, (kw, rounds, new, counter, used) in _mf_arms(cfg).items():
        runs = {}
        for arm in ("mesh", "plain"):
            mesh = build_mesh(MeshConfig()) if arm == "mesh" else None
            eng = GenerationEngine(cfg, params, quantize="int8", device=dev,
                                   mesh=mesh, **kw)
            reset_launches()
            with plain_calls() as plain:
                t0 = time.monotonic()
                toks = [[c.tokens for c in eng.generate(p, new)]
                        for p in rounds]
                torch.cuda.synchronize()
                wall = time.monotonic() - t0
            runs[arm] = {"tokens": toks, "launches": read_launches(),
                         "bodies": read_bodies(), "wall_s": wall,
                         "counter": _mf_counter(eng, counter),
                         "accepted": eng.spec_stats()["accepted_tokens"],
                         "plain_calls": dict(plain),
                         "graphs": eng.graph_stats()}
            if eng.paged:
                pool = eng.kv_pool_stats()
                nodes = sum(pc.node_count for pc in eng._prefixes)
                runs[arm]["pool_books"] = (
                    pool["free_blocks"] + pool["pinned_blocks"]
                    == pool["num_blocks"] and pool["pinned_blocks"] == nodes)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        m, p = runs["mesh"], runs["plain"]
        row = {"phase": "mesh_features", "arm": label, "config": cfg.name,
               "threads": len(rounds[0]), "rounds": len(rounds),
               "new_tokens": new, "world_size": 1,
               "streams_equal": m["tokens"] == p["tokens"],
               "launches_equal": (m["launches"], m["bodies"])
               == (p["launches"], p["bodies"]),
               "counter": {counter: {"mesh": m["counter"],
                                     "plain": p["counter"]}},
               "accepted_tokens": m["accepted"],
               "launches": m["launches"], "launches_by_body": m["bodies"],
               "wall_s": {"mesh": m["wall_s"], "plain": p["wall_s"]},
               "graphs": m["graphs"], "pool_books": m.get("pool_books"),
               "device": smi}
        emit(row)
        if not (row["streams_equal"] and row["launches_equal"]):
            raise AssertionError(f"mesh_features {label}: the mesh engine "
                                 f"differs from the un-meshed one: {row}")
        if m["counter"] <= 0 or (counter == "spec_dispatches"
                                 and m["accepted"] <= 0):
            raise AssertionError(f"mesh_features {label}: the feature did "
                                 f"not run: {row}")
        if m["plain_calls"] or m.get("pool_books") is False:
            raise AssertionError(f"mesh_features {label}: a plain version "
                                 f"ran or the pool's books do not hold: "
                                 f"{m['plain_calls']} {row['pool_books']}")
        check_path(f"mesh_features {label}", m["launches"], used)
        check_bodies(f"mesh_features {label}", m["bodies"])
        paths[f"mesh_features_{label}"] = (m["launches"], m["bodies"])
    phase_mesh_journal(dev, cfg, params, smi)
    return paths


def phase_mesh_journal(dev, cfg, params, smi):
    """The journal on the mesh at world size 1 (``phase_mesh_features``'
    last arm): stop, warm-restart, completions against an uninterrupted
    run's."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.parallel import (
        MeshConfig,
        build_mesh,
    )

    kw, (prompts,), _ = _mf_arms(cfg)["chunk_paged"][:3]
    kw = {k: v for k, v in kw.items() if k != "scheduler"}
    new = 32                # past the 2 steps' 17 tokens: none retires
    path = Path(__file__).resolve().parent / "build" / \
        "mesh_features_journal.sqlite3"
    path.parent.mkdir(exist_ok=True)
    for f in path.parent.glob(path.name + "*"):
        f.unlink()
    journal = {"path": str(path), "checkpoint_every": 1000}

    def engine(**extra):
        return GenerationEngine(cfg, params, quantize="int8", device=dev,
                                **kw, **extra)

    want = [c.tokens for c in engine().generate(prompts, new)]
    gc.collect()
    eng = engine(mesh=build_mesh(MeshConfig()), journal=journal)
    ids = [eng.submit(p, new) for p in prompts]
    done = {}
    for _ in range(2):
        for c in eng.step():
            done[c.request_id] = c
    depth = eng.journal.depth()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    back = engine(mesh=build_mesh(MeshConfig()), journal=journal)
    rec = {rid: i for i, (rid, _c) in enumerate(back.journal_recovered)}
    unfinished = [i for i, r in enumerate(ids) if r not in done]
    t0 = time.monotonic()
    got = {}
    while len(got) < len(rec):
        for c in back.step():
            got[c.request_id] = c
    torch.cuda.synchronize()
    comps = {ids.index(r): c for r, c in done.items()}
    for rid, c in got.items():
        comps[unfinished[rec[rid]]] = c
    tokens = [comps[i].tokens for i in range(len(prompts))]
    row = {"phase": "mesh_journal", "config": cfg.name, "world_size": 1,
           "threads": len(prompts), "new_tokens": new,
           "stopped_after_steps": 2, "journal_depth_at_stop": depth,
           "replayed": back.journal_replayed,
           "abandoned": back.journal_abandoned,
           "journal_stats": back.journal_stats(),
           "restart_s": time.monotonic() - t0,
           "completions_equal": tokens == want, "device": smi}
    emit(row)
    del back
    gc.collect()
    torch.cuda.empty_cache()
    for f in path.parent.glob(path.name + "*"):
        f.unlink()
    if not (row["completions_equal"] and row["replayed"] == len(unfinished)
            and row["replayed"] > 0):
        raise AssertionError(f"mesh_journal: {row}")


#: mesh_gloo2: two processes share the card as a world-2 gloo mesh, tp2
#: then dp2, at 2 layers of mistral-7b's widths (int8, bf16; the lm_head
#: keeps a 64-token alphabet, as spec_chunk_f32's, so drafts fire)
GLOO2_TIMEOUT_S = 420
GLOO2_BASE = dict(num_slots=4, max_len=1024, prefill_buckets=(128, 512),
                  decode_window=8, dtype="bfloat16", quantize="int8")


def _gloo2_params(cfg, dev):
    """Seed-0 bf16 weights at ``cfg``, the lm_head cut to an alphabet,
    and prompts drawn from it: (params, prompts by case)."""
    import numpy as np
    import torch

    from copilot_for_consensus_tpu_torch.models import decoder

    params = decoder.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                 device=dev)
    rng = np.random.default_rng(2)
    alphabet = rng.choice(np.arange(3, cfg.vocab_size), F32_ALPHABET,
                          replace=False)
    keep = torch.zeros(cfg.vocab_size, dtype=torch.bool, device=dev)
    keep[torch.from_numpy(alphabet).to(dev)] = True
    params["lm_head"] = params["lm_head"] * keep

    def draw(n):
        return rng.choice(alphabet, n).tolist()
    common = draw(256)
    prompts = {"plain": [draw(n) for n in (200, 90, 300, 150)],
               "spec": [draw(320) for _ in range(4)],
               "chunk": [draw(n) for n in (300, 90, 512, 200)],
               "paged_prefix": [common + draw(64) for _ in range(4)],
               "piggy": [draw(n) for n in (300, 200, 90, 400)]}
    return params, prompts


#: the logits a mesh_gloo2 case keeps of each (kind, dispatch, round) of
#: its sample and verify_draft calls: the first few
GLOO2_LOGITS_KEPT = 3
#: the calls that hold each case's feature: the first wave's draw (plain),
#: a verify pass's acceptance (spec), a chunk pass's candidate (chunk), the
#: repeat round's seeded hits (paged_prefix), a piggyback dispatch's draws
GLOO2_FEATURE_CALL = {
    "plain": lambda c: c["kind"] == "sample" and c["round"] == 0,
    "spec": lambda c: c["kind"] == "verify",
    "chunk": lambda c: c["where"] == "chunk",
    "paged_prefix": lambda c: c["round"] == 1,
    "piggy": lambda c: c["where"] == "piggy"}


@contextlib.contextmanager
def gloo2_call_log(eng, follow: list | None = None):
    """Every ``sample`` and ``verify_draft`` call the engine module makes in
    the block, in order (yielded list; the caller sets ``log.round``): its
    kind, the dispatch it ran in ("chunk", "piggy" or ""), the round, its
    outputs, and its logits on the host for the first
    ``GLOO2_LOGITS_KEPT`` calls of each (kind, dispatch, round). With
    ``follow`` (another run's log of the same traffic), each call returns
    that run's outputs of the same call in place of its own (``own_equal``
    says whether they agreed): the engine walks the other run's token
    path, so every call reads the context the other run's call read."""
    import torch

    from copilot_for_consensus_tpu_torch.engine import generation

    class Log(list):
        round = 0
    log, where, kept = Log(), [""], {}
    real_sample, real_verify = generation.sample, generation.verify_draft

    def record(kind, logits, outs) -> list:
        key = (kind, where[0], log.round)
        keep = kept.get(key, 0) < GLOO2_LOGITS_KEPT
        kept[key] = kept.get(key, 0) + keep
        entry = {"kind": kind, "where": where[0], "round": log.round,
                 "out": [o.cpu().tolist() for o in outs], "own_equal": None,
                 "logits": logits.float().cpu() if keep else None}
        i = len(log)
        log.append(entry)
        if follow is None or i >= len(follow) \
                or follow[i]["kind"] != kind:
            return list(outs)
        forced = [torch.tensor(v, dtype=o.dtype, device=o.device)
                  for v, o in zip(follow[i]["out"], outs)]
        if any(f.shape != o.shape for f, o in zip(forced, outs)):
            return list(outs)
        entry["own_equal"] = entry["out"] == follow[i]["out"]
        return forced

    def sample(logits, gen, scfg):
        return record("sample", logits, (real_sample(logits, gen, scfg),))[0]

    def verify_draft(logits, *a):
        return tuple(record("verify", logits, real_verify(logits, *a)))

    def inside(tag, fn):
        def run(*a, **kw):
            where[0] = tag
            try:
                return fn(*a, **kw)
            finally:
                where[0] = ""
        return run

    eng._chunk_step = inside("chunk", eng._chunk_step)
    eng._dispatch_piggyback = inside("piggy", eng._dispatch_piggyback)
    with patched(generation, "sample", sample), \
            patched(generation, "verify_draft", verify_draft):
        yield log


def gloo2_compare(got: list, want: list, feature) -> dict:
    """A mesh rank's call log against the un-meshed engine's, which
    followed it (``gloo2_call_log``): the same calls in the same order
    (``calls_match``), the logits both kept held by rel-L2, whether a call
    of the case's feature was among them, and how many of the un-meshed
    engine's own draws agreed with the rank's (tp sums in another order,
    so a near tie may turn)."""
    import numpy as np

    worst, compared, reached = 0.0, 0, False
    match = len(got) == len(want)
    for g, w in zip(got, want):
        if (g["kind"], g["where"], g["round"]) \
                != (w["kind"], w["where"], w["round"]):
            match = False
            break
        if g["logits"] is not None and w["logits"] is not None:
            a, b = g["logits"].numpy(), w["logits"].numpy()
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b)) \
                if a.shape == b.shape else float("inf")
            worst = max(worst, rel)
            compared += 1
            reached |= bool(feature(g))
    return {"calls_match": match, "calls": len(got), "rel_l2": worst,
            "compared": compared, "feature_reached": reached,
            "own_draws_equal": sum(bool(w["own_equal"]) for w in want)}


def _gloo2_cases(cfg, params, prompts, dev, mesh,
                 follow: dict | None = None) -> dict:
    """Each case of mesh_gloo2 on ``mesh`` (None: the un-meshed engine):
    its streams, the feature's counter, the graphs' state, and its
    ``gloo2_call_log`` (following ``follow[case]`` where given)."""
    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.scheduler import (
        SchedulerConfig,
    )

    cases = {
        "plain": ({}, 32, None),
        "spec": (dict(spec_decode=True), 64, "spec_dispatches"),
        "chunk": (dict(scheduler=SchedulerConfig(chunk_tokens=64)), 24,
                  "chunk_dispatches"),
        "paged_prefix": (dict(prefill_chunk=64, kv_pool_blocks=80,
                              prefix_cache_blocks=1), 16,
                         "zero_copy_admits"),
        "piggy": (dict(prefill_chunk=64, piggyback_min_prompt=64), 16,
                  "piggy_dispatches")}
    out = {}
    for name, (kw, new, counter) in cases.items():
        # the ranks probe capture and fall back to eager; the un-meshed
        # engine runs eager too, so its log sees every call
        eng = GenerationEngine(cfg, params, device=dev, mesh=mesh,
                               cuda_graphs=mesh is not None, **GLOO2_BASE,
                               **kw)
        toks = []
        with gloo2_call_log(eng, (follow or {}).get(name)) as log:
            for r in range(2 if name == "paged_prefix" else 1):
                log.round = r
                toks.append([c.tokens
                             for c in eng.generate(prompts[name], new)])
        out[name] = {"tokens": toks,
                     "counter": _mf_counter(eng, counter) if counter
                     else None,
                     "accepted": eng.spec_stats()["accepted_tokens"],
                     "graphs": eng.graph_stats(), "calls": list(log)}
        del eng
    return out


def gloo2_rank(spec_path: str, rank: int) -> int:
    """One rank of mesh_gloo2 (``python chip_smoke.py --gloo2-rank SPEC
    RANK``): joins the world-2 gloo group over TCP on localhost, serves
    ``_gloo2_cases`` on tp2 and then dp2 on the card, and writes what each
    gave to the spec's output path for its rank (``torch.save``: the call
    logs hold the logits as tensors)."""
    import traceback

    import torch
    import torch.distributed as dist

    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )
    from copilot_for_consensus_tpu_torch.parallel import (
        MeshConfig,
        build_mesh,
    )
    from copilot_for_consensus_tpu_torch.parallel.multihost import (
        initialize_multihost,
    )

    spec = json.loads(Path(spec_path).read_text())
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out: dict = {"rank": rank}
    try:
        initialize_multihost({"coordinator_address": spec["address"],
                              "num_processes": 2, "process_id": rank},
                             backend="gloo", timeout_s=spec["timeout_s"])
        cfg = decoder_config("mistral-7b", n_layers=F32_LAYERS)
        params, prompts = _gloo2_params(cfg, dev)
        for tag, dp, tp in (("tp2", 1, 2), ("dp2", 2, 1)):
            mesh = build_mesh(MeshConfig(dp=dp, tp=tp),
                              timeout_s=spec["timeout_s"])
            t0 = time.monotonic()
            out[tag] = _gloo2_cases(cfg, params, prompts, dev, mesh)
            out[f"{tag}_s"] = time.monotonic() - t0
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, f"{spec['out']}.{rank}.pt")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def phase_mesh_gloo2(dev, smi):
    """Two processes share the one card as a world-2 gloo mesh
    (``initialize_multihost(backend="gloo")``; gloo moves CUDA tensors
    through the host), first as tp2, then as dp2, at 2 layers of
    mistral-7b's widths in int8 and bf16 (``GLOO2_BASE``): plain serving,
    spec-decode verify, chunked prefill under the scheduler, paged prefix
    hits over two rounds, and piggyback prefill. The kernels were built by
    this process before the spawn. The two ranks' streams must equal each
    other's, each feature's counter must be above 0, the decode graphs
    stay off (the engine's own probe finds gloo's collectives not
    capturable: ``eager_reason``). Then the un-meshed bf16 engine on the
    same card serves each case again following rank 0's draws
    (``gloo2_call_log``), so each of its calls reads rank 0's context: it
    must make rank 0's calls in rank 0's order, and their logits, those of
    the case's feature among them (``GLOO2_FEATURE_CALL``), must lie
    within rel-L2 5e-2 of rank 0's (tp sums partial products in another
    order). A timeout or an error in either rank fails the phase; both
    processes end with it."""
    import socket

    import torch

    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    work = Path(tempfile.mkdtemp(prefix="mesh_gloo2_"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spec = {"address": f"127.0.0.1:{port}", "out": str(work / "rank"),
            "timeout_s": 120}
    (work / "spec.json").write_text(json.dumps(spec))
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--gloo2-rank", str(work / "spec.json"),
                               str(r)], stdout=subprocess.DEVNULL)
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, GLOO2_TIMEOUT_S
                               - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"mesh_gloo2: the ranks did not finish in "
                             f"{GLOO2_TIMEOUT_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.monotonic() - t0
    ranks = []
    for r in range(2):
        f = Path(f"{spec['out']}.{r}.pt")
        ranks.append(torch.load(f, weights_only=False) if f.exists()
                     else {"error": "no result"})
    shutil.rmtree(work, ignore_errors=True)
    errors = {r: res["error"][-3000:] for r, res in enumerate(ranks)
              if "error" in res}
    if errors:
        emit({"phase": "mesh_gloo2", "errors": errors, "device": smi})
        raise AssertionError(f"mesh_gloo2: {errors}")
    cfg = decoder_config("mistral-7b", n_layers=F32_LAYERS)
    params, prompts = _gloo2_params(cfg, dev)
    refs = {tag: _gloo2_cases(cfg, params, prompts, dev, None, follow={
        name: case["calls"] for name, case in ranks[0][tag].items()})
        for tag in ("tp2", "dp2")}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": "mesh_gloo2", "config": cfg.name,
           "layers": cfg.n_layers, "base": GLOO2_BASE,
           "spawn_s": spawn_s, "device": smi}
    ok = True
    for tag in ("tp2", "dp2"):
        a, b, ref = ranks[0][tag], ranks[1][tag], refs[tag]
        cases = {}
        for name in a:
            ca, cb = a[name], b[name]
            logits = gloo2_compare(ca["calls"], ref[name]["calls"],
                                   GLOO2_FEATURE_CALL[name])
            cases[name] = {
                "ranks_equal": ca["tokens"] == cb["tokens"],
                "logits": logits,
                "counter": ca["counter"], "accepted": ca["accepted"],
                "eager_reason": ca["graphs"].get(
                    "eager_reason", "").split("\n")[0],
                "captured": ca["graphs"]["captured"]}
            ok &= cases[name]["ranks_equal"] \
                and bool(cases[name]["eager_reason"]) \
                and not cases[name]["captured"] \
                and (ca["counter"] is None or ca["counter"] > 0) \
                and logits["calls_match"] and logits["feature_reached"] \
                and logits["rel_l2"] <= 5e-2
        row[tag] = {"seconds": ranks[0][f"{tag}_s"], "cases": cases}
    emit(row)
    if not ok:
        raise AssertionError(f"mesh_gloo2: {row}")


#: mesh_async_gloo2: two processes share the card as a world-2 gloo mesh;
#: rank 0 serves summarize_async through MeshEngineRunner and rank 1 follows
#: its operation log (``CUDASummarizer.follow()``). The groups' timeout is
#: short, so that the idle gap outlasts it
ASYNC2_TIMEOUT_S = 5.0
ASYNC2_SPAWN_S = 360
#: the tp2 arm: mistral-7b at full width and depth, the deployed geometry
ASYNC2_TP = dict(num_slots=4, max_len=4096, dtype="bfloat16",
                 quantize="int8")
ASYNC2_TP_NEW = 16
#: the dp2 arm: 2 layers of mistral-7b's widths on the paged pool with the
#: prefix cache, and one decode fault on every rank
ASYNC2_DP = dict(GLOO2_BASE, prefill_buckets=(128, 512, 1024),
                 prefill_chunk=64, kv_pool_blocks=80, prefix_cache_blocks=1)
ASYNC2_DP_NEW = 16
ASYNC2_FAULT = dict(kind="decode", at=3)
#: the two submitting threads' arrivals (thread, pause before it); the
#: threads submitted after the idle gap
ASYNC2_ARRIVALS = ([(0, 0.0), (2, 0.2), (4, 0.4)],
                   [(1, 0.1), (3, 0.3), (5, 0.2)])
ASYNC2_LATE = (6, 7)


def _store_barrier(store, key: str, n: int, timeout_s: float = 600.0):
    """Wait until ``n`` ranks reached ``key`` (the job's store, outside
    every group: a rank slower to build its engine than the groups'
    timeout is waited for here, not in a collective)."""
    store.add(key, 1)
    deadline = time.monotonic() + timeout_s
    while store.add(key, 0) < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"{key}: {n} ranks did not arrive")
        time.sleep(0.01)


def _async2_lead(summ, threads, gap_s: float, waves: bool) -> dict:
    """Rank 0's traffic: six threads from two submitting threads at
    staggered times, an idle gap of ``gap_s``, two more; then drain. With
    ``waves``, four threads, the gap, four more: each wave fills the slots
    in order and retires together, so an un-meshed engine places every
    request in rank 0's slot (the dp2 arm's replay)."""
    import threading

    waits, errors = {}, []
    if waves:
        half = len(threads) // 2
        done = {i: w(600) for i, w in
                [(i, summ.summarize_async(threads[i],
                                          correlation_id=f"a{i}"))
                 for i in range(half)]}
        late = range(half, len(threads))
        return _async2_end(summ, threads, done, late, gap_s)

    def submit(plan):
        try:
            for i, pause in plan:
                time.sleep(pause)
                waits[i] = summ.summarize_async(threads[i],
                                                correlation_id=f"a{i}")
        except Exception as exc:        # reported in the row, then failed
            errors.append(f"{type(exc).__name__}: {exc}")

    subs = [threading.Thread(target=submit, args=(plan,))
            for plan in ASYNC2_ARRIVALS]
    for t in subs:
        t.start()
    for t in subs:
        t.join(600)
    if errors:
        raise AssertionError(f"summarize_async: {errors}")
    done = {i: w(600) for i, w in waits.items()}
    return _async2_end(summ, threads, done, ASYNC2_LATE, gap_s)


def _async2_end(summ, threads, done: dict, late, gap_s: float) -> dict:
    """The idle gap, then the ``late`` threads together; drain."""
    runner = summ._runner
    t0 = time.monotonic()
    time.sleep(gap_s)
    idle = time.monotonic() - t0
    waits = [(i, summ.summarize_async(threads[i], correlation_id=f"a{i}"))
             for i in late]
    for i, w in waits:
        done[i] = w(600)
    oplog = runner.oplog
    rec = runner.recovery_stats()
    drained = summ.drain(120)
    return {"completion_tokens": [done[i].completion_tokens
                                  for i in range(len(threads))],
            "idle_s": idle, "drained": drained,
            "completions": oplog.completions, "batches": oplog.batches,
            "log": oplog.stats(),
            "recovery": {k: rec.get(k) for k in (
                "replayed", "recovered", "failed", "containments",
                "watchdog_trips", "suspect_failures")}}


def _async2_arm(tag: str, mesh, rank: int, dev, store) -> dict:
    """One arm of mesh_async_gloo2 on this rank: the engine, the
    summarizer over it, rank 0's traffic or rank 1's ``follow()``, every
    ``sample`` call logged (``gloo2_call_log``), and the launches by body
    of the served path."""
    import torch

    from copilot_for_consensus_tpu_torch.engine.faults import (
        FaultPlan,
        FaultSpec,
    )
    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.models import decoder, quant
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )
    from copilot_for_consensus_tpu_torch.summarization.summarizer import (
        CUDASummarizer,
    )

    if tag == "tp2":
        cfg = decoder_config("mistral-7b")
        params = quant.init_random_quantized(cfg, seed=0,
                                             dtype=torch.bfloat16,
                                             device=dev)
        eng = GenerationEngine(cfg, params, device=dev, mesh=mesh,
                               **ASYNC2_TP)
        new = ASYNC2_TP_NEW
    else:
        cfg = decoder_config("mistral-7b", n_layers=F32_LAYERS)
        params = decoder.init_params(cfg, seed=0, dtype=torch.bfloat16,
                                     device=dev)
        eng = GenerationEngine(
            cfg, params, device=dev, mesh=mesh,
            faults=FaultPlan(specs=[FaultSpec(**ASYNC2_FAULT)]),
            **ASYNC2_DP)
        new = ASYNC2_DP_NEW
    del params
    gc.collect()
    torch.cuda.empty_cache()
    threads = synthetic_threads(8)
    if tag == "dp2":
        # one chunk a thread: a replay's continuation (prompt and tokens)
        # stays within the prompt limit
        threads = [dataclasses.replace(t, chunks=t.chunks[:1])
                   for t in threads]
    summ = CUDASummarizer(cfg.name, engine=eng, max_new_tokens=new,
                          supervisor=True)
    summ.keep_mesh_log = True
    _store_barrier(store, f"async2/{tag}", 2)
    reset_launches()
    t0 = time.monotonic()
    with gloo2_call_log(eng) as log:
        if rank == 0:
            out = _async2_lead(summ, threads, ASYNC2_TIMEOUT_S + 1.0,
                               waves=tag == "dp2")
        else:
            out = summ.follow(keep=True)
        torch.cuda.synchronize()
    out.update(wall_s=time.monotonic() - t0, launches=read_launches(),
               bodies=read_bodies(), graphs=eng.graph_stats(),
               calls=list(log), config=cfg.name, layers=cfg.n_layers,
               allocated_gib=torch.cuda.max_memory_allocated() / 2**30)
    del summ, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def async2_rank(spec_path: str, rank: int) -> int:
    """One rank of mesh_async_gloo2 (``python chip_smoke.py
    --gloo2-async-rank SPEC RANK``): joins the world-2 gloo group over TCP
    on localhost with the phase's short timeout, serves the tp2 arm and
    then the dp2 arm on the card (rank 0 through ``summarize_async``, rank
    1 through ``follow()``), and writes what each gave to the spec's
    output path for its rank (``torch.save``)."""
    import traceback

    import torch
    import torch.distributed as dist

    from copilot_for_consensus_tpu_torch.parallel import (
        MeshConfig,
        build_mesh,
    )
    from copilot_for_consensus_tpu_torch.parallel.multihost import (
        default_store,
        initialize_multihost,
    )

    spec = json.loads(Path(spec_path).read_text())
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    out: dict = {"rank": rank}
    try:
        initialize_multihost({"coordinator_address": spec["address"],
                              "num_processes": 2, "process_id": rank},
                             backend="gloo", timeout_s=spec["timeout_s"])
        for tag, dp, tp in (("tp2", 1, 2), ("dp2", 2, 1)):
            mesh = build_mesh(MeshConfig(dp=dp, tp=tp),
                              timeout_s=spec["timeout_s"])
            out[tag] = _async2_arm(tag, mesh, rank, dev, default_store())
    except Exception:
        out["error"] = traceback.format_exc()
    torch.save(out, f"{spec['out']}.{rank}.pt")
    if dist.is_initialized() and "error" not in out:
        dist.destroy_process_group()
    return 0


def _async2_first_wave(cfg, params, dev, batches) -> list:
    """The un-meshed engine's call log of rank 0's first step: the first
    batch's submits, as rank 0's engine admitted them, and one step."""
    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )

    eng = GenerationEngine(cfg, params, device=dev, cuda_graphs=False,
                           **ASYNC2_TP)
    with gloo2_call_log(eng) as log:
        for op in batches[0]:
            if op[0] == "submit":
                _, rid, prompt, mnt, kw = op
                if eng.submit(prompt, mnt, **kw) != rid:
                    raise AssertionError("mesh_async_gloo2: the first "
                                         "wave's ids differ")
        eng.step()
    del eng
    return list(log)


def phase_mesh_async_gloo2(dev, cfg, params, smi):
    """The async front end over a world-2 gloo mesh on the one card: two
    processes (``python chip_smoke.py --gloo2-async-rank``), rank 0 serving
    ``CUDASummarizer(mesh=..., supervisor=True).summarize_async`` on 8
    synthetic threads from two submitting threads at staggered times, with
    an idle gap longer than the groups' timeout (set to
    ``ASYNC2_TIMEOUT_S`` for the phase), rank 1 serving rank 0's
    operation log through ``CUDASummarizer.follow()``. The tp2 arm runs
    ``cfg`` (mistral-7b) at full width and depth on the seed-0 int8
    weights (``params``, the same tensors each rank builds): every handle
    completes and ``drain`` returns True, rank 1's completions and request
    ids equal rank 0's, the first wave's logits lie within rel-L2 5e-2 of
    the un-meshed engine's on the same admissions, and each rank launched
    K1 on its wgmma body and K2 on its stream and wgmma bodies at the tp2
    shard shapes. The dp2 arm runs 2 layers of mistral-7b's widths on the
    paged pool with the prefix cache, every rank given the same fault
    plan (one decode fault): one containment and its replays on rank 0,
    the completions equal on both ranks, an un-meshed engine that replays
    rank 0's log (``mesh_runner.replay``) while following rank 0's draws
    (``gloo2_call_log``) makes rank 0's calls with logits within rel-L2
    5e-2 of rank 0's, and K3 launched on its decode and seeded bodies on
    each rank. The row gives each rank's wall, the operations a step and
    the control channel's ms a step beside the step's ms. Returns rank
    0's (launches, bodies) of each arm."""
    import socket

    import torch

    from copilot_for_consensus_tpu_torch.engine.faults import (
        FaultPlan,
        FaultSpec,
    )
    from copilot_for_consensus_tpu_torch.engine.generation import (
        GenerationEngine,
    )
    from copilot_for_consensus_tpu_torch.engine.mesh_runner import replay
    from copilot_for_consensus_tpu_torch.models import decoder
    from copilot_for_consensus_tpu_torch.models.configs import (
        decoder_config,
    )

    work = Path(tempfile.mkdtemp(prefix="mesh_async_gloo2_"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    spec = {"address": f"127.0.0.1:{port}", "out": str(work / "rank"),
            "timeout_s": ASYNC2_TIMEOUT_S}
    (work / "spec.json").write_text(json.dumps(spec))
    t0 = time.monotonic()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                               "--gloo2-async-rank", str(work / "spec.json"),
                               str(r)], stdout=subprocess.DEVNULL)
             for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, ASYNC2_SPAWN_S
                               - (time.monotonic() - t0)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"mesh_async_gloo2: the ranks did not finish "
                             f"in {ASYNC2_SPAWN_S} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    spawn_s = time.monotonic() - t0
    ranks = []
    for r in range(2):
        f = Path(f"{spec['out']}.{r}.pt")
        ranks.append(torch.load(f, weights_only=False) if f.exists()
                     else {"error": "no result"})
    shutil.rmtree(work, ignore_errors=True)
    errors = {r: res["error"][-3000:] for r, res in enumerate(ranks)
              if "error" in res}
    if errors:
        emit({"phase": "mesh_async_gloo2", "errors": errors, "device": smi})
        raise AssertionError(f"mesh_async_gloo2: {errors}")

    def per_step(res, key):
        steps = res.get("log", res).get("steps", 0) or 1
        return 1e3 * res.get("log", res)[key] / steps

    row = {"phase": "mesh_async_gloo2", "spawn_s": spawn_s,
           "timeout_s": ASYNC2_TIMEOUT_S, "device": smi}
    ok = True
    paths = {}
    # the tp2 arm: the first wave against the un-meshed engine on the
    # same tensors
    a, b = ranks[0]["tp2"], ranks[1]["tp2"]
    want = _async2_first_wave(cfg, params, dev, a["batches"])
    ga, gw = a["calls"][0]["logits"], want[0]["logits"]
    rel = float(torch.linalg.vector_norm(ga - gw)
                / torch.linalg.vector_norm(gw)) \
        if ga.shape == gw.shape else float("inf")
    gc.collect()
    torch.cuda.empty_cache()
    # the dp2 arm: an un-meshed engine replays rank 0's log, following its
    # draws
    a2, b2 = ranks[0]["dp2"], ranks[1]["dp2"]
    cfg2 = decoder_config("mistral-7b", n_layers=F32_LAYERS)
    params2 = decoder.init_params(cfg2, seed=0, dtype=torch.bfloat16,
                                  device=dev)
    ref = GenerationEngine(cfg2, params2, device=dev, cuda_graphs=False,
                           faults=FaultPlan(specs=[FaultSpec(
                               **ASYNC2_FAULT)]), **ASYNC2_DP)
    with gloo2_call_log(ref, a2["calls"]) as log:
        replayed = replay(ref, a2["batches"])
    follow = gloo2_compare(a2["calls"], list(log),
                           lambda c: c["kind"] == "sample")
    del ref, params2
    gc.collect()
    torch.cuda.empty_cache()
    for tag, lead, fol, used in (("tp2", a, b, ("K1", "K2")),
                                 ("dp2", a2, b2, ("K1", "K2", "K3"))):
        arm = {
            "config": lead["config"], "layers": lead["layers"],
            "threads": len(lead["completion_tokens"]),
            "completion_tokens": lead["completion_tokens"],
            "drained": lead["drained"], "idle_s": lead["idle_s"],
            "completions_equal": lead["completions"] == fol["completions"],
            "completions": len(lead["completions"]),
            "recovery": lead["recovery"], "follower_contained":
                fol["contained"],
            "wall_s": [lead["wall_s"], fol["wall_s"]],
            "steps": [lead["log"]["steps"], fol["steps"]],
            "ops_per_step": lead["log"]["ops"] / max(1, lead["log"][
                "steps"]),
            "channel_ms_per_step": [per_step(lead, "publish_s"),
                                    1e3 * fol["channel_s"]
                                    / max(1, fol["steps"])],
            "step_ms": [per_step(lead, "step_s"),
                        1e3 * fol["step_s"] / max(1, fol["steps"])],
            "follower_wait_s": fol["wait_s"],
            "launches": [lead["launches"], fol["launches"]],
            "launches_by_body": [lead["bodies"], fol["bodies"]],
            "eager_reason": lead["graphs"].get("eager_reason",
                                               "").split("\n")[0],
            "allocated_gib": [lead["allocated_gib"], fol["allocated_gib"]]}
        ok &= bool(arm["drained"]) and arm["completions_equal"] \
            and arm["completions"] == arm["threads"] \
            and all(n > 0 for n in arm["completion_tokens"]) \
            and arm["idle_s"] > ASYNC2_TIMEOUT_S
        for r, res in ((0, lead), (1, fol)):
            check_path(f"mesh_async_gloo2 {tag} rank {r}", res["launches"],
                       used)
            check_bodies(f"mesh_async_gloo2 {tag} rank {r}", res["bodies"])
            k = res["bodies"]
            ok &= k["K1"]["wgmma"] > 0 and k["K2"]["stream"] > 0 \
                and k["K2"]["wgmma"] > 0
            if tag == "dp2":
                ok &= k["K3"]["decode"] > 0 and k["K3"]["seeded"] > 0
        row[tag] = arm
        paths[f"mesh_async_{tag}"] = (lead["launches"], lead["bodies"])
    row["tp2"]["first_wave_rel_l2"] = rel
    row["tp2"]["first_wave_rows"] = list(ga.shape)
    row["dp2"]["fault"] = ASYNC2_FAULT
    row["dp2"]["replay"] = {**follow,
                            "completions_equal": replayed
                            == a2["completions"]}
    ok &= rel <= 5e-2
    ok &= a2["recovery"]["containments"] == 1 \
        and a2["recovery"]["replayed"] > 0 and b2["contained"] == 1
    ok &= follow["calls_match"] and follow["rel_l2"] <= 5e-2 \
        and follow["compared"] > 0 and row["dp2"]["replay"][
            "completions_equal"]
    emit(row)
    if not ok:
        raise AssertionError(f"mesh_async_gloo2: {row}")
    return paths


def tp_cases(tp: int):
    """The shard shapes one rank of a tp-``tp`` Mistral-7B mesh runs:
    K2's int8 leaves (D, F) (w_gate's and w_up's shape once, wk's and
    wv's once), K5's int4 leaves as the mesh engine fuses them after the
    cut (wqkv, wo, w_gu, w_down, the lm_head; group 256), K1's prefill
    attention (B 4, S 1024, D 128) at 32/tp q heads over 8/tp kv heads,
    and K3's decode at 8/tp kv heads (R 4)."""
    k2 = [("wq", 4096, 4096 // tp), ("wk", 4096, 1024 // tp),
          ("wo", 4096 // tp, 4096), ("w_gate", 4096, 14336 // tp),
          ("w_down", 14336 // tp, 4096), ("lm_head", 4096, 32000 // tp)]
    k5 = [("wqkv", 4096, (32 + 16) * 128 // tp), ("wo", 4096 // tp, 4096),
          ("w_gu", 4096, 2 * 14336 // tp), ("w_down", 14336 // tp, 4096),
          ("lm_head", 4096, 32000 // tp)]
    return k2, k5


#: the mesh features' K2 rows at a tp rank's widths: a verify pass of 16
#: and 32 slots x (k+1 = 9) rows, 288 also the piggyback dispatch's
#: 32 + 4 x 64 rows
TP_FEATURE_M = (144, 288)


def tp_k3_cases(tp: int):
    """(label, kv heads, R, lengths) of K3 at a tp rank's kv heads: the
    decode step (R 4), and the mesh features' seeded passes, a verify of
    k = 8 (R 36) and a 64-token chunk (R 256)."""
    hkv = 8 // tp
    return [("decode", hkv, 4, [0, 1, 64, 65, 1000, 4095, 2048, 777]),
            ("verify_k8", hkv, 4 * 9, [0, 1, 64, 333, 512, 777, 960, 1000]),
            ("chunk_s64", hkv, 4 * 64, [0, 0, 64, 128, 640, 896, 960, 0])]


def phase_tp_shapes(dev, flush):
    """Every shard shape a tp-2 or tp-4 rank of a four-card cell runs,
    held against its plain version on the card with the kernel phases'
    gates, each timed beside its bound and a PyTorch call: K2 at M 4 (its
    stream body), M 144 and 288 (a verify pass of 16 and 32 slots at
    k = 8, and the piggyback dispatch's rows) and M 4096 (wgmma), K5 at
    M 32 (stream) and M 4096 (wgmma), K1 at the local head counts for a
    prefill wave and the piggyback lanes (``piggy_s64``), and K3's decode
    and seeded passes (verify R 36, chunk R 256) at the local kv heads
    over a pool shard of 512 blocks. Each row names the body
    the shape launched (the wrapper's counters) and the body the rules of
    ``ops/quant_matmul.py`` want for it; a shape on another body is
    reported, not gated (a finding, not a failure). Returns the rows by
    (kernel, tp case, dtype)."""
    import torch
    import torch.nn.functional as F

    from copilot_for_consensus_tpu_torch.models import quant
    from copilot_for_consensus_tpu_torch.ops import flash_attention as fa
    from copilot_for_consensus_tpu_torch.ops import paged_attention as pa
    from copilot_for_consensus_tpu_torch.ops import quant_matmul as qm

    g = torch.Generator(device=dev).manual_seed(6)
    bf = torch.bfloat16
    rows = {}

    def launch(wrapper, call):
        """``call()``'s result and the bodies of ``wrapper`` it launched,
        read from the wrapper's counters."""
        before = dict(wrapper.launches_by_body)
        out = call()
        torch.cuda.synchronize()
        return out, "+".join(b for b, n in wrapper.launches_by_body.items()
                             if n != before[b])

    def record(row, ok, want_body):
        row["expected_body"] = want_body
        row["body_as_expected"] = row["body"] == want_body
        emit(row)
        if not ok:
            raise AssertionError(f"tp_shapes {row['kernel']} {row['case']}: "
                                 f"error {row['max_abs_err']} over "
                                 f"{row['tol']}")
        rows[(row["kernel"], row["case"], "bfloat16")] = row

    for tp in (2, 4):
        k2, k5 = tp_cases(tp)
        for leaf, d, f in k2:
            q = torch.randint(-127, 128, (d, f), generator=g,
                              dtype=torch.int8, device=dev)
            s = torch.rand(1, f, generator=g, device=dev) * (2 * d ** -0.5
                                                              / 73.3)
            for m in (4, *TP_FEATURE_M, 4096):
                x = torch.randn(m, d, generator=g, device=dev).to(bf)
                out, ran = launch(qm.int8_matmul,
                                  lambda: qm.int8_matmul(x, q, s))
                ref = qm.int8_matmul_ref(x, q, s)
                tol = K2_RTOL["bfloat16"] * ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                bnd, by = bound_ms(nbytes(x, q, s, out), 2.0 * m * d * f,
                                   "bfloat16")
                row = {"phase": "tp_shapes", "kernel": "K2", "tp": tp,
                       "leaf": leaf, "case": f"tp{tp}_{leaf}_m{m}",
                       "shape": [m, d, f], "body": ran,
                       "max_abs_err": err, "tol": tol,
                       "ms": time_ms(lambda: qm.int8_matmul(x, q, s),
                                     flush=flush),
                       "plain_ms": time_ms(lambda: qm.int8_matmul_ref(
                           x, q, s), n=3, flush=flush),
                       "library_ms": time_ms(lambda: x @ q.to(bf) * s,
                                             flush=flush),
                       "library": "x @ q.to(bf16) * scale",
                       "bound_ms": bnd, "bound_by": by}
                record(row, bool(torch.isfinite(out).all()) and err <= tol,
                       "stream" if m <= 8 else "wgmma")
                del x, out, ref
            del q, s
        for leaf, d, f in k5:
            q4 = torch.randint(-128, 128, (d // 2, f), generator=g,
                               dtype=torch.int8, device=dev)
            s = torch.rand(d // quant.INT4_GROUP, f, generator=g,
                           device=dev) * (2 * d ** -0.5 / 4.61)
            w = quant.dequant_int4({"q4": q4, "scale": s}, bf)
            for m in (32, 4096):
                x = torch.randn(m, d, generator=g, device=dev).to(bf)
                out, ran = launch(qm.int4_matmul,
                                  lambda: qm.int4_matmul(x, q4, s))
                ref = qm.int4_matmul_ref(x, q4, s)
                top = ref.float().abs().max().item()
                err = (out.float() - ref.float()).abs().max().item()
                bnd, by = bound_ms(nbytes(x, q4, s, out), 2.0 * m * d * f,
                                   "bfloat16")
                row = {"phase": "tp_shapes", "kernel": "K5", "tp": tp,
                       "leaf": leaf, "case": f"tp{tp}_{leaf}_m{m}",
                       "shape": [m, d, f],
                       "groups": d // quant.INT4_GROUP,
                       "body": ran,
                       "max_abs_err": err, "tol": K5_RTOL["bfloat16"] * top,
                       "ms": time_ms(lambda: qm.int4_matmul(x, q4, s),
                                     flush=flush),
                       "plain_ms": time_ms(lambda: qm.int4_matmul_ref(
                           x, q4, s), n=3, flush=flush),
                       "library_ms": time_ms(lambda: x @ w, flush=flush),
                       "library": "x @ w, w dequantized to bf16 beforehand",
                       "bound_ms": bnd, "bound_by": by}
                record(row, bool(torch.isfinite(out).all())
                       and err <= row["tol"],
                       "stream" if m <= qm.STREAM_MAX_M else "wgmma")
                del x, out, ref
            del q4, s, w
        # K1: a prefill wave's attention, and the piggyback lanes' (P 4
        # lanes of 64 rows at step 5 over 2048-column buffers, as
        # phase_kernels' piggy_s64), at the rank's heads
        hq, hkv, d = 32 // tp, 8 // tp, 128
        for label, b, sq, skv, lens_l, offs, begins, window in (
                ("prefill_s1024", 4, 1024, 1024, [1024, 700, 333, 64],
                 None, None, 4096),
                ("piggy_s64", 4, 64, 2048, [384, 384, 360, 0], [320] * 4,
                 [0, 192, 128, 2048], 0)):
            q = torch.randn(b, hq, sq, d, generator=g, device=dev).to(bf)
            k = torch.randn(b, hkv, skv, d, generator=g, device=dev).to(bf)
            v = torch.randn(b, hkv, skv, d, generator=g, device=dev).to(bf)

            def ivec(x):
                return None if x is None else torch.tensor(
                    x, dtype=torch.int32, device=dev)
            kw = dict(causal=True, window=window, kv_lengths=ivec(lens_l),
                      q_offsets=ivec(offs), kv_begins=ivec(begins))
            out, ran = launch(fa.flash_attention,
                              lambda: fa.flash_attention(q, k, v, **kw))
            ref = fa.flash_attention_ref(q, k, v, **kw)
            err = (out.float() - ref.float()).abs().max().item()
            lv, ov, bv = fa._row_params(b, skv, kw["kv_lengths"],
                                        kw["q_offsets"], kw["kv_begins"],
                                        dev)
            mask = fa._mask(b, sq, skv, lv, ov, bv, causal=True,
                            window=window, device=dev)
            pairs = int(mask.sum()) * hq
            kv_rows = int(mask.any(dim=1).sum())
            bnd, by = bound_ms(nbytes(q, out) + 2 * hkv * d * 2 * kv_rows
                               + 3 * 4 * b, 4.0 * d * pairs, "bfloat16")
            row = {"phase": "tp_shapes", "kernel": "K1", "tp": tp,
                   "case": f"tp{tp}_{label}",
                   "shape": [b, hq, hkv, sq, skv, d], "body": ran,
                   "max_abs_err": err, "tol": K1_ATOL["bfloat16"],
                   "ms": time_ms(lambda: fa.flash_attention(q, k, v, **kw)),
                   "plain_ms": time_ms(lambda: fa.flash_attention_ref(
                       q, k, v, **kw), n=3),
                   "library_ms": time_ms(
                       lambda: F.scaled_dot_product_attention(
                           q, k, v, attn_mask=mask[:, None],
                           enable_gqa=True)),
                   "library": "SDPA with the same mask",
                   "bound_ms": bnd, "bound_by": by}
            record(row, bool(torch.isfinite(out).all())
                   and err <= K1_ATOL["bfloat16"], "wgmma")
            del q, k, v, out, ref, mask
        # K3: a paged decode step and the mesh features' seeded passes at
        # the rank's kv heads, over a dp shard's 512 blocks of the pool
        bsz, d, blk, nbtot = 8, 128, 64, 512
        pk = torch.randn(2, nbtot, 8 // tp, blk, d, generator=g,
                         device=dev).to(bf)
        pv = torch.randn(2, nbtot, 8 // tp, blk, d, generator=g,
                         device=dev).to(bf)
        for label, hkv, r, lens_l in tp_k3_cases(tp):
            window = 4096 if r == 4 else 0
            nb = 64 if r == 4 else max(1, -(-max(lens_l) // blk))
            tables = torch.full((bsz, nb), nbtot, dtype=torch.int32,
                                device=dev)
            perm = torch.randperm(nbtot, generator=g, device=dev)
            for i, n in enumerate(lens_l):
                need = -(-n // blk)
                tables[i, :need] = perm[i * 64:i * 64 + need].to(
                    torch.int32)
            lengths = torch.tensor(lens_l, dtype=torch.int32, device=dev)
            q_pos = lengths + 2
            qr = torch.randn(bsz, hkv, r, d, generator=g, device=dev).to(bf)
            args = (qr, pk, pv, 1, tables, lengths, q_pos)
            part, body = launch(pa.paged_attention_partial,
                                lambda: pa.paged_attention_partial(
                                    *args, window=window))
            ref = pa.paged_attention_partial_ref(*args, window=window)
            err, m_err, l_err, ok = k3_errors(part, ref)
            # the positions [lo, hi) each row attends, read once each
            hi = lengths.clamp(max=nb * blk).long()
            lo = (q_pos.long() - window + 1).clamp(min=0) if window \
                else torch.zeros_like(hi)
            pos = int((hi - lo).clamp(min=0).sum())
            bnd, by = bound_ms(pos * hkv * d * 2 * 2
                               + nbytes(qr, tables, lengths, q_pos)
                               + sum(t.numel() * 4 for t in part),
                               4.0 * r * d * hkv * pos, "bfloat16")
            kg, vg = pa.paged_gather_layer(pk[1], pv[1], tables)
            t = torch.arange(kg.shape[2], device=dev)[None]
            kmask = (t < lengths.long()[:, None]) & (t >= lo[:, None])
            qs = qr.reshape(bsz, hkv * 4, r // 4, d)
            row = {"phase": "tp_shapes", "kernel": "K3", "tp": tp,
                   "case": f"tp{tp}_{label}",
                   "shape": [bsz, hkv, r, d, blk, nb], "pool_blocks": nbtot,
                   "body": body, "max_abs_err": err, "tol": K3_ATOL,
                   "m_err": m_err, "l_rel_err": l_err,
                   "ms": time_ms(lambda: pa.paged_attention_partial(
                       *args, window=window), flush=flush),
                   "plain_ms": time_ms(lambda: pa.paged_attention_partial_ref(
                       *args, window=window), n=3, flush=flush),
                   "library_ms": time_ms(
                       lambda: F.scaled_dot_product_attention(
                           qs, kg, vg, attn_mask=kmask[:, None, None],
                           enable_gqa=True), flush=flush),
                   "library": "SDPA over the pre-gathered view, gather "
                              "excluded",
                   "bound_ms": bnd, "bound_by": by}
            record(row, ok, "decode" if r <= 16 else "seeded")
            del qr, part, ref, kg, vg
        del pk, pv
    torch.cuda.empty_cache()
    return rows


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
    # K1 at the long route's prefill shape: the long_serve bucket of its
    # longest prompt (host work: the threads and their token counts)
    long_work, long_lens = long_serve_workload(decoder_config("mistral-7b"))
    long_q = LONG_SERVE["ctx_block"]
    rows.update(phase_long_k1(dev, flush, -(-max(long_lens) // long_q)
                              * long_q, max(long_lens)))
    rows.update(phase_k3(dev, flush))
    phase_k3_layouts(dev)
    rows.update(phase_quant_kernels(dev, flush))
    probe_rows, probe_launches, probe_per_mode = phase_probe(dev, flush, smi)
    rows.update(probe_rows)
    # the shard shapes a tp-2 or tp-4 rank runs, and the mesh's
    # collectives on NCCL at world size 1
    tp_rows = phase_tp_shapes(dev, flush)
    del flush
    phase_mesh_nccl(dev)
    # two ranks on the one card, over gloo
    phase_mesh_gloo2(dev, smi)

    cfg = decoder_config("mistral-7b")
    t0 = time.monotonic()
    params = quant.init_random_quantized(cfg, seed=0, dtype=torch.bfloat16,
                                         device=dev)
    torch.cuda.synchronize()
    emit({"phase": "weights", "config": cfg.name,
          "bytes": quant.param_bytes(params),
          "seconds": time.monotonic() - t0})
    phase_under_load(dev, cfg, params, smi)
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
    phase_graphs(dev, *cut_depth(cfg, params, GRAPHS_LAYERS), smi,
                 paged=False)
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
    phase_graphs(dev, *cut_depth(cfg, params, GRAPHS_LAYERS), smi,
                 paged=True)
    mesh_paths = phase_mesh_serve(dev, cfg, params, smi)
    mesh_paths.update(phase_mesh_features(dev, cfg, params, smi))
    # rank 0 serving summarize_async, rank 1 following its log, over a
    # world-2 gloo mesh on the card
    mesh_paths.update(phase_mesh_async_gloo2(dev, cfg, params, smi))
    fp8_launches, fp8_bodies = phase_paged_fp8(dev, cfg, params, smi,
                                               paged_comps)
    spec_launches, spec_bodies = phase_spec_serve(dev, cfg, params, smi)
    sched_launches, sched_bodies = phase_sched_serve(dev, cfg, params, smi)
    paged_new = phase_paged_spec_chunk(dev, cfg, params, smi)
    slice20 = {"piggy_serve": phase_piggy_serve(dev, cfg, params, smi),
               "prefix_serve": phase_prefix_serve(dev, cfg, params, smi),
               "holds": phase_holds(dev, cfg, params, smi),
               "gather_route": phase_gather_route(dev, cfg, params, smi),
               "roles": phase_roles(dev, cfg, params, smi)}
    long_launches, long_bodies = phase_long_serve(dev, cfg, params, smi,
                                                  long_work)
    phase_long_f32(dev, cfg, params, smi)
    phase_profile(dev, cfg, params, smi)
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
    phase_spec_chunk_f32(dev, smi)
    # Mixtral-8x7B, with no other model resident
    moe_rows = phase_moe_layer(dev, smi)
    rows.update(moe_rows)
    moe_paths = phase_moe_serve(dev, smi)
    phase_moe_f32(dev, smi)
    phase_moe_graphs(dev, smi)

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
               "int4_serve_a8": int4_a8_launches,
               "spec_serve": spec_launches, "sched_serve": sched_launches,
               "paged_spec": paged_new["paged_spec"][0],
               "paged_chunk": paged_new["paged_chunk"][0],
               **{p: lb[0] for p, lb in slice20.items()},
               "long_serve": long_launches,
               **{p: lb[0] for p, lb in moe_paths.items()},
               **{p: lb[0] for p, lb in mesh_paths.items()},
               "probe": probe_launches}
    bodies_by_path = {"pipeline": pipeline["sync"]["bodies"],
                      "pipeline_pipelined": pipeline["pipelined"]["bodies"],
                      "pipeline_retrieval": pipeline["retrieval"]["bodies"],
                      "encoder": encoder_bodies,
                      "serve": bodies, "paged_serve": paged_bodies,
                      "paged_fp8": fp8_bodies, "deadlines": deadline_bodies,
                      "journal_resume": journal_bodies,
                      "a8_model": a8_bodies, "int4_serve": int4_bodies,
                      "int4_serve_a8": int4_a8_bodies,
                      "spec_serve": spec_bodies,
                      "sched_serve": sched_bodies,
                      "paged_spec": paged_new["paged_spec"][1],
                      "paged_chunk": paged_new["paged_chunk"][1],
                      **{p: lb[1] for p, lb in slice20.items()},
                      "long_serve": long_bodies,
                      **{p: lb[1] for p, lb in moe_paths.items()},
                      **{p: lb[1] for p, lb in mesh_paths.items()}}
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
    # K1's wgmma body at the long route's prefill shape, beside its row
    long_k1 = rows[("K1", "long_s16k", "bfloat16")]
    table[0]["long_s16k"] = {
        k: long_k1[k] for k in ("shape", "kv_length", "window", "ms",
                                "plain_ms", "plain_chunk_rows", "bound_ms",
                                "bound_by", "library_ms", "max_abs_err")}
    table[0]["long_s16k"]["launches_long_serve"] = \
        long_bodies["K1"]["wgmma"]
    # K2's and K5's bodies at the MoE experts' shapes (moe_layer), each
    # beside the row of its body
    for row in table:
        k = {"int8_matmul": "K2", "int4_matmul": "K5"}.get(
            row["name"].removesuffix("_tiled"))
        if k is not None:
            row["moe_cases"] = {
                r["case"]: {key: r[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "max_abs_err")}
                for (kk, _, _), r in moe_rows.items()
                if kk == k and r["body"] == row["body"]}
    # each body's tp-2 and tp-4 shard shapes (tp_shapes), beside its row
    kernel_of = {"flash_attention": "K1", "int8_matmul": "K2",
                 "int8_matmul_tiled": "K2", "paged_attention": "K3",
                 "paged_attention_seeded": "K3",
                 "int4_matmul": "K5", "int4_matmul_tiled": "K5"}
    for row in table:
        k = kernel_of.get(row["name"])
        if k is not None:
            row["tp_cases"] = {
                r["case"]: {key: r[key] for key in (
                    "shape", "body", "ms", "plain_ms", "bound_ms",
                    "bound_by", "library_ms", "max_abs_err")}
                for (kk, _, _), r in tp_rows.items()
                if kk == k and r["body"] == row["body"]}
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
    if sys.argv[1:2] == ["--gloo2-rank"]:
        sys.exit(gloo2_rank(sys.argv[2], int(sys.argv[3])))
    if sys.argv[1:2] == ["--gloo2-async-rank"]:
        sys.exit(async2_rank(sys.argv[2], int(sys.argv[3])))
    sys.exit(main())
