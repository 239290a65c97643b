#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py                 # one card, no other arguments
    python3 chip_smoke.py --profile DIR   # also write a torch.profiler table

Phases (any failure exits non-zero and prints no final result line):

1. device: the card's name and power limit (nvidia-smi); TF32 off for the
   comparisons.
2. build: every kernel of the main paths (K1 flash_attention and its
   backward kernel, two sources; K2 decode_attention and K3
   paged_decode_attention, one source; K4 wkv6 and its backward, two
   sources; K5 ssd and its backward, two sources) is compiled from
   the checkout's sources with nvcc for sm_90a, one nvcc per source,
   started together.  cuobjdump's SASS must show HGMMA (wgmma) and HMMA
   (mma.sync: the float32 TF32 x 3 kernels) in K1's library and its
   backward's and HMMA in K2/K3's, K4's, K5's and K4's and K5's
   backward's; the counts go into the kernels line.  A ptxas line saying
   that it serialised a wgmma of K1's backward fails the build, and so
   does a spill in K4's or K5's backward or in any instantiation of K1's
   float32 tensor-core kernels (``TF32_KERNELS``).  A yardstick library is
   built beside them: K2/K3's source with P rounded to bf16 for P V (one
   product a tile, the kernel before it took P as bf16 hi + lo parts),
   written under build/variants and never called by the port.
3. kernels: each kernel is held against its plain PyTorch version on the
   card at the main path's shapes and at the edges.  K1: yi-9b attention,
   B=8, S=256, H=32, K=4, hd=128, bf16 and fp32, plus sliding window,
   ragged lengths, S not a multiple of the tile, strided inputs, other
   head dims, G=12 (96/8 heads), a window of 20 with ragged lengths and a
   length-0 row, S=1024 (the largest prefill bucket at max_len 1024),
   zamba2's shared block (hd=80, G=1, window 4096, B=8, S=512) and
   qwen3-moe's attention (B=8, S=256, H=64, K=4: G=16; bf16, fp32 and
   ragged lengths), and cross-attention with Skv != S: llama-3.2-vision's
   cross blocks (B=8, S=256, Skv=1601, H=32, K=8, hd=128, non-causal, bf16
   and fp32), whisper's (B=8, S=64, Skv=1500, H=K=8, hd=64) and its
   encoder's self-attention (S=1500, non-causal, bf16 and fp32) and
   strided inputs at Skv=1601, their keys shifted by KEY_SHIFT so that an
   unmasked ragged key edge shows, Skv < S with ragged lengths and a
   length-0 row, and causal Skv != S (top-left aligned, as the TPU
   kernel's mask).  K1's tolerance scales atol by min(1, max|ref|)
   (``scaled_tol``).  Every case logs the route it took
   (``flash_attention.tensor_cores``); whisper's fp32 encoder must take
   the tensor cores (TF32 x 3), in the forward and in the backward, and
   the fp32 timings carry the tensor-core bound beside the fp32 one.  K2: the
   decode tick at B=8, Smax=1024, H=32, K=4, hd=128 with ragged lengths
   (bf16 and fp32), plus a window, ring-style lengths, a length-1 row,
   Smax not a multiple of the tile, a layer view of the stacked cache,
   danube's hd=80 G=4, G=12 (one block per group), hd=256 and zamba2's
   hd=80 G=1 ring tick, and qwen3-moe's tick (B=8, Smax=1024, H=64, K=4,
   ragged; bf16 must take the tensor-core path at G=16, TC_HEADS, and fp32
   the CUDA-core one), and the cross step of llama-3.2-vision (B=8,
   Smax=1601, H=32, K=8, every key valid) and whisper (Smax=1500, H=K=8,
   hd=64).  Each is then timed (CUDA events and
   torch.profiler device time) beside its plain version, the PyTorch
   library call that computes the same function (SDPA, a yardstick only,
   also with its device time) and its bound; K1 at yi-9b S=256 and 1024,
   zamba2's and qwen3-moe's shapes and the vlm cross, whisper cross and
   whisper encoder shapes, K2 also at B=8, Smax=32768, full lengths, at
   qwen3-moe's tick and at the vlm cross step.  K3: the
   paged tick at B=8, 64 pages of 16 per row, H=32, K=4, hd=128, ragged
   lengths 17-330, a shuffled table in which 3 rows share their first 4
   pages (bf16 and fp32), plus a window, a vacant row on the dump page,
   danube's hd=80 G=4, hd=256, G=12, zamba2's hd=80 G=1 ring, page sizes
   32 and 64, a layer view of a stacked pool, and qwen3-moe's tick (G=16,
   bf16 on the tensor-core path, and fp32); at page size 16 it must equal
   K2 on the gathered cache bit for bit.  Timed at the tick shapes (yi-9b,
   qwen3-moe) and at 2,048 pages (32k keys) per row beside K2 on the
   gathered cache
   (bit for bit equal there too), the plain version, a gather + SDPA
   yardstick and its bound.
   K2/K3 on the fp8 e4m3 cache (bf16 q; the cache cast by the port's
   ``attention.to_cache``, with values near +-448 and e4m3 subnormals
   planted): K2 at the yi-9b tick, a window, danube's hd=80 G=4, qwen3-moe's
   G=16, a length-1 row and a layer view of a stacked cache (tensor-core
   kernel), hd=256 and rows 8 bytes off 16 (CUDA-core kernel; the path
   asserted), and 32k keys; K3 at the tick with shared pages, a window with
   a vacant row, danube, hd=256, page size 32, a layer view and qwen3-moe.
   Each is held against the plain version (which dequantizes to bf16) at
   the bf16 tolerance and bit for bit against the same kernel on the
   cache's bf16 copy; K3 at page size 16 also bit for bit against K2 on
   the gathered e4m3 cache.  Timed (K2 at the tick, qwen3-moe, danube,
   hd=256 and 32k keys; K3 at the tick and 32k keys) in turns beside the
   same kernel on the bf16 copy, the plain version, an upcast-to-bf16 +
   SDPA yardstick and the bound at 1 byte per cache element.
   K4 (fp32, tolerance 1e-4): the rwkv6-1.6b prefill bucket B=8, T=512,
   H=32, N=64, T=300 and T=17, masked pad steps (the masked row's state
   must equal the unpadded call's), a nonzero s0 with k=v=0, a two-call
   continuation, extreme decay and B=1, T=16384.  K5 (fp32, y over
   max|y|+1 at 1e-4): the zamba2-2.7b bucket B=8, T=512, H=80, P=N=64,
   T=300, dt=0 pad steps (the same state check), a nonzero h0, a two-call
   continuation and B=1, T=16384.  The buckets must take the tensor-core
   kernels (``ops.tensor_core_path``); K4 at N=32 and with an unaligned
   r, K5 at P=32, N=16 and with B rows 66 floats apart take the CUDA-core
   kernels and are checked as well.  Both timed beside their plain
   versions and two bounds at the bucket and at T=16384 (no single
   library call computes either): the fp32 one (every operation at the
   CUDA-core peak) and the tensor-core one (the products at a third of
   the TF32 peak, the three-term split's three products).
   K1's backward (``flash_attention_bwd``; bf16 at 3e-2, fp32 at 2e-5,
   atol scaled to each of dq, dk, dv, and each within BWD_REL_L2 relative
   L2 error) against ``flash_attention_bwd_plain`` on the
   forward kernel's own O and lse and a seeded dO: danube's training
   shape (B=4, S=2048, 32/8 heads of 80, its 4096 window; tensor cores
   asserted), danube fp32, yi-9b's, a window, ragged lengths with a
   length-0 row (bf16 and fp32), strided and unaligned inputs, hd 32, 64,
   96 and 256, G=12 and G=16, the vlm and whisper cross shapes and
   whisper's fp32 encoder (keys shifted by KEY_SHIFT), Skv < S and causal
   Skv > S.  Each case also runs the backward twice (bit for bit), holds
   the forward's lse to the plain one and O with lse bit for bit to O
   without.  Timed at danube's shape, the vlm cross and whisper's fp32
   encoder beside the plain version, SDPA's forward + backward
   (``enable_gqa``) and the bound (2.5x the forward's operations, or the
   bytes of q, k, v, o, dO, dq, dk, dv once), the device time split
   between the Delta, dK/dV and dQ kernels; a split that reads 0 in all
   fails (a renamed kernel would).
   K4's and K5's backward (``wkv6_bwd``, ``ssd_bwd``; fp32) against
   ``wkv6_bwd_plain`` / ``ssd_bwd_plain``, each gradient within
   RECUR_BWD_REL of its largest entry, two calls bit for bit: rwkv6's
   training shape (B=4, T=2048, H=32, N=64) and zamba2's (B=4, T=2048,
   H=80, P=N=64) with a zero initial state and no state cotangent, as
   training calls them, there also the plain backward against autograd
   of the plain forward; T=130 with a nonzero initial state and state
   cotangent; K4 at N=32 (its CUDA-core route), K5 at P=32, N=16; strong
   decay; an unaligned r (K4, the CUDA-core route) and Bm rows 66 floats
   apart (K5); one chunk (T=20).  Timed at the training shapes (CUDA
   events, and the device time split between each backward's two
   kernels, the boundary scans and the chunk-parallel kernel) beside the
   plain backward, the fp32 bound and a second bound, the products on
   TF32 tensor cores with the three-term split (a third of the TF32 peak)
   and the rest at the fp32 peak; no library call computes either.  K5's
   backward also at a head count that is not a multiple of its head group
   (H=6).
   K2/K3 taking P as bf16 hi + lo parts, what it costs: K2 and K3 at the
   yi-9b tick and at 32k keys, on the bf16 and the e4m3 cache, each
   timed in turns (after, before, before, after) against the yardstick
   library that rounds P to bf16.
4. ensemble path: ``build_app(["yi-9b", "yi-9b"], full=True, max_len=1024,
   num_slots=8)`` — two members at full width and depth with random
   weights from a seed, and a generate plane over member 0's params —
   behind ``FlexServeServer`` on an ephemeral port; /v1/infer and
   /v1/detect at batch sizes 1, 3 and 8, some concurrent.  Every response
   must be 200 and have the paper schema; the launch counts, zeroed just
   before and read just after, must be members x layers x forwards for K1
   and 0 for K2, and the flight recorder's index (/v1/traces; the app
   traces every request, the default) must list every request by its
   X-Request-Id; the fused block kernels (``kernels/fused_block``) must
   launch members x forwards x (2L + 1 norms, L ropes, L silu * up): every
   bf16 norm, rope and silu * up of the served forward takes its kernel
   (a wrapper on the card launches or raises).  One batch's
   member logits are then held against the plain path on the card (every
   kernel swapped for its plain version, the block's for the eager
   chains).
4b. the fused block kernels (``rms_norm`` with and without the residual
   add, ``rope_qk``, ``silu_mul``; bf16) against the eager chains they
   replace (``kernels/fused_block/ref.py``) at yi-9b's bulk forward (B=16,
   S=512), h2o-danube's long one (B=4, S=8192) and a tick of each (B=16,
   S=1, ragged int32 positions): the new residual stream, RoPE and silu *
   up bit for bit, the norm within one bf16 ulp, one launch a call.  Each
   timed (CUDA events and device time) beside the eager chain, the
   norm also beside ``F.rms_norm`` (torch's own kernel, where the card's
   torch has it), and the bytes-once bound at 3.35 TB/s; ptxas must
   report no spill.  Then one forward of phase 4's two members at
   yi9b-pair.bulk's shape (B=16, S=512, past the app's largest bucket, so
   the members are called as the batcher calls them): the launch counts a
   member forward (2L + 1, L, L), the device time by group (the eager
   elementwise kernels, the fused ones, the GEMMs, K1, all) and the host
   clock, with the kernels and with the eager chains in turns, and the
   member logits of the two within LOGITS_TOL.
5. generate path: ``InferenceEngine`` over member yi-9b#0's params (full
   width and depth, bf16, max_len 1024, max_batch 8).  A greedy
   ``generate`` of 8 prompts of 17-300 tokens, 32 new tokens each, must
   launch K1 48 x prefill_calls and K2 48 x decode_calls times, with
   decode_calls == steps - 1.  Prefill and 8 teacher-forced decode steps
   run again with the kernels and with their plain versions, and the
   logits must agree within LOGITS_TOL at every step; whether the two
   greedy streams agree is reported.  A seeded sampled run (temperature
   0.8, top_k 50, top_p 0.9, seed 7) must repeat token for token, and the
   rng's bits on the card must equal its bits on the CPU.  Prefill ms,
   decode ms per tick and tokens/s are printed; with ``--profile`` also
   K2's share of one tick's device time.
6. scheduler path: a ``SchedulerService`` over an ``InferenceEngine`` and
   one over a ``PagedInferenceEngine`` (page size 16), both over member
   yi-9b#0 at full width and depth, max_len 1024, 8 slots, each warmed
   first.  Two rounds in turns (dense, paged, dense, paged), each with its
   own 12 requests (prompts of 17-300 tokens, 32 new tokens, greedy mixed
   with seeded sampled rows): every request must finish with reason
   "length", the paged streams must equal the dense streams, K1 must
   launch 48 x prefill forwards, K2 48 x dense ticks and K3 48 x paged
   ticks (counts zeroed just before each run and read just after it), and
   each tick must move num_slots int32 ids to the host.  Then three greedy
   requests sharing a 64-token prefix on one slot (the followers must
   reuse 4 pages and 64 tokens each; their prefill goes through the C > 0
   plain attention: their first-token logits must equal the dense
   engine's within LOGITS_TOL, and the first divergence of the streams
   is reported), and
   a scheduler run that pauses and resumes a request mid-decode: the paged
   engine must reattach without recompute and reproduce the uninterrupted
   streams; the dense engine's recompute is reported against them (its
   re-prefilled K/V is not bitwise the decode-time K/V in bf16).  Tokens/s,
   ticks, tick times, TTFT, warm seconds and the pool's high water are
   printed.
6b. HTTP generate path: phase 4's app (its generate plane over member 0's
   weights, 8 slots; warmed first, "[serve] decode path warm in Ns") behind
   ``FlexServeServer``, driven through the port's ``FlexServeClient``.
   Run A: three requests one at a time (17, 300 and 120-token prompts, 32
   new tokens; greedy and two seeded sampled at temperature 0.8, top_k 50,
   top_p 0.9), each blocking and streamed: the blocking body must equal
   ``SchedulerService.submit_and_wait`` on the same engine bit for bit,
   the stream the blocking body, and K1 must launch 48 x prefill forwards
   and K2 48 x ticks (from /metrics).  Run B: 12 streams at once on 8
   slots: every one finishes with 32 tokens and "length", K1/K2 as in Run
   A, num_slots x 4 bytes per tick; TTFT p50/p99, time per output token
   p50/p99 and tokens/s as the client sees them, beside the card's name
   and power limit, and from each stream's trace (found by the trace id
   its terminal event carries) p50/p99 of the TTFT's parts: http_parse,
   admission to scheduler_queued, the wait until prefill, and prefill to
   first_token.  Run C: a ``FlexServeApp`` over a
   ``PagedInferenceEngine`` of the same member (page size 16): Run A's
   requests streamed must equal Run A's streams, K3 48 x ticks.  Run D:
   ``replicas=2`` and a fault raising once at replica 0's 8th
   ``engine_step``: the stream fails over, finishes with 32 tokens, and
   /metrics counts one failover; its first token that differs from the
   unfaulted stream is reported, and there the failed-over path's logits
   must match the unfaulted path's within LOGITS_TOL with the same argmax.
   The decode state added per replica and the failover's extra latency
   are printed.
6c. speculative path, while member 0 is resident (48 layers).  Pair E:
   ``SpeculativeEngine`` of an ``InferenceEngine`` over member 0 and a
   second one over the same tensors (the target is its own draft), dense,
   8 slots, max_window 4, ``SchedulerService.warm(seq_lens=[16])``; 8
   greedy requests of 17-300 tokens, 32 new, submitted at once to it and
   to a plain ``SchedulerService`` over the same target.  A
   ``LogitsProbe`` on each run records, per request and token, the logits
   the token was drawn from (the verify's row, the one-token step's on a
   plain tick, each draft step's).  Every stream must equal the plain
   stream or part where the two runs' logits for that token agree within
   LOGITS_TOL (a near-tie, logged with the gap and the sequential top-2
   margin); every rejected proposal must be such a near-tie between the
   verify's and the draft's logits; the controller must stay at window 4.
   Pair T:
   ``build_app([yi-9b], full=True, draft_model="yi-9b", draft_layers=8,
   spec_window=4)`` (the draft seeded 1000) and a paged pair over its
   params (page size 16): Run A's three requests streamed one at a time
   over /v1/generate (the last with "speculation": false) must equal
   phase 6b's ``SchedulerService`` references (or part at a logged
   near-tie; the reference's logits come from rerunning the request), the
   opted-out stream's summary is zeros, and k_hist shows level-1 ticks
   (the controller backed off); then 8 rows at once (half sampled, row 1
   opted out) against the plain service.  Launch counts: K1 (48 + L_d)
   per prefill forward, K2 (K3
   paged) W (48 + L_d) per speculative tick of window W and 48 per level-1
   tick.  Printed: acceptance, tokens per speculative tick, the memory of
   target and draft (``MemoryLedger``), host ms per tick at W = 2 and 4
   and at level 1 (8 rows live; dense and paged); with ``--profile`` the
   verify forward's device time, its K2/K3 and cuBLAS parts.
11. the fp8 e4m3 KV cache, while member 0 is resident (run after 6c): a
   dense and a paged engine over member 0 (full width and depth) built
   under ``repro_torch.opt.flags(kv_cache_f8=True)``, beside the same two
   with the bf16 cache.  The cache cast (``attention.to_cache``) must give
   the CPU's bytes for all 65,536 bf16 patterns.  Every cache leaf of their
   states must be
   float8_e4m3fn (bf16 without the flag); a page must cost half
   (``page_bytes``, equal to ``page_kv_bytes`` at bf16 over two),
   ``pages_for_budget`` at 8 GiB must double and a state's
   ``torch.cuda.memory_allocated`` delta must halve (within 1%).  A greedy
   ``generate`` of phase 5's 8 prompts (32 new) on each cache: K1 48 per
   prefill, K2 48 per tick exactly, K3 0; teacher-forced prefill + 8
   steps on the e4m3 cache, kernels vs plain versions (on the same e4m3
   cache) within LOGITS_TOL; how many rows part from the bf16-cache
   streams is reported, with the logit gap at the first parting (both
   engines teacher-forced to it).  ``SchedulerService`` rounds (8 slots,
   12 requests, half sampled) on the dense and paged e4m3 engines and the
   two bf16 ones: launch counts exact as in phase 6, paged streams equal
   to dense ones on the e4m3 cache; the shared-prefix run of phase 6 on
   the e4m3 engines: the leader's streams equal bit for bit, the
   followers' first-token logits (the C > 0 plain path reads the pool
   dequantized) within LOGITS_TOL.  With ``--profile``: one tick of each
   of the four engines, K2's and K3's share of its device time.

7. recurrent path, after the yi-9b members are freed:
   ``build_app(["rwkv6-1.6b", "zamba2-2.7b"], full=True)`` (24 and 54
   layers at full width, seeded weights) behind ``FlexServeServer``;
   /v1/infer and /v1/detect at batch sizes 1, 3 and 8, some concurrent:
   every response 200 with the paper schema, /v1/models naming families
   ssm and hybrid, launch counts (zeroed just before, read just after)
   K4 24, K5 54 and K1 9 per coalesced forward, K2 = K3 = 0, and one
   batch's member logits against the plain path.  Then an
   ``InferenceEngine`` over each member (max_len 1024, max_batch 8): a
   greedy ``generate`` of 8 prompts of 17-300 tokens, 32 new tokens
   (launches per prefill and per tick: rwkv6 K4 24; zamba2 K5 54 and K1 9
   per prefill, K2 9 per tick), teacher-forced prefill + 8 decode steps
   and prefill + decode against one forward over the same tokens (the
   recurrent state carried across calls), each with the kernels and with
   their plain versions: on float32 copies of the weights kernels vs plain
   and prefill + decode vs forward within RECUR_FP32_ATOL; in the served
   bf16 each path held against the float32 run, the kernels' RMS error at
   most BF16_WITNESS_RATIO times the plain versions'.  Then a seeded
   sampled run that must repeat.  Last, a ``SchedulerService`` over each engine runs 12
   mixed greedy and sampled requests on 8 slots: every request finishes
   with "length", the launch counts follow prefill forwards and ticks,
   each tick moves num_slots int32 ids; the first divergence of the
   greedy streams from ``generate``'s is reported.  Tokens/s, tick ms,
   TTFT and prefill ms are printed per family; with ``--profile`` also a
   recurrent ensemble forward, and a prefill and a tick of each family.
   Run E: the recurrent app's generate plane (an ``InferenceEngine`` over
   rwkv6-1.6b#0's params) streams one seeded request over /v1/generate: it
   must equal ``SchedulerService.submit_and_wait`` on the same engine, with
   K4 24 per prefill forward and nothing per tick.

8. control plane, after the recurrent members are freed: yi-9b at full
   width (bf16, seeded) with 8 layers, the depth cut that the manifest's
   own ``num_layers`` sets (``STORE_LAYERS``: the JAX checkpoint format is
   one msgpack map whose ``bin`` holds at most 2**32 - 1 bytes, and the
   stacked w_gate at 48 layers is 4.33 GB; phases 4-6b drive 48), in a
   ``ModelStore`` under a temporary directory removed at the end
   (uncompressed).  A: the port's store publishes yi-9b#0 and yi-9b#1 v1
   (seeds 0, 1); write, verify and load GB/s are printed.  B: /healthz is
   503 on a manager-backed app before its first load and 200 after; then
   ``build_store_app(["yi-9b", "yi-9b"], store, full=True, max_len=1024,
   num_slots=8)`` finds the store seeded and serves the latest versions:
   phase 4's requests (K1 2 x 8 x forwards, K2 0, the trace index) and
   one batch's logits against the plain path.  C: yi-9b#0 v2 (seed 2) is
   published to the running store and loaded (warm) and rolled back while
   a client sends an 8-row /v1/infer every 100 ms: every response 200,
   its trace (by X-Request-Id) names the version that served it, and its
   body equals that version's reference forward; unloading v2 returns
   ``torch.cuda.memory_allocated`` to within 5% of its value before the
   load; the load-to-serving latency and the largest response latency are
   printed.  D: the engine plane loads v2 while two streams (32 tokens)
   are in flight: they finish with "length" equal to v1's
   ``SchedulerService.submit_and_wait`` bit for bit, a stream after the
   flip equals v2's, K1 8 x prefill forwards and K2 8 x ticks (the old
   and the new scheduler's); then the engine rolls back.  D2: a 2-layer
   draft at full width (seed 1000) is published as "yi-9b#draft" and
   POST /v1/engines/{name}/load {"version": 2, "draft": ...} loads the
   speculative pair: one stream finishes with its speculation summary
   (reported against v2's non-speculative stream), then the engine rolls
   back to v1 without a draft.  E: v2 is loaded
   under alias "canary" on both planes with an SLO policy (the
   ``--slo-config`` format), requests target both aliases and each trace
   names the alias's version; ``SLOController.evaluate()`` (the timer is
   stopped) promotes the healthy canary, /v1/slo shows the decision and
   /v1/traces lists it as an slo trace.  F: the traces of one /v1/infer
   (http_parse, coalesce_queue, coalesce_forward) and one /v1/generate
   (scheduler_queued, prefill, first_token, the decode counters), each
   with its serving version; /metrics?format=prometheus parses and has a
   sample for every numeric leaf of /metrics.  G: ``POST
   /v1/debug/profile {"duration_ms": 1000, "mode": "torch"}`` during a
   generate run: its kernel table names K1's and K2's kernels with
   device time; the five largest are printed.

9. the moe family, after phase 8's members are freed (device memory
   back within 1 GiB of its value before phase 4): qwen3-moe-235b-a22b
   at full width (d_model 4096, 64/4 heads of 128, 128 experts of d_ff
   1536, top-8, vocab 151936), bf16, seed 0, cut to 8 of its 94 layers by
   ``dataclasses.replace`` (``MOE_LAYERS``; 42.30 GB), in an app built
   here from the port's parts (``ModelRegistry``, ``Ensemble``,
   ``InferenceEngine``, ``FlexServeApp``; the store format cannot hold
   this width: one 8-layer ``we_gate`` leaf is 12.9 GB).  A: phase 4's
   requests through /v1/infer and /v1/detect (K1 8 per forward, the
   trace index) and one batch's logits against the plain path; the
   number of dropped assignments in one prefill at B=8, S=256 (T = 2048,
   C = 160).  B: ``generate`` of 8 prompts of 17-300 tokens, 32 new (K1 8
   per prefill, K2 8 per tick), prefill ms and tick ms; teacher-forced
   prefill + 8 decode steps, kernels vs plain versions at LOGITS_TOL; and
   B=1 prefill + 8 decode steps against one forward over the same 25 and
   108 tokens (dropless) within test_decode_consistency's bf16 bound.
   Cross-path checks replay the reference run's expert choice by token
   (``RoutingPin``): a top-k near-tie flips under the other path's
   rounding; the free runs are reported.  C: ``SchedulerService`` over
   the dense and the paged engine (8 slots, 12 requests, half sampled):
   paged streams must equal dense ones (where one parts, the two runs'
   logits for that token must agree within LOGITS_TOL), K1 8 per prefill
   forward, K2 8 per dense tick, K3 8 per paged tick; one tick of each
   profiled: device time and the MoE blocks' and attention's shares.  D:
   one seeded stream over /v1/generate must equal
   ``SchedulerService.submit_and_wait`` bit for bit (K1 and K2 8 per
   prefill and tick).
9b. deepseek-v3-671b at full width (d_model 7168, 128 heads, q/kv LoRA
   1536/512, rope 64, nope 128, v 128, 256 experts of 2048 + 1 shared,
   top-8, vocab 129280), bf16, 4 of 61 layers (``MLA_LAYERS``: the 3
   dense layers as published and one MoE layer; 30.23 GB), MTP off:
   phase 4's requests, ``generate`` of 8 prompts of at most 200 tokens
   (max_len 512) with the B=1 prefill + absorbed decode vs forward check,
   the dense ``SchedulerService``; building a ``PagedInferenceEngine``
   over it raises; K1-K5 launch 0 times.
10. llama-3.2-vision-11b at full width and depth (40 layers: 8 groups of 4
   self layers and a gated cross block; d_model 4096, 32/8 heads of 128,
   d_ff 14336, vocab 128256, 1601 image tokens of 4096), bf16, seed 0,
   the cross gates opened to 1 (at 0 no image reaches a logit), after
   phase 9's members are freed; two float32 images of one scale from a
   numpy seed.  A: one forward at B=8, S=256, K1 launched 40 times (32
   causal self, 8 cross at Skv = 1601), its logits against the plain
   path within LOGITS_TOL and within half of what each row's image
   swapped for the other's moves them (so a kernel path reading the
   wrong image fails); the first cross-attention's output, kernel vs
   plain at the bf16 tolerance scaled to the output, with the other
   image moving it beyond that tolerance; and the logits' distance from
   a forward whose cross-attention runs in float32 on the float32 K/V,
   as JAX's promotion runs it (a measurement).  B: ``generate`` of 8
   prompts of 17-300 tokens with their images, 32 new (K1 40 per
   prefill, K2 40 per tick: 32 self, 8 cross with lengths 1601);
   teacher-forced prefill + 8 decode steps, kernels vs plain versions
   at LOGITS_TOL; B=1 prefill + 8 decode steps vs one forward within
   test_decode_consistency's bf16 bound.  C: the dense
   ``SchedulerService`` (8 slots) over 12 requests, half sampled, each
   with one of the two images (prefill groups mix them), launch counts
   exact; each stream against ``generate``'s of the same prompt, image
   and seed, and where one parts, the two runs' logits for that token
   within LOGITS_TOL.  ``PagedInferenceEngine`` and ``SpeculativeEngine``
   over it raise.  D (with ``--profile``): one prefill and one tick,
   device time, host clock and the shares of K1's and K2's cross and
   self launches and of the image K/V projections.
10b. whisper-base at full width and depth (6 encoder + 6 decoder layers,
   d_model 512, 8 heads of 64, vocab 51865, 1500 frames), bf16, float32
   frames from a numpy seed (the encoder's stream runs in float32, as
   JAX promotes it, so its K1 takes the fp32 path): the same A-C with
   prompts of 4-64 tokens and max_len 448, K1 18 per forward or prefill
   (6 encoder, 6 decoder self, 6 cross at Skv = 1500) and K2 12 per tick.

12. training, last: A. ``repro_torch.launch.train`` (``--full``) trains
   h2o-danube-1.8b at full width and depth (24 layers, d_model 2560, 32/8
   heads of 80, bf16, 1.83 B params) for TRAIN_STEPS steps of B=4 x 2048
   synthetic tokens at lr TRAIN_LR, remat on, fp32 moments: K1 48
   forward (24, and 24
   recomputed) and 24 backward launches a step exactly, K2-K5 none; the
   loss must fall by TRAIN_LOSS_DROP; the final checkpoint restores bit
   for bit; one more step is profiled (device time of K1's forward and
   backward, the GEMMs, the rest).  B. at A's initial weights and first
   batch, one step's loss and every leaf's gradient through the kernels
   against the plain versions, in bf16 and on float32 copies of the
   weights, and in bf16 each leaf's distance from the plain float32
   gradients against the bf16 plain versions', within GRAD_BOUNDS
   (``scripts/k1_bwd_fault.py`` shows each planted backward fault failing
   it).  C. whisper-base at full size, a
   few steps with float32 frames: K1's backward on the fp32 encoder (S =
   1500) and the bf16 cross-attention (Skv = 1500), launch counts exact,
   finite losses.
13. training of the recurrent families, after phase 12: A.
   ``launch.train --full`` trains rwkv6-1.6b at full width and depth (24
   layers, d_model 2048, bf16, 1.60 B params) for RECUR_TRAIN_STEPS steps
   of B=4 x 2048 synthetic tokens at lr RECUR_TRAIN_LR, remat on, fp32
   moments: K4 48 forward (24, and 24 recomputed) and 24 backward
   launches a step exactly, K1-K3 and K5 none; every loss finite and the
   last below the first; the final checkpoint restores bit for bit; one
   more step profiled (device time of K4's forward and backward, the
   GEMMs, the rest), with the step's seconds, tokens/s and peak memory.
   B. the same for zamba2-2.7b (54 layers, d_model 2560): K5 108 forward
   and 54 backward, K1 9 forward and 9 backward (the shared block is not
   remat'd, as in JAX). C. for each family at A's and B's initial weights
   (their first RECUR_GRAD_LAYERS layers: rwkv6's full-depth gradient at
   this init is ill-conditioned; zamba2's cut keeps the script's time)
   and first batch, one step's loss and
   every leaf's gradient through the kernels against the plain versions,
   on float32 copies and in bf16 as phase 12 B, within RECUR_GRAD_BOUNDS
   (``scripts/recurrent_bwd_fault.py`` shows each planted backward fault
   failing it); and at rwkv6's full depth, K4's backward on each layer's
   own inputs and cotangents from one float32 step against the plain
   backward and autograd of the plain forward, within RECUR_BWD_REL.
14. what fits one card, after every timed phase.  A: ``python -m
   repro_torch.launch.dryrun --all --jobs SWEEP_JOBS`` (a meta-device
   pass in worker processes with no card visible to them): every (arch x
   shape) of the configs, 10 x 4, must end "ok" (flops and argument bytes
   above 0) but whisper-base x long_500k, "skipped"; roofline's table of
   the records (per-card GiB, whether it fits, the dominant term, the
   useful ratio) is printed.  B, meanwhile in this process: the meta pass
   of each step phases 5, 12 and 13 measured, its peak bytes against the
   card's ``torch.cuda.max_memory_allocated()`` growth over what was
   resident before, within FIT_TOL either way: phase 12 A's and 13 A's
   and B's training runs (their meta pass at B=4 x 2048, remat, fp32
   moments: params, moments, batch and the step's peak), and phase 5's
   yi-9b prefill and tick (their growth over the resident params, state
   and batch; phase 5 resets the peak around one of each).  C: one more,
   untimed training step of danube, rwkv6 and zamba2 in phases 12 and 13
   runs under ``analysis.costs.Counter`` on the card: its flops within
   FLOPS_TOL and its bytes within BYTES_TOL of the meta pass's of the same
   step; the kernels' launches, as the wrappers count them where they
   launch, equal to the wrapper calls the counter saw on the card and to
   the calls the meta pass planned.  The bounds of phase 3 come from the
   kernels' cost functions (``kernels/*/ops.py``) and
   ``analysis/roofline.py``.

The line before the nvidia-smi line is ``{"kernels": [...]}`` (K1-K5,
K1's backward, K4's and K5's backward); the last line is ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import gc
import http.client
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import types
import urllib.parse
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parent

ARCH = "yi-9b"
MEMBERS = 2
QWEN_HEADS = (64, 4, 128)       # qwen3-moe-235b-a22b: H, K, hd (G = 16)
VLM_HEADS = (32, 8, 128)        # llama-3.2-vision-11b: H, K, hd
VLM_IMAGE_TOKENS = 1601         # its image: (560 / 14)^2 + 1 tokens
WHISPER_HEADS = (8, 8, 64)      # whisper-base
WHISPER_FRAMES = 1500           # its 30 s of audio after the conv stem
NUM_CLASSES = 16
# bf16 comparisons: the tolerance of the JAX kernel tests
# (tests/test_kernels.py); fp32: the same file's fp32 tolerance.
TOL = {"bfloat16": dict(rtol=3e-2, atol=3e-2),
       "float32": dict(rtol=2e-5, atol=2e-5)}
# Member logits after 48 bf16 layers: the kernel and the plain version
# round their bf16 attention outputs differently (one bf16 ulp apart), and
# each layer's difference propagates through the residual stream.  Logits
# are O(1) (|logit| <= ~2.4 with the seeded weights), where a bf16 ulp is
# 0.0156; the first H100 run measured 3.5e-2 and 3.9e-2 (about 2.5 ulps),
# so the bound is 0.1 absolute plus 5e-2 relative.
LOGITS_TOL = dict(rtol=5e-2, atol=1e-1)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_counts(library: str) -> dict:
    """Tensor-core instructions in a built library's SASS (cuobjdump):
    HGMMA is wgmma, HMMA is mma.sync.  Empty when cuobjdump is missing."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return {}
    out = subprocess.run([tool, "-sass", library], capture_output=True,
                         text=True, timeout=300).stdout
    return {op: len(re.findall(rf"\b{op}\.", out))
            for op in ("HGMMA", "HMMA")}


# K1's float32 tensor-core kernels (TF32 x 3 on mma.sync), by library
TF32_KERNELS = {"flash_attention": ("flash_attention_tf32_kernel",),
                "flash_attention_bwd": ("dkdv_tf32_kernel", "dq_tf32_kernel")}


def entry_spills(ptxas: str, names) -> dict:
    """Spill bytes (stores plus loads) of each kernel entry of a ``ptxas
    -v`` report whose name holds one of ``names``, as "name<HD>"."""
    out, entry = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry" in line:
            entry = None
            for n in names:
                m = re.search(rf"{n}I\w*?(\d+)E", line)
                if m:
                    entry = f"{n}<{m.group(1)}>"
                    out.setdefault(entry, 0)
        elif entry is not None:
            out[entry] += sum(int(b) for b in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", line))
    return out


def ptxas_spills(ptxas: str) -> dict:
    """Spill bytes (stores, loads) summed over a library's kernels, from
    its ``ptxas -v`` report."""
    out = {"stores": 0, "loads": 0}
    for m in re.finditer(r"(\d+) bytes spill (stores|loads)", ptxas):
        out[m.group(2)] += int(m.group(1))
    return out


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phase 3: kernels --------------------------------------------------------


def attention_case(name, B, S, H, K, hd, dtype, *, causal=True, window=None,
                   ragged=False, strided=False, offset=0, empty_row=False,
                   seed=0, Skv=None, key_shift=0.0):
    """q (B,S,H,hd) and k/v (B,Skv,K,hd) (Skv = S unless given).

    ``key_shift`` adds one constant to every element of k.  That moves
    each query's scores by one amount (its own c * sum(q) / sqrt(hd)),
    which leaves the true softmax as it was; but a key the kernel forgets
    to mask past Skv (TMA zero-fills the last tile) scores 0, and where a
    query's shift is negative it outweighs the real keys and pulls the
    output towards 0.  With unshifted keys such a fault shrinks every
    output at Skv = 1601 by about 2%, within the bf16 tolerance."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    Skv = S if Skv is None else Skv
    width = (2 * hd if strided else hd) + offset
    q = torch.randn((B, S, H, width), generator=g, device="cuda").to(dt)
    k = (torch.randn((B, Skv, K, width), generator=g, device="cuda")
         + key_shift).to(dt)
    v = torch.randn((B, Skv, K, width), generator=g, device="cuda").to(dt)
    q, k, v = (t[..., offset:offset + hd] for t in (q, k, v))
    lengths = None
    if ragged:
        lengths = torch.randint(0, Skv + 1, (B,), generator=g, device="cuda",
                                dtype=torch.int32)
        lengths[0] = Skv
        if empty_row:
            lengths[1] = 0
    return dict(name=name, q=q, k=k, v=v, lengths=lengths, causal=causal,
                window=window, dtype=dtype)


def time_flash(c):
    """K1 beside its plain version, SDPA and its bound at one case."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.flash_attention.ops import flash_attention_cost
    q, k, v = c["q"], c["k"], c["v"]
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    kw = dict(causal=c["causal"], window=c["window"], lengths=None)
    kernel_ms = cuda_time_ms(lambda: flash_attention(q, k, v, **kw))
    kernel_dev_ms = profiled_ms(lambda: flash_attention(q, k, v, **kw),
                                K1_KERNELS)
    plain_ms = cuda_time_ms(lambda: flash_attention_plain(q, k, v, **kw))
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def library():      # is_causal aligns top-left, as K1's mask does
        return F.scaled_dot_product_attention(qt, kt, vt,
                                              is_causal=c["causal"],
                                              enable_gqa=True)
    try:
        library_ms = cuda_time_ms(library)
        library_dev_ms = profiled_ms(library, ())
    except TypeError:                   # torch without enable_gqa
        library_ms = library_dev_ms = None
    cost = flash_attention_cost(B, S, Skv, H, K, hd, q.element_size(),
                                causal=c["causal"], window=c["window"])
    return {"shape": f"B={B} S={S}"
                     + (f" Skv={Skv}" if Skv != S else "")
                     + f" H={H} K={K} hd={hd} {c['dtype']} "
                     + ("causal" if c["causal"] else "non-causal")
                     + (f" window {c['window']}" if c["window"] else ""),
            "ms": kernel_ms, "kernel_ms": kernel_ms,
            "device_ms": kernel_dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "tensor_cores": flash_attention.tensor_cores,
            **k1_bounds(cost, c["dtype"])}


def k1_bounds(cost, dtype):
    """A K1 launch's bound from its cost: bytes once over the memory rate
    or the products over the dtype's peak (fp32: the CUDA cores'); fp32
    also the tensor-core bound of its TF32 x 3 route (the products at a
    third of the TF32 peak, nothing else counted)."""
    from repro_torch.analysis.roofline import kernel_bound, tc_bound
    bound, by = kernel_bound(cost.nbytes, cost.flops, dtype)
    out = {"bound_ms": bound, "bound_by": by, "bytes": cost.nbytes,
           "flops": cost.flops}
    if dtype == "float32":
        out["tc_bound_ms"], out["tc_bound_by"] = tc_bound(cost.nbytes,
                                                          cost.flops, 0.0)
    return out


def bound_text(t):
    """The bound (and the fp32 tensor-core bound) of a timing, for a log
    line."""
    text = f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})"
    if "tc_bound_ms" in t:
        text += (f", TF32 x 3 bound {t['tc_bound_ms']:.4f} ms "
                 f"({t['tc_bound_by']})")
    return text


# keys shifted by this much make an unmasked ragged key edge show (see
# attention_case); each query's scores move by N(0, KEY_SHIFT^2)
KEY_SHIFT = 2.0


def cross_cases(key_shift=KEY_SHIFT):
    """K1's cases at Skv != S whose key count ends in a ragged 64-key tile
    (1601 = 25 * 64 + 1, 1500 = 23 * 64 + 28), non-causal with every key
    valid, keys shifted by ``key_shift``: llama-3.2-vision's cross blocks,
    whisper's decoder cross-attention and its encoder's bidirectional
    self-attention, bf16 and the fp32 the float32 frames give, and strided
    inputs."""
    kw = dict(causal=False, key_shift=key_shift)
    return [
        attention_case("vlm cross bf16", 8, 256, *VLM_HEADS, "bfloat16",
                       Skv=VLM_IMAGE_TOKENS, **kw),
        attention_case("vlm cross fp32", 8, 256, *VLM_HEADS, "float32",
                       Skv=VLM_IMAGE_TOKENS, **kw),
        attention_case("whisper cross bf16", 8, 64, *WHISPER_HEADS,
                       "bfloat16", Skv=WHISPER_FRAMES, **kw),
        attention_case("whisper encoder bf16", 8, WHISPER_FRAMES,
                       *WHISPER_HEADS, "bfloat16", **kw),
        attention_case("whisper encoder fp32", 8, WHISPER_FRAMES,
                       *WHISPER_HEADS, "float32", **kw),
        attention_case("Skv != S bf16 strided inputs", 3, 100, 32, 8, 128,
                       "bfloat16", Skv=VLM_IMAGE_TOKENS, strided=True, **kw),
    ]


def scaled_tol(dtype, ref):
    """The dtype's tolerance with atol relative to the output's scale,
    atol * min(1, max|ref|): attention over many keys averages to small
    outputs (|out| ~ sqrt(e / Skv) for unit scores, 0.04 at Skv = 1601),
    where a fixed atol of 3e-2 would be as large as the values compared.
    Never looser than ``TOL``."""
    tol = TOL[dtype]
    return dict(rtol=tol["rtol"],
                atol=tol["atol"] * min(1.0, float(ref.abs().max())))


def check_flash_case(c):
    """K1 against its plain version at one case: (ok, max abs error, the
    tolerance used, max |ref|)."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    kw = dict(causal=c["causal"], window=c["window"], lengths=c["lengths"])
    out = flash_attention(c["q"], c["k"], c["v"], **kw).float()
    ref = flash_attention_plain(c["q"], c["k"], c["v"], **kw).float()
    torch.cuda.synchronize()
    tol = scaled_tol(c["dtype"], ref)
    ok = bool(torch.isfinite(out).all()) and torch.allclose(out, ref, **tol)
    return (ok, float((out - ref).abs().max()), tol,
            float(ref.abs().max()))


def kernel_phase(failures):
    import torch

    cases = [
        attention_case("yi-9b bf16 causal", 8, 256, 32, 4, 128, "bfloat16"),
        attention_case("yi-9b fp32 causal", 8, 256, 32, 4, 128, "float32"),
        attention_case("yi-9b bf16 window 64", 8, 256, 32, 4, 128,
                       "bfloat16", window=64),
        attention_case("yi-9b bf16 ragged lengths", 8, 256, 32, 4, 128,
                       "bfloat16", ragged=True),
        attention_case("yi-9b fp32 ragged lengths", 8, 256, 32, 4, 128,
                       "float32", ragged=True),
        attention_case("S=200 bf16 (ragged tile)", 3, 200, 32, 4, 128,
                       "bfloat16"),
        attention_case("S=200 fp32 strided inputs", 3, 200, 32, 4, 128,
                       "float32", strided=True),
        attention_case("S=200 bf16 strided inputs", 3, 200, 32, 4, 128,
                       "bfloat16", strided=True),
        attention_case("bf16 rows not 16-byte aligned", 2, 70, 8, 2, 128,
                       "bfloat16", offset=1),
        attention_case("fp32 non-causal", 2, 130, 8, 2, 64, "float32",
                       causal=False),
        attention_case("danube hd=80 bf16 window 48", 2, 130, 32, 8, 80,
                       "bfloat16", window=48),
        attention_case("hd=32 fp32 S=1", 4, 1, 4, 2, 32, "float32"),
        attention_case("hd=256 bf16 non-causal window 40", 2, 96, 4, 1, 256,
                       "bfloat16", causal=False, window=40),
        # mistral-large's and command-r-plus's group: 96 heads on 8
        attention_case("G=12 hd=128 bf16 (96/8 heads)", 2, 300, 96, 8, 128,
                       "bfloat16"),
        attention_case("bf16 window 20 (under one tile), ragged lengths "
                       "with a length-0 row", 4, 300, 32, 4, 128, "bfloat16",
                       window=20, ragged=True, empty_row=True),
        # the largest prefill bucket at max_len 1024
        attention_case("yi-9b bf16 causal S=1024", 8, 1024, 32, 4, 128,
                       "bfloat16"),
        # zamba2's shared block: MHA (G=1), hd=80, its 4096 window
        attention_case("zamba2 hd=80 G=1 bf16 window 4096", 8, 512, 32, 32,
                       80, "bfloat16", window=4096),
        # qwen3-moe's attention: 64 query heads on 4 (G=16)
        attention_case("qwen3-moe G=16 bf16 causal", 8, 256, *QWEN_HEADS,
                       "bfloat16"),
        attention_case("qwen3-moe G=16 fp32 causal", 8, 256, *QWEN_HEADS,
                       "float32"),
        attention_case("qwen3-moe G=16 bf16 ragged lengths", 8, 256,
                       *QWEN_HEADS, "bfloat16", ragged=True),
        *cross_cases(),
        attention_case("Skv < S bf16 ragged lengths with a length-0 row", 4,
                       300, 32, 8, 128, "bfloat16", causal=False, Skv=130,
                       ragged=True, empty_row=True),
        attention_case("Skv < S fp32 ragged lengths with a length-0 row", 4,
                       300, 32, 8, 128, "float32", causal=False, Skv=130,
                       ragged=True, empty_row=True),
        attention_case("causal Skv > S bf16 (top-left aligned)", 2, 200, 32,
                       8, 128, "bfloat16", Skv=333),
        attention_case("causal Skv < S fp32 ragged", 2, 200, 8, 2, 64,
                       "float32", Skv=77, ragged=True),
    ]
    from repro_torch.kernels.flash_attention import flash_attention
    results = []
    for c in cases:
        ok, err, tol, amax = check_flash_case(c)
        tc = flash_attention.tensor_cores
        log(f"[kernels] flash_attention {c['name']}: max_abs_err {err:.3e} "
            f"at max|ref| {amax:.3f} ({'ok' if ok else 'FAIL'}, rtol "
            f"{tol['rtol']}, atol {tol['atol']:.3e}), "
            f"{'tensor' if tc else 'CUDA'} cores")
        if not ok:
            failures.append(f"flash_attention {c['name']}: err {err}")
        results.append({"case": c["name"], "max_abs_err": err, "ok": ok,
                        "atol": tol["atol"], "max_abs_ref": amax,
                        "tensor_cores": tc})
    check_path(failures, "flash_attention whisper encoder fp32",
               results[[c["name"] for c in cases].index(
                   "whisper encoder fp32")]["tensor_cores"], True)

    by_name = {c["name"]: c for c in cases}
    main = time_flash(cases[0])
    zamba = time_flash(by_name["zamba2 hd=80 G=1 bf16 window 4096"])
    long = time_flash(by_name["yi-9b bf16 causal S=1024"])
    qwen = time_flash(by_name["qwen3-moe G=16 bf16 causal"])
    cross = {key: time_flash(by_name[name]) for key, name in (
        ("vlm_cross", "vlm cross bf16"), ("vlm_cross_fp32", "vlm cross fp32"),
        ("whisper_cross", "whisper cross bf16"),
        ("whisper_encoder", "whisper encoder bf16"),
        ("whisper_encoder_fp32", "whisper encoder fp32"))}
    entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:74 "
                    "(flash_attention_bhsd)",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        **main,
        "zamba2_shape": zamba,
        "s1024": long,
        "qwen3_moe_shape": qwen,
        **{f"{key}_shape": t for key, t in cross.items()},
        "cases": results,
    }
    for t in (main, zamba, long, qwen, *cross.values()):
        log(f"[kernels] flash_attention timed at {t['shape']}: kernel "
            f"{t['kernel_ms']:.4f} ms (device time {t['device_ms']:.4f} ms), "
            f"plain {t['plain_ms']:.4f} ms, SDPA {t['library_ms']} ms "
            f"(device time {t['library_device_ms']} ms), {bound_text(t)}, "
            f"{'tensor' if t['tensor_cores'] else 'CUDA'} cores")
    torch.cuda.empty_cache()
    return [entry]


# --- phase 3: K1's backward kernel ---------------------------------------------

# K1's backward kernels by launch: Delta, then dK/dV and dQ on the tensor
# cores (wgmma) or the CUDA cores
K1_BWD_SPLIT = {"delta": ("delta_kernel",),
                "dkdv": ("dkdv_wgmma_kernel", "dkdv_tf32_kernel",
                         "dkdv_kernel"),
                "dq": ("dq_wgmma_kernel", "dq_tf32_kernel", "dq_kernel")}
K1_BWD_KERNELS = tuple(n for names in K1_BWD_SPLIT.values() for n in names)
# h2o-danube-1.8b, the training phase's model: 32/8 heads of 80, its 4096
# window (wider than the sequence), B=4 x S=2048 a step
DANUBE_HEADS = (32, 8, 80)
TRAIN_SEQ, TRAIN_BATCH, DANUBE_WINDOW = 2048, 4, 4096
# Each gradient's relative L2 error against the plain backward's, besides
# the elementwise TOL at its own scale, so that a fault confined to rows
# whose gradients are small (the late queries of a long causal row) cannot
# hide under an atol set by the early rows.  Set from the unfaulted
# kernels' chip run (largest bf16 3.24e-4, fp32 1.40e-6) with a margin of
# about 6x; the last-tile fault of scripts/k1_bwd_fault.py gave 8.9e-3 to
# 0.68 in the cases it reaches.  BWD_ZERO: below this fraction of the
# case's largest norm a gradient is zero up to rounding.
BWD_REL_L2 = {"bfloat16": 2e-3, "float32": 1e-5}
BWD_ZERO = 1e-3


def bwd_inputs(c, seed=1):
    """K1's forward output and lse on a case (the kernel's own) and a
    seeded output gradient: the backward's inputs."""
    import torch
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = c["q"]
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    lengths = ops._check(q, c["k"], c["v"], c["lengths"])
    o, lse = ops._forward(q, c["k"], c["v"], c["causal"], c["window"],
                          lengths, with_lse=True)
    return o, lse, do


def check_bwd_case(c):
    """K1's backward kernel against its plain version on one case, the
    forward's lse against the plain lse, O with and without lse, and two
    runs of the backward bit for bit."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_plain, ops)
    kw = dict(causal=c["causal"], window=c["window"], lengths=c["lengths"])
    q, k, v = c["q"], c["k"], c["v"]
    o, lse, do = bwd_inputs(c)
    got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    tc = flash_attention_bwd.tensor_cores
    again = flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    o0 = ops._forward(q, k, v, c["causal"], c["window"],
                      ops._check(q, k, v, c["lengths"]), with_lse=False)[0]
    _, lse_ref = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    errs, rels, ok = {}, {}, True
    # Each gradient is held to its own scale: atol relative to its largest
    # element and its relative L2 error.  A tensor whose norm is below
    # BWD_ZERO of the case's largest is zero up to rounding (at S = 1,
    # dS = P (dP - Delta) = 0): atol takes the case's largest element
    # instead, and no relative error is taken.
    want32 = [w.float() for w in want]
    top = max(float(w.abs().max()) for w in want32)
    top_norm = max(float(w.norm()) for w in want32)
    for name, a, w in zip(("dq", "dk", "dv"), got, want32):
        a = a.float()
        zero = float(w.norm()) <= BWD_ZERO * top_norm
        tol = scaled_tol(c["dtype"], torch.tensor(
            top if zero else float(w.abs().max())))
        errs[name] = float((a - w).abs().max())
        rels[name] = None if zero else float((a - w).norm() / w.norm())
        ok &= (bool(torch.isfinite(a).all()) and torch.allclose(a, w, **tol)
               and (zero or rels[name] <= BWD_REL_L2[c["dtype"]]))
    det = all(torch.equal(a, b) for a, b in zip(got, again))
    fin = torch.isfinite(lse_ref)
    ltol = 1e-5 if c["dtype"] == "float32" else 1e-4
    lse_ok = (torch.equal(torch.isneginf(lse), torch.isneginf(lse_ref))
              and torch.allclose(lse[fin], lse_ref[fin], rtol=ltol,
                                 atol=ltol))
    lse_err = float((lse[fin] - lse_ref[fin]).abs().max()) if fin.any() \
        else 0.0
    return {"case": c["name"], "ok": bool(ok), "max_abs_err": max(
        errs.values()), "errs": errs, "rel_l2": rels, "deterministic": det,
        "lse_ok": bool(lse_ok), "lse_err": lse_err,
        "o_bitwise_with_lse": torch.equal(o0, o), "tensor_cores": tc}


def time_bwd(c):
    """K1's backward beside its plain version, SDPA's forward + backward
    and its bound at one case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, ops)
    q, k, v = c["q"], c["k"], c["v"]
    B, S, H, hd = q.shape
    Skv, K = k.shape[1], k.shape[2]
    kw = dict(causal=c["causal"], window=c["window"], lengths=None)
    o, lse, do = bwd_inputs(dict(c, lengths=None))

    def ours():
        return flash_attention_bwd(q, k, v, o, lse, do, **kw)

    def both():             # our forward (with lse) and backward
        o2, lse2 = ops._forward(q, k, v, c["causal"], c["window"], None,
                                with_lse=True)
        return flash_attention_bwd(q, k, v, o2, lse2, do, **kw)
    kernel_ms = cuda_time_ms(ours)
    split = profiled_groups_ms(ours, K1_BWD_SPLIT)
    device = sum(split.values())
    both_ms = cuda_time_ms(both)
    plain_ms = cuda_time_ms(lambda: flash_attention_bwd_plain(
        q, k, v, o, lse, do, **kw), iters=5, warmup=1)
    qt, kt, vt = (t.transpose(1, 2).detach().contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def library():      # SDPA forward + backward; is_causal is top-left
        out = F.scaled_dot_product_attention(qt, kt, vt,
                                             is_causal=c["causal"],
                                             enable_gqa=True)
        out.backward(dot)
    try:
        library_ms = cuda_time_ms(library)
        library_dev_ms = profiled_ms(library, ())
    except TypeError:                   # torch without enable_gqa
        library_ms = library_dev_ms = None
    del qt, kt, vt
    cost = ops.flash_attention_bwd_cost(B, S, Skv, H, K, hd, q.element_size(),
                                        causal=c["causal"],
                                        window=c["window"])
    tc = flash_attention_bwd.tensor_cores
    return {"shape": f"B={B} S={S}" + (f" Skv={Skv}" if Skv != S else "")
                     + f" H={H} K={K} hd={hd} {c['dtype']} "
                     + ("causal" if c["causal"] else "non-causal")
                     + (f" window {c['window']}" if c["window"] else ""),
            "ms": kernel_ms, "device_ms": device, "device_split_ms": split,
            "fwd_bwd_ms": both_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_device_ms": library_dev_ms, "tensor_cores": tc,
            **k1_bounds(cost, c["dtype"])}


def bwd_cases():
    """Phase 3's cases of K1's backward: danube's training shape first."""
    danube = ("danube train bf16 causal (B=4, S=2048, window 4096)",
              TRAIN_BATCH, TRAIN_SEQ, *DANUBE_HEADS, "bfloat16")
    return [
        attention_case(*danube, window=DANUBE_WINDOW),
        attention_case("danube fp32 causal S=1024", 1, 1024,
                       *DANUBE_HEADS, "float32", window=DANUBE_WINDOW),
        attention_case("yi-9b bf16 causal", 8, 256, 32, 4, 128, "bfloat16"),
        attention_case("yi-9b bf16 window 64", 4, 256, 32, 4, 128,
                       "bfloat16", window=64),
        attention_case("bf16 window 20, ragged lengths with a length-0 row",
                       4, 300, 32, 4, 128, "bfloat16", window=20,
                       ragged=True, empty_row=True),
        attention_case("fp32 ragged lengths with a length-0 row", 4, 200, 8,
                       2, 64, "float32", ragged=True, empty_row=True),
        attention_case("S=200 bf16 strided inputs", 3, 200, 32, 4, 128,
                       "bfloat16", strided=True),
        attention_case("bf16 rows not 16-byte aligned", 2, 70, 8, 2, 128,
                       "bfloat16", offset=1),
        attention_case("hd=32 fp32 S=1", 4, 1, 4, 2, 32, "float32"),
        attention_case("hd=256 bf16 non-causal window 40", 2, 96, 4, 1, 256,
                       "bfloat16", causal=False, window=40),
        attention_case("hd=64 bf16 causal", 2, 300, 8, 2, 64, "bfloat16"),
        attention_case("G=12 hd=128 bf16 (96/8 heads)", 2, 300, 96, 8, 128,
                       "bfloat16"),
        attention_case("hd=96 bf16 G=1", 2, 200, 4, 4, 96, "bfloat16"),
        attention_case("qwen3-moe G=16 bf16 causal", 2, 256, *QWEN_HEADS,
                       "bfloat16"),
        attention_case("vlm cross bf16", 8, 256, *VLM_HEADS, "bfloat16",
                       causal=False, Skv=VLM_IMAGE_TOKENS,
                       key_shift=KEY_SHIFT),
        attention_case("whisper cross bf16", 4, 64, *WHISPER_HEADS,
                       "bfloat16", causal=False, Skv=WHISPER_FRAMES,
                       key_shift=KEY_SHIFT),
        attention_case("whisper encoder fp32", 2, WHISPER_FRAMES,
                       *WHISPER_HEADS, "float32", causal=False,
                       key_shift=KEY_SHIFT),
        attention_case("whisper decoder self bf16", 4, 64, *WHISPER_HEADS,
                       "bfloat16"),
        attention_case("Skv < S fp32 ragged lengths with a length-0 row", 4,
                       300, 32, 8, 128, "float32", causal=False, Skv=130,
                       ragged=True, empty_row=True),
        attention_case("causal Skv > S bf16 (top-left aligned)", 2, 200, 32,
                       8, 128, "bfloat16", Skv=333),
    ]


def bwd_case_ok(r):
    return (r["ok"] and r["deterministic"] and r["lse_ok"]
            and r["o_bitwise_with_lse"])


def bwd_kernel_phase(failures):
    """Phase 3, K1's backward: every case against its plain version, then
    timed at danube's training shape, the vlm cross shape and whisper's
    fp32 encoder."""
    import torch
    cases = bwd_cases()
    results = []
    for c in cases:
        r = check_bwd_case(c)
        good = bwd_case_ok(r)
        log(f"[kernels] flash_attention_bwd {c['name']}: max_abs_err "
            f"{r['max_abs_err']:.3e} ({r['errs']}), relative L2 "
            f"{r['rel_l2']}, "
            f"{'tensor' if r['tensor_cores'] else 'CUDA'} cores, "
            f"deterministic {r['deterministic']}, lse err "
            f"{r['lse_err']:.2e}, O bitwise with lse "
            f"{r['o_bitwise_with_lse']} ({'ok' if good else 'FAIL'})")
        if not good:
            failures.append(f"flash_attention_bwd {c['name']}: {r}")
        results.append(r)
        torch.cuda.empty_cache()
    by_name = {c["name"]: c for c in cases}
    if not results[0]["tensor_cores"]:
        failures.append("flash_attention_bwd: danube's case did not take "
                        "the tensor-core kernels")
    check_path(failures, "flash_attention_bwd whisper encoder fp32",
               results[[c["name"] for c in cases].index(
                   "whisper encoder fp32")]["tensor_cores"], True)
    main = time_bwd(cases[0])
    timed = {key: time_bwd(by_name[name]) for key, name in (
        ("vlm_cross", "vlm cross bf16"),
        ("whisper_encoder_fp32", "whisper encoder fp32"))}
    for t in (main, *timed.values()):
        log(f"[kernels] flash_attention_bwd timed at {t['shape']}: kernel "
            f"{t['ms']:.4f} ms (device time {t['device_ms']:.4f} ms: "
            + ", ".join(f"{k} {v:.4f}" for k, v in
                        t["device_split_ms"].items())
            + f"; with K1's forward {t['fwd_bwd_ms']:.4f} ms), plain "
            f"{t['plain_ms']:.4f} ms, SDPA forward + backward "
            f"{t['library_ms']} ms (device {t['library_device_ms']} ms), "
            f"{bound_text(t)}, {'tensor' if t['tensor_cores'] else 'CUDA'} "
            f"cores")
        if not t["device_ms"] > 0:      # a renamed kernel would read 0
            failures.append(f"flash_attention_bwd: the profiled device time "
                            f"of {K1_BWD_KERNELS} reads 0 at {t['shape']}")
    torch.cuda.empty_cache()
    return {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:74 "
                    "(the gradient of flash_attention_bhsd; the TPU "
                    "kernel has none, JAX differentiates its jnp "
                    "attention)",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        **main,
        **{f"{key}_shape": t for key, t in timed.items()},
        "cases": results,
    }


def device_ms(prof, names) -> float:
    """Summed device time (ms) of the profiled kernels whose name holds
    one of ``names`` (all kernels when ``names`` is empty).  Only device
    events count: an operator's row repeats its kernels' time."""
    from torch.autograd import DeviceType
    total = 0.0
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        if names and not any(n in evt.key for n in names):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        total += us
    return total / 1e3


def profiled_groups_ms(fn, groups, iters: int = 20) -> dict:
    """Device time per call of each group of named kernels ({group:
    names}) over ``iters`` calls, from torch.profiler (the launches' host
    overhead is not in it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {g: device_ms(prof, names) / iters for g, names in groups.items()}


def profiled_ms(fn, names, iters: int = 20) -> float:
    """Device time per call of the named kernels (all kernels when
    ``names`` is empty)."""
    return profiled_groups_ms(fn, {"": names}, iters)[""]


K1_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_tf32_kernel",
              "flash_attention_kernel")
K2_KERNELS = ("decode_split_kernel", "decode_split_mma_kernel",
              "decode_combine_kernel")


def decode_case(name, B, Smax, H, K, hd, dtype, *, window=None,
                lengths="ragged", stacked=False, seed=0):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    layers = 3 if stacked else 1
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dt)
    ck = torch.randn((layers, B, Smax, K, hd), generator=g,
                     device="cuda").to(dt)
    cv = torch.randn((layers, B, Smax, K, hd), generator=g,
                     device="cuda").to(dt)
    ck, cv = ck[layers // 2], cv[layers // 2]
    if lengths == "full":
        lens = torch.full((B,), Smax, dtype=torch.int32, device="cuda")
    elif lengths == "ring":           # min(L+1, Smax): some rows wrapped
        L = torch.randint(0, 3 * Smax, (B,), generator=g, device="cuda")
        lens = torch.clamp(L + 1, max=Smax).to(torch.int32)
    else:
        lens = torch.randint(1, Smax + 1, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
        lens[0] = Smax
        if lengths == "one":
            lens[1] = 1
    return dict(name=name, q=q, k=ck, v=cv, lengths=lens, window=window,
                dtype=dtype)


def time_decode(c):
    """K2 beside its plain version, SDPA and its bound at one case."""
    import torch
    import torch.nn.functional as F
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.ops import decode_attention_cost
    q, k, v, lens = c["q"], c["k"], c["v"], c["lengths"]
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    kernel_ms = cuda_time_ms(lambda: decode_attention(q, k, v, lens))
    kernel_dev_ms = profiled_ms(lambda: decode_attention(q, k, v, lens),
                                K2_KERNELS)
    plain_ms = cuda_time_ms(lambda: decode_attention_plain(q, k, v, lens))
    qs = q[:, :, None, :]
    ks, vs = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(Smax, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                              enable_gqa=True)
    try:
        library_ms = cuda_time_ms(library)
        library_dev_ms = profiled_ms(library, ())
    except TypeError:                   # torch without enable_gqa
        library_ms = library_dev_ms = None
    keys = int(torch.clamp(lens, max=Smax).sum())
    cost = decode_attention_cost(B, H, K, hd, Smax, k.element_size(),
                                 q.element_size(), keys)
    bound, by = kernel_bound(cost.nbytes, cost.flops, c["dtype"])
    return {"shape": f"B={B} Smax={Smax} H={H} K={K} hd={hd} {c['dtype']} "
                     f"valid keys {keys}",
            "ms": kernel_ms, "kernel_ms": kernel_ms,
            "device_ms": kernel_dev_ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "bound_ms": bound, "bound_by": by, "bytes": cost.nbytes,
            "flops": cost.flops}


def decode_kernel_phase(failures):
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.ops import tensor_core_path
    yi = (32, 4, 128)
    cases = [
        decode_case("yi-9b bf16 ragged", 8, 1024, *yi, "bfloat16"),
        decode_case("yi-9b fp32 ragged", 8, 1024, *yi, "float32"),
        decode_case("yi-9b bf16 window 100", 8, 1024, *yi, "bfloat16",
                    window=100),
        decode_case("ring lengths min(L+1,Smax) bf16", 8, 256, *yi,
                    "bfloat16", lengths="ring"),
        decode_case("length-1 row bf16", 8, 1024, *yi, "bfloat16",
                    lengths="one"),
        decode_case("Smax 1000 fp32 (ragged tile)", 3, 1000, *yi,
                    "float32"),
        decode_case("layer view of a stacked cache bf16", 8, 512, *yi,
                    "bfloat16", stacked=True),
        decode_case("danube hd=80 G=4 bf16 window 300", 4, 512, 32, 8, 80,
                    "bfloat16", window=300),
        decode_case("G=12 bf16", 2, 700, 96, 8, 128, "bfloat16"),
        decode_case("hd=256 fp32", 2, 300, 8, 2, 256, "float32"),
        decode_case("hd=256 bf16", 2, 300, 8, 2, 256, "bfloat16"),
        # zamba2's shared block tick: MHA (G=1), hd=80, a ring of 1024
        decode_case("zamba2 hd=80 G=1 bf16 ring lengths", 8, 1024, 32, 32,
                    80, "bfloat16", lengths="ring"),
        # qwen3-moe's tick: G=16, TC_HEADS, one tensor-core block a group
        decode_case("qwen3-moe G=16 bf16 ragged", 8, 1024, *QWEN_HEADS,
                    "bfloat16"),
        decode_case("qwen3-moe G=16 fp32 ragged", 8, 1024, *QWEN_HEADS,
                    "float32"),
        # the cross-attention step: one token against the fixed image K/V
        # (llama-3.2-vision) or audio K/V (whisper), every key valid
        decode_case("vlm cross step bf16", 8, VLM_IMAGE_TOKENS, *VLM_HEADS,
                    "bfloat16", lengths="full"),
        decode_case("whisper cross step bf16", 8, WHISPER_FRAMES,
                    *WHISPER_HEADS, "bfloat16", lengths="full"),
    ]
    results = []
    for c in cases:
        if c["name"].startswith("qwen3-moe"):
            check_path(failures, f"decode_attention {c['name']}",
                       tensor_core_path(c["q"], c["k"], c["v"]),
                       c["dtype"] == "bfloat16")
        args = (c["q"], c["k"], c["v"], c["lengths"])
        out = decode_attention(*args, window=c["window"])
        ref = decode_attention_plain(*args, window=c["window"])
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[c["dtype"]]
        ok = bool(torch.isfinite(out.float()).all()) and torch.allclose(
            out.float(), ref.float(), **tol)
        log(f"[kernels] decode_attention {c['name']}: max_abs_err {err:.3e} "
            f"({'ok' if ok else 'FAIL'}, rtol/atol {tol['rtol']})")
        if not ok:
            failures.append(f"decode_attention {c['name']}: err {err}")
        results.append({"case": c["name"], "max_abs_err": err, "ok": ok})

    by_name = {c["name"]: c for c in cases}
    main = time_decode(cases[0])
    zamba = time_decode(by_name["zamba2 hd=80 G=1 bf16 ring lengths"])
    qwen = time_decode(by_name["qwen3-moe G=16 bf16 ragged"])
    vlm_step = time_decode(by_name["vlm cross step bf16"])
    long_case = decode_case("long cache", 8, 32768, *yi, "bfloat16",
                            lengths="full")
    long = time_decode(long_case)
    del long_case
    for t in (main, zamba, long, qwen, vlm_step):
        log(f"[kernels] decode_attention timed at {t['shape']}: kernel "
            f"{t['kernel_ms']:.4f} ms (device time {t['device_ms']:.4f} "
            f"ms), plain {t['plain_ms']:.4f} ms, SDPA {t['library_ms']} "
            f"ms (device time {t['library_device_ms']} ms), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}, {t['bytes']} bytes)")
    e4m3 = decode_e4m3_cases(failures)
    entry = {
        "name": "decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:72 "
                    "(decode_attention_bkgd)",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        **main,
        "zamba2_shape": zamba,
        "long_cache": long,
        "qwen3_moe_shape": qwen,
        "vlm_cross_step_shape": vlm_step,
        "cases": results,
        "e4m3": e4m3,
    }
    torch.cuda.empty_cache()
    return [entry]



# --- phase 3, K2/K3 on the fp8 e4m3 cache ---------------------------------------


def to_e4m3(x):
    """The port's cache cast (``attention.to_cache``) of a float tensor,
    after planting the format's edges: a share of values near +-448 and of
    e4m3 subnormals (|x| < 2^-6), so that a wrong conversion shows."""
    import torch
    from repro_torch.models.attention import to_cache
    flat = x.reshape(-1)
    flat[::97] = 440.0
    flat[1::89] = -448.0
    flat[2::7] *= 2 ** -9
    return to_cache(x.to(torch.bfloat16), torch.float8_e4m3fn)


def e4m3_copy(c):
    """A decode or paged case with its k/v turned into an e4m3 cache (a
    layer view stays a view of its stacked cache) and q kept bf16; the
    bf16 copy of the same cache rides along."""
    import torch
    k, v = c["k"], c["v"]
    kb, vb = (t._base if t._base is not None else t for t in (k, v))
    k8b, v8b = to_e4m3(kb.float() * 3.0), to_e4m3(vb.float() * 3.0)
    k8 = k8b.as_strided(k.shape, k.stride(), k.storage_offset())
    v8 = v8b.as_strided(v.shape, v.stride(), v.storage_offset())
    return dict(c, name=c["name"] + " e4m3", k=k8, v=v8,
                k_bf16=k8.to(torch.bfloat16), v_bf16=v8.to(torch.bfloat16),
                dtype="float8_e4m3fn", q=c["q"].to(torch.bfloat16))


def check_e4m3(failures, kernel_name, c, out, ref, copy):
    """An e4m3 case: finite, within the bf16 tolerance of the plain version
    (which dequantizes to bf16) and bit for bit the kernel on the bf16 copy
    of the same cache (e4m3 -> bf16 is exact)."""
    import torch
    err = float((out.float() - ref.float()).abs().max())
    tol = TOL["bfloat16"]
    bitwise = bool(torch.equal(out, copy))
    ok = (bool(torch.isfinite(out.float()).all())
          and torch.allclose(out.float(), ref.float(), **tol) and bitwise)
    log(f"[kernels] {kernel_name} {c['name']}: max_abs_err {err:.3e} (rtol/"
        f"atol {tol['rtol']}), bitwise equal to the kernel on the cache's "
        f"bf16 copy: {bitwise} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{kernel_name} {c['name']}: err {err}, bitwise vs "
                        f"the bf16 copy {bitwise}")
    return {"case": c["name"], "max_abs_err": err, "ok": ok,
            "bitwise_bf16_copy": bitwise}


def unaligned_copy(t):
    """A copy of ``t`` whose rows start 8 bytes off 16 (so a bf16 copy
    takes the CUDA-core kernel, as its e4m3 original does)."""
    import torch
    pad = 8 // t.element_size()
    buf = torch.empty(t.shape[:-1] + (t.shape[-1] + pad,), dtype=t.dtype,
                      device=t.device)
    out = buf[..., pad:]
    out.copy_(t)
    return out


def time_decode_e4m3(c):
    """K2 on an e4m3 cache beside K2 on its bf16 copy (same shape, same
    call), the plain version, an upcast-to-bf16 + SDPA yardstick and the
    1-byte bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.ops import decode_attention_cost
    q, k, v, lens = c["q"], c["k"], c["v"], c["lengths"]
    kb, vb = c["k_bf16"], c["v_bf16"]
    B, H, hd = q.shape
    Smax, K = k.shape[1], k.shape[2]
    t = {}
    # in turns: e4m3, bf16, bf16, e4m3
    for name, kk, vv in (("e4m3", k, v), ("bf16", kb, vb),
                         ("bf16_again", kb, vb), ("e4m3_again", k, v)):
        t[name] = cuda_time_ms(lambda: decode_attention(q, kk, vv, lens))
    dev = profiled_ms(lambda: decode_attention(q, k, v, lens), K2_KERNELS)
    dev_bf16 = profiled_ms(lambda: decode_attention(q, kb, vb, lens),
                           K2_KERNELS)
    plain_ms = cuda_time_ms(lambda: decode_attention_plain(q, k, v, lens))
    mask = (torch.arange(Smax, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]

    def library():                  # dequantize, then the library call
        return F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2).to(torch.bfloat16),
            v.transpose(1, 2).to(torch.bfloat16), attn_mask=mask,
            enable_gqa=True)
    try:
        library_ms = cuda_time_ms(library)
        library_dev_ms = profiled_ms(library, ())
    except TypeError:                   # torch without enable_gqa
        library_ms = library_dev_ms = None
    keys = int(torch.clamp(lens, max=Smax).sum())
    cost = decode_attention_cost(B, H, K, hd, Smax, k.element_size(),
                                 q.element_size(), keys)
    bound, by = kernel_bound(cost.nbytes, cost.flops, "bfloat16")
    return {"shape": f"B={B} Smax={Smax} H={H} K={K} hd={hd} e4m3 cache, "
                     f"bf16 q, valid keys {keys}",
            "ms": min(t["e4m3"], t["e4m3_again"]),
            "kernel_ms": min(t["e4m3"], t["e4m3_again"]),
            "kernel_ms_runs": [t["e4m3"], t["e4m3_again"]],
            "device_ms": dev,
            "bf16_kernel_ms": min(t["bf16"], t["bf16_again"]),
            "bf16_kernel_ms_runs": [t["bf16"], t["bf16_again"]],
            "bf16_device_ms": dev_bf16, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_device_ms": library_dev_ms,
            "bound_ms": bound, "bound_by": by, "bytes": cost.nbytes,
            "flops": cost.flops}


def log_e4m3_timed(name, t, extra=""):
    log(f"[kernels] {name} e4m3 timed at {t['shape']}: kernel "
        f"{t['kernel_ms']:.4f} ms (runs {t['kernel_ms_runs'][0]:.4f}, "
        f"{t['kernel_ms_runs'][1]:.4f}; device {t['device_ms']:.4f} ms); the "
        f"same kernel on the bf16 copy {t['bf16_kernel_ms']:.4f} ms (device "
        f"{t['bf16_device_ms']:.4f} ms); plain {t['plain_ms']:.4f} ms; "
        f"upcast to bf16 + SDPA {t['library_ms']} ms (device "
        f"{t['library_device_ms']} ms); bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}, {t['bytes']} bytes at 1 byte per cache "
        f"element){extra}")


def decode_e4m3_cases(failures):
    """K2 on e4m3 caches at the shapes that exist: each held against the
    plain version and bit for bit against K2 on the bf16 copy; the path
    (tensor-core or CUDA-core) asserted; timed at the tick, 32k keys,
    qwen3-moe's G=16, danube and hd=256 beside K2 on the bf16 copy."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.ops import tensor_core_path
    yi = (32, 4, 128)
    bf = "bfloat16"
    cases = [(e4m3_copy(c), tc) for c, tc in (
        (decode_case("yi-9b tick ragged", 8, 1024, *yi, bf), True),
        (decode_case("yi-9b window 100", 8, 1024, *yi, bf, window=100),
         True),
        (decode_case("danube hd=80 G=4 window 300", 4, 512, 32, 8, 80, bf,
                     window=300), True),
        (decode_case("qwen3-moe G=16 ragged", 8, 1024, *QWEN_HEADS, bf),
         True),
        (decode_case("hd=256", 2, 300, 8, 2, 256, bf), False),
        (decode_case("length-1 row", 8, 1024, *yi, bf, lengths="one"),
         True),
        (decode_case("layer view of a stacked cache", 8, 512, *yi, bf,
                     stacked=True), True))]
    # a strided row: head dims 8..72 of a 128-wide e4m3 cache (8 bytes off
    # 16): the CUDA-core kernel
    base = e4m3_copy(decode_case("strided rows hd=64", 4, 600, 16, 2, 128,
                                 bf))
    strided = dict(base, q=base["q"][..., :64].contiguous(),
                   k=base["k"][..., 8:72], v=base["v"][..., 8:72],
                   k_bf16=base["k_bf16"][..., 8:72],
                   v_bf16=base["v_bf16"][..., 8:72])
    cases.append((strided, False))
    results = []
    for c, want_tc in cases:
        check_path(failures, f"decode_attention {c['name']}",
                   tensor_core_path(c["q"], c["k"], c["v"]), want_tc)
        args = (c["q"], c["k"], c["v"], c["lengths"])
        out = decode_attention(*args, window=c["window"])
        ref = decode_attention_plain(*args, window=c["window"])
        kb, vb = c["k_bf16"], c["v_bf16"]
        if not want_tc and tensor_core_path(c["q"], kb, vb):
            kb, vb = unaligned_copy(kb), unaligned_copy(vb)   # CUDA cores too
        check_path(failures, f"decode_attention {c['name']} bf16 copy",
                   tensor_core_path(c["q"], kb, vb), want_tc)
        copy = decode_attention(c["q"], kb, vb, c["lengths"],
                                window=c["window"])
        torch.cuda.synchronize()
        results.append(check_e4m3(failures, "decode_attention", c, out, ref,
                                  copy))
    by_name = {c["name"]: c for c, _ in cases}
    timed = {}
    for key, name in (("tick", "yi-9b tick ragged e4m3"),
                      ("qwen3_moe", "qwen3-moe G=16 ragged e4m3"),
                      ("danube", "danube hd=80 G=4 window 300 e4m3"),
                      ("hd256_cuda_core", "hd=256 e4m3")):
        timed[key] = time_decode_e4m3(by_name[name])
        log_e4m3_timed("decode_attention", timed[key])
    del cases, by_name, base, strided
    long_case = e4m3_copy(decode_case("32k keys", 8, 32768, *yi, bf,
                                      lengths="full"))
    out = decode_attention(long_case["q"], long_case["k"], long_case["v"],
                           long_case["lengths"])
    ref = decode_attention_plain(long_case["q"], long_case["k"],
                                 long_case["v"], long_case["lengths"])
    copy = decode_attention(long_case["q"], long_case["k_bf16"],
                            long_case["v_bf16"], long_case["lengths"])
    results.append(check_e4m3(failures, "decode_attention", long_case, out,
                              ref, copy))
    timed["long_cache"] = time_decode_e4m3(long_case)
    t = timed["long_cache"]
    log_e4m3_timed("decode_attention", t, f"; e4m3 / bf16 kernel time "
                   f"{t['kernel_ms'] / t['bf16_kernel_ms']:.3f}")
    if t["kernel_ms"] > t["bf16_kernel_ms"]:
        log(f"[kernels] decode_attention e4m3 at 32k keys is SLOWER than "
            f"the bf16 kernel on the same cache ({t['kernel_ms']:.4f} vs "
            f"{t['bf16_kernel_ms']:.4f} ms); recorded in PERF.md")
    del long_case
    torch.cuda.empty_cache()
    return {"cases": results, "timed": timed}


def paged_case(name, B, MP, ps, H, K, hd, dtype, *, window=None,
               lengths="ragged", share=False, vacant=False, stacked=False,
               shuffle=True, seed=0):
    """q, a pool of B*MP + 1 pages (page 0 the dump page) and a shuffled
    table (``shuffle=False``: each row's pages in pool order); ``share``:
    rows 1-2 take row 0's first 4 pages; ``vacant``: the last row sits on
    the dump page with length 1."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    layers = 3 if stacked else 1
    P = B * MP + 1
    q = torch.randn((B, H, hd), generator=g, device="cuda").to(dt)
    kp = torch.randn((layers, P, ps, K, hd), generator=g,
                     device="cuda").to(dt)
    vp = torch.randn((layers, P, ps, K, hd), generator=g,
                     device="cuda").to(dt)
    kp, vp = kp[layers // 2], vp[layers // 2]
    perm = (torch.randperm(P - 1, generator=g, device="cuda") if shuffle
            else torch.arange(P - 1, device="cuda")) + 1
    table = perm.reshape(B, MP).to(torch.int32)
    Smax = MP * ps
    if lengths == "full":
        lens = torch.full((B,), Smax, dtype=torch.int32, device="cuda")
    elif lengths == "tick":          # the generate phase's 17-330 tokens
        lens = torch.randint(17, 331, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
    elif lengths == "ring":          # min(L+1, Smax): some rows wrapped
        L = torch.randint(0, 3 * Smax, (B,), generator=g, device="cuda")
        lens = torch.clamp(L + 1, max=Smax).to(torch.int32)
    else:
        lens = torch.randint(1, Smax + 1, (B,), generator=g, device="cuda",
                             dtype=torch.int32)
    if share:
        table[1:3, :4] = table[0, :4]
        lens[1:3] = torch.clamp(lens[1:3], min=4 * ps + 1)
    if vacant:
        table[-1] = 0
        lens[-1] = 1
    return dict(name=name, q=q, k=kp, v=vp, table=table, lengths=lens,
                window=window, dtype=dtype, ps=ps)


def paged_decode_kernel_phase(failures):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention,
        paged_decode_attention_plain)
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels.decode_attention.ops import (
        paged_decode_attention_cost, tensor_core_path)
    from repro_torch.models.paged import _gathered_view

    yi = (32, 4, 128)
    cases = [
        paged_case("yi-9b tick bf16, 3 rows share 4 pages", 8, 64, 16, *yi,
                   "bfloat16", lengths="tick", share=True),
        paged_case("yi-9b tick fp32, 3 rows share 4 pages", 8, 64, 16, *yi,
                   "float32", lengths="tick", share=True),
        paged_case("yi-9b bf16 window 100", 8, 64, 16, *yi, "bfloat16",
                   window=100),
        paged_case("vacant row on the dump page bf16", 8, 64, 16, *yi,
                   "bfloat16", vacant=True),
        paged_case("danube hd=80 G=4 bf16 window 300", 4, 32, 16, 32, 8,
                   80, "bfloat16", window=300),
        paged_case("hd=256 bf16", 2, 20, 16, 8, 2, 256, "bfloat16"),
        paged_case("G=12 bf16 (one block per group)", 2, 44, 16, 96, 8, 128,
                   "bfloat16"),
        paged_case("zamba2 hd=80 G=1 bf16 ring lengths", 8, 64, 16, 32, 32,
                   80, "bfloat16", lengths="ring"),
        paged_case("page size 32 bf16", 8, 32, 32, *yi, "bfloat16"),
        paged_case("page size 64 bf16", 8, 16, 64, *yi, "bfloat16"),
        paged_case("layer view of a stacked pool bf16", 8, 32, 16, *yi,
                   "bfloat16", stacked=True),
        # qwen3-moe's paged tick: G=16 on the tensor-core path
        paged_case("qwen3-moe tick G=16 bf16, 3 rows share 4 pages", 8, 64,
                   16, *QWEN_HEADS, "bfloat16", lengths="tick", share=True),
        paged_case("qwen3-moe tick G=16 fp32", 8, 64, 16, *QWEN_HEADS,
                   "float32", lengths="tick"),
    ]
    results = []
    for c in cases:
        if c["name"].startswith("qwen3-moe"):
            check_path(failures, f"paged_decode_attention {c['name']}",
                       tensor_core_path(c["q"], c["k"], c["v"]),
                       c["dtype"] == "bfloat16")
        args = (c["q"], c["k"], c["v"], c["table"], c["lengths"])
        out = paged_decode_attention(*args, window=c["window"])
        ref = paged_decode_attention_plain(*args, window=c["window"])
        bitwise = None
        if c["ps"] == 16:            # K2's split plan: K2's bits
            gk, gv = _gathered_view(c["k"], c["v"], c["table"])
            k2 = decode_attention(c["q"], gk, gv, c["lengths"],
                                  window=c["window"])
            bitwise = bool(torch.equal(out, k2))
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = TOL[c["dtype"]]
        ok = (bool(torch.isfinite(out.float()).all())
              and torch.allclose(out.float(), ref.float(), **tol)
              and bitwise is not False)
        log(f"[kernels] paged_decode_attention {c['name']}: max_abs_err "
            f"{err:.3e} (rtol/atol {tol['rtol']})"
            + ("" if bitwise is None else
               f", bitwise equal to K2 on the gathered cache: {bitwise}")
            + f" -> {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"paged_decode_attention {c['name']}: err {err}, "
                            f"bitwise vs K2 {bitwise}")
        results.append({"case": c["name"], "max_abs_err": err, "ok": ok,
                        "bitwise_k2": bitwise})

    def timed(c):
        q, kp, vp, table, lens = (c[k] for k in ("q", "k", "v", "table",
                                                 "lengths"))
        B, H, hd = q.shape
        ps, K = kp.shape[1], kp.shape[2]
        Smax = table.shape[1] * ps
        gk, gv = _gathered_view(kp, vp, table)
        kernel_ms = cuda_time_ms(
            lambda: paged_decode_attention(q, kp, vp, table, lens))
        dev_ms = profiled_ms(
            lambda: paged_decode_attention(q, kp, vp, table, lens),
            K2_KERNELS)
        k2_ms = cuda_time_ms(lambda: decode_attention(q, gk, gv, lens))
        k2_dev_ms = profiled_ms(lambda: decode_attention(q, gk, gv, lens),
                                K2_KERNELS)
        plain_ms = cuda_time_ms(
            lambda: paged_decode_attention_plain(q, kp, vp, table, lens))
        # page size 16: K2's split plan, so K2's bits on the gathered cache
        bitwise = bool(torch.equal(
            paged_decode_attention(q, kp, vp, table, lens),
            decode_attention(q, gk, gv, lens))) if ps == 16 else None
        mask = (torch.arange(Smax, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]

        def library():              # the JAX default: gather, then attend
            ck, cv = _gathered_view(kp, vp, table)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], ck.transpose(1, 2), cv.transpose(1, 2),
                attn_mask=mask, enable_gqa=True)
        try:
            library_ms = cuda_time_ms(library)
        except TypeError:                   # torch without enable_gqa
            library_ms = None
        del gk, gv
        keys = int(torch.clamp(lens, max=Smax).sum())
        pages = int(((torch.clamp(lens, max=Smax) + ps - 1) // ps).sum())
        cost = paged_decode_attention_cost(B, H, K, hd, table.shape[1], ps,
                                           kp.element_size(),
                                           q.element_size(), keys, pages)
        bound, by = kernel_bound(cost.nbytes, cost.flops, c["dtype"])
        return {"shape": f"B={B} pages/row={table.shape[1]} ps={ps} H={H} "
                         f"K={K} hd={hd} {c['dtype']} valid keys {keys}",
                "ms": kernel_ms, "kernel_ms": kernel_ms,
                "device_ms": dev_ms, "k2_ms": k2_ms, "k2_device_ms": k2_dev_ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound, "bound_by": by, "bytes": cost.nbytes,
                "flops": cost.flops, "bitwise_k2": bitwise}

    main = timed(cases[0])
    qwen = timed(cases[-2])
    long_case = paged_case("32k keys per row", 8, 2048, 16, *yi, "bfloat16",
                           lengths="full")
    long = timed(long_case)
    del long_case
    # the same pool with each row's pages in pool order: what page
    # scattering over 0.5 GB costs beside the indirection itself
    long_case = paged_case("32k keys per row, pages in order", 8, 2048, 16,
                           *yi, "bfloat16", lengths="full", shuffle=False)
    ordered = timed(long_case)
    del long_case
    long["pages_in_order"] = {k: ordered[k] for k in (
        "kernel_ms", "device_ms", "k2_ms", "k2_device_ms")}
    log(f"[kernels] paged_decode_attention at 32k keys per row with each "
        f"row's pages in pool order: kernel {ordered['kernel_ms']:.4f} ms "
        f"(device {ordered['device_ms']:.4f} ms); K2 on the gathered cache "
        f"{ordered['k2_ms']:.4f} ms (device {ordered['k2_device_ms']:.4f} "
        f"ms)")
    for t in (main, long, qwen):
        log(f"[kernels] paged_decode_attention timed at {t['shape']}: kernel "
            f"{t['kernel_ms']:.4f} ms (device {t['device_ms']:.4f} ms); K2 on "
            f"the gathered cache {t['k2_ms']:.4f} ms (device "
            f"{t['k2_device_ms']:.4f} ms); plain {t['plain_ms']:.4f} ms; "
            f"gather + SDPA {t['library_ms']} ms; bound {t['bound_ms']:.4f} "
            f"ms ({t['bound_by']}, {t['bytes']} bytes); bitwise equal to K2 "
            f"on the gathered cache: {t['bitwise_k2']}")
        if t["bitwise_k2"] is False:
            failures.append(f"paged_decode_attention at {t['shape']}: not "
                            f"bitwise equal to K2 on the gathered cache")
    torch.cuda.empty_cache()
    e4m3 = paged_e4m3_cases(failures)
    return [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/csrc/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:164 "
                    "(pallas_call :202)",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        **main,
        "long_cache": long,
        "qwen3_moe_shape": qwen,
        "cases": results,
        "e4m3": e4m3,
    }]


def paged_e4m3_cases(failures):
    """K3 on e4m3 pools: each case held against the plain version, bit for
    bit against K3 on the pool's bf16 copy and, at page size 16, against
    K2 on the gathered e4m3 cache; timed at the tick and at 32k keys per
    row beside K3 on the bf16 copy, K2 on the gathered e4m3 cache, a
    gather + upcast + SDPA yardstick and the 1-byte bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import (
        decode_attention, paged_decode_attention,
        paged_decode_attention_plain)
    from repro_torch.analysis.roofline import kernel_bound
    from repro_torch.kernels.decode_attention.ops import (
        paged_decode_attention_cost, tensor_core_path)
    from repro_torch.models.paged import _gathered_view

    yi = (32, 4, 128)
    bf = "bfloat16"
    cases = [(e4m3_copy(c), tc) for c, tc in (
        (paged_case("yi-9b tick, 3 rows share 4 pages", 8, 64, 16, *yi, bf,
                    lengths="tick", share=True), True),
        (paged_case("yi-9b window 100, a vacant row", 8, 64, 16, *yi, bf,
                    window=100, vacant=True), True),
        (paged_case("danube hd=80 G=4 window 300", 4, 32, 16, 32, 8, 80, bf,
                    window=300), True),
        (paged_case("hd=256", 2, 20, 16, 8, 2, 256, bf), False),
        (paged_case("page size 32", 8, 32, 32, *yi, bf), True),
        (paged_case("layer view of a stacked pool", 8, 32, 16, *yi, bf,
                    stacked=True), True),
        (paged_case("qwen3-moe tick G=16, 3 rows share 4 pages", 8, 64, 16,
                    *QWEN_HEADS, bf, lengths="tick", share=True), True))]
    results = []
    for c, want_tc in cases:
        check_path(failures, f"paged_decode_attention {c['name']}",
                   tensor_core_path(c["q"], c["k"], c["v"]), want_tc)
        args = (c["q"], c["k"], c["v"], c["table"], c["lengths"])
        out = paged_decode_attention(*args, window=c["window"])
        ref = paged_decode_attention_plain(*args, window=c["window"])
        copy = paged_decode_attention(c["q"], c["k_bf16"], c["v_bf16"],
                                      c["table"], c["lengths"],
                                      window=c["window"])
        k2 = None
        if c["ps"] == 16:            # K2's split plan: K2's bits
            gk, gv = _gathered_view(c["k"], c["v"], c["table"])
            k2 = bool(torch.equal(out, decode_attention(
                c["q"], gk, gv, c["lengths"], window=c["window"])))
        torch.cuda.synchronize()
        rec = check_e4m3(failures, "paged_decode_attention", c, out, ref,
                         copy)
        rec["bitwise_k2"] = k2
        if k2 is False:
            failures.append(f"paged_decode_attention {c['name']}: not "
                            f"bitwise K2 on the gathered e4m3 cache")
        log(f"[kernels] paged_decode_attention {c['name']}: bitwise equal to "
            f"K2 on the gathered e4m3 cache: {k2}")
        results.append(rec)

    def timed(c):
        q, kp, vp, table, lens = (c[k] for k in ("q", "k", "v", "table",
                                                 "lengths"))
        kb, vb = c["k_bf16"], c["v_bf16"]
        B, H, hd = q.shape
        ps, K = kp.shape[1], kp.shape[2]
        Smax = table.shape[1] * ps
        gk, gv = _gathered_view(kp, vp, table)
        t = {}
        for name, kk, vv in (("e4m3", kp, vp), ("bf16", kb, vb),
                             ("bf16_again", kb, vb), ("e4m3_again", kp, vp)):
            t[name] = cuda_time_ms(
                lambda: paged_decode_attention(q, kk, vv, table, lens))
        dev = profiled_ms(
            lambda: paged_decode_attention(q, kp, vp, table, lens),
            K2_KERNELS)
        k2_ms = cuda_time_ms(lambda: decode_attention(q, gk, gv, lens))
        plain_ms = cuda_time_ms(
            lambda: paged_decode_attention_plain(q, kp, vp, table, lens))
        bitwise = bool(torch.equal(
            paged_decode_attention(q, kp, vp, table, lens),
            decode_attention(q, gk, gv, lens)))
        mask = (torch.arange(Smax, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]

        def library():        # gather, dequantize, then the library call
            ck, cv = _gathered_view(kp, vp, table)
            return F.scaled_dot_product_attention(
                q[:, :, None, :], ck.transpose(1, 2).to(torch.bfloat16),
                cv.transpose(1, 2).to(torch.bfloat16), attn_mask=mask,
                enable_gqa=True)
        try:
            library_ms = cuda_time_ms(library)
        except TypeError:                   # torch without enable_gqa
            library_ms = None
        del gk, gv
        keys = int(torch.clamp(lens, max=Smax).sum())
        pages = int(((torch.clamp(lens, max=Smax) + ps - 1) // ps).sum())
        cost = paged_decode_attention_cost(B, H, K, hd, table.shape[1], ps,
                                           kp.element_size(),
                                           q.element_size(), keys, pages)
        nbytes = cost.nbytes
        bound, by = kernel_bound(nbytes, cost.flops, "bfloat16")
        rec = {"shape": f"B={B} pages/row={table.shape[1]} ps={ps} H={H} "
                        f"K={K} hd={hd} e4m3 pool, bf16 q, valid keys {keys}",
               "ms": min(t["e4m3"], t["e4m3_again"]),
               "kernel_ms": min(t["e4m3"], t["e4m3_again"]),
               "kernel_ms_runs": [t["e4m3"], t["e4m3_again"]],
               "device_ms": dev,
               "bf16_kernel_ms": min(t["bf16"], t["bf16_again"]),
               "bf16_kernel_ms_runs": [t["bf16"], t["bf16_again"]],
               "k2_ms": k2_ms, "plain_ms": plain_ms,
               "library_ms": library_ms,
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "flops": cost.flops, "bitwise_k2": bitwise}
        log(f"[kernels] paged_decode_attention e4m3 timed at {rec['shape']}: "
            f"kernel {rec['kernel_ms']:.4f} ms (runs "
            f"{t['e4m3']:.4f}, {t['e4m3_again']:.4f}; device {dev:.4f} ms); "
            f"the same kernel on the bf16 copy {rec['bf16_kernel_ms']:.4f} "
            f"ms; K2 on the gathered e4m3 cache {k2_ms:.4f} ms; plain "
            f"{plain_ms:.4f} ms; gather + upcast + SDPA {library_ms} ms; "
            f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, {nbytes} "
            f"bytes at 1 byte per pool element); bitwise equal to K2 on the "
            f"gathered cache: {bitwise}")
        if not bitwise:
            failures.append(f"paged_decode_attention e4m3 at {rec['shape']}: "
                            f"not bitwise K2 on the gathered cache")
        return rec

    tick = timed(cases[0][0])
    del cases
    long_case = e4m3_copy(paged_case("32k keys per row", 8, 2048, 16, *yi,
                                     bf, lengths="full"))
    long = timed(long_case)
    del long_case
    torch.cuda.empty_cache()
    return {"cases": results, "timed": {"tick": tick, "long_cache": long}}

# --- phase 3: K2/K3 with P as bf16 hi + lo parts, before and after --------

# decode_attention.cu's P V as it was before the kernels took P as bf16 hi
# + lo parts: P rounded to bf16, one product a tile
P_SPLIT_NOW = """    uint32_t ph[4], pl[4];
    pack_bf16_split(s[0][0], s[0][1], ph[0], pl[0]);
    pack_bf16_split(s[0][2], s[0][3], ph[1], pl[1]);
    pack_bf16_split(s[1][0], s[1][1], ph[2], pl[2]);
    pack_bf16_split(s[1][2], s[1][3], ph[3], pl[3]);
#pragma unroll
    for (int d = 0; d < NT_O; d += 2) {
      // matrices: (keys 0-7, dims 8d), (keys 8-15, dims 8d), (.., 8d+8)
      uint32_t bf[4];
      ldsm_x4_trans(bf, vs + ((mi & 1) * 8 + (lane & 7)) * LDS +
                            (d + (mi >> 1)) * 8);
      mma_bf16(acc[d], pl, bf[0], bf[1]);
      mma_bf16(acc[d + 1], pl, bf[2], bf[3]);
      mma_bf16(acc[d], ph, bf[0], bf[1]);
      mma_bf16(acc[d + 1], ph, bf[2], bf[3]);
    }"""
P_SPLIT_BEFORE = """    uint32_t pf[4];
    pf[0] = pack_bf16(s[0][0], s[0][1]);
    pf[1] = pack_bf16(s[0][2], s[0][3]);
    pf[2] = pack_bf16(s[1][0], s[1][1]);
    pf[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
    for (int d = 0; d < NT_O; d += 2) {
      // matrices: (keys 0-7, dims 8d), (keys 8-15, dims 8d), (.., 8d+8)
      uint32_t bf[4];
      ldsm_x4_trans(bf, vs + ((mi & 1) * 8 + (lane & 7)) * LDS +
                            (d + (mi >> 1)) * 8);
      mma_bf16(acc[d], pf, bf[0], bf[1]);
      mma_bf16(acc[d + 1], pf, bf[2], bf[3]);
    }"""


def bf16_p_library():
    """K2/K3's library with P rounded to bf16 for P V (the kernels before
    they took P as hi + lo parts), written from the checkout's source
    under build/variants and built beside the real one: a yardstick that
    only ``p_split_phase`` loads."""
    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention import ops as da_ops
    src = da_ops.SOURCE.read_text()
    if src.count(P_SPLIT_NOW) != 1:
        raise RuntimeError("bf16_p_library: the P V block is not in "
                           f"{da_ops.SOURCE} once")
    path = ROOT / "build" / "variants" / "decode_attention_bf16p.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(P_SPLIT_NOW, P_SPLIT_BEFORE))
    lib = common.load_library("decode_attention_bf16p", [path])
    real = da_ops.build()
    for fn in ("decode_attention_fwd", "paged_decode_attention_fwd"):
        getattr(lib, fn).argtypes = getattr(real, fn).argtypes
        getattr(lib, fn).restype = getattr(real, fn).restype
    return lib


def p_split_phase(failures, kernels):
    """K2 and K3 at the yi-9b tick and at 32k keys, bf16 and e4m3 caches:
    the kernels (P as bf16 hi + lo parts) timed in turns against the
    yardstick that rounds P to bf16 (after, before, before, after; CUDA
    events, and the device time from torch.profiler, which at the tick is
    a tenth of the event time), and the two outputs' largest
    difference.  The results go into K2's
    and K3's kernels-line entries under ``p_split``."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      paged_decode_attention)
    from repro_torch.kernels.decode_attention import ops as da_ops
    before_lib = bf16_p_library()
    real_build = da_ops.build
    yi = (32, 4, 128)

    def timed(fn):
        runs, dev = {}, {}
        for name, lib in (("after", None), ("before", before_lib),
                          ("before_again", before_lib), ("after_again", None)):
            da_ops.build = real_build if lib is None else (lambda: lib)
            try:
                runs[name] = cuda_time_ms(fn)
                dev[name] = profiled_ms(fn, K2_KERNELS)
                if name == "before":
                    old = fn()
            finally:
                da_ops.build = real_build
        new = fn()
        torch.cuda.synchronize()
        after = min(runs["after"], runs["after_again"])
        before = min(runs["before"], runs["before_again"])
        dev_after = min(dev["after"], dev["after_again"])
        dev_before = min(dev["before"], dev["before_again"])
        return {"ms": after, "bf16_p_ms": before, "device_ms": dev_after,
                "bf16_p_device_ms": dev_before,
                "device_ratio": dev_after / dev_before, "runs": runs,
                "device_runs": dev,
                "max_abs_diff": float((new.float() - old.float()).abs().max())}

    out = {"decode_attention": {}, "paged_decode_attention": {}}
    for shape, Smax, MP, lens in (("tick", 1024, 64, "ragged"),
                                  ("32k keys", 32768, 2048, "full")):
        dense = decode_case(shape, 8, Smax, *yi, "bfloat16", lengths=lens)
        paged = paged_case(shape, 8, MP, 16, *yi, "bfloat16",
                           lengths="tick" if lens == "ragged" else lens,
                           share=lens == "ragged")
        for cache, dc, pc in (("bf16", dense, paged),
                              ("e4m3", e4m3_copy(dense), e4m3_copy(paged))):
            key = f"{shape} {cache}"
            out["decode_attention"][key] = timed(
                lambda: decode_attention(dc["q"], dc["k"], dc["v"],
                                         dc["lengths"]))
            out["paged_decode_attention"][key] = timed(
                lambda: paged_decode_attention(pc["q"], pc["k"], pc["v"],
                                               pc["table"], pc["lengths"]))
            for name in out:
                t = out[name][key]
                log(f"[kernels] {name} at {key}, P as bf16 hi + lo parts: "
                    f"device {t['device_ms']:.4f} ms (event {t['ms']:.4f}); "
                    f"P in bf16 (before): device {t['bf16_p_device_ms']:.4f} "
                    f"ms (event {t['bf16_p_ms']:.4f}); device ratio "
                    f"{t['device_ratio']:.3f} (device runs "
                    + ", ".join(f"{k} {v:.4f}"
                                for k, v in t["device_runs"].items())
                    + "; event runs "
                    + ", ".join(f"{k} {v:.4f}" for k, v in t["runs"].items())
                    + f"); outputs differ by at most {t['max_abs_diff']:.3e}")
        del dense, paged
        torch.cuda.empty_cache()
    by_name = {k["name"]: k for k in kernels}
    for name in out:
        by_name[name]["p_split"] = out[name]
        if not all(t["max_abs_diff"] > 0 for t in out[name].values()):
            failures.append(f"{name}: the bf16-P yardstick gave the same "
                            f"outputs as the kernel (not built as meant?)")


# --- phase 3: K4 (WKV-6) and K5 (SSD) ------------------------------------------

# fp32 in and out: tests/test_kernels.py's WKV and SSD tolerance (the SSD's
# y relative to max|y| + 1, as there)
RECUR_TOL = dict(rtol=1e-4, atol=1e-4)


def wkv_inputs(B, T, H, N, *, decay_shift=-1.0, s0_scale=0.3, seed=0):
    """r, k, v, logw = -exp(normal + decay_shift), u, s0 on the card
    (tests/test_kernels.py::test_wkv6's distributions)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = rnd(B, T, H, N), rnd(B, T, H, N), rnd(B, T, H, N)
    logw = -torch.exp(rnd(B, T, H, N) + decay_shift)
    return [r, k, v, logw, rnd(H, N) * 0.5, rnd(B, H, N, N) * s0_scale]


def ssd_inputs(B, T, H, P, N, *, h0_scale=0.3, seed=0):
    """x, dt = softplus(normal), A = -exp(normal), Bm, Cm, h0 on the card
    (tests/test_kernels.py::test_ssd's distributions)."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    return [rnd(B, T, H, P), F.softplus(rnd(B, T, H)), -torch.exp(rnd(H)),
            rnd(B, T, N), rnd(B, T, N), rnd(B, H, P, N) * h0_scale]


def pad_mask(B, T, seed=0):
    """(B,T,1,1) float mask of right-padded rows with 17..T valid steps
    (row 0 full), and the lengths."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    lens = torch.randint(17, T + 1, (B,), generator=g, device="cuda")
    lens[0] = T
    m = (torch.arange(T, device="cuda")[None, :] < lens[:, None]).float()
    return m[:, :, None, None], lens


def check_pair(failures, kernel_name, case, got, want, *, scaled=False):
    """Kernel outputs vs plain outputs: finite, allclose (y relative to
    max|y| + 1 with ``scaled``).  Returns the max abs error."""
    import torch
    errs, ok = [], True
    for i, (g, w) in enumerate(zip(got, want)):
        scale = float(w.abs().max()) + 1.0 if (scaled and i == 0) else 1.0
        errs.append(float((g - w).abs().max()))
        ok &= bool(torch.isfinite(g).all()) and torch.allclose(
            g / scale, w / scale, **RECUR_TOL)
    log(f"[kernels] {kernel_name} {case}: max_abs_err y {errs[0]:.3e}, "
        f"state {errs[1]:.3e} ({'ok' if ok else 'FAIL'}, rtol/atol "
        f"{RECUR_TOL['rtol']}{', y over max|y|+1' if scaled else ''})")
    if not ok:
        failures.append(f"{kernel_name} {case}: errs {errs}")
    return {"case": case, "max_abs_err": max(errs), "ok": ok}


def check_path(failures, name, takes_tc, want_tc):
    """The wrapper's shape predicate on a case: the model's shapes must
    take the tensor-core kernel."""
    log(f"[kernels] {name}: {'tensor-core' if takes_tc else 'CUDA-core'} "
        f"kernel")
    if takes_tc != want_tc:
        failures.append(f"{name}: tensor_core_path is {takes_tc}")


def log_timed(name, t):
    log(f"[kernels] {name} timed at {t['shape']}: kernel "
        f"{t['kernel_ms']:.4f} ms (device {t['device_ms']:.4f} ms), plain "
        f"{t['plain_ms']:.4f} ms, no library call; fp32 bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} bytes, "
        f"{t['flops']} fp32 operations), tensor-core bound "
        f"{t['bound_tf32x3_ms']:.4f} ms ({t['bound_tf32x3_by']}: "
        f"{t['tc_products']} operations in products at 495/3 TFLOP/s, "
        f"{t['tc_other']} others at 67)")


def wkv_kernel_phase(failures):
    import torch
    from repro_torch.analysis.roofline import kernel_bound, tc_bound
    from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_plain
    from repro_torch.kernels.rwkv6_wkv.ops import (KERNEL_NAMES,
                                                   tensor_core_path,
                                                   wkv6_cost)

    def run(name, ins):
        got = wkv6(*ins)
        want = wkv6_plain(*ins)
        torch.cuda.synchronize()
        return check_pair(failures, "wkv6", name, got, want)

    main_ins = wkv_inputs(8, 512, 32, 64)
    check_path(failures, "wkv6 at the rwkv6 bucket",
               tensor_core_path(*main_ins[:4]), True)
    results = [run("rwkv6 prefill B=8 T=512 H=32 N=64 fp32", main_ins)]
    results.append(run("T=300", wkv_inputs(2, 300, 32, 64, seed=1)))
    results.append(run("T=17", wkv_inputs(3, 17, 32, 64, seed=2)))
    # masked pad steps, as the model's ragged prefill makes them
    r, k, v, logw, u, s0 = wkv_inputs(8, 512, 32, 64, seed=3)
    m, lens = pad_mask(8, 512, seed=3)
    masked = [r, k * m, v * m, logw * m, u, s0]
    results.append(run("masked pad steps (k=v=0, logw=0)", masked))
    n1 = int(lens[1])
    _, s_masked = wkv6(*masked)
    _, s_row = wkv6(r[1:2, :n1], k[1:2, :n1], v[1:2, :n1], logw[1:2, :n1],
                    u, s0[1:2])
    same = torch.allclose(s_masked[1:2], s_row, **RECUR_TOL)
    log(f"[kernels] wkv6 masked row of {n1} steps: state equals the "
        f"unpadded call's: {same}")
    if not same:
        failures.append("wkv6: masked steps changed the state")
    ins = wkv_inputs(4, 200, 32, 64, s0_scale=1.0, seed=4)
    ins[1], ins[2] = torch.zeros_like(ins[1]), torch.zeros_like(ins[2])
    results.append(run("nonzero s0, k=v=0", ins))
    r, k, v, logw, u, s0 = wkv_inputs(2, 300, 32, 64, seed=5)
    y1, s1 = wkv6(r[:, :131], k[:, :131], v[:, :131], logw[:, :131], u, s0)
    y2, s2 = wkv6(r[:, 131:], k[:, 131:], v[:, 131:], logw[:, 131:], u, s1)
    want = wkv6_plain(r, k, v, logw, u, s0)
    torch.cuda.synchronize()
    results.append(check_pair(failures, "wkv6",
                              "two-call continuation (131 + 169)",
                              (torch.cat([y1, y2], 1), s2), want))
    results.append(run("extreme decay", wkv_inputs(2, 512, 32, 64,
                                                   decay_shift=2.0, seed=6)))
    long_ins = wkv_inputs(1, 16384, 32, 64, seed=7)
    results.append(run("B=1 T=16384", long_ins))
    # the other side of the shape predicate: N=32 and an unaligned view
    small = wkv_inputs(2, 100, 4, 32, seed=8)
    check_path(failures, "wkv6 at N=32", tensor_core_path(*small[:4]),
               False)
    results.append(run("N=32 (CUDA-core kernel)", small))
    r = wkv_inputs(2, 100, 4, 64, seed=9)
    flat = torch.empty(r[0].numel() + 1, device="cuda")[1:]
    r[0] = flat.view(r[0].shape).copy_(r[0])
    check_path(failures, "wkv6 with r 4 bytes off 16-byte alignment",
               tensor_core_path(*r[:4]), False)
    results.append(run("N=64 unaligned r (CUDA-core kernel)", r))

    def timed(ins):
        B, T, H, N = ins[0].shape
        kernel_ms = cuda_time_ms(lambda: wkv6(*ins))
        dev_ms = profiled_ms(lambda: wkv6(*ins), KERNEL_NAMES)
        plain_ms = cuda_time_ms(lambda: wkv6_plain(*ins), iters=5,
                                warmup=1)
        cost = wkv6_cost(B, T, H, N)
        nbytes, flops = cost.nbytes, cost.flops
        products, other = cost.products, cost.other
        bound, by = kernel_bound(nbytes, flops, "float32")
        tc, tc_by = tc_bound(nbytes, products, other)
        return {"shape": f"B={B} T={T} H={H} N={N} fp32", "ms": kernel_ms,
                "kernel_ms": kernel_ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
                "bound_by": by, "bound_tf32x3_ms": tc,
                "bound_tf32x3_by": tc_by, "bytes": nbytes, "flops": flops,
                "tc_products": products, "tc_other": other}

    main, long = timed(main_ins), timed(long_ins)
    for t in (main, long):
        log_timed("wkv6", t)
    del main_ins, long_ins
    torch.cuda.empty_cache()
    return [{
        "name": "wkv6",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:74 (wkv6_bhtn, "
                    "pallas_call :85)",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        **main,
        "long_sequence": long,
        "cases": results,
    }]


def ssd_kernel_phase(failures):
    import torch
    from repro_torch.analysis.roofline import kernel_bound, tc_bound
    from repro_torch.kernels.mamba2_ssd import ssd, ssd_plain
    from repro_torch.kernels.mamba2_ssd.ops import (KERNEL_NAMES, ssd_cost,
                                                    tensor_core_path)

    def run(name, ins):
        got = ssd(*ins)
        want = ssd_plain(*ins)
        torch.cuda.synchronize()
        return check_pair(failures, "ssd", name, got, want, scaled=True)

    main_ins = ssd_inputs(8, 512, 80, 64, 64)
    check_path(failures, "ssd at the zamba2 bucket",
               tensor_core_path(main_ins[0], main_ins[3], main_ins[4]), True)
    results = [run("zamba2 prefill B=8 T=512 H=80 P=N=64 fp32", main_ins)]
    results.append(run("T=300", ssd_inputs(2, 300, 80, 64, 64, seed=1)))
    x, dt, A, Bm, Cm, h0 = ssd_inputs(8, 512, 80, 64, 64, seed=2)
    m, lens = pad_mask(8, 512, seed=2)
    results.append(run("dt=0 pad steps", [x, dt * m[..., 0], A, Bm, Cm, h0]))
    n1 = int(lens[1])
    _, h_masked = ssd(x, dt * m[..., 0], A, Bm, Cm, h0)
    _, h_row = ssd(x[1:2, :n1], dt[1:2, :n1], A, Bm[1:2, :n1], Cm[1:2, :n1],
                   h0[1:2])
    same = torch.allclose(h_masked[1:2], h_row, **RECUR_TOL)
    log(f"[kernels] ssd dt=0 row of {n1} steps: state equals the unpadded "
        f"call's: {same}")
    if not same:
        failures.append("ssd: dt=0 steps changed the state")
    results.append(run("nonzero h0", ssd_inputs(2, 200, 80, 64, 64,
                                                h0_scale=1.0, seed=3)))
    x, dt, A, Bm, Cm, h0 = ssd_inputs(2, 300, 80, 64, 64, seed=4)
    y1, h1 = ssd(x[:, :130], dt[:, :130], A, Bm[:, :130], Cm[:, :130], h0)
    y2, h2 = ssd(x[:, 130:], dt[:, 130:], A, Bm[:, 130:], Cm[:, 130:], h1)
    want = ssd_plain(x, dt, A, Bm, Cm, h0)
    torch.cuda.synchronize()
    results.append(check_pair(failures, "ssd",
                              "two-call continuation (130 + 170)",
                              (torch.cat([y1, y2], 1), h2), want,
                              scaled=True))
    long_ins = ssd_inputs(1, 16384, 80, 64, 64, seed=5)
    results.append(run("B=1 T=16384", long_ins))
    # the other side of the shape predicate: P=32, N=16 and a view whose
    # rows are 66 floats apart
    small = ssd_inputs(2, 100, 8, 32, 16, seed=6)
    check_path(failures, "ssd at P=32 N=16",
               tensor_core_path(small[0], small[3], small[4]), False)
    results.append(run("P=32 N=16 (CUDA-core kernel)", small))
    odd = ssd_inputs(2, 100, 8, 64, 64, seed=7)
    odd[3] = torch.nn.functional.pad(odd[3], (0, 2))[..., :64]
    check_path(failures, "ssd with Bm rows 66 floats apart",
               tensor_core_path(odd[0], odd[3], odd[4]), False)
    results.append(run("P=N=64 Bm rows 66 apart (CUDA-core kernel)", odd))

    def timed(ins):
        B, T, H, P = ins[0].shape
        N = ins[3].shape[-1]
        kernel_ms = cuda_time_ms(lambda: ssd(*ins))
        dev_ms = profiled_ms(lambda: ssd(*ins), KERNEL_NAMES)
        plain_ms = cuda_time_ms(lambda: ssd_plain(*ins), iters=5, warmup=1)
        cost = ssd_cost(B, T, H, P, N)
        nbytes, flops = cost.nbytes, cost.flops
        products, other = cost.products, cost.other
        bound, by = kernel_bound(nbytes, flops, "float32")
        tc, tc_by = tc_bound(nbytes, products, other)
        return {"shape": f"B={B} T={T} H={H} P={P} N={N} fp32",
                "ms": kernel_ms, "kernel_ms": kernel_ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
                "bound_by": by, "bound_tf32x3_ms": tc,
                "bound_tf32x3_by": tc_by, "bytes": nbytes, "flops": flops,
                "tc_products": products, "tc_other": other}

    main, long = timed(main_ins), timed(long_ins)
    for t in (main, long):
        log_timed("ssd", t)
    del main_ins, long_ins
    torch.cuda.empty_cache()
    return [{
        "name": "ssd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:73 (ssd_bhtp, "
                    "pallas_call :83)",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        **main,
        "long_sequence": long,
        "cases": results,
    }]

# --- phase 3: K4's and K5's backward -------------------------------------------

# Each gradient's largest error against the plain backward over that
# gradient's largest entry: the CPU tests' bound (tests/test_torch_rwkv6_
# wkv_bwd.py, test_torch_mamba2_ssd_bwd.py), fp32 on both sides.
RECUR_BWD_REL = 1e-4
RWKV6_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 32, 64)          # B, T, H, N
ZAMBA2_TRAIN = (TRAIN_BATCH, TRAIN_SEQ, 80, 64, 64)     # B, T, H, P, N
WKV_GRADS = ("r", "k", "v", "logw", "u", "s0")
SSD_GRADS = ("x", "dt", "A", "Bm", "Cm", "h0")


def cotangents(seed, *shapes):
    """Seeded randn cotangents on the card, one per shape (None for a
    shape of None: a dropped output)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    return [None if s is None else torch.randn(s, generator=g, device="cuda")
            for s in shapes]


def grads_check(failures, kernel, case, got, want, names):
    """Each gradient against the plain backward's at RECUR_BWD_REL of its
    largest entry, finite.  Returns the case's record."""
    import torch
    rel, errs, ok = {}, {}, True
    for name, g, w in zip(names, got, want):
        scale = float(w.abs().max())
        errs[name] = float((g - w).abs().max())
        rel[name] = errs[name] / scale if scale > 0 else errs[name]
        ok &= bool(torch.isfinite(g).all()) and rel[name] <= RECUR_BWD_REL
    worst = max(rel, key=rel.get)
    log(f"[kernels] {kernel} {case}: largest error over each gradient's "
        f"largest entry {rel[worst]:.2e} ({worst}; bound {RECUR_BWD_REL}): "
        + ", ".join(f"{k} {v:.1e}" for k, v in rel.items())
        + f" ({'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append(f"{kernel} {case}: relative errors {rel}")
    return {"case": case, "max_abs_err": max(errs.values()),
            "rel_err": rel, "ok": ok}


def bwd_case(failures, kernel, case, fn, plain, ins, names):
    """``fn`` (the kernels' wrapper) twice and ``plain`` once on the same
    inputs: every gradient within RECUR_BWD_REL, the two calls bit for
    bit."""
    import torch
    got = fn(*ins)
    again = fn(*ins)
    want = plain(*ins)
    torch.cuda.synchronize()
    rec = grads_check(failures, kernel, case, got, want, names)
    rec["bitwise_repeat"] = all(torch.equal(a, b) for a, b in zip(got, again))
    if not rec["bitwise_repeat"]:
        failures.append(f"{kernel} {case}: two calls differ")
    del got, again, want
    torch.cuda.empty_cache()
    return rec


def identity_check(failures, kernel, fwd_plain, plain_bwd, ins, names):
    """At the training shape, the plain backward (the kernels' formula,
    reverse sums and all) against autograd of the plain forward: the same
    gradient by another route, so a flaw of the formula that the kernels
    share cannot pass unseen at full length."""
    import torch
    *xs, dy, dT = ins
    leaves = [t.detach().clone().requires_grad_(True) for t in xs]
    y, sT = fwd_plain(*leaves)
    loss = (y * dy).sum() + (0.0 if dT is None else (sT * dT).sum())
    want = torch.autograd.grad(loss, leaves)
    del y, sT, loss, leaves
    got = plain_bwd(*ins)
    torch.cuda.synchronize()
    rec = grads_check(failures, kernel, "training shape, the plain backward "
                      "against autograd of the plain forward", got, want,
                      names)
    del got, want
    torch.cuda.empty_cache()
    return rec


def time_recurrent_bwd(fn, plain, ins, names, nbytes, flops, shape):
    """One backward's kernel ms (CUDA events), device ms (torch.profiler,
    split between its two kernels: the boundary scans and the chunk
    kernel), the plain backward's ms and the fp32 bound (bytes over 3.35
    TB/s or operations over the fp32 peak)."""
    kernel_ms = cuda_time_ms(lambda: fn(*ins), iters=10, warmup=2)
    split = profiled_groups_ms(lambda: fn(*ins),
                               {k: (k,) for k in names}, iters=10)
    from repro_torch.analysis.roofline import kernel_bound
    plain_ms = cuda_time_ms(lambda: plain(*ins), iters=3, warmup=1)
    bound, by = kernel_bound(nbytes, flops, "float32")
    return {"shape": shape, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "device_ms": sum(split.values()), "device_split_ms": split,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound,
            "bound_by": by, "bytes": nbytes, "flops": flops}


def log_bwd_timed(name, t):
    log(f"[kernels] {name} timed at {t['shape']}: kernel {t['ms']:.4f} ms "
        f"(device {t['device_ms']:.4f} ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t["device_split_ms"].items())
        + f"), plain backward {t['plain_ms']:.4f} ms, no library call; "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} "
        f"bytes, {t['flops']} fp32 operations)")


def wkv_bwd_kernel_phase(failures):
    """Phase 3, K4's backward (``wkv6_bwd``) against ``wkv6_bwd_plain``:
    rwkv6's training shape (zero s0, no state cotangent, as training
    calls it; the tensor-core route asserted) also against autograd of the
    plain forward, an unaligned T with a nonzero s0 and dsT, N=32 and an
    unaligned r (the CUDA-core route), strong decay, one chunk; timed at
    the training shape against the fp32 and the tensor-core bound."""
    import torch
    from repro_torch.analysis.roofline import tc_bound
    from repro_torch.kernels.rwkv6_wkv import (wkv6_bwd, wkv6_bwd_plain,
                                               wkv6_plain)
    from repro_torch.kernels.rwkv6_wkv.ops import (BWD_KERNEL_NAMES,
                                                   tensor_core_path,
                                                   wkv6_bwd_cost)

    def inputs(B, T, H, N, *, s0_scale=0.3, dsT=True, seed=0, **kw):
        ins = wkv_inputs(B, T, H, N, s0_scale=s0_scale, seed=seed, **kw)
        return ins + cotangents(seed, (B, T, H, N),
                                (B, H, N, N) if dsT else None)

    def case(name, ins):
        return bwd_case(failures, "wkv6_bwd", name, wkv6_bwd,
                        wkv6_bwd_plain, ins, WKV_GRADS)

    B, T, H, N = RWKV6_TRAIN
    main_ins = inputs(B, T, H, N, s0_scale=0.0, dsT=False)
    check_path(failures, "wkv6_bwd at the rwkv6 training shape",
               tensor_core_path(*main_ins[:4]), True)
    results = [case(f"rwkv6 training B={B} T={T} H={H} N={N}, s0 = 0, "
                    f"no dsT", main_ins)]
    results.append(identity_check(failures, "wkv6_bwd", wkv6_plain,
                                  wkv6_bwd_plain, main_ins, WKV_GRADS))
    results.append(case("T=130, nonzero s0 and dsT",
                        inputs(2, 130, 32, 64, seed=1)))
    small = inputs(2, 100, 4, 32, seed=2)
    check_path(failures, "wkv6_bwd at N=32", tensor_core_path(*small[:4]),
               False)
    results.append(case("N=32", small))
    results.append(case("strong decay (logw = -exp(normal + 2))",
                        inputs(2, 512, 32, 64, decay_shift=2.0, seed=3)))
    ins = inputs(2, 100, 4, 64, seed=4)
    flat = torch.empty(ins[0].numel() + 1, device="cuda")[1:]
    ins[0] = flat.view(ins[0].shape).copy_(ins[0])
    check_path(failures, "wkv6_bwd with r 4 bytes off 16-byte alignment",
               tensor_core_path(*ins[:4]), False)
    results.append(case("r 4 bytes off 16-byte alignment", ins))
    results.append(case("one chunk (T=20)", inputs(3, 20, 32, 64, seed=5)))
    cost = wkv6_bwd_cost(B, T, H, N)
    t = time_recurrent_bwd(wkv6_bwd, wkv6_bwd_plain, main_ins,
                           BWD_KERNEL_NAMES, cost.nbytes, cost.flops,
                           f"B={B} T={T} H={H} N={N} fp32")
    products, other = cost.products, cost.other
    tc, tc_by = tc_bound(cost.nbytes, products, other)
    t.update(bound_tf32x3_ms=tc, bound_tf32x3_by=tc_by, tc_products=products,
             tc_other=other)
    log_bwd_timed("wkv6_bwd", t)
    log(f"[kernels] wkv6_bwd tensor-core bound {tc:.4f} ms ({tc_by}: "
        f"{products} operations in products at 495/3 TFLOP/s, {other} "
        f"others at 67); kernel {t['ms'] / tc:.2f}x it, "
        f"{t['ms'] / t['bound_ms']:.2f}x the fp32 bound")
    if not all(v > 0 for v in t["device_split_ms"].values()):
        failures.append(f"wkv6_bwd: a profiled device time of "
                        f"{BWD_KERNEL_NAMES} reads 0: {t['device_split_ms']}")
    del main_ins, ins
    torch.cuda.empty_cache()
    return {
        "name": "wkv6_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/rwkv6_wkv_bwd.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:74 (the gradient "
                    "of wkv6_bhtn; the TPU kernel has none, JAX "
                    "differentiates its jnp wkv_chunked)",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        **t,
        "cases": results,
    }


def ssd_bwd_kernel_phase(failures):
    """Phase 3, K5's backward (``ssd_bwd``) against ``ssd_bwd_plain``:
    zamba2's training shape (zero h0, no state cotangent, as training calls
    it) also against autograd of the plain forward, an unaligned T with a
    nonzero h0 and dhT, P=32 N=16, strong decay, Bm rows 66 floats apart,
    H=6 (a partial head group) and one chunk; timed at the training shape
    against the fp32 and the tensor-core bound."""
    import torch
    from repro_torch.analysis.roofline import tc_bound
    from repro_torch.kernels.mamba2_ssd import (ssd_bwd, ssd_bwd_plain,
                                                ssd_plain)
    from repro_torch.kernels.mamba2_ssd.ops import (BWD_KERNEL_NAMES,
                                                    HEAD_GROUP, ssd_bwd_cost)

    def inputs(B, T, H, P, N, *, h0_scale=0.3, dhT=True, seed=0,
               a_shift=0.0):
        ins = ssd_inputs(B, T, H, P, N, h0_scale=h0_scale, seed=seed)
        ins[2] = ins[2] * math.exp(a_shift)
        return ins + cotangents(seed, (B, T, H, P),
                                (B, H, P, N) if dhT else None)

    def case(name, ins):
        return bwd_case(failures, "ssd_bwd", name, ssd_bwd, ssd_bwd_plain,
                        ins, SSD_GRADS)

    B, T, H, P, N = ZAMBA2_TRAIN
    main_ins = inputs(B, T, H, P, N, h0_scale=0.0, dhT=False)
    results = [case(f"zamba2 training B={B} T={T} H={H} P={P} N={N}, h0 = "
                    f"0, no dhT", main_ins)]
    results.append(identity_check(failures, "ssd_bwd", ssd_plain,
                                  ssd_bwd_plain, main_ins, SSD_GRADS))
    results.append(case("T=130, nonzero h0 and dhT",
                        inputs(2, 130, 80, 64, 64, seed=1)))
    results.append(case("P=32 N=16", inputs(2, 100, 8, 32, 16, seed=2)))
    results.append(case("strong decay (A = -exp(normal + 3))",
                        inputs(2, 512, 80, 64, 64, seed=3, a_shift=3.0)))
    ins = inputs(2, 100, 8, 64, 64, seed=4)
    ins[3] = torch.nn.functional.pad(ins[3], (0, 2))[..., :64]
    results.append(case("Bm rows 66 floats apart", ins))
    results.append(case(f"H=6, a head group of 6 of {HEAD_GROUP}",
                        inputs(2, 150, 6, 64, 64, seed=5)))
    results.append(case("one chunk (T=20), H=11", inputs(3, 20, 11, 64, 64,
                                                          seed=6)))
    cost = ssd_bwd_cost(B, T, H, P, N)
    t = time_recurrent_bwd(ssd_bwd, ssd_bwd_plain, main_ins,
                           BWD_KERNEL_NAMES, cost.nbytes, cost.flops,
                           f"B={B} T={T} H={H} P={P} N={N} fp32")
    products, other = cost.products, cost.other
    tc, tc_by = tc_bound(cost.nbytes, products, other)
    t.update(bound_tf32x3_ms=tc, bound_tf32x3_by=tc_by, tc_products=products,
             tc_other=other)
    log_bwd_timed("ssd_bwd", t)
    log(f"[kernels] ssd_bwd tensor-core bound {tc:.4f} ms ({tc_by}: "
        f"{products} operations in products at 495/3 TFLOP/s, {other} "
        f"others at 67); kernel {t['ms'] / tc:.2f}x it, "
        f"{t['ms'] / t['bound_ms']:.2f}x the fp32 bound")
    if not all(v > 0 for v in t["device_split_ms"].values()):
        failures.append(f"ssd_bwd: a profiled device time of "
                        f"{BWD_KERNEL_NAMES} reads 0: {t['device_split_ms']}")
    del main_ins, ins
    torch.cuda.empty_cache()
    return {
        "name": "ssd_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/mamba2_ssd/csrc/mamba2_ssd_bwd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd/kernel.py:73 (the gradient "
                    "of ssd_bhtp; the TPU kernel has none, JAX "
                    "differentiates its jnp ssd_chunked)",
        "launches": None,
        "max_abs_err": results[0]["max_abs_err"],
        **t,
        "cases": results,
    }

# --- phase 4: main path --------------------------------------------------------


class Client:
    def __init__(self, host, port):
        self.host, self.port = host, port

    def call(self, method, path, body=None):
        status, payload, _ = self.call_id(method, path, body)
        return status, payload

    def call_id(self, method, path, body=None):
        """(status, JSON body, the response's X-Request-Id or None)."""
        conn = http.client.HTTPConnection(self.host, self.port, timeout=600)
        try:
            data = json.dumps(body).encode() if body is not None else None
            conn.request(method, path, body=data)
            resp = conn.getresponse()
            return (resp.status, json.loads(resp.read() or b"{}"),
                    resp.getheader("X-Request-Id"))
        finally:
            conn.close()


def check_schema(status, body, n, kind, members=MEMBERS):
    if status != 200:
        raise AssertionError(f"{kind}: HTTP {status}: {body}")
    for i in range(members):
        vals = body[f"model_{i}"]
        if len(vals) != n:
            raise AssertionError(f"{kind}: model_{i} has {len(vals)} rows, "
                                 f"expected {n}")
        want = bool if kind == "detect" else str
        if not all(isinstance(x, want) for x in vals):
            raise AssertionError(f"{kind}: model_{i} values not {want}")
    if len(body["ensemble"]) != n or "policy" not in body:
        raise AssertionError(f"{kind}: bad ensemble/policy: {body}")


def main_path_phase(failures, kernels, profile_dir):
    import numpy as np
    import torch
    from repro_torch.launch.serve import build_app
    from repro_torch.serving import FlexServeServer

    t0 = time.perf_counter()
    # the generate plane (phase 6b) runs over member 0's params
    app = build_app([ARCH] * MEMBERS, full=True, num_classes=NUM_CLASSES,
                    max_batch=8, seed=0, max_len=GEN_MAX_LEN,
                    num_slots=SCHED_SLOTS)
    torch.cuda.synchronize()
    cfg = app.registry.get(f"{ARCH}#0").model.config
    layers = cfg.num_layers
    log(f"[main] build_app({[ARCH] * MEMBERS}, full=True): "
        f"{layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads / "
        f"{cfg.num_kv_heads} kv, head_dim {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; no depth cut; "
        f"{time.perf_counter() - t0:.1f}s; device memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    ledger = app.ensemble.memory_ledger()
    log("[main] " + ledger.report().replace("\n", "\n[main] "))

    server = FlexServeServer(app).start()
    client = Client(*server.address)
    try:
        requests, launches = drive_ensemble(
            failures, client, cfg.vocab_size, layers, "main",
            block=block_per_forward(layers))
        kernels[0]["launches"] = launches
        for name in ("/health", "/healthz", "/v1/models"):
            st, body = client.call("GET", name)
            if st != 200:
                failures.append(f"GET {name}: {st} {body}")
    finally:
        stop_listener(server)

    # one batch's member logits: kernel path vs plain path, on the card
    ens = app.ensemble
    check_member_logits(failures, ens, requests[1][1], "main")
    timed = {"tokens": np.asarray(requests[2][1], np.int32)}
    fwd_ms = host_time_ms(lambda: ens.forward(timed))
    with plain_kernels():
        fwd_plain_ms = host_time_ms(lambda: ens.forward(timed))
    log(f"[main] one ensemble forward (2 members, B=8, S=256): kernel path "
        f"{fwd_ms:.2f} ms, plain attention path {fwd_plain_ms:.2f} ms "
        f"(host clock around a synchronised forward, median of 5)")
    kernels[0]["ensemble_forward_ms"] = fwd_ms
    kernels[0]["ensemble_forward_plain_ms"] = fwd_plain_ms
    if profile_dir:
        profile_forward(ens, timed, Path(profile_dir))
    return app


def drive_ensemble(failures, client, vocab, layers, tag, members=MEMBERS,
                   block=None):
    """/v1/infer and /v1/detect at 1, 3 and 8 rows, some concurrent, on an
    ensemble of ``members`` members (two yi-9b by default): every response
    200 with the paper schema, K1 members x layers x coalesced forwards
    (``layers`` counts the layers whose attention is K1's: 0 for MLA) and
    every other kernel 0 (counts zeroed just before, read just after), and
    the trace index lists every request by its X-Request-Id.  ``block``,
    where given, is the fused block kernels' launches in one member's
    forward ({wrapper: count}): each must launch members x forwards times
    that (every bf16 norm, rope and silu * up took its kernel).  Returns
    (requests, K1 launches)."""
    import numpy as np
    rng = np.random.default_rng(0)

    def toks(n, s):
        return rng.integers(0, vocab, (n, s)).tolist()

    requests = [("infer", toks(1, 32)), ("infer", toks(3, 64)),
                ("infer", toks(8, 256)), ("detect", toks(3, 64)),
                ("detect", toks(8, 256))]
    concurrent_reqs = [("infer", toks(1, 64)) for _ in range(4)] + \
        [("detect", toks(1, 64)) for _ in range(2)]

    def send(kind, tokens):
        body = {"inputs": {"tokens": tokens}}
        if kind == "detect":
            body.update(positive_class=1, threshold=0.05, policy="or")
        t = time.perf_counter()
        status, resp, rid = client.call_id("POST", f"/v1/{kind}", body)
        return kind, len(tokens), status, resp, time.perf_counter() - t, rid

    # warm: the first forward per shape grows the allocator
    status, body = client.call("POST", "/v1/infer",
                               {"inputs": {"tokens": toks(8, 256)}})
    check_schema(status, body, 8, "infer", members)
    status, m0 = client.call("GET", "/metrics")
    batches0 = m0["coalesce"]["batches_formed"]
    counts_reset()                          # the ensemble path's run
    for fn in block_fns().values():
        fn.launches = 0
    results = [send(kind, t) for kind, t in requests]
    with concurrent.futures.ThreadPoolExecutor(len(concurrent_reqs)) as ex:
        futs = [ex.submit(send, kind, t) for kind, t in concurrent_reqs]
        results += [f.result() for f in futs]
    counts = counts_read()
    block_counts = {k: fn.launches for k, fn in block_fns().items()}
    status, m1 = client.call("GET", "/metrics")
    forwards = m1["coalesce"]["batches_formed"] - batches0
    for kind, n, st, resp, dt, _ in results:
        check_schema(st, resp, n, kind, members)
        log(f"[{tag}] POST /v1/{kind} rows={n}: {st} in "
            f"{1e3 * dt:.1f} ms -> {json.dumps(resp)[:120]}")
    launches = counts["flash_attention"]
    expected = members * layers * forwards
    log(f"[{tag}] {len(results)} requests, {forwards} coalesced "
        f"forwards; flash_attention launches {launches} (expected "
        f"members x layers x forwards = {expected})")
    if launches != expected or forwards == 0:
        failures.append(f"{tag}: flash_attention launches {launches} != "
                        f"{expected}")
    other = sum(v for k, v in counts.items() if k != "flash_attention")
    if other:
        failures.append(f"{tag}: {counts} on the ensemble path (only K1 "
                        f"runs there)")
    if block is not None:
        want = {k: members * forwards * n for k, n in block.items()}
        log(f"[{tag}] fused block launches {block_counts} (expected "
            f"members x forwards x per member forward = {want})")
        if block_counts != want:
            failures.append(f"{tag}: fused block launches {block_counts} != "
                            f"{want}")
    # the flight recorder lists every request of the run
    st, idx = client.call("GET", f"/v1/traces?limit={4 * len(results)}")
    listed = {r["trace_id"]: r for r in idx.get("recent", [])}
    ids = [rid for *_, rid in results]
    missing = [rid for rid in ids if rid is None or rid not in listed]
    ok = (st == 200 and not missing and all(
        listed[rid]["status"] == 200 and listed[rid]["plane"] == kind
        for (kind, *_, rid) in results))
    log(f"[{tag}] GET /v1/traces: {st}, lists {len(ids) - len(missing)} of "
        f"the run's {len(ids)} requests by X-Request-Id "
        f"({'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append(f"{tag}: /v1/traces {st} misses {missing}")
    return requests, launches


def check_member_logits(failures, ens, tokens, tag):
    """One batch's member logits: kernel path vs plain path, on the card,
    within LOGITS_TOL."""
    import numpy as np
    import torch
    batch = {"tokens": np.asarray(tokens, np.int32)}
    kern = ens.forward(batch)
    with plain_kernels():
        plain = ens.forward(batch)
    for name in kern:
        a, b = kern[name].float(), plain[name].float()
        err = float((a - b).abs().max())
        ok = (tuple(a.shape) == (len(tokens), NUM_CLASSES)
              and bool(torch.isfinite(a).all())
              and torch.allclose(a, b, **LOGITS_TOL))
        log(f"[{tag}] member {name} logits {tuple(a.shape)} vs plain path: "
            f"max_abs_err {err:.3e}, max |logit| {float(b.abs().max()):.3f} "
            f"({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"{tag}: member {name} logits vs plain: err "
                            f"{err}")


def stop_listener(server) -> None:
    """Close a server's socket but not its app: the app (and its generate
    plane) serves again behind a new ``FlexServeServer`` later on."""
    server.httpd.shutdown()
    server.httpd.server_close()


def host_time_ms(fn, reps: int = 5) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return sorted(times)[len(times) // 2]


def profile_forward(ens, batch, out_dir: Path) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    out_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ens.forward(batch)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=30)
    (out_dir / "ensemble_forward_profile.txt").write_text(table)
    log("[profile] " + table.replace("\n", "\n[profile] "))


# --- phase 4b: the fused block kernels -----------------------------------------

BLOCK_KERNELS = ("rms_norm_kernel", "rope_qk_kernel", "silu_mul_kernel")
# the eager chains' kernels, as the benchmark's traced breakdowns name them
EAGER_ELEMENTWISE = ("elementwise_kernel", "reduce_kernel",
                     "CatArrayBatchedCopy")
GEMM_KERNELS = ("nvjet", "gemm", "cutlass", "sm90_xmma")
# (arch, B, S): the two closed-loop cells' forwards and a decode tick each
BLOCK_SHAPES = (("yi-9b", 16, 512), ("h2o-danube-1.8b", 4, 8192),
                ("yi-9b", 16, 1), ("h2o-danube-1.8b", 16, 1))
HBM_BYTES_PER_S = 3.35e12


def block_fns():
    from repro_torch.kernels.fused_block import rms_norm, rope_qk, silu_mul
    return {"rms_norm": rms_norm, "rope_qk": rope_qk, "silu_mul": silu_mul}


def block_per_forward(layers: int) -> dict:
    """The fused block kernels' launches in one dense member's forward:
    ln1, ln2 (with the residual add) and the final norm; one rope and one
    silu * up a layer."""
    return {"rms_norm": 2 * layers + 1, "rope_qk": layers,
            "silu_mul": layers}


def bf16_ulps(a, b) -> float:
    """The largest distance between a and b in units of b's last bf16
    place."""
    import torch
    a, b = a.float(), b.float()
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(1e-30))) - 7)
    return float(((a - b).abs() / ulp).max())


def block_inputs(arch, B, S, seed=0):
    """bf16 activations at ``arch``'s widths (norm scales 1 + N(0, 0.1^2),
    as the benchmark draws them); positions from 0, or a tick's ragged
    lengths (B, 1) int32 as the decode path passes them."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.layers import _rope_freqs_on
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device="cuda")
                ).to(torch.bfloat16)
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if S == 1:
        pos = torch.randint(0, 4096, (B, 1), generator=gen, device="cuda",
                            dtype=torch.int32)
    else:
        pos = torch.arange(S, device="cuda")[None]
    return dict(cfg=cfg, x=rnd(B, S, D), res=rnd(B, S, D, scale=0.5),
                scale=1 + 0.1 * torch.randn(D, generator=gen,
                                            device="cuda"),
                q=rnd(B, S, H, hd), k=rnd(B, S, K, hd), pos=pos,
                freqs=_rope_freqs_on(hd, cfg.rope_theta,
                                     torch.device("cuda")),
                gate=rnd(B, S, cfg.d_ff, scale=3.0), up=rnd(B, S, cfg.d_ff))


def block_kernel_phase(failures) -> dict:
    """Phase 4b, kernels: each fused block kernel against its eager chain
    at BLOCK_SHAPES (the residual stream and RoPE and silu * up bit for
    bit, the norm within one bf16 ulp), then timed: CUDA events and
    device time a call beside the eager chain's and the bytes-once bound
    at 3.35 TB/s, the norm also beside ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fused_block import (ops, rms_norm_plain,
                                                 rope_qk_plain,
                                                 silu_mul_plain)
    fns = block_fns()
    out = {}
    for arch, B, S in BLOCK_SHAPES:
        c = block_inputs(arch, B, S)
        cfg, eps = c["cfg"], c["cfg"].norm_eps
        x, res, scale = c["x"], c["res"], c["scale"]
        q, k, pos, freqs = c["q"], c["k"], c["pos"], c["freqs"]
        gate, up = c["gate"], c["up"]
        name = f"{arch} B={B} S={S}"
        before = {n: f.launches for n, f in fns.items()}
        with torch.no_grad():
            got_x, got_y = fns["rms_norm"](x, scale, eps, residual=res)
            want_x, want_y = rms_norm_plain(x, scale, eps, residual=res)
            got_plain = fns["rms_norm"](x, scale, eps)
            want_plain = rms_norm_plain(x, scale, eps)
            got_q, got_k = fns["rope_qk"](q.clone(), k.clone(), pos, freqs)
            want_q, want_k = rope_qk_plain(q, k, pos, freqs)
            got_h = fns["silu_mul"](gate, up)
            want_h = silu_mul_plain(gate, up)
        torch.cuda.synchronize()
        launched = {n: f.launches - before[n] for n, f in fns.items()}
        err = {
            "residual_mismatches": int((got_x != want_x).sum()),
            "norm_ulps": max(bf16_ulps(got_y, want_y),
                             bf16_ulps(got_plain, want_plain)),
            "norm_mismatch_share": float((got_y != want_y).float().mean()),
            "rope_mismatches": int((got_q != want_q).sum()
                                   + (got_k != want_k).sum()),
            "rope_max_abs": float(max((got_q.float() - want_q.float()).abs()
                                      .max(), (got_k.float()
                                               - want_k.float()).abs().max())),
            "silu_mul_mismatches": int((got_h != want_h).sum()),
            "silu_mul_max_abs": float((got_h.float() - want_h.float()).abs()
                                      .max())}
        ok = (err["residual_mismatches"] == 0 and err["norm_ulps"] <= 1.0
              and err["rope_mismatches"] == 0
              and err["silu_mul_mismatches"] == 0
              and launched == {"rms_norm": 2, "rope_qk": 1, "silu_mul": 1})
        log(f"[block] {name}: {json.dumps(err)} launches {launched} "
            f"({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"fused block {name}: {err} {launched}")
        rows = B * S
        cases = {
            "rms_norm+residual": (
                lambda: fns["rms_norm"](x, scale, eps, residual=res),
                lambda: rms_norm_plain(x, scale, eps, residual=res),
                ops.rms_norm_cost(rows, cfg.d_model, True)),
            "rms_norm": (
                lambda: fns["rms_norm"](x, scale, eps),
                lambda: rms_norm_plain(x, scale, eps),
                ops.rms_norm_cost(rows, cfg.d_model, False)),
            "rope_qk": (
                lambda: fns["rope_qk"](q, k, pos, freqs),
                lambda: rope_qk_plain(q, k, pos, freqs),
                ops.rope_qk_cost(B, S, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.head_dim, pos.numel(),
                                 pos.element_size())),
            "silu_mul": (
                lambda: fns["silu_mul"](gate, up),
                lambda: silu_mul_plain(gate, up),
                ops.silu_mul_cost(gate.numel()))}
        timed = {}
        with torch.no_grad():
            for op, (kern, eager, cost) in cases.items():
                bound = 1e3 * cost.nbytes / HBM_BYTES_PER_S
                t = {"event_ms": cuda_time_ms(kern),
                     "device_ms": profiled_ms(kern, BLOCK_KERNELS),
                     "eager_event_ms": cuda_time_ms(eager),
                     "eager_device_ms": profiled_ms(eager, ()),
                     "bound_ms": bound, "bytes": cost.nbytes}
                t["roofline_pct"] = 100 * bound / t["device_ms"]
                lib = ""
                if op == "rms_norm" and hasattr(F, "rms_norm"):
                    w = scale.to(x.dtype)   # torch's kernel takes x's dtype

                    def library():
                        return F.rms_norm(x, (cfg.d_model,), w, eps)
                    t["library_event_ms"] = cuda_time_ms(library)
                    t["library_device_ms"] = profiled_ms(library, ())
                    lib = (f"; F.rms_norm event {t['library_event_ms']:.4f}, "
                           f"device {t['library_device_ms']:.4f} ms")
                timed[op] = t
                log(f"[block] {name} {op}: kernel event "
                    f"{t['event_ms']:.4f} ms, device {t['device_ms']:.4f} "
                    f"ms; eager chain event {t['eager_event_ms']:.4f}, "
                    f"device {t['eager_device_ms']:.4f} ms{lib}; bound "
                    f"{bound:.4f} ms ({cost.nbytes / 1e6:.1f} MB once at "
                    f"3.35 TB/s): {t['roofline_pct']:.1f}% of it")
        out[name] = {"errors": err, "timed": timed}
        del c, x, res, q, k, gate, up, got_x, got_y, want_x, want_y
        torch.cuda.empty_cache()
    return out


def block_forward_phase(failures, ens, layers, members=MEMBERS) -> dict:
    """Phase 4b, one forward of the ensemble's members at yi9b-pair.bulk's
    shape, B=16 and S=512 (past the app's largest bucket, so the members
    are called as the batcher calls them, under inference_mode): the
    fused block kernels' launches (``block_per_forward`` a member), the
    device time of the eager elementwise kernels (EAGER_ELEMENTWISE), the
    fused ones, the GEMMs and K1 from torch.profiler with the kernels and
    with the eager chains (``eager_block``, K1 kept), the host clock of
    each, and the member logits of the two within LOGITS_TOL."""
    import numpy as np
    import torch
    B, S = 16, 512
    vocab = ens.members[0].params["embed"].shape[0]
    tokens = np.random.default_rng(1).integers(0, vocab, (B, S))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int32)).cuda()}

    def forward():
        with torch.inference_mode():
            return {m.name: m.apply(m.params, batch) for m in ens.members}
    fns = block_fns()
    forward()
    torch.cuda.synchronize()
    for fn in fns.values():
        fn.launches = 0
    kern = forward()
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in fns.items()}
    want = {k: members * n for k, n in block_per_forward(layers).items()}
    log(f"[block] one ensemble forward (B={B}, S={S}): launches {counts} "
        f"(expected {want})")
    if counts != want:
        failures.append(f"fused block forward launches {counts} != {want}")
    groups = {"elementwise": EAGER_ELEMENTWISE, "fused": BLOCK_KERNELS,
              "gemm": GEMM_KERNELS, "k1": K1_KERNELS, "all": ()}
    res = {}
    for side in ("fused", "eager", "eager", "fused"):    # in turns
        ctx = eager_block() if side == "eager" else nullcontext()
        with ctx:
            ms = profiled_groups_ms(forward, groups, iters=3)
            ms["host_ms"] = host_time_ms(forward)
        for g, v in ms.items():
            res.setdefault(side, {}).setdefault(g, []).append(v)
    for side, groups_ms in res.items():
        log(f"[block] forward, {side} chains: " + ", ".join(
            f"{g} {' / '.join(f'{v:.2f}' for v in vals)} ms"
            for g, vals in groups_ms.items())
            + " (device time a forward by kernel group; host clock around "
              "a synchronised forward)")
    with eager_block():
        eager = forward()
    for name in kern:
        a, b = kern[name].float(), eager[name].float()
        err = float((a - b).abs().max())
        ok = torch.allclose(a, b, **LOGITS_TOL)
        log(f"[block] member {name} logits, fused vs eager chains: max_abs_err "
            f"{err:.3e} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"fused block: member {name} logits vs eager: "
                            f"{err}")
    return {"launches": counts, "forward_ms": res}


# --- phase 5: generate path ----------------------------------------------------

GEN_MAX_LEN = 1024
GEN_BATCH = 8
GEN_TOKENS = 32
GEN_PROMPT_MAX = 300    # phase 5's prompts are 17-300 tokens long
FORCED_STEPS = 8


def first_divergence(a, b):
    """(row, position) of the first differing token of two streams."""
    for i, (x, y) in enumerate(zip(a, b)):
        for j, (s, t) in enumerate(zip(x, y)):
            if s != t:
                return i, j
    return None


def teacher_forced(engine, batch, teacher, steps=FORCED_STEPS):
    """Prefill logits, then ``steps`` decode steps fed ``teacher``."""
    logits, state = engine.prefill(batch, engine.new_state(GEN_BATCH))
    outs = [logits.float()]
    for t in range(steps):
        logits, state = engine.decode(teacher[:, t], state)
        outs.append(logits.float())
    return outs


def engine_peaks(engine, batch):
    """Phase 14 B's yi-9b pair: the growth of
    ``torch.cuda.max_memory_allocated()`` over what was resident (params,
    a new state and the batch) during one prefill, then during one tick
    on its state."""
    import torch
    out = {"bucket": int(batch["tokens"].shape[1])}
    state = engine.new_state(GEN_BATCH)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, state = engine.prefill(batch, state)
    torch.cuda.synchronize()
    out["prefill"] = torch.cuda.max_memory_allocated() - before
    token = logits.argmax(-1).to(torch.int32)
    del logits
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, state = engine.decode(token, state)
    torch.cuda.synchronize()
    out["tick"] = torch.cuda.max_memory_allocated() - before
    del logits, state, token
    log(f"[fits] yi-9b engine (B={GEN_BATCH}, prompt bucket "
        f"{out['bucket']}, max_len {GEN_MAX_LEN}): peak growth over the "
        f"resident params, state and batch: prefill {out['prefill']} bytes, "
        f"tick {out['tick']} bytes")
    return out


def generate_phase(failures, kernels, app, profile_dir, fits):
    import numpy as np
    import torch
    from repro_torch.core import InferenceEngine, SamplingParams, rng
    from repro_torch.core.batching import pad_sequences
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      paged_decode_attention)
    from repro_torch.kernels.flash_attention import flash_attention

    member = app.registry.get(f"{ARCH}#0")        # no second copy of weights
    cfg = member.model.config
    layers = cfg.num_layers
    engine = InferenceEngine(member.model, member.params,
                             max_len=GEN_MAX_LEN, max_batch=GEN_BATCH)
    r = np.random.default_rng(0)
    lens = r.integers(17, GEN_PROMPT_MAX + 1, GEN_BATCH)
    lens[0], lens[-1] = 17, GEN_PROMPT_MAX
    prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    log(f"[generate] InferenceEngine(yi-9b#0: {layers} layers, "
        f"d_model {cfg.d_model}, {cfg.dtype}; max_len {GEN_MAX_LEN}, "
        f"max_batch {GEN_BATCH}); prompts of {sorted(lens.tolist())} tokens")
    engine.generate(prompts, max_new_tokens=2)      # warm the allocator
    torch.cuda.synchronize()

    # the generate path's counted run
    engine.prefill_calls = engine.decode_calls = 0
    flash_attention.launches = 0
    decode_attention.launches = 0
    paged_decode_attention.launches = 0
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=GEN_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fa_n, da_n = flash_attention.launches, decode_attention.launches
    if paged_decode_attention.launches:
        failures.append(f"paged_decode_attention launched "
                        f"{paged_decode_attention.launches} times in the "
                        f"dense generate run")
    pre_n, dec_n = engine.prefill_calls, engine.decode_calls
    log(f"[generate] greedy generate: {res.steps} steps in {1e3 * wall:.1f} "
        f"ms; prefill_calls {pre_n}, decode_calls {dec_n}; flash_attention "
        f"launches {fa_n} (expected {layers} x {pre_n}), decode_attention "
        f"launches {da_n} (expected {layers} x {dec_n})")
    good = (len(res.tokens) == GEN_BATCH
            and all(len(t) == GEN_TOKENS for t in res.tokens)
            and all(0 <= x < cfg.vocab_size for t in res.tokens for x in t)
            and res.finish_reasons == ["length"] * GEN_BATCH
            and res.steps == GEN_TOKENS)
    if not good:
        failures.append(f"greedy generate output malformed: steps "
                        f"{res.steps}, reasons {res.finish_reasons}")
    if fa_n != layers * pre_n or pre_n != 1:
        failures.append(f"flash_attention launches {fa_n} != {layers} x "
                        f"{pre_n} prefill calls")
    if da_n != layers * dec_n or dec_n != res.steps - 1 or da_n == 0:
        failures.append(f"decode_attention launches {da_n} != {layers} x "
                        f"{dec_n} decode calls (steps {res.steps})")
    kernels[0]["launches_generate"] = fa_n
    kernels[1]["launches"] = da_n
    kernels[1]["launches_per_tick"] = da_n // max(dec_n, 1)

    # prefill ms and decode ms per tick (host clock, synchronised)
    tokens, lengths = pad_sequences(prompts, engine.seq_buckets)
    dev = engine.device
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "lengths": torch.from_numpy(lengths).to(dev)}
    fits["yi-9b"] = engine_peaks(engine, batch)
    prefill_ms = host_time_ms(
        lambda: engine.prefill(batch, engine.new_state(GEN_BATCH)))
    samp_greedy = {"temperature": torch.zeros(GEN_BATCH, device=dev),
                   "top_k": torch.zeros(GEN_BATCH, dtype=torch.int32,
                                        device=dev),
                   "top_p": torch.ones(GEN_BATCH, device=dev),
                   "key": torch.zeros((GEN_BATCH, 2), dtype=torch.int64,
                                      device=dev),
                   "regime": "greedy"}
    logits, state = engine.prefill(batch, engine.new_state(GEN_BATCH))
    ctr = torch.zeros(GEN_BATCH, dtype=torch.int32, device=dev)
    tok = engine.sample(logits, samp_greedy, ctr)
    ticks = []
    for _ in range(16):
        t = time.perf_counter()
        tok, state, ctr = engine.decode_sample(tok, state, samp_greedy, ctr)
        tok.cpu()                                  # the loop's one transfer
        ticks.append(1e3 * (time.perf_counter() - t))
    tick_ms = sorted(ticks)[len(ticks) // 2]
    tick_share = None
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tok, state, ctr = engine.decode_sample(tok, state, samp_greedy,
                                                   ctr)
            torch.cuda.synchronize()
        total, k2 = device_ms(prof, ()), device_ms(prof, K2_KERNELS)
        tick_share = {"tick_device_ms": total, "decode_attention_ms": k2,
                      "share": k2 / total if total else None}
        out_dir = Path(profile_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=30)
        (out_dir / "decode_tick_profile.txt").write_text(table)
        log("[profile] " + table.replace("\n", "\n[profile] "))
        log(f"[profile] one decode tick: device time {total:.3f} ms, "
            f"decode_attention {k2:.3f} ms ({100 * k2 / total:.1f}%)")
    del state
    gen = {"generate_wall_ms": 1e3 * wall, "prefill_ms": prefill_ms,
           "decode_tick_ms": tick_ms,
           "decode_tokens_per_s": GEN_BATCH * 1e3 / tick_ms,
           "generate_tokens_per_s": GEN_BATCH * GEN_TOKENS / wall,
           "tick_profile": tick_share}
    kernels[1]["generate"] = gen
    log(f"[generate] B={GEN_BATCH}, prompt bucket {tokens.shape[1]}: "
        f"prefill {prefill_ms:.2f} ms (median of 5); decode tick "
        f"{tick_ms:.2f} ms (host clock median of 16, sampling and the ids' "
        f"transfer included) = {gen['decode_tokens_per_s']:.1f} tokens/s; "
        f"generate of {GEN_TOKENS} tokens {gen['generate_tokens_per_s']:.1f} "
        f"tokens/s end to end")

    # teacher-forced logits: kernels vs their plain versions
    teacher = torch.tensor(res.tokens, dtype=torch.int32, device=dev)
    kern_logits = teacher_forced(engine, batch, teacher)
    with plain_kernels():
        plain_logits = teacher_forced(engine, batch, teacher)
        plain_res = engine.generate(prompts, max_new_tokens=GEN_TOKENS)
    errs = []
    for step, (a, b) in enumerate(zip(kern_logits, plain_logits)):
        err = float((a - b).abs().max())
        errs.append(err)
        ok = (bool(torch.isfinite(a).all())
              and tuple(a.shape) == (GEN_BATCH, cfg.vocab_size)
              and torch.allclose(a, b, **LOGITS_TOL))
        if not ok:
            failures.append(f"teacher-forced logits step {step} vs plain: "
                            f"err {err}")
    log(f"[generate] teacher-forced logits, kernels vs plain versions, "
        f"prefill + {FORCED_STEPS} decode steps: max_abs_err per step "
        f"{[f'{e:.3e}' for e in errs]}, max |logit| "
        f"{float(plain_logits[-1].abs().max()):.3f}")
    div = first_divergence(res.tokens, plain_res.tokens)
    log(f"[generate] greedy streams, kernels vs plain versions: "
        + ("identical" if div is None else
           f"first differ at row {div[0]}, token {div[1]} (near-ties under "
           f"random weights can flip; reported, not checked)"))
    gen["teacher_forced_max_abs_err"] = errs
    gen["greedy_first_divergence"] = div

    # seeded sampled streams repeat token for token
    sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=7,
                        max_new_tokens=GEN_TOKENS)
    s1 = engine.generate(prompts, sampling=sp)
    s2 = engine.generate(prompts, sampling=sp)
    same = s1.tokens == s2.tokens
    log(f"[generate] seeded sampled run (temperature 0.8, top_k 50, top_p "
        f"0.9, seed 7) twice: {'identical' if same else 'DIFFERENT'}; row 0 "
        f"{s1.tokens[0][:12]}...")
    if not same or any(len(t) != GEN_TOKENS for t in s1.tokens):
        failures.append("seeded sampled generate did not repeat")

    # the rng's bits on the card equal its bits on the CPU
    keys = np.stack([rng.base_key(s) for s in (0, 7, 12345, 2 ** 31 - 1)])
    ctrs = np.array([0, 1, 31, 1000], np.int32)
    on_card = rng.bits(rng.fold_in(rng.as_key(keys, dev),
                                   torch.from_numpy(ctrs).to(dev)),
                       cfg.vocab_size).cpu()
    on_cpu = rng.bits(rng.fold_in(rng.as_key(keys),
                                  torch.from_numpy(ctrs)), cfg.vocab_size)
    bits_ok = torch.equal(on_card, on_cpu)
    log(f"[generate] rng bits, card vs CPU, 4 keys x {cfg.vocab_size}: "
        f"{'equal' if bits_ok else 'DIFFERENT'}")
    if not bits_ok:
        failures.append("rng bits differ between the card and the CPU")


# --- phase 6: scheduler path ---------------------------------------------------

SCHED_SLOTS = 8
SCHED_REQUESTS = 12
PREFIX_TOKENS = 64


def sched_workload(vocab, seed):
    """12 requests: prompts of 17-300 tokens, 32 new tokens, greedy rows
    mixed with seeded sampled rows (temperature 0.8, top_k 50, top_p 0.9)."""
    import numpy as np
    from repro_torch.core import SamplingParams
    r = np.random.default_rng(seed)
    lens = r.integers(17, 301, SCHED_REQUESTS)
    lens[0], lens[-1] = 17, 300
    work = []
    for i, n in enumerate(lens):
        extra = ({} if i % 2 == 0 else
                 dict(temperature=0.8, top_k=50, top_p=0.9, seed=100 + i))
        work.append((r.integers(0, vocab, n).tolist(),
                     SamplingParams(max_new_tokens=GEN_TOKENS, **extra)))
    return work


K_NAMES = ("flash_attention", "decode_attention", "paged_decode_attention",
           "wkv6", "ssd", "flash_attention_bwd", "wkv6_bwd", "ssd_bwd")


def kernel_fns():
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      paged_decode_attention)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.mamba2_ssd import ssd, ssd_bwd
    from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_bwd
    return dict(zip(K_NAMES, (flash_attention, decode_attention,
                              paged_decode_attention, wkv6, ssd,
                              flash_attention_bwd, wkv6_bwd, ssd_bwd)))


def counts_reset():
    for fn in kernel_fns().values():
        fn.launches = 0


def counts_read():
    """Every kernel's launch count, after the device has finished."""
    import torch
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in kernel_fns().items()}


def remat_plain_attention(*args, **kw):
    """K1's plain version, recomputed in backward where autograd records
    it: its (B, H, S, Skv) fp32 scores would otherwise stay alive for every
    attention call that no remat covers (zamba2's shared block: 9 x about
    6 GB at B=4, S=2048).  The gradients are the same."""
    import torch
    from torch.utils.checkpoint import checkpoint
    from repro_torch.kernels.flash_attention import flash_attention_plain
    if not torch.is_grad_enabled():
        return flash_attention_plain(*args, **kw)
    return checkpoint(flash_attention_plain, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def block_swaps():
    """The fused block kernels' wrappers in ``models/layers.py`` against
    their plain versions (the eager chains)."""
    from repro_torch.kernels.fused_block import (rms_norm_plain,
                                                 rope_qk_plain,
                                                 silu_mul_plain)
    from repro_torch.models import layers
    return [(layers, "rms_norm", rms_norm_plain),
            (layers, "rope_qk", rope_qk_plain),
            (layers, "silu_mul", silu_mul_plain)]


class plain_kernels:
    """Swap K1, K2, K4, K5 and the fused block kernels for their plain
    versions in the model modules for the duration of a ``with`` block
    (the comparison runs; there is deliberately no flag for this in the
    port)."""

    def swaps(self):
        from repro_torch.kernels.decode_attention import decode_attention_plain
        from repro_torch.kernels.mamba2_ssd import ssd_plain
        from repro_torch.kernels.rwkv6_wkv import wkv6_plain
        from repro_torch.models import attention, mamba2, rwkv6
        return [(attention, "flash_attention", remat_plain_attention),
                (attention, "decode_attention", decode_attention_plain),
                (rwkv6, "wkv6", wkv6_plain), (mamba2, "ssd", ssd_plain),
                *block_swaps()]

    def __enter__(self):
        swaps = self.swaps()
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in swaps]
        for m, n, plain in swaps:
            setattr(m, n, plain)

    def __exit__(self, *exc):
        for m, n, orig in self.saved:
            setattr(m, n, orig)


class eager_block(plain_kernels):
    """Only the fused block kernels swapped for the eager chains (K1 and
    the rest stay): the forward as it ran before those kernels."""

    def swaps(self):
        return block_swaps()


def drive_service(svc, work, extras=None):
    """Submit every request (a sink per request, as ``submit_request``
    does; ``extras``, where given, one dict per request) and wait for all;
    returns (requests, wall seconds).  The 12 land under the service's
    lock, so the driver's next tick sees all of them and both engines
    admit the same prefill groups (a prefill's matmul shapes, and so its
    bits, depend on the group's batch bucket)."""
    done = [threading.Event() for _ in work]
    extras = extras or [None] * len(work)
    t0 = time.perf_counter()
    with svc._lock:
        reqs = [svc.scheduler.submit(prompt, sampling=sp, extras=ex,
                                     sink=lambda r, t, f, ev=ev: ev.set()
                                     if f else None)
                for (prompt, sp), ex, ev in zip(work, extras, done)]
        svc._work.notify()
    for ev in done:
        if not ev.wait(900):
            raise TimeoutError("scheduler request did not finish")
    return reqs, time.perf_counter() - t0


def drive_counted(failures, svc, work, name, layers, warm_s, rnd, *,
                  extras=None, tick_layers=None):
    """One counted run of the 12 requests through ``svc``: the launch
    counts are zeroed just before it and read just after it (K1 ``layers``
    per prefill forward, K2 or K3 ``tick_layers``, default ``layers``, per
    tick).  Returns the run's record and its streams."""
    s = svc.scheduler
    ticks0, fwd0, xfer0 = (s.decode_ticks, s.prefill_forwards,
                           s.decode_transfer_bytes)
    host0, dev0 = len(s.host_ms_window), len(s.device_ms_window)
    pre0 = s.prefill_s_total
    counts_reset()
    reqs, wall = drive_service(svc, work, extras)
    n = counts_read()
    fa_n, k2_n, k3_n = (n[k] for k in K_NAMES[:3])
    ticks = s.decode_ticks - ticks0
    fwds = s.prefill_forwards - fwd0
    ntok = sum(len(r.output) for r in reqs)
    dev = sorted(s.device_ms_window[dev0:])
    host = sorted(s.host_ms_window[host0:])
    ttft = sorted(r.ttft_s for r in reqs)
    pages_hw = (s.pager_stats() or {}).get("pages_used_high_water", 0)
    rec = {"round": rnd, "tokens_per_s": ntok / wall, "wall_s": wall,
           "req_ids": [r.req_id for r in reqs],
           "ticks": ticks, "prefill_forwards": fwds,
           "tick_decode_ms_p50": dev[len(dev) // 2],
           "tick_bookkeeping_ms_p50": host[len(host) // 2],
           "prefill_ms_mean": 1e3 * (s.prefill_s_total - pre0) / max(fwds, 1),
           "ttft_ms_p50": 1e3 * ttft[len(ttft) // 2], "warm_s": warm_s,
           "pages_used_high_water": pages_hw,
           "launches": {"flash_attention": fa_n, "decode_attention": k2_n,
                        "paged_decode_attention": k3_n}}
    log(f"[scheduler] {name} round {rnd}: {SCHED_REQUESTS} requests, {ntok} "
        f"tokens in {wall:.2f} s = {ntok / wall:.1f} tokens/s; {ticks} "
        f"ticks, {fwds} prefill forwards; tick p50: decode call through the "
        f"ids on the host {rec['tick_decode_ms_p50']:.2f} ms + scheduler "
        f"bookkeeping {rec['tick_bookkeeping_ms_p50']:.2f} ms; prefill "
        f"{rec['prefill_ms_mean']:.2f} ms per forward (mean, first tokens "
        f"included); TTFT p50 {rec['ttft_ms_p50']:.1f} ms; warm "
        f"{warm_s:.2f} s; pool pages used at most {pages_hw}; launches K1 "
        f"{fa_n}, K2 {k2_n}, K3 {k3_n}")
    reasons = [r.finish_reason for r in reqs]
    if reasons != ["length"] * SCHED_REQUESTS or any(
            len(r.output) != GEN_TOKENS for r in reqs):
        failures.append(f"scheduler {name}: reasons {reasons}")
    per_tick = layers if tick_layers is None else tick_layers
    want_k2, want_k3 = ((0, per_tick * ticks) if "paged" in name
                        else (per_tick * ticks, 0))
    if (fa_n != layers * fwds or k2_n != want_k2 or k3_n != want_k3
            or ticks == 0):
        failures.append(f"scheduler {name}: launches K1 {fa_n} K2 {k2_n} "
                        f"K3 {k3_n}, expected {layers * fwds}, {want_k2}, "
                        f"{want_k3} ({ticks} ticks, {fwds} forwards)")
    xfer = s.decode_transfer_bytes - xfer0
    if xfer != 4 * SCHED_SLOTS * ticks:
        failures.append(f"scheduler {name}: transfer {xfer} bytes over "
                        f"{ticks} ticks")
    return rec, [r.output for r in reqs]


def profile_scheduler_tick(eng, work, out_dir: Path, name: str):
    """torch.profiler over one decode-only scheduler tick with every slot
    live: the tick's device time and the decode-attention kernels' share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import ContinuousBatchingScheduler
    s = ContinuousBatchingScheduler(eng, num_slots=SCHED_SLOTS)
    for prompt, sp in work[:SCHED_SLOTS]:
        s.submit(prompt, sampling=sp)
    s.step()                                # admits all, first tick
    s.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.step()
        torch.cuda.synchronize()
    total, attn = device_ms(prof, ()), device_ms(prof, K2_KERNELS)
    out_dir.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=30)
    (out_dir / f"scheduler_tick_{name}_profile.txt").write_text(table)
    log(f"[profile] one {name} scheduler tick ({SCHED_SLOTS} live slots): "
        f"device time {total:.3f} ms, decode attention {attn:.3f} ms "
        f"({100 * attn / total:.1f}%), host clock of the tick "
        f"{s.device_ms_window[-1] + s.host_ms_window[-1]:.2f} ms")
    return {"tick_device_ms": total, "decode_attention_ms": attn,
            "share": attn / total if total else None,
            "tick_host_clock_ms": s.device_ms_window[-1]
            + s.host_ms_window[-1]}


def shared_prefix_run(failures, engines, cfg, layers, r, tag):
    """Three greedy requests sharing a PREFIX_TOKENS prefix on one slot,
    through the dense and the paged engine: the followers must reuse the
    leader's 4 pages and 64 tokens each (their prefill takes the C > 0
    plain attention), K3 must launch ``layers`` a paged tick, and each
    follower's first-token logits must equal the dense engine's within
    LOGITS_TOL.  Returns the pager's stats, the streams, the first-token
    logit differences and the streams' first divergence."""
    import torch
    from repro_torch.core import ContinuousBatchingScheduler, SamplingParams
    prefix = r.integers(0, cfg.vocab_size, PREFIX_TOKENS).tolist()
    pwork = [prefix + r.integers(0, cfg.vocab_size, 3 + i).tolist()
             for i in range(3)]
    # each prefill's first-token logits (one request a prefill on one slot)
    streams, firsts, pager = {}, {}, None
    for name, eng in engines.items():
        s = ContinuousBatchingScheduler(eng, num_slots=1)
        method = "paged_prefill" if name == "paged" else "prefill"
        firsts[name] = []

        def recording(*args, _inner=getattr(eng, method),
                      _out=firsts[name]):
            logits, state = _inner(*args)
            _out.append(logits[0].float().cpu())
            return logits, state
        setattr(eng, method, recording)
        try:
            counts_reset()
            reqs = [s.submit(p, sampling=SamplingParams(max_new_tokens=16))
                    for p in pwork]
            s.run()
            n = counts_read()
        finally:
            delattr(eng, method)
        fa_n, k2_n, k3_n = (n[k] for k in K_NAMES[:3])
        streams[name] = [x.output for x in reqs]
        if name == "paged":
            st = s.pager_stats()
            followers = len(pwork) - 1
            log(f"[{tag}] shared {PREFIX_TOKENS}-token prefix, 1 slot: "
                f"prefix_hits {st['prefix_hits']}, prefill_tokens_reused "
                f"{st['prefill_tokens_reused']} (expected "
                f"{4 * followers} and {PREFIX_TOKENS * followers}); "
                f"launches K1 {fa_n} K3 {k3_n} over {s.decode_ticks} ticks")
            if (st["prefix_hits"] != 4 * followers
                    or st["prefill_tokens_reused"] != PREFIX_TOKENS
                    * followers or k3_n != layers * s.decode_ticks
                    or k2_n != 0):
                failures.append(f"{tag} shared prefix: {st}, K2 {k2_n} K3 "
                                f"{k3_n}")
            pager = st
    # the followers' first-token logits: the paged engine's C > 0 prefill
    # (suffix against the shared pages, plain attention) against the dense
    # engine's whole-prompt prefill (K1), at LOGITS_TOL
    diffs = []
    for i in range(len(pwork)):
        d, pg = firsts["dense"][i], firsts["paged"][i]
        diffs.append(float((pg - d).abs().max()))
        ok = bool(torch.isfinite(pg).all()) and torch.allclose(
            pg, d, **LOGITS_TOL)
        log(f"[{tag}] shared prefix, request {i} "
            f"({'leader, C = 0' if i == 0 else 'follower, C > 0'}): "
            f"first-token logits paged vs dense max abs diff {diffs[-1]:.4e} "
            f"(|logit| <= {float(d.abs().max()):.3f}; "
            f"{'ok' if ok else 'FAIL'} at rtol {LOGITS_TOL['rtol']}, atol "
            f"{LOGITS_TOL['atol']}); argmax dense {int(d.argmax())}, paged "
            f"{int(pg.argmax())}")
        if i > 0 and not ok:
            failures.append(f"{tag} shared prefix: follower {i}'s "
                            f"first-token logits differ by {diffs[-1]:.4e}")
    div = first_divergence(streams["dense"], streams["paged"])
    log(f"[{tag}] shared-prefix streams (followers through the C > 0 "
        "plain attention), paged vs dense: "
        + ("identical" if div is None else
           f"first differ at request {div[0]}, token {div[1]} (reported, "
           f"not checked)"))
    return {"pager": pager, "streams": streams, "first_token_diffs": diffs,
            "first_divergence": div}


def scheduler_phase(failures, kernels, app, profile_dir):
    import numpy as np
    import torch
    from repro_torch.core import (ContinuousBatchingScheduler,
                                  InferenceEngine, PagedInferenceEngine,
                                  SamplingParams, SchedulerService)

    member = app.registry.get(f"{ARCH}#0")        # no second copy of weights
    cfg = member.model.config
    layers = cfg.num_layers
    kw = dict(max_len=GEN_MAX_LEN, max_batch=GEN_BATCH)
    engines = {"dense": InferenceEngine(member.model, member.params, **kw),
               "paged": PagedInferenceEngine(member.model, member.params,
                                             page_size=16, **kw)}
    pool = engines["paged"]
    log(f"[scheduler] yi-9b#0 ({layers} layers, full width), max_len "
        f"{GEN_MAX_LEN}, {SCHED_SLOTS} slots; paged pool {pool.num_pages} "
        f"pages of 16 x {pool.page_bytes / 2**20:.2f} MiB = "
        f"{pool.num_pages * pool.page_bytes / 1e9:.3f} GB")
    services = {name: SchedulerService(eng, num_slots=SCHED_SLOTS)
                for name, eng in engines.items()}
    info = {name: [] for name in engines}
    try:
        warm_s = {name: svc.warm() for name, svc in services.items()}
        # two rounds in turns (dense, paged, dense, paged): host-clock
        # times on a shared host spread between runs.  Each round has its
        # own prompts, so none finds the paged prefix cache warm.
        for rnd in range(2):
            work = sched_workload(cfg.vocab_size, seed=1 + rnd)
            out = {}
            for name, svc in services.items():
                rec, out[name] = drive_counted(failures, svc, work, name,
                                               layers, warm_s[name], rnd)
                info[name].append(rec)
            same = out["paged"] == out["dense"]
            log(f"[scheduler] round {rnd}, fresh prompts, paged vs dense "
                f"streams: {'identical' if same else 'DIFFERENT'}")
            if not same:
                failures.append(f"scheduler round {rnd}: paged streams "
                                f"differ from dense")
    finally:
        for svc in services.values():
            svc.close()
    kernels[2]["launches"] = info["paged"][0]["launches"][
        "paged_decode_attention"]
    kernels[2]["launches_per_tick"] = layers
    kernels[2]["scheduler"] = {"runs": info}
    if profile_dir:
        kernels[2]["scheduler"]["tick_profile"] = {
            name: profile_scheduler_tick(eng, work, Path(profile_dir), name)
            for name, eng in engines.items()}

    # shared prefix: one slot, so each follower finds the leader's pages
    r = np.random.default_rng(2)
    pre = shared_prefix_run(failures, engines, cfg, layers, r, "scheduler")
    kernels[2]["scheduler"]["prefix"] = pre["pager"]
    kernels[2]["scheduler"]["prefix_first_divergence"] = pre[
        "first_divergence"]
    kernels[2]["scheduler"]["prefix_follower_logits_max_abs_diff"] = max(
        pre["first_token_diffs"][1:])

    # pause/resume mid-decode: dense recomputes, paged reattaches its
    # pages.  The paged streams must equal the same requests run without a
    # pause (reattach keeps the decode-time K/V).  The dense resume
    # re-derives the K/V of a's emitted tokens through a prefill, which in
    # bf16 is not bitwise the decode-time K/V: its first divergence is
    # reported, not checked.
    a_prompt = r.integers(0, cfg.vocab_size, 100).tolist()
    b_prompt = r.integers(0, cfg.vocab_size, 40).tolist()
    resumed = {}
    for name, eng in (("uninterrupted", engines["dense"]),
                      *engines.items()):
        s = ContinuousBatchingScheduler(eng, num_slots=2)
        a = s.submit(a_prompt, sampling=SamplingParams(
            max_new_tokens=12, temperature=0.8, top_k=50, top_p=0.9,
            seed=42))
        s.step()                                  # a prefilled alone
        b = s.submit(b_prompt, sampling=SamplingParams(max_new_tokens=12))
        s.step()
        if name != "uninterrupted":
            s.pause(a)
        s.step()
        s.step()
        if name != "uninterrupted" and not s.resume(a):
            failures.append(f"pause/resume {name}: nothing parked")
        s.run()
        resumed[name] = ([a.output, b.output], s.prefill_requests,
                         (s.pager_stats() or {}).get(
                             "resumes_without_recompute"))
    want = resumed["uninterrupted"][0]
    paged_ok = resumed["paged"][0] == want
    div = first_divergence(want, resumed["dense"][0])
    log(f"[scheduler] pause/resume mid-decode: paged (reattached) streams vs "
        f"the uninterrupted run: {'identical' if paged_ok else 'DIFFERENT'}; "
        f"dense (recomputed) vs the uninterrupted run: "
        + ("identical" if div is None else
           f"first differ at request {div[0]}, token {div[1]} (reported, not "
           f"checked)")
        + f"; prefill requests dense {resumed['dense'][1]}, paged "
        f"{resumed['paged'][1]}; paged resumes_without_recompute "
        f"{resumed['paged'][2]}")
    if (not paged_ok or resumed["paged"][2] != 1
            or resumed["dense"][1] != 3 or resumed["paged"][1] != 2
            or resumed["dense"][0][1] != want[1]):
        failures.append(f"pause/resume: {resumed}")
    kernels[2]["scheduler"]["pause_resume_dense_first_divergence"] = div
    del engines
    torch.cuda.empty_cache()


# --- phase 11: yi-9b on the fp8 e4m3 KV cache ----------------------------------

E4M3_BUDGET = 8 << 30       # the budget pages_for_budget is read at: 8 GiB
E4M3_SEED = 11              # the scheduler round's workload


def cache_dtypes(state):
    """{leaf path: dtype} of a dense or paged decode state's caches."""
    return {f"{key}/{kv}": t.dtype for key, c in state.items()
            if isinstance(c, dict) for kv, t in c.items()}


def parting_gap(engines, batch, streams, div):
    """At the first token where the e4m3-cache stream parts from the
    bf16-cache one: both engines teacher-forced along the bf16 stream up
    to that token, and the parting row's logits compared (max abs gap,
    each engine's argmax and the bf16 side's top-2 margin)."""
    import torch
    row, j = div
    teacher = torch.tensor(streams["bf16"], dtype=torch.int32,
                           device=batch["tokens"].device)
    last = {name: teacher_forced(eng, batch, teacher, steps=j)[j][row]
            for name, eng in engines.items()}
    top2 = last["bf16"].topk(2).values
    return {"row": row, "token": j,
            "max_abs_gap": float((last["e4m3"] - last["bf16"]).abs().max()),
            "argmax": {k: int(v.argmax()) for k, v in last.items()},
            "bf16_top2_margin": float(top2[0] - top2[1]),
            "max_abs_logit": float(last["bf16"].abs().max())}


def e4m3_phase(failures, kernels, app, profile_dir):
    """Phase 11: member yi-9b#0 (full width and depth) served with
    engines built under ``opt.flags(kv_cache_f8=True)``, beside engines of
    the same params with the bf16 cache."""
    import numpy as np
    import torch
    from repro_torch import opt
    from repro_torch.core import (InferenceEngine, PagedInferenceEngine,
                                  SchedulerService, page_kv_bytes)
    from repro_torch.core.batching import pad_sequences
    from repro_torch.core.kv_pager import pages_for_budget
    from repro_torch.models.attention import to_cache

    member = app.registry.get(f"{ARCH}#0")        # no second copy of weights
    cfg = member.model.config
    layers = cfg.num_layers
    kw = dict(max_len=GEN_MAX_LEN, max_batch=GEN_BATCH)

    def build():
        return {"dense": InferenceEngine(member.model, member.params, **kw),
                "paged": PagedInferenceEngine(member.model, member.params,
                                              page_size=16, **kw)}
    with opt.flags(kv_cache_f8=True):
        f8 = build()
    bf = build()
    out = {}

    # the cast on the card gives the CPU's bytes (which the CPU tests hold
    # to the JAX package's) for every bf16 bit pattern
    x = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16)
    on_cpu = to_cache(x, torch.float8_e4m3fn).view(torch.uint8)
    on_card = to_cache(x.cuda(), torch.float8_e4m3fn).view(torch.uint8)
    same = bool(torch.equal(on_card.cpu(), on_cpu))
    log(f"[e4m3] the cache cast over all 65536 bf16 patterns, card vs CPU: "
        f"{'equal' if same else 'DIFFERENT'}")
    if not same:
        failures.append("e4m3 cast: the card's bytes differ from the CPU's")

    # every GQA cache leaf is e4m3 (and bf16 without the flag); a page and
    # the pool cost half
    for cache, engs in (("e4m3", f8), ("bf16", bf)):
        want = torch.float8_e4m3fn if cache == "e4m3" else torch.bfloat16
        for name, eng in engs.items():
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            st = eng.new_state(SCHED_SLOTS)
            torch.cuda.synchronize()
            delta = torch.cuda.memory_allocated() - m0
            dts = cache_dtypes(st)
            del st
            out[f"{name}_{cache}_state_bytes"] = delta
            log(f"[e4m3] {name} engine, {cache} cache: leaves "
                f"{sorted((k, str(v)) for k, v in dts.items())}; a "
                f"{SCHED_SLOTS}-slot state allocates {delta} bytes")
            if not dts or set(dts.values()) != {want}:
                failures.append(f"e4m3 phase: {name} {cache} state dtypes "
                                f"{dts}")
    pb8, pb16 = f8["paged"].page_bytes, bf["paged"].page_bytes
    n8, n16 = (pages_for_budget(E4M3_BUDGET, b) for b in (pb8, pb16))
    ratios = {name: out[f"{name}_bf16_state_bytes"]
              / max(out[f"{name}_e4m3_state_bytes"], 1)
              for name in ("dense", "paged")}
    log(f"[e4m3] page_bytes {pb8} (bf16 {pb16}; page_kv_bytes "
        f"{page_kv_bytes(cfg, 16)}); pages_for_budget at "
        f"{E4M3_BUDGET} bytes: {n8} (bf16 {n16}); state bytes bf16 / e4m3: "
        f"dense {ratios['dense']:.4f}, paged pool {ratios['paged']:.4f}")
    if (2 * pb8 != pb16 or pb16 != page_kv_bytes(cfg, 16) or n8 != 2 * n16
            or any(abs(r - 2) > 0.01 for r in ratios.values())):
        failures.append(f"e4m3 phase: page bytes {pb8}/{pb16}, pages "
                        f"{n8}/{n16}, state ratios {ratios}")
    out.update(page_bytes=pb8, page_bytes_bf16=pb16,
               pages_for_budget=n8, pages_for_budget_bf16=n16,
               budget_bytes=E4M3_BUDGET, state_bytes_ratio=ratios)

    # generate: K1 48 a prefill, K2 48 a tick, exactly
    r = np.random.default_rng(0)
    lens = r.integers(17, 301, GEN_BATCH)
    lens[0], lens[-1] = 17, 300
    prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    gen = {"e4m3": f8["dense"], "bf16": bf["dense"]}
    res = {}
    for cache, eng in gen.items():
        eng.generate(prompts, max_new_tokens=2)      # warm the allocator
        eng.prefill_calls = eng.decode_calls = 0
        counts_reset()
        t0 = time.perf_counter()
        res[cache] = eng.generate(prompts, max_new_tokens=GEN_TOKENS)
        n = counts_read()
        wall = time.perf_counter() - t0
        fa_n, k2_n, k3_n = (n[k] for k in K_NAMES[:3])
        pre_n, dec_n = eng.prefill_calls, eng.decode_calls
        steps = res[cache].steps
        log(f"[e4m3] greedy generate, {cache} cache: {steps} steps in "
            f"{1e3 * wall:.1f} ms ({GEN_BATCH * GEN_TOKENS / wall:.1f} "
            f"tokens/s); prefill_calls {pre_n}, decode_calls {dec_n}; "
            f"launches K1 {fa_n} (expected {layers} x {pre_n}), K2 {k2_n} "
            f"(expected {layers} x {dec_n}), K3 {k3_n}")
        if (fa_n != layers * pre_n or pre_n != 1 or k2_n != layers * dec_n
                or dec_n != steps - 1 or k2_n == 0 or k3_n
                or res[cache].finish_reasons != ["length"] * GEN_BATCH):
            failures.append(f"e4m3 phase generate ({cache}): K1 {fa_n} K2 "
                            f"{k2_n} K3 {k3_n}, {pre_n} prefills, {dec_n} "
                            f"ticks, {steps} steps")
        out[f"generate_{cache}"] = {"wall_ms": 1e3 * wall,
                                    "tokens_per_s": GEN_BATCH * GEN_TOKENS
                                    / wall, "launches_k2": k2_n,
                                    "ticks": dec_n}
        if cache == "e4m3":
            kernels[1]["launches_e4m3_generate"] = k2_n
            kernels[1]["launches_per_tick_e4m3"] = k2_n // max(dec_n, 1)

    # teacher-forced: kernels vs plain versions on the same e4m3 cache
    tokens, lengths = pad_sequences(prompts, f8["dense"].seq_buckets)
    dev = f8["dense"].device
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "lengths": torch.from_numpy(lengths).to(dev)}
    teacher = torch.tensor(res["e4m3"].tokens, dtype=torch.int32,
                           device=dev)
    kern = teacher_forced(f8["dense"], batch, teacher)
    with plain_kernels():
        plain = teacher_forced(f8["dense"], batch, teacher)
    errs = []
    for step, (a, b) in enumerate(zip(kern, plain)):
        errs.append(float((a - b).abs().max()))
        if not (bool(torch.isfinite(a).all())
                and torch.allclose(a, b, **LOGITS_TOL)):
            failures.append(f"e4m3 teacher-forced logits step {step} vs "
                            f"plain: err {errs[-1]}")
    log(f"[e4m3] teacher-forced logits on the e4m3 cache, kernels vs plain "
        f"versions, prefill + {FORCED_STEPS} steps: max_abs_err per step "
        f"{[f'{e:.3e}' for e in errs]} (LOGITS_TOL rtol "
        f"{LOGITS_TOL['rtol']}, atol {LOGITS_TOL['atol']})")
    out["teacher_forced_max_abs_err"] = errs

    # e4m3 vs bf16 cache streams: partings reported, not failed
    streams = {k: v.tokens for k, v in res.items()}
    parted = [i for i in range(GEN_BATCH)
              if streams["e4m3"][i] != streams["bf16"][i]]
    div = first_divergence(streams["bf16"], streams["e4m3"])
    gap = parting_gap(gen, batch, streams, div) if div else None
    log(f"[e4m3] greedy streams, e4m3 vs bf16 cache: {len(parted)} of "
        f"{GEN_BATCH} rows part (reported, not checked)"
        + ("" if gap is None else
           f"; first parting row {gap['row']}, token {gap['token']}: logit "
           f"gap {gap['max_abs_gap']:.4e} at |logit| <= "
           f"{gap['max_abs_logit']:.3f}, argmax {gap['argmax']}, bf16 top-2 "
           f"margin {gap['bf16_top2_margin']:.4e}"))
    out["streams_parted_rows"] = parted
    out["first_parting"] = gap

    # dense and paged SchedulerService rounds, e4m3 and bf16 in turns
    work = sched_workload(cfg.vocab_size, seed=E4M3_SEED)
    services = {f"{name} {cache}": SchedulerService(eng,
                                                    num_slots=SCHED_SLOTS)
                for name in ("dense", "paged")
                for cache, eng in (("e4m3", f8[name]), ("bf16", bf[name]))}
    rounds, sched_streams = {}, {}
    try:
        warm_s = {name: svc.warm() for name, svc in services.items()}
        for name, svc in services.items():
            rounds[name], sched_streams[name] = drive_counted(
                failures, svc, work, name, layers, warm_s[name], 0)
    finally:
        for svc in services.values():
            svc.close()
    same = sched_streams["paged e4m3"] == sched_streams["dense e4m3"]
    parted = sum(a != b for a, b in zip(sched_streams["dense e4m3"],
                                        sched_streams["dense bf16"]))
    log(f"[e4m3] scheduler round, e4m3 cache: paged vs dense streams "
        f"{'identical' if same else 'DIFFERENT'}; {parted} of "
        f"{SCHED_REQUESTS} streams part from the bf16 cache's (reported)")
    if not same:
        failures.append("e4m3 phase: paged streams differ from dense")
    kernels[2]["launches_e4m3_scheduler"] = rounds["paged e4m3"][
        "launches"]["paged_decode_attention"]
    out["scheduler"] = rounds
    out["scheduler_streams_parted_from_bf16"] = parted

    # shared prefix on the e4m3 engines: the leader bit for bit, the
    # followers (C > 0: the plain path reads the pool dequantized) within
    # LOGITS_TOL
    pre = shared_prefix_run(failures, f8, cfg, layers,
                            np.random.default_rng(2), "e4m3")
    lead = pre["streams"]["paged"][0] == pre["streams"]["dense"][0]
    log(f"[e4m3] shared prefix: the leader's streams paged vs dense "
        f"{'identical' if lead else 'DIFFERENT'}")
    if not lead:
        failures.append("e4m3 shared prefix: the leader's paged stream "
                        "differs from its dense one")
    out["prefix"] = {k: pre[k] for k in ("pager", "first_token_diffs",
                                         "first_divergence")}
    if profile_dir:
        out["tick_profile"] = {
            f"{name} {cache}": profile_scheduler_tick(
                engs[name], work, Path(profile_dir), f"{name}_{cache}")
            for name in ("dense", "paged")
            for cache, engs in (("e4m3", f8), ("bf16", bf))}
    kernels[1]["e4m3_phase"] = out
    del f8, bf, gen
    torch.cuda.empty_cache()


# --- phase 6b: HTTP generate path ----------------------------------------------

FAULT_AT = 8        # Run D: the 8th decode tick of replica 0 raises


def pctl(vals, p):
    xs = sorted(vals)
    return xs[min(len(xs) - 1, int(p * len(xs)))]


def http_requests(vocab):
    """Run A's sequential requests: one greedy, two seeded sampled
    (temperature 0.8, top_k 50, top_p 0.9); prompts of 17, 300 and 120
    tokens, GEN_TOKENS new tokens each.  Run D fails over the last."""
    import numpy as np
    r = np.random.default_rng(5)
    samp = dict(temperature=0.8, top_k=50, top_p=0.9)
    return [(r.integers(0, vocab, 17).tolist(), {}),
            (r.integers(0, vocab, 300).tolist(), dict(samp, seed=300)),
            (r.integers(0, vocab, 120).tolist(), dict(samp, seed=42))]


def timed_stream(client, prompt, kw, started=None):
    """One streamed /v1/generate as the client sees it: tokens, the
    terminal event, TTFT and total seconds from the request's send.
    ``started`` (an Event) is set at the first token (or the end)."""
    t0 = time.perf_counter()
    first, toks, last = None, [], None
    for ev in client.generate_stream(prompt, max_new_tokens=GEN_TOKENS,
                                     **kw):
        if ev["event"] == "token":
            if first is None:
                first = time.perf_counter()
                if started is not None:
                    started.set()
            toks.append(ev["token"])
        else:
            last = ev
    t1 = time.perf_counter()
    if started is not None:
        started.set()
    return {"tokens": toks, "done": last, "t0": t0, "t1": t1,
            "ttft_s": (first or t1) - t0, "total_s": t1 - t0}


def stream_ok(rec):
    done = rec["done"] or {}
    return (done.get("event") == "done"
            and done.get("finish_reason") == "length"
            and done.get("token_count") == GEN_TOKENS
            and done.get("tokens") == rec["tokens"])


def decode_counters(client):
    d = client.metrics()["generate"]["decode"]
    return d["ticks"], d["prefill_forwards"], d["transfer_bytes_total"]


def check_http_counts(failures, where, counts, layers, fwds, ticks, paged):
    want = dict.fromkeys(K_NAMES, 0)
    want["flash_attention"] = layers * fwds
    want["paged_decode_attention" if paged else "decode_attention"] = \
        layers * ticks
    ok = counts == want and fwds > 0 and ticks > 0
    log(f"[http] {where}: {fwds} prefill forwards, {ticks} ticks; launches "
        f"K1 {counts['flash_attention']} K2 {counts['decode_attention']} "
        f"K3 {counts['paged_decode_attention']} K4 {counts['wkv6']} K5 "
        f"{counts['ssd']} (expected {layers} per prefill forward and "
        f"{layers} per tick) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"http {where}: launches {counts}, expected {want}")


# the TTFT parts read off each stream's trace (ms): the HTTP parse, the
# handler from admission to the scheduler's queue, the wait there until
# the stream's prefill forward starts, and that forward to its first token
TTFT_PARTS = ("http_parse", "admitted_to_queued", "queued_to_prefill",
              "prefill_to_first_token")


def trace_parts(snap):
    """One generate trace's TTFT parts (ms) and its own TTFT."""
    spans = {s["name"]: s for s in snap["spans"]}
    events = {}
    for e in snap["events"]:
        events.setdefault(e["name"], e["t_ms"])
    prefill = spans["prefill"]["start_ms"]
    return {"http_parse": spans["http_parse"]["duration_ms"],
            "admitted_to_queued": events["scheduler_queued"]
            - events["admitted"],
            "queued_to_prefill": prefill - events["scheduler_queued"],
            "prefill_to_first_token": events["first_token"] - prefill,
            "ttft_trace": events["first_token"]}


def ttft_breakdown(failures, client, recs):
    """p50/p99 of the TTFT parts over the streams' traces, found by the
    trace ids their terminal events carry."""
    rows = []
    for rec in recs:
        tid = (rec["done"] or {}).get("trace_id")
        try:
            rows.append(trace_parts(client.trace(tid)))
        except (KeyError, TypeError, RuntimeError) as e:
            failures.append(f"trace of stream {tid}: {e!r}")
    out = {}
    for part in TTFT_PARTS + ("ttft_trace",):
        vals = [r[part] for r in rows]
        if vals:
            out[part] = {"p50": pctl(vals, 0.5), "p99": pctl(vals, 0.99)}
    log("[http] Run B TTFT parts from the streams' traces (p50 / p99 ms): "
        + ", ".join(f"{k} {v['p50']:.1f} / {v['p99']:.1f}"
                    for k, v in out.items()))
    return out


def teacher_logits(engine, prefix, feed, steps):
    """Batch-1 logits: prefill ``prefix``, then ``steps`` decode steps fed
    ``feed``; returns the logits of the last step (float32, on the host)."""
    import torch
    from repro_torch.core.batching import pad_sequences
    tokens, lengths = pad_sequences([prefix], engine.seq_buckets)
    dev = engine.device
    logits, state = engine.prefill(
        {"tokens": torch.from_numpy(tokens).to(dev),
         "lengths": torch.from_numpy(lengths).to(dev)}, engine.new_state(1))
    for t in feed[:steps]:
        logits, state = engine.decode(
            torch.tensor([t], dtype=torch.int32, device=dev), state)
    return logits[0].float().cpu()


def http_generate_phase(failures, kernels, app, profile_dir):
    """Phase 6b: /v1/generate over HTTP on phase 4's app (member 0's
    weights), driven through the port's stdlib client."""
    import torch
    from repro_torch.core import (PagedInferenceEngine, SamplingParams,
                                  SchedulerService)
    from repro_torch.serving import (FlexServeApp, FlexServeClient,
                                     FlexServeServer)

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    member = app.registry.get(f"{ARCH}#0")
    engine = app.generation.engine_for()
    cfg = member.model.config
    layers = cfg.num_layers
    if engine.params is not member.params:
        failures.append("http: the generate engine holds a second copy of "
                        "member 0's weights")
    work = http_requests(cfg.vocab_size)
    info = {"card": smi}
    kernels[0]["http_generate"] = info

    # the reference: SchedulerService.submit_and_wait on the same engine,
    # each request alone
    ref_svc = SchedulerService(engine, num_slots=SCHED_SLOTS)
    refs, ref_s = [], []
    try:
        for p, kw in work:
            t = time.perf_counter()
            refs.append(ref_svc.submit_and_wait([p], sampling=SamplingParams(
                max_new_tokens=GEN_TOKENS, **kw)).tokens[0])
            ref_s.append(time.perf_counter() - t)
    finally:
        ref_svc.close()

    warm_s = app.generation.entry_for().service.warm()
    log(f"[serve] decode path warm in {warm_s:.1f}s")
    server = FlexServeServer(app).start(timeout=60)
    client = FlexServeClient(*server.address, timeout=600)
    try:
        # Run A: sequential, blocking then streamed, counted
        ticks0, fwds0, _ = decode_counters(client)
        counts_reset()
        blocking, streams = [], []
        for prompt, kw in work:
            t = time.perf_counter()
            body = client.generate([prompt], max_new_tokens=GEN_TOKENS,
                                   **kw)
            blocking.append((body, time.perf_counter() - t))
            streams.append(timed_stream(client, prompt, kw))
        counts = counts_read()
        ticks1, fwds1, _ = decode_counters(client)
        check_http_counts(failures, "Run A (3 blocking + 3 streamed, one "
                          "at a time)", counts, layers, fwds1 - fwds0,
                          ticks1 - ticks0, paged=False)
        for i, ((prompt, kw), (body, dt), rec, ref, rs) in enumerate(
                zip(work, blocking, streams, refs, ref_s)):
            same_ref = body["outputs"][0] == ref
            same_stream = rec["tokens"] == body["outputs"][0]
            log(f"[http] Run A request {i} ({len(prompt)}-token prompt, "
                f"{'seed ' + str(kw['seed']) if kw else 'greedy'}): "
                f"SchedulerService.submit_and_wait {1e3 * rs:.1f} ms, "
                f"blocking /v1/generate {1e3 * dt:.1f} ms, stream TTFT "
                f"{1e3 * rec['ttft_s']:.1f} ms, total "
                f"{1e3 * rec['total_s']:.1f} ms; blocking == "
                f"SchedulerService.submit_and_wait: "
                f"{'identical' if same_ref else 'DIFFERENT'}; stream == "
                f"blocking: {'identical' if same_stream else 'DIFFERENT'}")
            if (not (same_ref and same_stream and stream_ok(rec))
                    or body["finish_reasons"] != ["length"]):
                failures.append(f"http Run A request {i}: blocking "
                                f"{body}, stream {rec['done']}, reference "
                                f"{ref}")
        kernels[0]["launches_http"] = counts["flash_attention"]
        kernels[1]["launches_http"] = counts["decode_attention"]
        info["run_a"] = {
            "ttft_ms": [1e3 * r["ttft_s"] for r in streams],
            "total_ms": [1e3 * r["total_s"] for r in streams],
            "blocking_ms": [1e3 * dt for _, dt in blocking],
            "direct_ms": [1e3 * t for t in ref_s],
            "launches": counts, "warm_s": warm_s}

        # Run B: 12 streams at once on 8 slots
        bwork = sched_workload(cfg.vocab_size, seed=3)
        ticks0, fwds0, xfer0 = decode_counters(client)
        counts_reset()
        with concurrent.futures.ThreadPoolExecutor(len(bwork)) as ex:
            futs = [ex.submit(timed_stream, client, p,
                              {k: v for k, v in sp.describe().items()
                               if k != "max_new_tokens"})
                    for p, sp in bwork]
            recs = [f.result() for f in futs]
        counts = counts_read()
        ticks1, fwds1, xfer1 = decode_counters(client)
        ticks, fwds = ticks1 - ticks0, fwds1 - fwds0
        check_http_counts(failures, f"Run B ({len(bwork)} concurrent "
                          f"streams, {SCHED_SLOTS} slots)", counts, layers,
                          fwds, ticks, paged=False)
        bad = [i for i, r in enumerate(recs) if not stream_ok(r)]
        if bad:
            failures.append(f"http Run B: streams {bad} incomplete: "
                            f"{[recs[i]['done'] for i in bad]}")
        if xfer1 - xfer0 != 4 * SCHED_SLOTS * ticks:
            failures.append(f"http Run B: {xfer1 - xfer0} bytes moved over "
                            f"{ticks} ticks")
        wall = max(r["t1"] for r in recs) - min(r["t0"] for r in recs)
        ntok = sum(len(r["tokens"]) for r in recs)
        ttft = [1e3 * r["ttft_s"] for r in recs]
        tpot = [1e3 * (r["total_s"] - r["ttft_s"]) / (len(r["tokens"]) - 1)
                for r in recs]
        run_b = {"requests": len(recs), "tokens": ntok, "wall_s": wall,
                 "tokens_per_s": ntok / wall,
                 "ttft_ms_p50": pctl(ttft, 0.5), "ttft_ms_p99": pctl(ttft, 0.99),
                 "tpot_ms_p50": pctl(tpot, 0.5), "tpot_ms_p99": pctl(tpot, 0.99),
                 "ticks": ticks, "prefill_forwards": fwds,
                 "transfer_bytes_per_tick": (xfer1 - xfer0) / max(ticks, 1),
                 "launches": counts}
        run_b["ttft_parts_ms"] = ttft_breakdown(failures, client, recs)
        info["run_b"] = run_b
        log(f"[http] Run B on {smi}: {len(recs)} streams, {ntok} tokens in "
            f"{wall:.2f} s = {run_b['tokens_per_s']:.1f} tokens/s; TTFT p50 "
            f"{run_b['ttft_ms_p50']:.1f} ms, p99 {run_b['ttft_ms_p99']:.1f} "
            f"ms; time per output token p50 {run_b['tpot_ms_p50']:.1f} ms, "
            f"p99 {run_b['tpot_ms_p99']:.1f} ms (client side, through "
            f"/v1/generate); {ticks} ticks moving "
            f"{run_b['transfer_bytes_per_tick']:.0f} bytes each")
    finally:
        client.close()
        stop_listener(server)

    # Run C: the paged engine (page size 16) of the same member
    peng = PagedInferenceEngine(member.model, member.params,
                                max_len=GEN_MAX_LEN, max_batch=GEN_BATCH,
                                page_size=16)
    papp = FlexServeApp(app.registry, None, peng, num_slots=SCHED_SLOTS)
    pserver = FlexServeServer(papp).start(timeout=60)
    pclient = FlexServeClient(*pserver.address, timeout=600)
    try:
        pwarm = papp.generation.entry_for().service.warm()
        ticks0, fwds0, _ = decode_counters(pclient)
        counts_reset()
        precs = [timed_stream(pclient, p, kw) for p, kw in work]
        counts = counts_read()
        ticks1, fwds1, _ = decode_counters(pclient)
    finally:
        pclient.close()
        pserver.stop()
    check_http_counts(failures, "Run C (paged engine, 3 streams one at a "
                      "time)", counts, layers, fwds1 - fwds0,
                      ticks1 - ticks0, paged=True)
    same = [r["tokens"] for r in precs] == [r["tokens"] for r in streams]
    log(f"[http] Run C: paged streams vs Run A's dense streams: "
        f"{'identical' if same else 'DIFFERENT'}; warm {pwarm:.1f} s; TTFT "
        f"{[round(1e3 * r['ttft_s'], 1) for r in precs]} ms")
    if not same or not all(stream_ok(r) for r in precs):
        failures.append("http Run C: paged streams differ from dense or "
                        "are incomplete")
    kernels[2]["launches_http"] = counts["paged_decode_attention"]
    info["run_c"] = {"ttft_ms": [1e3 * r["ttft_s"] for r in precs],
                     "total_ms": [1e3 * r["total_s"] for r in precs],
                     "launches": counts, "warm_s": pwarm}
    del peng, papp

    # Run D: two replicas; replica 0's FAULT_AT-th tick raises mid-stream
    prompt, kw = work[2]
    mem0 = torch.cuda.memory_allocated()
    fapp = FlexServeApp(app.registry, None, engine, num_slots=SCHED_SLOTS,
                        replicas=2, fault_config=[
                            {"site": "engine_step", "replica": 0,
                             "at": FAULT_AT, "count": 1,
                             "message": "chip_smoke failover drill"}])
    per_replica_gb = (torch.cuda.memory_allocated() - mem0) / 2 / 1e9
    fserver = FlexServeServer(fapp).start(timeout=60)
    fclient = FlexServeClient(*fserver.address, timeout=600)
    try:
        frec = timed_stream(fclient, prompt, kw)
        reps = fclient.metrics()["replicas"]
        pool = fapp.generation.pool_for()
        resumed = (pool.replicas[1].service.scheduler.prefill_tokens_total
                   - len(prompt))
    finally:
        fclient.close()
        fserver.stop()
    div = first_divergence([refs[2]], [frec["tokens"]])
    extra_ms = 1e3 * (frec["total_s"] - streams[2]["total_s"])
    log(f"[http] Run D (2 replicas, engine_step raises at replica 0's tick "
        f"{FAULT_AT}): stream {frec['done'].get('finish_reason')} with "
        f"{len(frec['tokens'])} tokens; failovers {reps['failovers']}, "
        f"{resumed} tokens resumed on replica 1; total "
        f"{1e3 * frec['total_s']:.1f} ms, {extra_ms:+.1f} ms against Run A's "
        f"unfaulted stream; decode state {per_replica_gb:.3f} GB per replica; "
        f"vs the unfaulted stream: "
        + ("identical" if div is None else f"first differ at token {div[1]}"))
    if not stream_ok(frec) or reps["failovers"] != 1:
        failures.append(f"http Run D: {frec['done']}, failovers "
                        f"{reps['failovers']}")
    info["run_d"] = {"failovers": reps["failovers"], "resumed": resumed,
                     "total_ms": 1e3 * frec["total_s"],
                     "extra_ms": extra_ms, "first_divergence": div,
                     "decode_state_gb_per_replica": per_replica_gb}
    if div is not None:
        # a dense re-prefill of prompt + resumed output is not bitwise the
        # decode-time K/V in bf16: at the parting step, the failed-over
        # path's logits must agree with the unfaulted path's within
        # LOGITS_TOL and have the same argmax
        j = div[1]
        want = teacher_logits(engine, prompt, refs[2], j)
        got = teacher_logits(engine, prompt + frec["tokens"][:resumed],
                             frec["tokens"][resumed:], j - resumed)
        err = float((got - want).abs().max())
        ok = (j >= resumed and bool(torch.isfinite(got).all())
              and torch.allclose(got, want, **LOGITS_TOL)
              and int(got.argmax()) == int(want.argmax()))
        log(f"[http] Run D logits at token {j}, failed over vs unfaulted: "
            f"max abs diff {err:.4e} (|logit| <= "
            f"{float(want.abs().max()):.3f}), argmax {int(got.argmax())} vs "
            f"{int(want.argmax())}, tokens {frec['tokens'][j]} vs "
            f"{refs[2][j]} ({'ok' if ok else 'FAIL'})")
        info["run_d"]["logits_max_abs_diff"] = err
        if not ok:
            failures.append(f"http Run D: logits at token {j} differ by "
                            f"{err:.4e} or in argmax")
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[http] phase 6b in {info['seconds']:.1f} s")
    return refs


# --- phase 6c: speculative decoding --------------------------------------------

SPEC_WINDOW = 4
DRAFT_LAYERS = 8            # Pair T: --draft-layers 8 of yi-9b
SPEC_REQUESTS = 8           # one wave on the 8 slots


class LogitsProbe:
    """Records, per request and token index, the logits each emitted token
    of a scheduler run was drawn from: the engine's one-token step on a
    plain tick, the verify forward's row on a speculative tick (and, on a
    speculative pair, each draft step's logits and every rejected
    proposal).  ``tag`` names the request in flight where a run submits
    one at a time.  On a dense engine it also records each request's
    first token, from its prefill group's logits.  With no ``scheduler``
    it records ``engine.generate``: its rows run in lockstep and each
    row's index stands for the request id.  Logits are kept on the device
    as they came (bf16 at yi-9b), one row per token."""

    def __init__(self, engine, scheduler=None, tag=None):
        self.engine = engine
        self.scheduler = scheduler
        self.tag = tag
        self.logits = {}            # (tag, req_id, token) -> (V,)
        self.draft = {}             # the draft's logits, same keys
        self.rejections = []        # (tag, req_id, token) of a rejection
        self.ticks = []             # (window, tokens emitted)
        self._steps = []
        self._token = 1             # generate: the token a tick emits

    def _rows(self):
        if self.scheduler is None:
            for b in range(len(self._tsteps[-1])):
                yield b, (self.tag, b), self._token
            return
        for b, req in enumerate(self.scheduler.slots):
            if req is not None:
                yield b, (self.tag, req.req_id), len(req.output)

    def _wrap(self, engine, out):
        real = engine._decode_step

        def step(token, state):
            logits, state = real(token, state)
            out.append(logits)
            return logits, state
        engine._decode_step = step
        return engine

    def __enter__(self):
        from repro_torch.core import engine as eng_mod
        from repro_torch.models import paged, transformer
        spec = getattr(self.engine, "speculative", False)
        target = self.engine.target if spec else self.engine
        self._tsteps = []
        self._wrapped = [self._wrap(target, self._tsteps)]
        self._saved = []
        if spec:
            self._wrapped.append(self._wrap(self.engine.draft, self._steps))
            self._saved = [(transformer, "verify_decode_step"),
                           (paged, "paged_verify_step"),
                           (eng_mod, "speculative_accept")]
            self._orig = {n: getattr(m, n) for m, n in self._saved}
            transformer.verify_decode_step = self._verify(
                "verify_decode_step")
            paged.paged_verify_step = self._verify("paged_verify_step")
            eng_mod.speculative_accept = self._accept
        # a plain tick: the target's step logits are the token's
        orig_sample = self.engine.decode_sample

        def decode_sample(token, state, samp, ctr):
            out = orig_sample(token, state, samp, ctr)
            for b, who, n in self._rows():
                self.logits[who + (n,)] = self._tsteps[-1][b].clone()
            self._tsteps.clear()
            self._token += 1
            return out
        self.engine.decode_sample = decode_sample
        self._firsts = not spec and not getattr(self.engine, "paged", False)
        if self._firsts:
            self._wrap_prefill()
        return self

    def _wrap_prefill(self):
        """A prefill group's rows are its requests in order; generate's
        prefill emits token 0 of every row."""
        s, eng = self.scheduler, self.engine
        orig_prefill = eng.prefill
        group = []

        def prefill(batch, state):
            logits, state = orig_prefill(batch, state)
            whos = group if s is not None else [
                (self.tag, b, 0) for b in range(len(logits))]
            for i, who in enumerate(whos):
                self.logits[who] = logits[i].clone()
            group.clear()
            return logits, state
        eng.prefill = prefill
        if s is not None:
            orig_group = s._prefill_group

            def prefill_group(reqs, *a, **kw):
                group[:] = [(self.tag, r.req_id, len(r.output))
                            for r in reqs]
                return orig_group(reqs, *a, **kw)
            s._prefill_group = prefill_group

    def __exit__(self, *exc):
        for eng in self._wrapped:
            del eng._decode_step
        del self.engine.decode_sample
        if self._firsts:
            del self.engine.prefill
            if self.scheduler is not None:
                del self.scheduler._prefill_group
        for m, n in self._saved:
            setattr(m, n, self._orig[n])

    def _verify(self, name):
        def run(params, tokens, state, cfg, **kw):
            logits, state = self._orig[name](params, tokens, state, cfg,
                                             **kw)
            # a later tick overwrites the positions this one did not emit
            for b, who, n in self._rows():
                for i in range(tokens.shape[1]):
                    self.logits[who + (n + i,)] = logits[b, i].clone()
                for s, lg in enumerate(self._steps):
                    self.draft[who + (n + s,)] = lg[b].clone()
            self._steps.clear()
            return logits, state
        return run

    def _accept(self, logits, drafts, temperature, top_k, top_p, key, ctr,
                *, regime=None):
        draws, counts = self._orig["speculative_accept"](
            logits, drafts, temperature, top_k, top_p, key, ctr,
            regime=regime)
        c_h = counts.cpu().numpy()
        s, W, emitted = self.scheduler, logits.shape[1], 0
        for b, who, n in self._rows():
            k = int(c_h[b]) if s._spec_on[b] else 1
            emitted += k
            if s._spec_on[b] and k < W:
                self.rejections.append(who + (n + k - 1,))
        self.ticks.append((W, emitted))
        return draws, counts

    def get(self, table, who, token):
        """The row for ``token`` of the request ``who`` (tag, request id;
        a None part matches any)."""
        for key, row in table.items():
            if key[2] == token and all(w is None or w == x
                                       for w, x in zip(who, key[:2])):
                return row
        return None


def logits_gap(a, b):
    """(max abs difference, within LOGITS_TOL, top-2 margin of ``b``,
    max |b|) of two logit rows, in float32."""
    import torch
    a, b = a.float(), b.float()
    top2 = b.topk(2).values
    return (float((a - b).abs().max()), bool(torch.allclose(
        a, b, **LOGITS_TOL)), float(top2[0] - top2[1]),
        float(b.abs().max()))


def check_partings(failures, where, spec_probe, spec_streams, spec_whos,
                   plain_logits, plain_streams):
    """Each speculative stream against its sequential stream.  Where one
    parts, the two paths' logits for that token (the speculative run's,
    recorded by ``spec_probe``, and the sequential run's, from
    ``plain_logits(k, j)``) must agree within LOGITS_TOL: a near-tie,
    logged with their gap and the sequential path's top-2 margin.  Returns
    the number of streams that part."""
    parted = 0
    for k, (got, want, who) in enumerate(zip(spec_streams, plain_streams,
                                             spec_whos)):
        div = first_divergence([want], [got])
        if div is None:
            continue
        parted += 1
        j = div[1]
        lv = spec_probe.get(spec_probe.logits, who, j)
        ls = plain_logits(k, j)
        if lv is None or ls is None:
            log(f"[spec] {where}: request {k} parts at token {j} ({got[j]} "
                f"against {want[j]}) with no recorded logits: FAIL")
            failures.append(f"spec {where}: request {k} token {j}: no "
                            f"recorded logits")
            continue
        gap, close, margin, amax = logits_gap(lv, ls)
        log(f"[spec] {where}: request {k} parts from the sequential stream "
            f"at token {j} ({got[j]} against {want[j]}): the two paths' "
            f"logits differ by {gap:.4e} at |logit| <= {amax:.3f}; the "
            f"sequential path's top-2 margin {margin:.4e}: "
            + ("a near-tie within LOGITS_TOL" if close else
               "NOT within LOGITS_TOL: FAIL"))
        if not close:
            failures.append(f"spec {where}: request {k} token {j}: logits "
                            f"gap {gap:.4e} outside LOGITS_TOL")
    return parted


def recorded(probe, whos):
    """``plain_logits`` for ``check_partings`` from a probe of the
    sequential run (request k of the run is ``whos[k]``)."""
    return lambda k, j: probe.get(probe.logits, whos[k], j)



def spec_launch_check(failures, where, counts, layers, dlayers, k_hist,
                      fwds, paged):
    """K1 = (L + L_d) per prefill forward; K2 (K3 paged) = the sum over
    speculative ticks of W (L + L_d), plus L per level-1 tick."""
    k_attn = "paged_decode_attention" if paged else "decode_attention"
    spec = sum(int(w) * (layers + dlayers) * n for w, n in k_hist.items()
               if int(w) > 1)
    want_attn = spec + layers * k_hist.get("1", 0)
    got_attn = counts[k_attn]
    other = "decode_attention" if paged else "paged_decode_attention"
    ok = (counts["flash_attention"] == (layers + dlayers) * fwds
          and got_attn == want_attn and counts[other] == 0 and fwds > 0)
    log(f"[spec] {where}: launches K1 {counts['flash_attention']} (expected "
        f"{layers + dlayers} x {fwds} prefill forwards), "
        f"{'K3' if paged else 'K2'} {got_attn} (expected {want_attn}: W x "
        f"{layers + dlayers} per speculative tick over {k_hist}, {layers} "
        f"per level-1 tick) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"spec {where}: launches {counts}, k_hist "
                        f"{k_hist}, {fwds} forwards")
    return got_attn


def spec_drive(svc, work):
    """``drive_service`` returning the k_hist, spec counters and prefill
    forwards of the run."""
    s = svc.scheduler
    hist0 = dict(s.spec_k_hist)
    prop0, acc0, fwd0 = (s.spec_proposed_total, s.spec_accepted_total,
                         s.prefill_forwards)
    reqs, wall = drive_service(svc, work)
    hist = {str(w): s.spec_k_hist[w] - hist0[w] for w in s.spec_k_hist}
    return (reqs, wall, hist, s.spec_proposed_total - prop0,
            s.spec_accepted_total - acc0, s.prefill_forwards - fwd0)


def spec_tick_times(spec, prompts, reps=5):
    """Host ms per tick with all 8 rows live (median of ``reps``, each
    ending in the host copy the scheduler makes): a speculative step at
    every window level and the plain level-1 tick."""
    import numpy as np
    import torch
    from repro_torch.core.batching import pad_sequences
    from repro_torch.core.engine import pad_batch_rows
    dev = spec.device
    tokens, lengths = pad_sequences(prompts, spec.seq_buckets)
    B = len(prompts)
    tokens = torch.from_numpy(pad_batch_rows(tokens, B)).to(dev)
    lengths = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    state = spec.new_state(B)
    if spec.paged:
        # each row owns a contiguous run of pages (page 0 is the dump page)
        MP, ps = spec.max_pages_per_seq, spec.page_size
        table = torch.arange(1, 1 + B * MP, dtype=torch.int32,
                             device=dev).reshape(B, MP)
        nc = -(-tokens.shape[1] // ps)
        logits, state = spec.paged_prefill(
            state, tokens, lengths,
            torch.zeros((B, 0), dtype=torch.int32, device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            table[:, :nc].contiguous())
        state["page_table"] = table
        state["length"] = lengths
    else:
        logits, state = spec.prefill({"tokens": tokens,
                                      "lengths": lengths}, state)
    samp = {"temperature": torch.zeros((B,), device=dev),
            "top_k": torch.zeros((B,), dtype=torch.int32, device=dev),
            "top_p": torch.ones((B,), device=dev),
            "key": torch.zeros((B, 2), dtype=torch.int64, device=dev),
            "regime": "greedy"}
    ctr = torch.ones((B,), dtype=torch.int32, device=dev)
    on = torch.ones((B,), dtype=torch.bool, device=dev)
    tok = spec.sample(logits, samp, ctr)
    out = {}
    for w in spec.spec_levels:
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if w == 1:
                tok, state, ctr = spec.decode_sample(tok, state, samp, ctr)
                tok.cpu()
            else:
                draws, counts, tok, state, ctr = spec.speculative_step(
                    w, tok, state, samp, ctr, on)
                torch.cat([draws, counts[:, None]], 1).cpu()
            times.append(1e3 * (time.perf_counter() - t))
        out[w] = float(np.median(times[1:]))
    return out, (tok, state, samp, ctr, on)


def profile_verify(spec, carry, out_dir: Path, name: str):
    """torch.profiler over one speculative step at the top window and over
    the verify forward alone: device ms, the K2/K3 kernels' and cuBLAS's
    parts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import paged, transformer
    tok, state, samp, ctr, on = carry
    W = spec.max_window
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        draws, counts, tok, state, ctr = spec.speculative_step(
            W, tok, state, samp, ctr, on)
        torch.cuda.synchronize()
    out["step"] = {"device_ms": device_ms(prof, ()),
                   "attention_ms": device_ms(prof, K2_KERNELS),
                   "matmul_ms": device_ms(prof, CUBLAS_KERNELS)}
    window = torch.cat([tok[:, None], draws[:, :W - 1]], 1)
    tview = {**state["target"], "length": state["length"]}
    if spec.paged:
        tview["page_table"] = state["page_table"]
    cfg = spec.target.model.config
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if spec.paged:
            paged.paged_verify_step(spec.target.params, window, tview, cfg,
                                    page_size=spec.page_size)
        else:
            transformer.verify_decode_step(spec.target.params, window,
                                           tview, cfg)
        torch.cuda.synchronize()
    out["verify"] = {"device_ms": device_ms(prof, ()),
                     "attention_ms": device_ms(prof, K2_KERNELS),
                     "matmul_ms": device_ms(prof, CUBLAS_KERNELS)}
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"verify_{name}_profile.txt").write_text(
        prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    v = out["verify"]
    log(f"[profile] {name} verify forward (W={W}, B={GEN_BATCH}): device "
        f"{v['device_ms']:.3f} ms, {'K3' if spec.paged else 'K2'} "
        f"{v['attention_ms']:.3f} ms ({100 * v['attention_ms'] / max(v['device_ms'], 1e-9):.1f}%), "
        f"cuBLAS {v['matmul_ms']:.3f} ms; the whole speculative step "
        f"{out['step']['device_ms']:.3f} ms device")
    return out


CUBLAS_KERNELS = ("gemm", "Gemm", "cutlass", "nvjet")


def spec_phase(failures, kernels, app, refs, profile_dir):
    """Phase 6c: the speculative pair at yi-9b's full width and depth."""
    import numpy as np
    import torch
    from repro_torch.core import (InferenceEngine, MemoryLedger,
                                  PagedInferenceEngine, SamplingParams,
                                  SchedulerService, SpeculativeEngine)
    from repro_torch.launch.serve import build_app
    from repro_torch.serving import (FlexServeApp, FlexServeClient,
                                     FlexServeServer)

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    member = app.registry.get(f"{ARCH}#0")
    cfg = member.model.config
    layers = cfg.num_layers
    kw = dict(max_len=GEN_MAX_LEN, max_batch=GEN_BATCH)
    info = {"card": smi}
    for k in kernels[:3]:
        k["launches_speculative"] = {}

    # Pair E: the target doubles as its own draft (the same tensors)
    target = InferenceEngine(member.model, member.params, **kw)
    pair_e = SpeculativeEngine(
        target, InferenceEngine(member.model, member.params, **kw),
        max_window=SPEC_WINDOW)
    r = np.random.default_rng(11)
    lens = r.integers(17, 301, SPEC_REQUESTS)
    lens[0], lens[-1] = 17, 300
    ework = [(r.integers(0, cfg.vocab_size, n).tolist(),
              SamplingParams(max_new_tokens=GEN_TOKENS)) for n in lens]
    plain = SchedulerService(target, num_slots=SCHED_SLOTS)
    svc = SchedulerService(pair_e, num_slots=SCHED_SLOTS)
    try:
        with LogitsProbe(target, plain.scheduler) as pprobe:
            want, _ = drive_service(plain, ework)
        warm_s = svc.warm(seq_lens=[16])
        counts_reset()
        with LogitsProbe(pair_e, svc.scheduler) as probe:
            reqs, wall, hist, prop, acc, fwds = spec_drive(svc, ework)
        counts = counts_read()
        st = svc.scheduler.speculation_stats()
    finally:
        plain.close()
        svc.close()
    got = [x.output for x in reqs]
    parted = check_partings(
        failures, "Pair E", probe, got, [(None, x.req_id) for x in reqs],
        recorded(pprobe, [(None, x.req_id) for x in want]),
        [x.output for x in want])
    spec_ticks = sum(n for w, n in hist.items() if w != "1")
    emitted = sum(e for _, e in probe.ticks)
    # a rejected proposal of an equal draft: the verify's and the draft's
    # logits for that token must be a near-tie
    rejected, bad = probe.rejections, []
    for key in rejected:
        gap, close, margin, amax = logits_gap(probe.logits[key],
                                              probe.draft[key])
        log(f"[spec] Pair E: request {key[1]}'s proposal for token "
            f"{key[2]} rejected: verify and draft logits differ by "
            f"{gap:.4e} at |logit| <= {amax:.3f}, the draft's top-2 margin "
            f"{margin:.4e}: " + ("a near-tie within LOGITS_TOL" if close
                                 else "NOT within LOGITS_TOL: FAIL"))
        if not close:
            bad.append((key, gap))
    log(f"[spec] Pair E (the target as its own draft, dense, "
        f"{SPEC_REQUESTS} greedy requests of 17-300 tokens, {GEN_TOKENS} "
        f"new): {prop} proposed, {acc} accepted = acceptance "
        f"{acc / max(prop, 1):.4f}; {len(rejected)} rejections, each a "
        f"logged near-tie: {not bad}; window {st['window']} of "
        f"{st['max_window']}, k_hist {hist}; {emitted} tokens in "
        f"{spec_ticks} speculative ticks = {emitted / max(spec_ticks, 1):.2f}"
        f" a tick ({emitted / max(spec_ticks, 1) / SPEC_REQUESTS:.2f} a "
        f"row); {parted} of {SPEC_REQUESTS} streams part from "
        f"SchedulerService's non-speculative streams; warm {warm_s:.1f} s")
    if (bad or st["window"] != SPEC_WINDOW
            or hist.get(str(SPEC_WINDOW), 0) == 0):
        failures.append(f"spec Pair E: rejections {rejected[:4]}, window "
                        f"{st['window']}, k_hist {hist}")
    if any(x.finish_reason != "length" or len(x.output) != GEN_TOKENS
           for x in reqs):
        failures.append("spec Pair E: a stream did not finish with "
                        f"{GEN_TOKENS} tokens")
    k2 = spec_launch_check(failures, "Pair E", counts, layers, layers, hist,
                           fwds, paged=False)
    kernels[0]["launches_speculative"]["pair_e"] = counts["flash_attention"]
    kernels[1]["launches_speculative"]["pair_e"] = k2
    info["pair_e"] = {"proposed": prop, "accepted": acc,
                      "rejections": len(rejected), "parted": parted,
                      "k_hist": hist, "tokens_per_spec_tick":
                      emitted / max(spec_ticks, 1), "wall_s": wall}
    del pair_e, target, svc, plain, probe, pprobe
    torch.cuda.empty_cache()

    # Pair T: an 8-layer draft seeded seed + 1000, through build_app
    t0 = time.perf_counter()
    app_t = build_app([ARCH], full=True, num_classes=NUM_CLASSES,
                      max_len=GEN_MAX_LEN, max_batch=GEN_BATCH,
                      num_slots=SCHED_SLOTS, draft_model=ARCH,
                      draft_layers=DRAFT_LAYERS, spec_window=SPEC_WINDOW)
    spec = app_t.generation.engine_for()
    log(f"[spec] Pair T: build_app(draft_model={ARCH!r}, draft_layers="
        f"{DRAFT_LAYERS}, spec_window={SPEC_WINDOW}) in "
        f"{time.perf_counter() - t0:.1f} s")
    dlayers = spec.draft.model.config.num_layers
    if not (isinstance(spec, SpeculativeEngine) and dlayers == DRAFT_LAYERS):
        failures.append(f"spec Pair T: build_app gave {type(spec)}")
    work = http_requests(cfg.vocab_size)
    optout = len(work) - 1                      # the last opts out
    tpaged = PagedInferenceEngine(spec.target.model, spec.target.params,
                                  page_size=16, **kw)
    pspec = SpeculativeEngine(
        tpaged, PagedInferenceEngine(spec.draft.model, spec.draft.params,
                                     page_size=16,
                                     num_pages=tpaged.num_pages, **kw),
        max_window=SPEC_WINDOW)
    ledger = MemoryLedger(n_chips=1)
    ledger.add_params(f"target ({layers} layers)", spec.target.params)
    ledger.add_params(f"draft ({dlayers} layers)", spec.draft.params)
    st8 = spec.new_state(SCHED_SLOTS)
    ledger.add_cache("target KV, 8 x 1024", st8["target"])
    ledger.add_cache("draft KV, 8 x 1024", st8["draft"])
    del st8
    info["memory"] = {e.name: e.total_bytes for e in ledger.entries}
    log("[spec] Pair T memory (MemoryLedger): " + "; ".join(
        f"{e.name} {e.total_bytes / 1e9:.3f} GB" for e in ledger.entries)
        + f" on {smi}")
    ref_engine = InferenceEngine(spec.target.model, spec.target.params,
                                 **kw)

    def ref_logits(k, j):
        """Request k of Run A's alone through a plain service on the pair's
        target, as phase 6b's reference ran: its logits for token j (its
        stream must be that reference's)."""
        one = SchedulerService(ref_engine, num_slots=SCHED_SLOTS)
        try:
            with LogitsProbe(ref_engine, one.scheduler, tag=k) as rp:
                p, kwd = work[k]
                out = one.submit_and_wait([p], sampling=SamplingParams(
                    max_new_tokens=GEN_TOKENS, **kwd)).tokens[0]
        finally:
            one.close()
        return rp.get(rp.logits, (k, None), j) if out == refs[k] else None

    runs = {}
    papp_t = FlexServeApp(app_t.registry, None, pspec,
                          num_slots=SCHED_SLOTS)
    for name, papp in (("dense", app_t), ("paged", papp_t)):
        eng = papp.generation.engine_for()
        sch = papp.generation.entry_for().service.scheduler
        server = FlexServeServer(papp).start(timeout=60)
        client = FlexServeClient(*server.address, timeout=600)
        try:
            counts_reset()
            recs, hist0 = [], dict(sch.spec_k_hist)
            fwd0 = sch.prefill_forwards
            with LogitsProbe(eng, sch) as probe:
                for k, (p, kwd) in enumerate(work):
                    probe.tag = k
                    recs.append(timed_stream(
                        client, p, dict(kwd, speculation=k != optout)))
            counts = counts_read()
        finally:
            client.close()
            stop_listener(server)
        hist = {str(w): sch.spec_k_hist[w] - hist0[w]
                for w in sch.spec_k_hist}
        streams = [x["tokens"] for x in recs]
        whos = [(k, None) for k in range(len(work))]
        parted = check_partings(failures, f"Pair T {name} over HTTP", probe,
                                streams, whos, ref_logits, refs)
        summaries = [(x["done"] or {}).get("speculation") for x in recs]
        ok = (all(stream_ok(x) for x in recs)
              and summaries[optout] == {"proposed": 0, "accepted": 0,
                                        "acceptance_rate": 0.0}
              and hist.get("1", 0) > 0)
        log(f"[spec] Pair T {name} over /v1/generate ({len(work)} streams "
            f"one at a time; the last with \"speculation\": false): "
            f"summaries {summaries}; k_hist {hist} (level-1 ticks: the "
            f"controller backed off); {parted} streams part from the "
            f"non-speculative ones {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"spec Pair T {name}: {summaries}, k_hist "
                            f"{hist}, streams ok "
                            f"{[stream_ok(x) for x in recs]}")
        n_attn = spec_launch_check(failures, f"Pair T {name}", counts,
                                   layers, dlayers, hist,
                                   sch.prefill_forwards - fwd0,
                                   paged=name == "paged")
        kernels[0]["launches_speculative"][f"pair_t_{name}"] = counts[
            "flash_attention"]
        kernels[2 if name == "paged" else 1]["launches_speculative"][
            f"pair_t_{name}"] = n_attn
        runs[name] = {"k_hist": hist, "parted": parted,
                      "summaries": summaries}
    info["pair_t"] = runs

    # Pair T through SchedulerService: 8 rows at once, half sampled, one
    # opted out, against the plain service on the same target
    swork = []
    for i, (p, sp) in enumerate(sched_workload(cfg.vocab_size, seed=4)[
            :SPEC_REQUESTS]):
        swork.append((p, dataclasses.replace(sp, speculation=i != 1)))
    plain = SchedulerService(ref_engine, num_slots=SCHED_SLOTS)
    svc = SchedulerService(spec, num_slots=SCHED_SLOTS)
    try:
        with LogitsProbe(ref_engine, plain.scheduler) as pprobe:
            want, _ = drive_service(plain, swork)
        counts_reset()
        with LogitsProbe(spec, svc.scheduler) as probe:
            reqs, wall, hist, prop, acc, fwds = spec_drive(svc, swork)
        counts = counts_read()
    finally:
        plain.close()
        svc.close()
    parted = check_partings(
        failures, "Pair T, 8 rows at once", probe, [x.output for x in reqs],
        [(None, x.req_id) for x in reqs],
        recorded(pprobe, [(None, x.req_id) for x in want]),
        [x.output for x in want])
    spec_ticks = sum(n for w, n in hist.items() if w != "1")
    emitted = sum(e for _, e in probe.ticks)
    ok = (hist.get("1", 0) > 0 and reqs[1].spec_proposed == 0
          and all(x.finish_reason == "length" for x in reqs))
    log(f"[spec] Pair T, {SPEC_REQUESTS} rows at once (half sampled, row 1 "
        f"opted out): {prop} proposed, {acc} accepted = acceptance "
        f"{acc / max(prop, 1):.4f}; k_hist {hist}; "
        f"{emitted / max(spec_ticks, 1):.2f} tokens a speculative tick; "
        f"row 1 proposed {reqs[1].spec_proposed}; {parted} streams part "
        f"from the non-speculative ones {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"spec Pair T rows at once: k_hist {hist}, row 1 "
                        f"{reqs[1].spec_proposed}")
    spec_launch_check(failures, "Pair T, rows at once", counts, layers,
                      dlayers, hist, fwds, paged=False)
    info["pair_t_rows"] = {"proposed": prop, "accepted": acc,
                           "k_hist": hist, "parted": parted,
                           "tokens_per_spec_tick":
                           emitted / max(spec_ticks, 1)}

    # host ms per tick, all 8 rows live, at every window level
    prompts = [p for p, _ in swork]
    times = {}
    for name, eng in (("dense", spec), ("paged", pspec)):
        times[name], carry = spec_tick_times(eng, prompts)
        log(f"[spec] Pair T {name}, host ms per tick with {SCHED_SLOTS} "
            f"rows live (median of 5, the ids' host copy included): "
            + ", ".join(f"W={w}: {t:.2f}" for w, t in times[name].items())
            + f" (W=1 is the plain tick) on {smi}")
        if profile_dir:
            info[f"profile_{name}"] = profile_verify(
                eng, carry, Path(profile_dir), f"pair_t_{name}")
        del carry
    info["tick_host_ms"] = times
    papp_t.close()
    app_t.close()
    del app_t, papp_t, spec, pspec, tpaged, ref_engine, probe, pprobe
    gc.collect()
    torch.cuda.empty_cache()
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[spec] phase 6c in {info['seconds']:.1f} s")
    kernels[0]["speculative"] = info


# --- phase 7: recurrent path ---------------------------------------------------

RECURRENT = ["rwkv6-1.6b", "zamba2-2.7b"]


def profile_kernels():
    """Device-kernel names per port kernel for the profiled breakdowns:
    every kernel a wrapper may launch (K5's G pass and scan, both sides of
    K4's and K5's shape predicate)."""
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    return {"wkv6": wkv_ops.KERNEL_NAMES, "ssd": ssd_ops.KERNEL_NAMES,
            "flash_attention": K1_KERNELS, "decode_attention": K2_KERNELS}


def recurrent_per_call(cfg):
    """Launches per forward/prefill and per decode tick of a recurrent
    model: rwkv6 runs K4 in every layer; zamba2 runs K5 in every Mamba-2
    layer and K1 (full sequence) or K2 (a tick) in each of its shared
    block's applications."""
    per_fwd = dict.fromkeys(K_NAMES, 0)
    per_tick = dict.fromkeys(K_NAMES, 0)
    if cfg.family == "ssm":
        per_fwd["wkv6"] = cfg.num_layers
    else:
        napp = cfg.num_layers // cfg.hybrid.shared_block_period
        per_fwd["ssd"] = cfg.num_layers
        per_fwd["flash_attention"] = napp
        per_tick["decode_attention"] = napp
    return per_fwd, per_tick


def check_counts(failures, where, got, want):
    ok = got == want and any(want.values())
    log(f"[recurrent] {where}: launches {got} (expected {want}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{where}: launches {got}, expected {want}")


def scaled(counts, n):
    return {k: v * n for k, v in counts.items()}


def add_counts(a, b):
    return {k: a[k] + b[k] for k in a}


def recurrent_ensemble_phase(failures, kernels, profile_dir):
    """Part 1: the paper's path over rwkv6-1.6b + zamba2-2.7b at full width
    and depth."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import build_app
    from repro_torch.models.mamba2 import mamba2_dims
    from repro_torch.serving import FlexServeServer

    t0 = time.perf_counter()
    # the generate plane runs over the first member, rwkv6 (Run E)
    app = build_app(RECURRENT, full=True, num_classes=NUM_CLASSES,
                    max_batch=8, seed=0, max_len=GEN_MAX_LEN,
                    num_slots=SCHED_SLOTS)
    torch.cuda.synchronize()
    cfgs = [app.registry.get(f"{a}#{i}").model.config
            for i, a in enumerate(RECURRENT)]
    rw, zb = cfgs
    inner, H, P, N = mamba2_dims(zb)
    log(f"[recurrent] build_app({RECURRENT}, full=True) in "
        f"{time.perf_counter() - t0:.1f}s: rwkv6-1.6b {rw.num_layers} layers, "
        f"d_model {rw.d_model}, {rw.d_model // rw.ssm.head_dim} heads of "
        f"{rw.ssm.head_dim}, d_ff {rw.d_ff}, vocab {rw.vocab_size}, "
        f"{rw.dtype}; zamba2-2.7b {zb.num_layers} Mamba-2 layers (d_model "
        f"{zb.d_model}, {H} heads, P={P}, N={N}) + a shared block every "
        f"{zb.hybrid.shared_block_period} ({zb.num_heads} heads of "
        f"{zb.head_dim}, window {zb.hybrid.shared_window}), vocab "
        f"{zb.vocab_size}, {zb.dtype}; no depth cut; device memory allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    log("[recurrent] " + app.ensemble.memory_ledger().report().replace(
        "\n", "\n[recurrent] "))
    per = [recurrent_per_call(c)[0] for c in cfgs]
    per_forward = add_counts(*per)

    server = FlexServeServer(app).start()
    client = Client(*server.address)
    rng = np.random.default_rng(0)
    vocab = min(c.vocab_size for c in cfgs)

    def toks(n, s):
        return rng.integers(0, vocab, (n, s)).tolist()

    requests = [("infer", toks(1, 32)), ("infer", toks(3, 64)),
                ("infer", toks(8, 256)), ("detect", toks(3, 64)),
                ("detect", toks(8, 256))]
    concurrent_reqs = [("infer", toks(1, 64)) for _ in range(4)] + \
        [("detect", toks(1, 64)) for _ in range(2)]

    def send(kind, tokens):
        body = {"inputs": {"tokens": tokens}}
        if kind == "detect":
            body.update(positive_class=1, threshold=0.05, policy="or")
        t = time.perf_counter()
        status, resp = client.call("POST", f"/v1/{kind}", body)
        return kind, len(tokens), status, resp, time.perf_counter() - t

    try:
        status, body = client.call("POST", "/v1/infer",
                                   {"inputs": {"tokens": toks(8, 256)}})
        check_schema(status, body, 8, "infer")
        _, m0 = client.call("GET", "/metrics")
        batches0 = m0["coalesce"]["batches_formed"]
        counts_reset()                      # the recurrent path's run
        results = [send(kind, t) for kind, t in requests]
        with concurrent.futures.ThreadPoolExecutor(len(concurrent_reqs)) as ex:
            futs = [ex.submit(send, kind, t) for kind, t in concurrent_reqs]
            results += [f.result() for f in futs]
        counts = counts_read()
        _, m1 = client.call("GET", "/metrics")
        forwards = m1["coalesce"]["batches_formed"] - batches0
        for kind, n, st, resp, dt in results:
            check_schema(st, resp, n, kind)
            log(f"[recurrent] POST /v1/{kind} rows={n}: {st} in "
                f"{1e3 * dt:.1f} ms -> {json.dumps(resp)[:120]}")
        check_counts(failures, f"ensemble, {len(results)} requests in "
                     f"{forwards} coalesced forwards", counts,
                     scaled(per_forward, forwards))
        st, body = client.call("GET", "/v1/models")
        fams = sorted(m["family"] for m in body.get("models", []))
        log(f"[recurrent] GET /v1/models: {st}, families {fams}")
        if st != 200 or fams != ["hybrid", "ssm"]:
            failures.append(f"/v1/models: {st} {body}")
        http_generate_rwkv6(failures, kernels, app, server, per[0])
    finally:
        server.stop()
    kernels[3]["launches"] = counts["wkv6"]
    kernels[4]["launches"] = counts["ssd"]
    kernels[0]["launches_recurrent_ensemble"] = counts["flash_attention"]

    ens = app.ensemble
    batch = {"tokens": np.asarray(requests[1][1], np.int32)}
    timed = {"tokens": np.asarray(requests[2][1], np.int32)}
    kern = ens.forward(batch)
    fwd_ms = host_time_ms(lambda: ens.forward(timed))
    with plain_kernels():
        plain = ens.forward(batch)
        fwd_plain_ms = host_time_ms(lambda: ens.forward(timed), reps=3)
    for name in kern:
        a, b = kern[name].float(), plain[name].float()
        err = float((a - b).abs().max())
        ok = (tuple(a.shape) == (3, NUM_CLASSES)
              and bool(torch.isfinite(a).all())
              and torch.allclose(a, b, **LOGITS_TOL))
        log(f"[recurrent] member {name} logits {tuple(a.shape)} vs plain "
            f"path: max_abs_err {err:.3e}, max |logit| "
            f"{float(b.abs().max()):.3f} ({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"recurrent member {name} logits vs plain: "
                            f"err {err}")
    log(f"[recurrent] one ensemble forward (rwkv6 + zamba2, B=8, S=256): "
        f"kernel path {fwd_ms:.2f} ms, plain path {fwd_plain_ms:.2f} ms "
        f"(host clock around a synchronised forward, median)")
    kernels[3]["ensemble_forward_ms"] = fwd_ms
    kernels[3]["ensemble_forward_plain_ms"] = fwd_plain_ms
    if profile_dir:
        profile_calls(lambda: ens.forward(timed), Path(profile_dir),
                      "recurrent_ensemble_forward")
    return app


def http_generate_rwkv6(failures, kernels, app, server, per_prefill):
    """Run E: one streamed /v1/generate on the recurrent app's generate
    plane (an InferenceEngine over rwkv6-1.6b#0's params): K4 per prefill
    forward, nothing per tick, and the stream equal to
    ``SchedulerService.submit_and_wait`` on the same engine."""
    import numpy as np
    from repro_torch.core import SamplingParams, SchedulerService
    from repro_torch.serving import FlexServeClient

    engine = app.generation.engine_for()
    member = app.registry.get(f"{RECURRENT[0]}#0")
    if engine.params is not member.params:
        failures.append("Run E: the generate engine is not over rwkv6's "
                        "params")
    prompt = np.random.default_rng(6).integers(
        0, member.model.config.vocab_size, 120).tolist()
    kw = dict(temperature=0.8, top_k=50, top_p=0.9, seed=7)
    ref_svc = SchedulerService(engine, num_slots=SCHED_SLOTS)
    try:
        ref = ref_svc.submit_and_wait(
            [prompt], sampling=SamplingParams(max_new_tokens=GEN_TOKENS,
                                              **kw)).tokens[0]
    finally:
        ref_svc.close()
    warm_s = app.generation.entry_for().service.warm()
    client = FlexServeClient(*server.address, timeout=600)
    try:
        ticks0, fwds0, _ = decode_counters(client)
        counts_reset()
        rec = timed_stream(client, prompt, kw)
        counts = counts_read()
        ticks1, fwds1, _ = decode_counters(client)
    finally:
        client.close()
    fwds = fwds1 - fwds0
    check_counts(failures, f"Run E, /v1/generate stream on rwkv6 ({fwds} "
                 f"prefill forwards, {ticks1 - ticks0} ticks)", counts,
                 scaled(per_prefill, fwds))
    same = rec["tokens"] == ref
    log(f"[recurrent] Run E: {RECURRENT[0]} stream of {len(rec['tokens'])} "
        f"tokens, TTFT {1e3 * rec['ttft_s']:.1f} ms, total "
        f"{1e3 * rec['total_s']:.1f} ms, warm {warm_s:.1f} s; vs "
        f"SchedulerService.submit_and_wait: "
        f"{'identical' if same else 'DIFFERENT'}")
    if not (same and stream_ok(rec)):
        failures.append(f"Run E: stream {rec['done']} vs reference {ref}")
    kernels[3]["launches_http"] = counts["wkv6"]
    kernels[3]["http_generate"] = {"ttft_ms": 1e3 * rec["ttft_s"],
                                   "total_ms": 1e3 * rec["total_s"],
                                   "launches": counts, "warm_s": warm_s}


def profile_calls(fn, out_dir: Path, name: str):
    """torch.profiler over one call: the table to a file, and the device
    time of the call and of each kernel of the port."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t)
    total = device_ms(prof, ())
    parts = {k: device_ms(prof, v) for k, v in profile_kernels().items()}
    parts["matmul (cuBLAS)"] = device_ms(prof, ("gemm", "Gemm", "cutlass",
                                                "nvjet"))
    out_dir.mkdir(parents=True, exist_ok=True)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=25)
    (out_dir / f"{name}_profile.txt").write_text(table)
    log(f"[profile] {name}: host clock {host:.2f} ms (profiled), device "
        f"{total:.3f} ms: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                         parts.items()))
    return {"host_ms": host, "device_ms": total, **parts}


RECUR_FORCED_PREFIX = 120
# Phase 7's float32 checks differ only by summation order (the H100
# measured 3.6e-5 to 1.2e-4 at |logit| <= 4.4); the bound leaves 8x.
RECUR_FP32_ATOL = 1e-3
# Phase 7's bf16 witness: against the float32 run on the same tokens, the
# kernel path's RMS logit error may be at most this multiple of the plain
# path's.
BF16_WITNESS_RATIO = 1.5


def prefill_then_decode(engine, seq, n, steps):
    """Logits of a prefill of seq[:, :n] and ``steps`` decode steps of the
    tokens that follow it."""
    import torch
    B = seq.shape[0]
    logits, state = engine.prefill(
        {"tokens": seq[:, :n], "lengths": torch.full(
            (B,), n, dtype=torch.int32, device=seq.device)},
        engine.new_state(B))
    outs = [logits.float()]
    for t in range(steps):
        logits, state = engine.decode(seq[:, n + t], state)
        outs.append(logits.float())
    return outs


def step_errors(got, want):
    """Per-step max abs errors, the RMS error over every step's logits, and
    whether ``got`` is finite."""
    import torch
    maxes = [float((a - b).abs().max()) for a, b in zip(got, want)]
    sq = sum(float(((a - b) ** 2).sum()) for a, b in zip(got, want))
    rms = (sq / sum(a.numel() for a in got)) ** 0.5
    return maxes, rms, all(bool(torch.isfinite(a).all()) for a in got)


def recurrent_engine_phase(failures, kernels, app, profile_dir):
    """Part 2: InferenceEngine.generate over each recurrent member."""
    import numpy as np
    import torch
    from repro_torch.core import InferenceEngine, SamplingParams
    from repro_torch.core.batching import pad_sequences
    from repro_torch.models import build_model

    engines, greedy = {}, {}
    for i, arch in enumerate(RECURRENT):
        member = app.registry.get(f"{arch}#{i}")
        cfg = member.model.config
        per_fwd, per_tick = recurrent_per_call(cfg)
        engine = InferenceEngine(member.model, member.params,
                                 max_len=GEN_MAX_LEN, max_batch=GEN_BATCH)
        engines[arch] = engine
        r = np.random.default_rng(10 + i)
        lens = r.integers(17, 301, GEN_BATCH)
        lens[0], lens[-1] = 17, 300
        prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in lens]
        engine.generate(prompts, max_new_tokens=2)      # warm the allocator
        engine.prefill_calls = engine.decode_calls = 0
        counts_reset()
        t0 = time.perf_counter()
        res = engine.generate(prompts, max_new_tokens=GEN_TOKENS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = counts_read()
        pre_n, dec_n = engine.prefill_calls, engine.decode_calls
        check_counts(failures, f"{arch} generate ({pre_n} prefill, {dec_n} "
                     f"decode calls)", counts,
                     add_counts(scaled(per_fwd, pre_n),
                                scaled(per_tick, dec_n)))
        good = (len(res.tokens) == GEN_BATCH
                and all(len(t) == GEN_TOKENS for t in res.tokens)
                and all(0 <= x < cfg.vocab_size for t in res.tokens
                        for x in t)
                and res.finish_reasons == ["length"] * GEN_BATCH
                and res.steps == GEN_TOKENS and dec_n == res.steps - 1)
        if not good:
            failures.append(f"{arch} greedy generate malformed: steps "
                            f"{res.steps}, reasons {res.finish_reasons}")
        greedy[arch] = (prompts, res.tokens)
        rec = {"launches": counts, "generate_wall_ms": 1e3 * wall,
               "generate_tokens_per_s": GEN_BATCH * GEN_TOKENS / wall}

        tokens, lengths = pad_sequences(prompts, engine.seq_buckets)
        dev = engine.device
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "lengths": torch.from_numpy(lengths).to(dev)}
        rec["prefill_ms"] = host_time_ms(
            lambda: engine.prefill(batch, engine.new_state(GEN_BATCH)))
        samp = {"temperature": torch.zeros(GEN_BATCH, device=dev),
                "top_k": torch.zeros(GEN_BATCH, dtype=torch.int32,
                                     device=dev),
                "top_p": torch.ones(GEN_BATCH, device=dev),
                "key": torch.zeros((GEN_BATCH, 2), dtype=torch.int64,
                                   device=dev),
                "regime": "greedy"}
        logits, state = engine.prefill(batch, engine.new_state(GEN_BATCH))
        ctr = torch.zeros(GEN_BATCH, dtype=torch.int32, device=dev)
        tok = engine.sample(logits, samp, ctr)
        ticks = []
        for _ in range(16):
            t = time.perf_counter()
            tok, state, ctr = engine.decode_sample(tok, state, samp, ctr)
            tok.cpu()
            ticks.append(1e3 * (time.perf_counter() - t))
        rec["decode_tick_ms"] = sorted(ticks)[len(ticks) // 2]
        rec["decode_tokens_per_s"] = GEN_BATCH * 1e3 / rec["decode_tick_ms"]
        if profile_dir:
            rec["prefill_profile"] = profile_calls(
                lambda: engine.prefill(batch, engine.new_state(GEN_BATCH)),
                Path(profile_dir), f"{cfg.name}_prefill")
            box = {"s": state, "t": tok, "c": ctr}

            def tick():
                box["t"], box["s"], box["c"] = engine.decode_sample(
                    box["t"], box["s"], samp, box["c"])
            rec["tick_profile"] = profile_calls(tick, Path(profile_dir),
                                                f"{cfg.name}_decode_tick")
        del state
        log(f"[recurrent] {arch} engine: B={GEN_BATCH}, prompt bucket "
            f"{tokens.shape[1]}: prefill {rec['prefill_ms']:.2f} ms (median "
            f"of 5); decode tick {rec['decode_tick_ms']:.2f} ms (host clock "
            f"median of 16) = {rec['decode_tokens_per_s']:.1f} tokens/s; "
            f"generate of {GEN_TOKENS} tokens "
            f"{rec['generate_tokens_per_s']:.1f} tokens/s end to end")

        # Teacher-forced prefill + 8 decode steps, and prefill + decode
        # against one forward over the same tokens (the recurrent state
        # carried across calls), each with the kernels and with their plain
        # versions, in float32 (copies of the member's weights) and in the
        # served bf16.  In float32 the two sides differ only by summation
        # order: kernels vs plain and prefill + decode vs forward must agree
        # within RECUR_FP32_ATOL at every step.  In bf16 a last-bit
        # difference flips roundings that the recurrence carries on, so
        # kernels and plain versions differ by 0.2-0.3 (the H100's runs):
        # there each bf16 path is held against the float32 run on the same
        # tokens, and the kernels' RMS error may be at most
        # BF16_WITNESS_RATIO times the plain versions'.
        teacher = torch.tensor(res.tokens, dtype=torch.int32, device=dev)
        seq = torch.from_numpy(np.random.default_rng(20 + i).integers(
            0, cfg.vocab_size, (GEN_BATCH, RECUR_FORCED_PREFIX
                                + FORCED_STEPS)).astype(np.int32)).to(dev)
        eng32 = InferenceEngine(
            build_model(dataclasses.replace(cfg, dtype="float32")),
            {k: v.float() for k, v in member.params.items()},
            max_len=GEN_MAX_LEN, max_batch=GEN_BATCH)
        runs = {}
        for eng, dtype in ((eng32, "float32"), (engine, cfg.dtype)):
            for path in ("kernels", "plain"):
                with plain_kernels() if path == "plain" else nullcontext():
                    runs[dtype, path, "forced"] = teacher_forced(
                        eng, batch, teacher)
                    runs[dtype, path, "steps"] = prefill_then_decode(
                        eng, seq, RECUR_FORCED_PREFIX, FORCED_STEPS - 1)
        with torch.no_grad():
            full = eng32.model.forward(eng32.params, {"tokens": seq})
        forward32 = [full[:, RECUR_FORCED_PREFIX - 1 + t].float().clone()
                     for t in range(FORCED_STEPS)]
        del full, eng32
        torch.cuda.empty_cache()

        f32, bf = "float32", cfg.dtype
        for key, what, got, want in (
                ("fp32_teacher_forced_max_abs_err",
                 "teacher-forced logits, kernels vs plain versions, prefill "
                 f"+ {FORCED_STEPS} decode steps",
                 runs[f32, "kernels", "forced"], runs[f32, "plain", "forced"]),
                ("fp32_prefill_decode_vs_forward_max_abs_err",
                 f"prefill of {RECUR_FORCED_PREFIX} + {FORCED_STEPS - 1} "
                 "decode steps vs one forward over the same tokens",
                 runs[f32, "kernels", "steps"], forward32)):
            errs, _, finite = step_errors(got, want)
            ok = finite and max(errs) <= RECUR_FP32_ATOL
            log(f"[recurrent] {arch} float32 {what}: max_abs_err per step "
                f"{[f'{e:.3e}' for e in errs]} (bound {RECUR_FP32_ATOL}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{arch} float32 {what}: max_abs_err "
                                f"{max(errs)}")
            rec[key] = errs
        errs, _, _ = step_errors(runs[bf, "kernels", "forced"],
                                 runs[bf, "plain", "forced"])
        log(f"[recurrent] {arch} {bf} teacher-forced logits, kernels vs "
            f"plain versions: max_abs_err per step "
            f"{[f'{e:.3e}' for e in errs]} (reported; held below against "
            f"float32)")
        rec["bf16_teacher_forced_kernels_vs_plain_max_abs_err"] = errs
        witness = {}
        for kind, what, ref in (
                ("forced", "teacher-forced", runs[f32, "plain", "forced"]),
                ("steps", "prefill + decode", forward32)):
            k_max, k_rms, finite = step_errors(runs[bf, "kernels", kind], ref)
            p_max, p_rms, _ = step_errors(runs[bf, "plain", kind], ref)
            ok = finite and k_rms <= BF16_WITNESS_RATIO * p_rms
            ratio = k_rms / p_rms if p_rms else float("nan")
            witness[kind] = {"kernels_rms": k_rms, "plain_rms": p_rms,
                             "kernels_max_abs_err": max(k_max),
                             "plain_max_abs_err": max(p_max)}
            log(f"[recurrent] {arch} {bf} {what} vs the float32 run: "
                f"kernels RMS {k_rms:.4e} (max {max(k_max):.3e}), plain "
                f"versions RMS {p_rms:.4e} (max {max(p_max):.3e}), ratio "
                f"{ratio:.3f} (bound {BF16_WITNESS_RATIO}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{arch} {bf} {what} vs float32: kernels' "
                                f"RMS error {k_rms} > {BF16_WITNESS_RATIO} x "
                                f"the plain versions' {p_rms}")
        rec["bf16_vs_fp32_witness"] = witness
        del runs, forward32

        sp = SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=7,
                            max_new_tokens=GEN_TOKENS)
        s1 = engine.generate(prompts, sampling=sp)
        s2 = engine.generate(prompts, sampling=sp)
        same = s1.tokens == s2.tokens
        log(f"[recurrent] {arch} seeded sampled run twice: "
            f"{'identical' if same else 'DIFFERENT'}; row 0 "
            f"{s1.tokens[0][:12]}...")
        if not same or any(len(t) != GEN_TOKENS for t in s1.tokens):
            failures.append(f"{arch} seeded sampled generate did not repeat")
        kernels[3 if cfg.family == "ssm" else 4]["generate"] = rec
    return engines, greedy


def recurrent_scheduler_phase(failures, kernels, engines, greedy):
    """Part 3: SchedulerService over each recurrent engine."""
    import torch
    from repro_torch.core import SchedulerService

    for arch, engine in engines.items():
        cfg = engine.model.config
        per_fwd, per_tick = recurrent_per_call(cfg)
        svc = SchedulerService(engine, num_slots=SCHED_SLOTS)
        try:
            warm_s = svc.warm()
            work = sched_workload(cfg.vocab_size, seed=1)
            s = svc.scheduler
            ticks0, fwd0, xfer0 = (s.decode_ticks, s.prefill_forwards,
                                   s.decode_transfer_bytes)
            host0, dev0 = len(s.host_ms_window), len(s.device_ms_window)
            pre0 = s.prefill_s_total
            counts_reset()
            reqs, wall = drive_service(svc, work)
            counts = counts_read()
            ticks = s.decode_ticks - ticks0
            fwds = s.prefill_forwards - fwd0
            xfer = s.decode_transfer_bytes - xfer0
            dev = sorted(s.device_ms_window[dev0:])
            host = sorted(s.host_ms_window[host0:])
            prefill_ms = 1e3 * (s.prefill_s_total - pre0) / max(fwds, 1)
        finally:
            svc.close()
        ntok = sum(len(r.output) for r in reqs)
        ttft = sorted(r.ttft_s for r in reqs)
        reasons = [r.finish_reason for r in reqs]
        if reasons != ["length"] * SCHED_REQUESTS or any(
                len(r.output) != GEN_TOKENS for r in reqs):
            failures.append(f"{arch} scheduler: reasons {reasons}")
        check_counts(failures, f"{arch} scheduler ({fwds} prefill forwards, "
                     f"{ticks} ticks)", counts,
                     add_counts(scaled(per_fwd, fwds),
                                scaled(per_tick, ticks)))
        if xfer != 4 * SCHED_SLOTS * ticks:
            failures.append(f"{arch} scheduler: transfer {xfer} bytes over "
                            f"{ticks} ticks")
        # the greedy requests against generate's greedy streams
        g_prompts = [p for p, sp in work if sp.temperature == 0]
        g_out = [r.output for r, (_, sp) in zip(reqs, work)
                 if sp.temperature == 0]
        ref = engine.generate(g_prompts, max_new_tokens=GEN_TOKENS).tokens
        div = first_divergence(ref, g_out)
        rec = {"tokens_per_s": ntok / wall, "wall_s": wall, "ticks": ticks,
               "prefill_forwards": fwds,
               "tick_decode_ms_p50": dev[len(dev) // 2],
               "tick_bookkeeping_ms_p50": host[len(host) // 2],
               "prefill_ms_mean": prefill_ms,
               "ttft_ms_p50": 1e3 * ttft[len(ttft) // 2], "warm_s": warm_s,
               "launches": counts, "greedy_first_divergence": div}
        log(f"[recurrent] {arch} scheduler: {SCHED_REQUESTS} requests, "
            f"{ntok} tokens in {wall:.2f} s = {ntok / wall:.1f} tokens/s; "
            f"{ticks} ticks, {fwds} prefill forwards; tick p50: decode call "
            f"through the ids on the host {rec['tick_decode_ms_p50']:.2f} ms "
            f"+ bookkeeping {rec['tick_bookkeeping_ms_p50']:.2f} ms; prefill "
            f"{prefill_ms:.2f} ms per forward (mean); TTFT p50 "
            f"{rec['ttft_ms_p50']:.1f} ms; warm {warm_s:.2f} s; greedy "
            f"streams vs generate's: "
            + ("identical" if div is None else
               f"first differ at request {div[0]}, token {div[1]} (the "
               f"prefill groups differ in batch bucket; reported, not "
               f"checked)"))
        kernels[3 if cfg.family == "ssm" else 4]["scheduler"] = rec
    del engines
    torch.cuda.empty_cache()


# --- phase 8: control plane ----------------------------------------------------

# The store path's depth cut: one msgpack ``bin`` holds at most 2**32 - 1
# bytes, and yi-9b's stacked w_gate at 48 layers is 4,328,521,728, so the
# JAX checkpoint format cannot hold full depth; the manifest's own
# ``num_layers`` sets 8 (3.82 GB a version).  Phases 4-6b drive 48.
STORE_LAYERS = 8
STORE_DRAFT_LAYERS = 2      # phase 8 D2: the speculative pair's draft
SWAP_PERIOD_S = 0.1         # phase 8 C: the open loop's send interval
SLO_POLICY = {"name": "gen-canary", "alias": "canary",
              "promote_to": "stable", "plane": "generate",
              "success_rate": 0.9, "max_deadline_miss_rate": 0.2,
              "fast_window_s": 30.0, "slow_window_s": 120.0,
              "burn_threshold": 2.0, "min_requests": 4,
              "qualify_window_s": 60.0}


def store_meta(seed):
    """A version's manifest fields, as the launcher writes them, plus the
    depth cut."""
    return {"reduced": False, "num_layers": STORE_LAYERS,
            "num_classes": NUM_CLASSES, "init_seed": seed,
            "max_len": GEN_MAX_LEN, "max_batch": GEN_BATCH}


def publish_version(store, name, model, seed):
    """Seeded weights on the card -> the store; (version, seconds, bytes)."""
    import torch
    params = model.init(seed, "cuda")
    torch.cuda.synchronize()
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    t = time.perf_counter()
    v = store.publish(name, params, config=ARCH, source=model.config.source,
                      meta=store_meta(seed))
    dt = time.perf_counter() - t
    del params
    torch.cuda.empty_cache()
    log(f"[store] published {name} v{v}: {nbytes / 1e9:.3f} GB in "
        f"{dt:.2f} s = {nbytes / 1e9 / dt:.2f} GB/s written (device -> "
        f"host, file, sha256 in one pass)")
    return v, dt, nbytes


def version_label(members):
    return ",".join(f"{n}@v{v}" for n, v in sorted(members.items()))


def reference_ensemble(mgr, members):
    """An Ensemble over the manager's registered tensors of ``members``
    ({name: version}), as the manager builds an alias's."""
    from repro_torch.core import Ensemble, EnsembleMember
    out = []
    for name in sorted(members):
        rm = mgr.registry.get(name, members[name])
        out.append(EnsembleMember(name, rm.meta["apply"], rm.params,
                                  rm.meta["num_classes"]))
    return Ensemble(out, max_batch=GEN_BATCH)


def min_margin(ens, batch):
    """The smallest top-two class-probability gap of any member or of the
    soft vote over the batch's rows (how near the decisions sit to a
    tie)."""
    import numpy as np
    stacked = np.stack(list(ens.probs(batch).values()))
    gaps = [np.diff(np.sort(p, -1)[:, -2:], axis=-1).min()
            for p in list(stacked) + [stacked.mean(0)]]
    return float(min(gaps))


def open_loop(send, period_s, stop):
    """Send on a fixed cadence, independent of completions, until
    ``stop`` is set; returns the futures' results."""
    futs = []
    with concurrent.futures.ThreadPoolExecutor(16) as ex:
        while not stop.is_set():
            futs.append(ex.submit(send))
            time.sleep(period_s)
    return [f.result() for f in futs]


def parse_prometheus(text):
    """Text exposition -> {sample name: value}; raises on a bad line."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("# TYPE ") \
                or line.startswith("# EXEMPLAR "):
            continue
        metric, _, value = line.rpartition(" ")
        if not metric or line.startswith("#"):
            raise ValueError(f"bad exposition line {line!r}")
        samples[metric.partition("{")[0]] = float(value)
    return samples


def json_leaves(node, name):
    """Sample names a /metrics document must render: one per numeric leaf,
    a histogram family's ``_count`` for each histogram."""
    from repro_torch.serving.telemetry import _sanitize
    if isinstance(node, dict):
        if {"le", "counts", "count", "sum"} <= set(node):
            return {f"{name}_count"}
        out = set()
        for k, v in node.items():
            out |= json_leaves(v, f"{name}_{_sanitize(k)}")
        return out
    return {name} if isinstance(node, (int, float)) else set()


def control_plane_phase(failures, kernels, profile_dir):
    """Phase 8: the control plane on store-loaded yi-9b versions at full
    width (8 layers, the manifest's depth cut)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SamplingParams, SchedulerService
    from repro_torch.launch.serve import build_store_app
    from repro_torch.models.build import build_model
    from repro_torch.serving import (FlexServeApp, FlexServeClient,
                                     FlexServeServer, ModelManager,
                                     ModelStore)
    from repro_torch.training import checkpoint

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    info = {"card": smi, "layers": STORE_LAYERS}
    kernels[0]["control_plane"] = info
    root = tempfile.mkdtemp(prefix="flexserve-store-")
    store_dir = os.path.join(root, "store")
    free = shutil.disk_usage(root).free
    cfg = dataclasses.replace(get_config(ARCH), num_layers=STORE_LAYERS)
    model = build_model(cfg)
    nbytes = sum(v.numel() * v.element_size() for v in model.like().values())
    log(f"[store] yi-9b at full width, {STORE_LAYERS} layers (the JAX "
        f"format's 4 GiB leaf limit: see STORE_LAYERS): {nbytes / 1e9:.3f} "
        f"GB a version; store under {root} ({free / 1e9:.0f} GB free)")
    if free < 4 * nbytes:
        failures.append(f"store: {free / 1e9:.1f} GB free under {root}, "
                        f"{4 * nbytes / 1e9:.1f} GB needed")
        shutil.rmtree(root, ignore_errors=True)
        return
    app = server = None
    try:
        # A. publish v1 of both members; the verify rate on one
        store = ModelStore(store_dir)
        writes = [publish_version(store, f"{ARCH}#{i}", model, i)
                  for i in range(MEMBERS)]
        info["write_gb_s"] = [b / 1e9 / s for _, s, b in writes]
        path = os.path.join(store.version_dir(f"{ARCH}#0", 1),
                            "step_0.ckpt")
        host, _ = checkpoint.restore(path, model.like())
        t = time.perf_counter()
        digest = checkpoint.param_hash(host)
        verify_s = time.perf_counter() - t
        del host
        ok = digest == store.manifest(f"{ARCH}#0", 1)["param_hash"]
        info["verify_gb_s"] = nbytes / 1e9 / verify_s
        log(f"[store] verify {ARCH}#0 v1: sha256 of {nbytes / 1e9:.3f} GB "
            f"in {verify_s:.2f} s = {info['verify_gb_s']:.2f} GB/s, "
            f"{'equal to' if ok else 'DIFFERENT from'} the manifest's")
        if not ok:
            failures.append("store: param_hash differs from the manifest")

        # B. readiness: 503 until the manager has loaded, 200 after
        mgr0 = ModelManager(store, max_batch=GEN_BATCH)
        srv0 = FlexServeServer(FlexServeApp(manager=mgr0)).start(
            wait_ready=False)
        c0 = Client(*srv0.address)
        st_before, _ = c0.call("GET", "/healthz")
        t = time.perf_counter()
        mgr0.bootstrap([f"{ARCH}#0"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
        st_after, _ = c0.call("GET", "/healthz")
        srv0.stop()
        del mgr0, srv0, c0
        gc.collect()
        torch.cuda.empty_cache()
        info["load_gb_s"] = nbytes / 1e9 / load_s
        log(f"[store] /healthz {st_before} before the manager's first load, "
            f"{st_after} after it; the load (read, verify, upload) took "
            f"{load_s:.2f} s = {info['load_gb_s']:.2f} GB/s")
        if (st_before, st_after) != (503, 200):
            failures.append(f"store: /healthz {st_before} -> {st_after}")

        # B. the store-backed app: latest versions of both members, the
        # engine plane over member 0; the SLO timer is stopped so that E
        # decides when to evaluate
        slo_path = os.path.join(root, "slo.json")
        with open(slo_path, "w") as f:
            json.dump({"policies": [SLO_POLICY]}, f)
        t = time.perf_counter()
        app = build_store_app([ARCH] * MEMBERS, store_dir, full=True,
                              max_len=GEN_MAX_LEN, num_slots=SCHED_SLOTS,
                              profile_dir=os.path.join(root, "profiles"),
                              slo_config=slo_path)
        app.slo.close()
        torch.cuda.synchronize()
        mgr = app.manager
        log(f"[store] build_store_app({[ARCH] * MEMBERS}, full=True): "
            f"{time.perf_counter() - t:.1f} s, aliases "
            f"{mgr.stats()['aliases']}, engine "
            f"{mgr.stats()['engine_aliases']}; device memory allocated "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
        log("[store] " + mgr.memory_ledger().report().replace(
            "\n", "\n[store] "))
        server = FlexServeServer(app).start(timeout=60)
        client = Client(*server.address)
        fc = FlexServeClient(*server.address, timeout=600)
        requests, k1 = drive_ensemble(failures, client, cfg.vocab_size,
                                      STORE_LAYERS, "store")
        check_member_logits(failures, app.ensemble, requests[1][1], "store")
        info["launches_ensemble"] = k1

        # C. hot swap of yi-9b#0 v1 -> v2 -> v1 under open-loop /v1/infer.
        # Every request is one full bucket (GEN_BATCH rows), so it is never
        # merged with another and its forward has the reference's shapes:
        # its decisions must equal the serving version's reference forward
        # on every row, near-ties included.
        v2, _, _ = publish_version(store, f"{ARCH}#0", model, 2)
        rng = np.random.default_rng(8)
        tokens = rng.integers(0, cfg.vocab_size, (GEN_BATCH, 64)).tolist()

        def send():
            t0 = time.perf_counter()
            st, body, rid = client.call_id(
                "POST", "/v1/infer", {"inputs": {"tokens": tokens}})
            return st, body, rid, t0, time.perf_counter()

        stop = threading.Event()
        name0 = urllib.parse.quote(f"{ARCH}#0", safe="")
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        with concurrent.futures.ThreadPoolExecutor(1) as ex:
            loop = ex.submit(open_loop, send, SWAP_PERIOD_S, stop)
            time.sleep(0.5)
            t_load = time.perf_counter()
            st_load, res_load = client.call(
                "POST", f"/v1/models/{name0}/load",
                {"version": v2, "warm": True})
            t_loaded = time.perf_counter()
            load_parts = dict(getattr(mgr.store, "last_load_ms", {}),
                              warm=res_load.get("warm_ms", 0.0))
            time.sleep(0.8)
            v2_members = {f"{ARCH}#0": v2, f"{ARCH}#1": 1}
            v2_ref = reference_ensemble(mgr, v2_members)
            st_rb, res_rb = client.call("POST",
                                        f"/v1/models/{name0}/rollback", {})
            time.sleep(0.5)
            stop.set()
            results = loop.result()
        v1_members = {f"{ARCH}#0": 1, f"{ARCH}#1": 1}
        batch = {"tokens": np.asarray(tokens, np.int32)}
        refs, margins = {}, {}
        for m, ens in ((v1_members, reference_ensemble(mgr, v1_members)),
                       (v2_members, v2_ref)):
            refs[version_label(m)] = ens.respond(batch)
            margins[version_label(m)] = min_margin(ens, batch)
        del v2_ref, ens         # nothing but the manager may hold v2 now
        st_un, res_un = client.call("POST", f"/v1/models/{name0}/unload",
                                    {"version": v2})
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        served, bad, waits = {}, [], []
        for st, body, rid, t0, t1 in results:
            tr_st, tr, _ = client.call_id("GET", f"/v1/trace/{rid}")
            label = (tr.get("attrs") or {}).get("version")
            served[label] = served.get(label, 0) + 1
            same = st == 200 and tr_st == 200 and body == refs.get(label)
            if not same:
                bad.append((st, rid, label))
            if t0 < t_loaded and t1 > t_load and tr_st == 200:
                # where a request overlapping the load waited: the
                # coalescer's queue or its (batched) forward
                spans = {}
                for sp in tr.get("spans", []):
                    spans[sp["name"]] = spans.get(sp["name"], 0.0) \
                        + sp["duration_ms"]
                waits.append((1e3 * (t1 - t0),
                              spans.get("coalesce_queue", 0.0),
                              spans.get("coalesce_forward", 0.0)))
        during = [1e3 * (t1 - t0) for _, _, _, t0, t1 in results
                  if t0 < t_loaded and t1 > t_load]
        slowest = max(waits, default=(0.0, 0.0, 0.0))
        info["swap"] = {
            "requests": len(results), "served_by": served,
            "load_to_serving_ms": 1e3 * (t_loaded - t_load),
            "max_response_ms_during_load": max(during or [0.0]),
            "max_response_ms": max(1e3 * (t1 - t0)
                                   for *_, t0, t1 in results),
            "load_parts_ms": load_parts,
            "overlapping": len(waits),
            "queue_ms_max": max((w[1] for w in waits), default=0.0),
            "forward_ms_max": max((w[2] for w in waits), default=0.0),
            "slowest_response_parts_ms": {
                "response": slowest[0], "coalesce_queue": slowest[1],
                "coalesce_forward": slowest[2]},
            "min_margin": margins,
            "memory_before_gb": mem_before / 1e9,
            "memory_after_unload_gb": mem_after / 1e9}
        log(f"[store] C: {len(results)} open-loop /v1/infer "
            f"({GEN_BATCH} rows, one every {1e3 * SWAP_PERIOD_S:.0f} ms) "
            f"across load v{v2} ({st_load}, warm "
            f"{res_load.get('warm_ms', 0):.0f} ms, drained "
            f"{res_load.get('drained')}) and rollback ({st_rb}): served by "
            f"{served}; load-to-serving {info['swap']['load_to_serving_ms']:.1f}"
            f" ms, largest response during the load "
            f"{info['swap']['max_response_ms_during_load']:.1f} ms (of all "
            f"{info['swap']['max_response_ms']:.1f} ms); every response "
            f"equal to its serving version's reference forward: "
            f"{'yes' if not bad else bad} (smallest top-two probability "
            f"gap {margins}); on {smi}")
        log(f"[store] C: the load's parts {load_parts} ms; {len(waits)} "
            f"requests overlapped it: coalesce_queue max "
            f"{info['swap']['queue_ms_max']:.1f} ms, coalesce_forward max "
            f"{info['swap']['forward_ms_max']:.1f} ms; the slowest "
            f"{info['swap']['slowest_response_parts_ms']}")
        log(f"[store] C: unload v{v2} ({st_un}): device memory allocated "
            f"{mem_before / 1e9:.3f} GB before the load, "
            f"{mem_after / 1e9:.3f} GB after the unload")
        if (st_load, st_rb, st_un) != (200, 200, 200) or bad \
                or len(served) != 2:
            failures.append(f"store C: load {st_load}, rollback {st_rb}, "
                            f"unload {st_un}, served {served}, {bad[:4]}")
        if abs(mem_after - mem_before) > 0.05 * mem_before:
            failures.append(f"store C: memory {mem_before} before the load, "
                            f"{mem_after} after unloading v{v2}")

        # D. engine swap while two streams are in flight
        svc_name = f"{ARCH}#0"
        engine_v1 = app.generation.engine_for()
        r = np.random.default_rng(9)
        dwork = [(r.integers(0, cfg.vocab_size, 40).tolist(), {}),
                 (r.integers(0, cfg.vocab_size, 90).tolist(),
                  dict(temperature=0.8, top_k=50, top_p=0.9, seed=11))]

        def references(engine):
            svc = SchedulerService(engine, num_slots=SCHED_SLOTS)
            try:
                return [svc.submit_and_wait([p], sampling=SamplingParams(
                    max_new_tokens=GEN_TOKENS, **kw)).tokens[0]
                    for p, kw in dwork]
            finally:
                svc.close()

        v1_refs = references(engine_v1)
        old_svc = app.generation.entry_for().service
        d0 = old_svc.stats()["decode"]
        counts_reset()
        firsts = [threading.Event() for _ in dwork]
        with concurrent.futures.ThreadPoolExecutor(len(dwork)) as ex:
            futs = []
            for (p, kw), ev in zip(dwork, firsts):
                futs.append(ex.submit(timed_stream, fc, p, kw, ev))
                ev.wait(300)        # prefilled alone, as the reference
            # no warm: every K1/K2 launch of this run is then a prefill
            # forward or tick of the old or the new scheduler
            t_post = time.perf_counter()
            st_eng, res_eng = client.call(
                "POST", f"/v1/engines/{name0}/load",
                {"version": v2, "warm": False})
            post_ms = 1e3 * (time.perf_counter() - t_post)
            inflight = [f.result() for f in futs]
        d1 = old_svc.stats()["decode"]
        engine_v2 = app.generation.engine_for()
        after = timed_stream(fc, dwork[0][0], dwork[0][1])
        counts = counts_read()
        d2 = app.generation.entry_for().service.stats()["decode"]
        fwds = (d1["prefill_forwards"] - d0["prefill_forwards"]
                + d2["prefill_forwards"])
        ticks = d1["ticks"] - d0["ticks"] + d2["ticks"]
        v2_refs = references(engine_v2)
        # in flight at the swap: each finished after the POST was sent
        same_inflight = [rec["tokens"] == ref and rec["t1"] > t_post
                         and (rec["done"] or {}).get("finish_reason")
                         == "length" for rec, ref in zip(inflight, v1_refs)]
        same_after = after["tokens"] == v2_refs[0]
        log(f"[store] D: engine load v{v2} ({st_eng}, {res_eng.get('engine')}"
            f", drained {res_eng.get('drained')}; the POST returned in "
            f"{post_ms:.0f} ms) with 2 streams in flight:"
            f" they finish on v1 equal to its SchedulerService."
            f"submit_and_wait bit for bit: {same_inflight}; a stream after "
            f"the flip equals v{v2}'s: {same_after}")
        check_http_counts(failures, "store D (engine swap)", counts,
                          STORE_LAYERS, fwds, ticks, paged=False)
        info["engine_swap"] = {"post_ms": post_ms,
                               "prefill_forwards": fwds, "ticks": ticks,
                               "launches": counts}
        kernels[1]["launches_control_plane"] = counts["decode_attention"]
        if st_eng != 200 or not all(same_inflight) or not same_after:
            failures.append(f"store D: {st_eng} {res_eng}, in flight "
                            f"{same_inflight}, after {same_after}")
        st_erb, res_erb = client.call("POST", f"/v1/engines/{name0}/"
                                      "rollback", {})
        if st_erb != 200 or res_erb.get("engine") != f"{svc_name}@v1":
            failures.append(f"store D: engine rollback {st_erb} {res_erb}")

        # D2. the speculative pair on the engine plane: a 2-layer draft
        # published through the store as "#draft" (its depth in the
        # manifest), loaded with v2, one stream, rolled back to v1
        draft_name = f"{ARCH}#draft"
        dparams = build_model(dataclasses.replace(
            cfg, num_layers=STORE_DRAFT_LAYERS)).init(1000, "cuda")
        vd = store.publish(draft_name, dparams, config=ARCH,
                           source=cfg.source,
                           meta={**store_meta(1000),
                                 "num_layers": STORE_DRAFT_LAYERS})
        del dparams
        st_sp, res_sp = client.call(
            "POST", f"/v1/engines/{name0}/load",
            {"version": v2, "draft": draft_name, "warm": False})
        counts_reset()
        srec = timed_stream(fc, dwork[0][0], dwork[0][1])
        counts = counts_read()
        sp_div = first_divergence([v2_refs[0]], [srec["tokens"]])
        summary = (srec["done"] or {}).get("speculation") or {}
        st_sr, res_sr = client.call("POST", f"/v1/engines/{name0}/"
                                    "rollback", {})
        log(f"[store] D2: engine load v{v2} + {draft_name} v{vd} "
            f"({STORE_DRAFT_LAYERS} layers): {st_sp}, speculative "
            f"{res_sp.get('speculative')}, draft {res_sp.get('draft')}; one "
            f"stream: {(srec['done'] or {}).get('finish_reason')}, "
            f"{len(srec['tokens'])} tokens, speculation {summary}, launches "
            f"K1 {counts['flash_attention']} K2 {counts['decode_attention']}"
            f"; against v{v2}'s non-speculative stream: "
            + ("identical" if sp_div is None else
               f"first differ at token {sp_div[1]} (reported)")
            + f"; rollback {st_sr} to {res_sr.get('engine')} (speculative "
            f"{res_sr.get('speculative')})")
        info["speculative_pair"] = {"load": res_sp.get("draft"),
                                    "summary": summary,
                                    "first_divergence": sp_div,
                                    "launches": counts}
        if (st_sp != 200 or not res_sp.get("speculative")
                or res_sp.get("draft") != f"{draft_name}@v{vd}"
                or not stream_ok(srec) or summary.get("proposed", 0) <= 0
                or st_sr != 200 or res_sr.get("speculative")
                or res_sr.get("engine") != f"{svc_name}@v1"):
            failures.append(f"store D2: load {st_sp} {res_sp.get('draft')}"
                            f", stream {srec['done']}, rollback {st_sr} "
                            f"{res_sr.get('engine')}")

        # E. canary (model and engine planes) and the autopilot
        st_c1, _ = client.call("POST", f"/v1/models/{name0}/load",
                               {"version": v2, "alias": "canary"})
        st_c2, _ = client.call("POST", f"/v1/engines/{name0}/load",
                               {"version": v2, "alias": "canary"})
        labels, statuses = {}, []
        for target in ("canary", "stable", "canary", "canary", "canary",
                       "stable"):
            for kind in ("infer", "generate"):
                body = ({"inputs": {"tokens": tokens[:2]}}
                        if kind == "infer" else
                        {"prompts": [dwork[0][0]], "max_new_tokens": 8})
                st, _, rid = client.call_id("POST", f"/v1/{kind}",
                                            dict(body, target=target))
                statuses.append(st)
                _, tr, _ = client.call_id("GET", f"/v1/trace/{rid}")
                labels.setdefault((kind, target), set()).add(
                    (tr.get("attrs") or {}).get("version"))
        decisions = app.slo.evaluate()
        st_slo, slo = client.call("GET", "/v1/slo")
        st_idx, idx = client.call("GET", "/v1/traces?limit=200")
        slo_rows = [row for row in idx.get("recent", [])
                    if row["plane"] == "slo"]
        st_en, engines = client.call("GET", "/v1/engines")
        want_labels = {
            ("infer", "canary"): {version_label({f"{ARCH}#0": v2,
                                                 f"{ARCH}#1": 1})},
            ("infer", "stable"): {version_label(v1_members)},
            ("generate", "canary"): {f"{svc_name}@v{v2}"},
            ("generate", "stable"): {f"{svc_name}@v1"}}
        promoted = (len(decisions) == 1
                    and decisions[0]["action"] == "promote"
                    and decisions[0]["engine"] == f"{svc_name}@v{v2}"
                    and engines["aliases"].get("stable")
                    == f"{svc_name}@v{v2}"
                    and any(d["trace_id"] == decisions[0]["trace_id"]
                            for d in slo.get("decisions", []))
                    and any(row["trace_id"] == decisions[0]["trace_id"]
                            and row["status"] == 200 for row in slo_rows))
        log(f"[store] E: canary loads {st_c1}/{st_c2}; per-alias versions "
            f"{ {f'{k}->{t}': sorted(v) for (k, t), v in labels.items()} };"
            f" SLOController.evaluate(): "
            f"{[(d['action'], d['engine']) for d in decisions]}; /v1/slo "
            f"{st_slo} lists {len(slo.get('decisions', []))} decision(s); "
            f"/v1/traces lists {len(slo_rows)} slo trace(s); stable engine "
            f"now {engines['aliases'].get('stable')}")
        if ((st_c1, st_c2, st_slo, st_idx, st_en) != (200,) * 5
                or set(statuses) != {200} or labels != want_labels
                or not promoted):
            failures.append(f"store E: {statuses}, {labels}, {decisions}, "
                            f"{engines}")

        # F. the traces of one infer and one generate request
        r_inf = fc.infer({"tokens": tokens[:3]})
        r_gen = fc.generate([dwork[1][0]], max_new_tokens=8)
        t_inf, t_gen = fc.trace(r_inf.trace_id), fc.trace(r_gen.trace_id)

        def names(snap):
            return ({s["name"] for s in snap["spans"]}
                    | {e["name"] for e in snap["events"]})
        want_inf = {"http_parse", "coalesce_queue", "coalesce_forward"}
        want_gen = {"http_parse", "scheduler_queued", "prefill",
                    "first_token"}
        gen_counters = {"decode_ticks", "decode_tokens", "decode_device_ms",
                        "decode_host_ms", "decode_transfer_bytes"}
        ok_f = (want_inf <= names(t_inf) and want_gen <= names(t_gen)
                and gen_counters <= set(t_gen["counters"])
                and t_inf.get("attrs", {}).get("version")
                == version_label(v1_members)
                and t_gen.get("attrs", {}).get("version")
                == f"{svc_name}@v{v2}")
        log(f"[store] F: infer trace {sorted(names(t_inf))} version "
            f"{t_inf.get('attrs', {}).get('version')}; generate trace "
            f"{sorted(names(t_gen))}, counters {t_gen['counters']}, version "
            f"{t_gen.get('attrs', {}).get('version')} "
            f"({'ok' if ok_f else 'FAIL'})")
        if not ok_f:
            failures.append(f"store F: traces {t_inf} {t_gen}")
        doc = fc.metrics()
        text = fc.metrics(format="prometheus")
        try:
            samples = parse_prometheus(text)
            missing = json_leaves(doc, "flexserve") - set(samples)
        except ValueError as e:
            samples, missing = {}, {str(e)}
        log(f"[store] F: /metrics?format=prometheus: {len(samples)} "
            f"samples, {len(text.splitlines())} lines; every numeric leaf "
            f"of /metrics is a sample: {not missing}")
        if missing or not samples:
            failures.append(f"store F: prometheus misses {sorted(missing)[:5]}")

        # G. a torch.profiler capture during a generate run
        st_p, prof = client.call("POST", "/v1/debug/profile",
                                 {"duration_ms": 1000, "mode": "torch"})
        time.sleep(0.15)
        fc.generate([p for p, _ in dwork], max_new_tokens=24)
        deadline = time.monotonic() + 300
        while True:
            _, pst = client.call("GET", "/v1/debug/profile")
            if pst.get("active") is None or time.monotonic() > deadline:
                break
            time.sleep(0.2)
        table = []
        kpath = os.path.join(prof.get("artifact", ""), "kernels.json")
        if os.path.exists(kpath):
            with open(kpath) as f:
                table = json.load(f)["kernels"]

        def device_time(names_):
            return sum(row["device_ms"] for row in table
                       if any(n in row["name"] for n in names_))
        k1_ms, k2_ms = device_time(K1_KERNELS), device_time(K2_KERNELS)
        log(f"[store] G: POST /v1/debug/profile {st_p} -> {prof.get('mode')}"
            f" capture, status {pst.get('last')}; {len(table)} device "
            f"kernels; K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms of device time; "
            f"top 5: " + "; ".join(f"{row['name'][:60]} {row['device_ms']:.3f}"
                                   f" ms x{row['calls']}"
                                   for row in table[:5]))
        info["profile"] = {"kernels": len(table), "k1_ms": k1_ms,
                           "k2_ms": k2_ms, "top5": table[:5]}
        if (st_p != 202 or not (pst.get("last") or {}).get("ok")
                or k1_ms <= 0 or k2_ms <= 0):
            failures.append(f"store G: profile {st_p} {prof} {pst}, K1 "
                            f"{k1_ms} ms, K2 {k2_ms} ms")
        fc.close()
    finally:
        if server is not None:
            server.stop()
        elif app is not None:
            app.close()
        shutil.rmtree(root, ignore_errors=True)
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[store] phase 8 in {info['seconds']:.1f} s")


# --- phase 9: the moe family (qwen3-moe, then deepseek-v3 with MLA) ---------

MOE_ARCH = "qwen3-moe-235b-a22b"
MOE_LAYERS = 8          # of 94: the width is kept, the depth cut
MLA_ARCH = "deepseek-v3-671b"
MLA_LAYERS = 4          # of 61: first_k_dense = 3 kept, one MoE layer
MLA_MAX_LEN = 512
MLA_PROMPT_MAX = 200
MEMORY_SLACK = 1 << 30  # a phase starts within 1 GiB of the baseline


def moe_config(arch, layers, **changes):
    """The published config at full width, cut to ``layers`` layers by
    ``dataclasses.replace`` (as ``launch.serve.draft_config`` cuts a
    draft)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), num_layers=layers,
                               **changes)


def moe_app(cfg, max_len, seed=0, device="cuda"):
    """The app from the port's parts: one member (seeded random weights)
    in a ``ModelRegistry`` and an ``Ensemble``, and an ``InferenceEngine``
    over the same params for the generate plane (``FlexServeApp`` puts a
    ``GenerationService`` over it)."""
    from repro_torch.core import (Ensemble, EnsembleMember, InferenceEngine,
                                  ModelRegistry)
    from repro_torch.models import build_model
    from repro_torch.serving import FlexServeApp
    model = build_model(cfg)
    params = model.init(seed, device)
    name = f"{cfg.name}#0"
    registry = ModelRegistry()
    registry.register(name, model, params)

    def apply(p, batch, _m=model):
        return _m.forward(p, batch)[:, -1, :NUM_CLASSES]

    ensemble = Ensemble([EnsembleMember(name, apply, params, NUM_CLASSES)],
                        max_batch=8)
    engine = InferenceEngine(model, params, max_len=max_len,
                             max_batch=GEN_BATCH)
    return FlexServeApp(registry, ensemble, engine, num_slots=SCHED_SLOTS)


def param_gb(params, *prefixes):
    return sum(t.numel() * t.element_size() for k, t in params.items()
               if not prefixes or k.startswith(prefixes)) / 1e9


def memory_back(failures, base_bytes, tag):
    import torch
    held = torch.cuda.memory_allocated()
    log(f"[{tag}] device memory allocated before loading {held / 1e9:.3f} "
        f"GB (baseline {base_bytes / 1e9:.3f} GB)")
    if held - base_bytes > MEMORY_SLACK:
        failures.append(f"{tag}: {held / 1e9:.3f} GB still allocated "
                        f"before loading (baseline {base_bytes / 1e9:.3f})")


class RoutingPin:
    """Records the experts every MoE call of one run chose and replays the
    choice in another run over the same tokens, so that two numerically
    different paths (kernels vs plain versions; prefill + decode vs one
    forward) are compared under one routing: a top-k near-tie that one
    path's rounding flips swaps an expert, which is another function, not
    an error of either path.  The replaying run recomputes the gate
    weights, positions and capacity from its own router.  Keys: (pass,
    MoE call, flat row) with no positions, or (MoE layer, row, absolute
    position) under ``at(positions)``; ``at`` is entered around every
    model pass.  Rows with no recorded choice (padding) route freely.
    ``flips`` counts the replayed rows whose own choice differed;
    ``dropped`` the (T, C, dropped assignments) of each recorded call."""

    def __init__(self, n_moe):
        self.n_moe = n_moe
        self.table = {}
        self._depth = 0
        self.start(replay=False)

    def start(self, replay):
        self.replay = replay
        self.passes = -1
        self.flips = self.rows = 0
        self.dropped = []
        return self

    def at(self, positions=None):
        import numpy as np
        self.positions = (None if positions is None
                          else np.asarray(positions))
        self.passes += 1
        self.calls = 0
        return self

    def __enter__(self):
        from repro_torch.models import moe
        if self._depth == 0:
            self._orig = moe.route
            moe.route = self._route
        self._depth += 1
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        self._depth -= 1
        if self._depth == 0:
            moe.route = self._orig

    def _keys(self, T):
        if self.positions is None:
            return [(self.passes, self.calls, t) for t in range(T)]
        B, S = self.positions.shape
        if B * S != T:
            raise AssertionError(f"routing pin: {T} rows, positions "
                                 f"{self.positions.shape}")
        layer = self.calls % self.n_moe
        return [(layer, b, int(self.positions[b, s]))
                for b in range(B) for s in range(S)]

    def _route(self, p, x2, cfg, *, capacity_factor=1.25):
        import torch
        from repro_torch.models import moe
        r = self._orig(p, x2, cfg, capacity_factor=capacity_factor)
        keys = self._keys(x2.shape[0])
        self.calls += 1
        top_i = r.top_i.cpu()
        if not self.replay:
            self.table.update(zip(keys, top_i))
            self.dropped.append((x2.shape[0], r.capacity,
                                 int((~r.keep).sum())))
            return r
        new = top_i.clone()
        for t, key in enumerate(keys):
            rec = self.table.get(key)
            if rec is not None:
                self.rows += 1
                self.flips += set(rec.tolist()) != set(new[t].tolist())
                new[t] = rec
        new = new.to(r.top_i.device)
        top_p = r.probs.gather(1, new)
        if cfg.moe.norm_topk_prob:
            top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True),
                                        min=1e-9)
        pos = moe._positions_in_expert(new.reshape(-1), cfg.moe.num_experts)
        return moe.Routing(r.probs, top_p, new, pos, pos < r.capacity,
                           r.capacity)


def moe_member_logits(failures, ens, tokens, tag, n_moe):
    """One batch's member logits, kernel path vs plain path on the card,
    within LOGITS_TOL under the kernel run's routing (``RoutingPin``); the
    plain path's free run (its own routing) is reported beside it."""
    import numpy as np
    import torch
    batch = {"tokens": np.asarray(tokens, np.int32)}
    pin = RoutingPin(n_moe)
    with pin.at():
        kern = ens.forward(batch)
    with plain_kernels():
        free = ens.forward(batch)
    pin.start(replay=True)
    with pin.at(), plain_kernels():
        plain = ens.forward(batch)
    out = {}
    for name in kern:
        a, b = kern[name].float(), plain[name].float()
        err = float((a - b).abs().max())
        free_err = float((a - free[name].float()).abs().max())
        ok = (tuple(a.shape) == (len(tokens), NUM_CLASSES)
              and bool(torch.isfinite(a).all())
              and torch.allclose(a, b, **LOGITS_TOL))
        log(f"[{tag}] member {name} logits {tuple(a.shape)} vs plain path "
            f"under the kernel run's routing: max_abs_err {err:.3e}, max "
            f"|logit| {float(b.abs().max()):.3f} ({'ok' if ok else 'FAIL'}); "
            f"the plain path's own routing differs in {pin.flips} of "
            f"{pin.rows} token-layer choices, max_abs_err {free_err:.3e} "
            f"(reported)")
        if not ok:
            failures.append(f"{tag}: member {name} logits vs plain: err "
                            f"{err}")
        out[name] = {"max_abs_err": err, "free_max_abs_err": free_err,
                     "flips": pin.flips, "rows": pin.rows}
    return out


def prefill_decode(engine, prompt, feed, steps, pin=None, extras=None):
    """Batch-1 prefill of ``prompt`` (with ``extras``, device tensors of
    one row, where the family takes them) and ``steps`` decode steps fed
    ``feed``; the logits of every pass (float32).  With ``pin`` the
    passes replay its routing by position."""
    import numpy as np
    import torch
    from repro_torch.core.batching import pad_sequences
    tokens, lengths = pad_sequences([prompt], engine.seq_buckets)
    dev = engine.device
    pos = np.arange(tokens.shape[1])[None]
    ctx = (pin.at(np.where(pos < len(prompt), pos, -1)) if pin
           else nullcontext())           # padding (-1) routes freely
    with ctx:
        logits, state = engine.prefill(
            {"tokens": torch.from_numpy(tokens).to(dev),
             "lengths": torch.from_numpy(lengths).to(dev), **(extras or {})},
            engine.new_state(1))
    outs = [logits[0].float()]
    for t in range(steps):
        ctx = pin.at([[len(prompt) + t]]) if pin else nullcontext()
        with ctx:
            logits, state = engine.decode(
                torch.tensor([feed[t]], dtype=torch.int32, device=dev),
                state)
        outs.append(logits[0].float())
    return outs


def forward_consistency(failures, engine, prompts, streams, n_moe, tag):
    """Prefill + FORCED_STEPS decode steps against one teacher-forced
    forward over prompt + the stream's first tokens, batch 1 and at most
    128 tokens (so every MoE call is dropless: C = T), within
    test_decode_consistency's bf16 bound 2e-2 (max|logit| + 1), with the
    forward's routing replayed by position; the free run is reported."""
    import numpy as np
    import torch
    out = []
    for i, (prompt, stream) in enumerate(zip(prompts, streams)):
        seq = prompt + stream[:FORCED_STEPS]
        if len(seq) > 128:
            raise AssertionError(f"{tag}: row {i} has {len(seq)} tokens")
        pin = RoutingPin(n_moe)
        with pin.at(np.arange(len(seq))[None]):
            full = engine.model.forward(
                engine.params, {"tokens": torch.tensor(
                    [seq], dtype=torch.int32, device=engine.device)}
            )[0].float()
        want = full[len(prompt) - 1:]
        free = prefill_decode(engine, prompt, stream, FORCED_STEPS)
        pin.start(replay=True)
        pinned = prefill_decode(engine, prompt, stream, FORCED_STEPS, pin)
        tol = 2e-2 * (float(want.abs().max()) + 1.0)
        errs = [float((g - w).abs().max()) for g, w in zip(pinned, want)]
        free_errs = [float((g - w).abs().max()) for g, w in zip(free, want)]
        ok = (all(bool(torch.isfinite(g).all()) for g in pinned)
              and max(errs) < tol)
        log(f"[{tag}] prefill ({len(prompt)} tokens) + {FORCED_STEPS} decode "
            f"steps vs one forward over {len(seq)} tokens (B=1, dropless): "
            f"max_abs_err per step {[f'{e:.3e}' for e in errs]} under the "
            f"forward's routing, bound {tol:.3e} "
            f"({'ok' if ok else 'FAIL'}); own routing: {pin.flips} of "
            f"{pin.rows} token-layer choices differ, max_abs_err "
            f"{max(free_errs):.3e} (reported)")
        if not ok:
            failures.append(f"{tag}: prefill + decode vs forward, row {i}: "
                            f"errs {errs}, bound {tol}")
        out.append({"prompt": len(prompt), "max_abs_err": max(errs),
                    "bound": tol, "free_max_abs_err": max(free_errs),
                    "flips": pin.flips, "rows": pin.rows})
    return out


def moe_profile(fn, name, out_dir, attn_names):
    """torch.profiler over one call of ``fn``: its device time, the MoE
    blocks' (a ``record_function`` range around ``moe_block``: its
    kernels' device time, the range's own device row left out of the
    total) and the attention kernels'."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import transformer
    orig = transformer.moe_block

    def traced(*a, **kw):
        with record_function("moe_block"):
            return orig(*a, **kw)
    transformer.moe_block = traced
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        transformer.moe_block = orig
    total = device_ms(prof, ()) - device_ms(prof, ("moe_block",))
    attn = device_ms(prof, attn_names)
    moe_us = 0.0
    for e in prof.events():
        if (e.name == "moe_block"
                and getattr(e, "device_type", None) == DeviceType.CPU):
            us = getattr(e, "device_time_total", None)
            moe_us += us if us is not None else e.cuda_time_total
    moe_ms = moe_us / 1e3
    share = 1 / total if total else 0.0
    log(f"[moe] {name}: device time {total:.3f} ms, MoE blocks "
        f"{moe_ms:.3f} ms ({100 * moe_ms * share:.1f}%), attention kernels "
        f"{attn:.3f} ms ({100 * attn * share:.1f}%)")
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"moe_{name.replace(' ', '_')}_profile.txt").write_text(
            prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=30))
    return {"device_ms": total, "moe_block_ms": moe_ms,
            "attention_ms": attn}


def moe_tick_profile(eng, work, name, out_dir):
    """``moe_profile`` of one decode-only scheduler tick with every slot
    live, beside the tick's host clock."""
    import torch
    from repro_torch.core import ContinuousBatchingScheduler
    s = ContinuousBatchingScheduler(eng, num_slots=SCHED_SLOTS)
    for prompt, sp in work[:SCHED_SLOTS]:
        s.submit(prompt, sampling=sp)
    s.step()
    s.step()
    torch.cuda.synchronize()
    rec = moe_profile(s.step, f"{name} tick", out_dir, K2_KERNELS)
    rec["tick_host_clock_ms"] = s.device_ms_window[-1] + s.host_ms_window[-1]
    log(f"[moe] {name} tick ({SCHED_SLOTS} live slots): host clock "
        f"{rec['tick_host_clock_ms']:.2f} ms")
    return rec


def moe_generate(failures, engine, prompts, layers, tag, k1=True,
                 extras=None, tick_layers=None):
    """A greedy ``generate`` of the prompts (GEN_TOKENS new each, with the
    numpy ``extras`` where given), counted: K1 ``layers`` per prefill and
    K2 ``tick_layers`` (default ``layers``) per tick where ``k1`` (GQA),
    no kernel at all otherwise; then prefill and tick ms.  Returns
    (result, record)."""
    import torch
    from repro_torch.core.batching import pad_sequences
    engine.generate(prompts, max_new_tokens=2,      # warm the allocator
                    extras=extras)
    torch.cuda.synchronize()
    engine.prefill_calls = engine.decode_calls = 0
    counts_reset()
    t0 = time.perf_counter()
    res = engine.generate(prompts, max_new_tokens=GEN_TOKENS, extras=extras)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = counts_read()
    pre_n, dec_n = engine.prefill_calls, engine.decode_calls
    want = dict.fromkeys(K_NAMES, 0)
    if k1:
        want["flash_attention"] = layers * pre_n
        want["decode_attention"] = (layers if tick_layers is None
                                    else tick_layers) * dec_n
    log(f"[{tag}] greedy generate of {len(prompts)} prompts: {res.steps} "
        f"steps in {1e3 * wall:.1f} ms; prefill_calls {pre_n}, decode_calls "
        f"{dec_n}; launches {n} (expected {want})")
    good = (all(len(t) == GEN_TOKENS for t in res.tokens)
            and all(0 <= x < engine.model.config.vocab_size
                    for t in res.tokens for x in t)
            and res.finish_reasons == ["length"] * len(prompts)
            and res.steps == GEN_TOKENS)
    if not good:
        failures.append(f"{tag} generate output malformed: steps "
                        f"{res.steps}, reasons {res.finish_reasons}")
    if n != want or pre_n != 1 or dec_n != res.steps - 1:
        failures.append(f"{tag} generate: launches {n}, expected {want} "
                        f"({pre_n} prefills, {dec_n} ticks)")
    tokens, lengths = pad_sequences(prompts, engine.seq_buckets)
    dev = engine.device
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "lengths": torch.from_numpy(lengths).to(dev),
             **{k: torch.from_numpy(v).to(dev)
                for k, v in (extras or {}).items()}}
    prefill_ms = host_time_ms(
        lambda: engine.prefill(batch, engine.new_state(GEN_BATCH)))
    samp = {"temperature": torch.zeros(GEN_BATCH, device=dev),
            "top_k": torch.zeros(GEN_BATCH, dtype=torch.int32, device=dev),
            "top_p": torch.ones(GEN_BATCH, device=dev),
            "key": torch.zeros((GEN_BATCH, 2), dtype=torch.int64,
                               device=dev),
            "regime": "greedy"}
    logits, state = engine.prefill(batch, engine.new_state(GEN_BATCH))
    ctr = torch.zeros(GEN_BATCH, dtype=torch.int32, device=dev)
    tok = engine.sample(logits, samp, ctr)
    ticks = []
    for _ in range(16):
        t = time.perf_counter()
        tok, state, ctr = engine.decode_sample(tok, state, samp, ctr)
        tok.cpu()
        ticks.append(1e3 * (time.perf_counter() - t))
    del state
    tick_ms = sorted(ticks)[len(ticks) // 2]
    rec = {"launches": n, "generate_wall_ms": 1e3 * wall,
           "prefill_ms": prefill_ms, "prefill_bucket": int(tokens.shape[1]),
           "decode_tick_ms": tick_ms,
           "decode_tokens_per_s": GEN_BATCH * 1e3 / tick_ms,
           "generate_tokens_per_s": len(prompts) * GEN_TOKENS / wall}
    log(f"[{tag}] B={GEN_BATCH}, prompt bucket {tokens.shape[1]}: prefill "
        f"{prefill_ms:.2f} ms (median of 5); decode tick {tick_ms:.2f} ms "
        f"(host clock median of 16, sampling and the ids' transfer "
        f"included) = {rec['decode_tokens_per_s']:.1f} tokens/s; generate "
        f"of {GEN_TOKENS} tokens {rec['generate_tokens_per_s']:.1f} tokens/s "
        f"end to end")
    return res, rec


def teacher_forced_pinned(failures, engine, prompts, teacher, n_moe, tag):
    """Phase 5's check on a MoE model: prefill + FORCED_STEPS teacher-forced
    decode steps with the kernels and with their plain versions, the plain
    run under the kernel run's routing, within LOGITS_TOL at every step."""
    import torch
    from repro_torch.core.batching import pad_sequences
    tokens, lengths = pad_sequences(prompts, engine.seq_buckets)
    dev = engine.device
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "lengths": torch.from_numpy(lengths).to(dev)}
    teacher = torch.tensor(teacher, dtype=torch.int32, device=dev)
    pin = RoutingPin(n_moe)

    def run():
        with pin.at():
            logits, state = engine.prefill(batch, engine.new_state(GEN_BATCH))
        outs = [logits.float()]
        for t in range(FORCED_STEPS):
            with pin.at():
                logits, state = engine.decode(teacher[:, t], state)
            outs.append(logits.float())
        return outs
    kern = run()
    pin.start(replay=True)
    with plain_kernels():
        plain = run()
    errs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    ok = all(bool(torch.isfinite(a).all()) and torch.allclose(
        a, b, **LOGITS_TOL) for a, b in zip(kern, plain))
    log(f"[{tag}] teacher-forced logits, kernels vs plain versions under "
        f"one routing, prefill + {FORCED_STEPS} decode steps at B="
        f"{GEN_BATCH}: max_abs_err per step {[f'{e:.3e}' for e in errs]} "
        f"({'ok' if ok else 'FAIL'}); the plain run's own routing differs "
        f"in {pin.flips} of {pin.rows} token-layer choices")
    if not ok:
        failures.append(f"{tag}: teacher-forced logits vs plain: {errs}")
    return {"max_abs_err": errs, "flips": pin.flips, "rows": pin.rows}


def moe_phase(failures, kernels, profile_dir, base_bytes):
    """Phase 9: qwen3-moe-235b-a22b at full width, 8 layers, through the
    ensemble, the engine, the dense and paged schedulers and HTTP."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (PagedInferenceEngine, SamplingParams,
                                  SchedulerService)
    from repro_torch.serving import FlexServeClient, FlexServeServer

    t_phase = time.perf_counter()
    info = {"card": nvidia_smi_line()}
    kernels[0]["qwen3_moe"] = info
    memory_back(failures, base_bytes, "moe")
    cfg = moe_config(MOE_ARCH, MOE_LAYERS)
    m = cfg.moe
    t0 = time.perf_counter()
    app = moe_app(cfg, GEN_MAX_LEN)
    torch.cuda.synchronize()
    name = f"{cfg.name}#0"
    params = app.registry.get(name).params
    engine = app.generation.engine_for()
    layers = cfg.num_layers
    sizes = {"total_gb": param_gb(params),
             "per_layer_gb": param_gb(params, "layers/") / layers,
             "experts_per_layer_gb": param_gb(params, "layers/moe/we_")
             / layers,
             "embed_head_gb": param_gb(params, "embed", "head")}
    info["config"] = {"layers": layers, "cut_from": get_config(
        MOE_ARCH).num_layers, **sizes}
    log(f"[moe] {cfg.name}: cut to {layers} of "
        f"{info['config']['cut_from']} layers (dataclasses.replace); width "
        f"kept: d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
        f"heads of {cfg.head_dim}, {m.num_experts} experts of d_ff "
        f"{m.d_ff_expert}, top-{m.top_k}, vocab {cfg.vocab_size}, "
        f"{cfg.dtype}, seed 0; {sizes['total_gb']:.2f} GB of weights "
        f"({sizes['per_layer_gb']:.3f} GB a layer, experts "
        f"{sizes['experts_per_layer_gb']:.3f}; embed and head "
        f"{sizes['embed_head_gb']:.3f}); built in "
        f"{time.perf_counter() - t0:.1f} s; allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")

    # A: /v1/infer and /v1/detect, K1 8 per forward
    server = FlexServeServer(app).start()
    client = Client(*server.address)
    try:
        requests, k1 = drive_ensemble(failures, client, cfg.vocab_size,
                                      layers, "moe", members=1)
    finally:
        stop_listener(server)
    info["launches_ensemble"] = k1
    info["member_logits"] = moe_member_logits(
        failures, app.ensemble, requests[1][1], "moe", layers)
    r = np.random.default_rng(9)
    toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (8, 256)).astype(
        np.int32)).to(engine.device)
    pin = RoutingPin(layers)
    with pin.at():
        engine.prefill({"tokens": toks, "lengths": torch.full(
            (8,), 256, dtype=torch.int32, device=engine.device)},
            engine.new_state(8))
    T, C = pin.dropped[0][:2]
    drops = [d for *_, d in pin.dropped]
    info["prefill_profile"] = moe_profile(
        lambda: engine.prefill({"tokens": toks, "lengths": torch.full(
            (8,), 256, dtype=torch.int32, device=engine.device)},
            engine.new_state(8)), "prefill B=8 S=256",
        Path(profile_dir) if profile_dir else None, K1_KERNELS)
    info["prefill_drops"] = {"T": T, "C": C, "per_layer": drops}
    log(f"[moe] one prefill at B=8, S=256: T = {T} tokens x top-{m.top_k} "
        f"= {T * m.top_k} assignments a layer, C = {C} slots per expert: "
        f"{sum(drops)} of {T * m.top_k * layers} assignments dropped "
        f"({100 * sum(drops) / (T * m.top_k * layers):.3f}%; per layer "
        f"{drops})")
    if (T, C) != (2048, 160) or len(drops) != layers:
        failures.append(f"moe prefill routing: T {T}, C {C}, {drops}")

    # B: InferenceEngine.generate, K1 8 per prefill and K2 8 per tick
    lens = r.integers(17, 301, GEN_BATCH)
    lens[0], lens[1], lens[-1] = 17, 100, 300
    prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    res, gen = moe_generate(failures, engine, prompts, layers, "moe")
    info["generate"] = gen
    gen["teacher_forced"] = teacher_forced_pinned(
        failures, engine, prompts, res.tokens, layers, "moe")
    gen["forward_consistency"] = forward_consistency(
        failures, engine, prompts[:2], res.tokens[:2], layers, "moe")

    # C: SchedulerService over the dense and the paged engine
    engines = {"dense": engine,
               "paged": PagedInferenceEngine(engine.model, params,
                                             page_size=16,
                                             max_len=GEN_MAX_LEN,
                                             max_batch=GEN_BATCH)}
    work = sched_workload(cfg.vocab_size, seed=1)
    runs, probes, ids, outs = {}, {}, {}, {}
    for kind, eng in engines.items():
        svc = SchedulerService(eng, num_slots=SCHED_SLOTS)
        try:
            warm = svc.warm()
            with LogitsProbe(eng, svc.scheduler) as probes[kind]:
                runs[kind], outs[kind] = drive_counted(
                    failures, svc, work, kind, layers, warm, 0)
            ids[kind] = runs[kind].pop("req_ids")
        finally:
            svc.close()
    div = first_divergence(outs["dense"], outs["paged"])
    log("[moe] paged vs dense streams (same prefill groups): "
        + ("identical" if div is None else
           f"first differ at request {div[0]}, token {div[1]}"))
    for k, (a, b) in enumerate(zip(outs["dense"], outs["paged"])):
        d = first_divergence([a], [b])
        if d is None:
            continue
        j = d[1]
        la = probes["dense"].get(probes["dense"].logits,
                                 (None, ids["dense"][k]), j)
        lb = probes["paged"].get(probes["paged"].logits,
                                 (None, ids["paged"][k]), j)
        if la is None or lb is None:
            failures.append(f"moe: request {k} parts at token {j} with no "
                            f"recorded logits")
            continue
        gap, close, margin, amax = logits_gap(lb, la)
        log(f"[moe] request {k} parts at token {j} ({b[j]} against {a[j]}): "
            f"paged and dense logits differ by {gap:.4e} at |logit| <= "
            f"{amax:.3f}, dense top-2 margin {margin:.4e}: "
            + ("within LOGITS_TOL" if close else "NOT within LOGITS_TOL"))
        if not close:
            failures.append(f"moe: request {k} token {j}: paged vs dense "
                            f"logits gap {gap:.4e}")
    info["scheduler"] = {"runs": runs, "first_divergence": div,
                         "ticks": {kind: moe_tick_profile(
                             eng, work, kind, Path(profile_dir)
                             if profile_dir else None)
                             for kind, eng in engines.items()}}
    kernels[1]["qwen3_moe_launches"] = runs["dense"]["launches"][
        "decode_attention"]
    kernels[2]["qwen3_moe_launches"] = runs["paged"]["launches"][
        "paged_decode_attention"]
    kernels[0]["qwen3_moe_launches"] = (
        k1 + sum(x["launches"]["flash_attention"] for x in runs.values()))
    del engines["paged"]

    # D: one seeded stream over /v1/generate == submit_and_wait
    prompt, kw = http_requests(cfg.vocab_size)[2]
    ref_svc = SchedulerService(engine, num_slots=SCHED_SLOTS)
    try:
        ref = ref_svc.submit_and_wait([prompt], sampling=SamplingParams(
            max_new_tokens=GEN_TOKENS, **kw)).tokens[0]
    finally:
        ref_svc.close()
    warm = app.generation.entry_for().service.warm()
    server = FlexServeServer(app).start(timeout=60)
    fc = FlexServeClient(*server.address, timeout=600)
    try:
        ticks0, fwds0, _ = decode_counters(fc)
        counts_reset()
        rec = timed_stream(fc, prompt, kw)
        counts = counts_read()
        ticks1, fwds1, _ = decode_counters(fc)
        check_http_counts(failures, f"moe Run D ({len(prompt)}-token "
                          f"prompt, seed {kw['seed']})", counts, layers,
                          fwds1 - fwds0, ticks1 - ticks0, paged=False)
        same = rec["tokens"] == ref
        log(f"[moe] /v1/generate stream vs SchedulerService.submit_and_wait: "
            f"{'identical' if same else 'DIFFERENT'}; TTFT "
            f"{1e3 * rec['ttft_s']:.1f} ms, total {1e3 * rec['total_s']:.1f} "
            f"ms; plane warm {warm:.1f} s")
        if not (same and stream_ok(rec)):
            failures.append(f"moe Run D: stream {rec['done']}, reference "
                            f"{ref}")
        info["http"] = {"ttft_ms": 1e3 * rec["ttft_s"],
                        "total_ms": 1e3 * rec["total_s"], "warm_s": warm}
        fc.close()
    finally:
        server.stop()
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[moe] phase 9 in {info['seconds']:.1f} s")


def mla_phase(failures, kernels, profile_dir, base_bytes):
    """Phase 9b: deepseek-v3-671b at full width, 4 layers (3 dense, 1 MoE),
    MLA, through the ensemble, the engine and the dense scheduler; no
    kernel of K1-K5 runs."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import PagedInferenceEngine, SchedulerService
    from repro_torch.serving import FlexServeServer

    t_phase = time.perf_counter()
    info = {"card": nvidia_smi_line()}
    kernels[0]["deepseek_v3"] = info
    memory_back(failures, base_bytes, "mla")
    full = get_config(MLA_ARCH)
    cfg = moe_config(MLA_ARCH, MLA_LAYERS, mtp=False)
    m, a = cfg.moe, cfg.mla
    t0 = time.perf_counter()
    app = moe_app(cfg, MLA_MAX_LEN)
    torch.cuda.synchronize()
    params = app.registry.get(f"{cfg.name}#0").params
    engine = app.generation.engine_for()
    sizes = {"total_gb": param_gb(params),
             "embed_head_gb": param_gb(params, "embed", "head"),
             "per_dense_layer_gb": param_gb(params, "dense_layers/")
             / m.first_k_dense,
             "moe_layer_gb": param_gb(params, "layers/")
             / (cfg.num_layers - m.first_k_dense)}
    info["config"] = {"layers": cfg.num_layers, "cut_from": full.num_layers,
                      "mtp": False, **sizes}
    log(f"[mla] {cfg.name}: cut to {cfg.num_layers} of {full.num_layers} "
        f"layers ({m.first_k_dense} dense, as published, and "
        f"{cfg.num_layers - m.first_k_dense} MoE), mtp off (its head serves "
        f"nothing); width kept: d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads, q/kv LoRA {a.q_lora_rank}/{a.kv_lora_rank}, rope "
        f"{a.rope_head_dim}, nope {a.nope_head_dim}, v {a.v_head_dim}, "
        f"{m.num_experts} experts of {m.d_ff_expert} + "
        f"{m.num_shared_experts} shared, top-{m.top_k}, dense d_ff "
        f"{m.d_ff_dense}, vocab {cfg.vocab_size}, {cfg.dtype}, seed 0; "
        f"{sizes['total_gb']:.2f} GB (embed and head "
        f"{sizes['embed_head_gb']:.3f}, a dense layer "
        f"{sizes['per_dense_layer_gb']:.3f}, the MoE layer "
        f"{sizes['moe_layer_gb']:.3f}); built in "
        f"{time.perf_counter() - t0:.1f} s")
    counts_reset()          # the whole MLA path: no kernel of K1-K5
    server = FlexServeServer(app).start()
    client = Client(*server.address)
    try:
        requests, _ = drive_ensemble(failures, client, cfg.vocab_size, 0,
                                     "mla", members=1)
    finally:
        stop_listener(server)
    n_moe = cfg.num_layers - m.first_k_dense
    info["member_logits"] = moe_member_logits(
        failures, app.ensemble, requests[1][1], "mla", n_moe)

    r = np.random.default_rng(11)
    lens = r.integers(17, MLA_PROMPT_MAX + 1, GEN_BATCH)
    lens[0], lens[1], lens[-1] = 17, 100, MLA_PROMPT_MAX
    prompts = [r.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    res, gen = moe_generate(failures, engine, prompts, 0, "mla", k1=False)
    info["generate"] = gen
    gen["forward_consistency"] = forward_consistency(
        failures, engine, prompts[:2], res.tokens[:2], n_moe, "mla")

    svc = SchedulerService(engine, num_slots=SCHED_SLOTS)
    try:
        warm = svc.warm()
        info["scheduler"], _ = drive_counted(
            failures, svc, sched_workload(cfg.vocab_size, seed=4), "dense",
            0, warm, 0)
        info["scheduler"].pop("req_ids")
    finally:
        svc.close()
    try:
        PagedInferenceEngine(engine.model, params, max_len=MLA_MAX_LEN,
                             max_batch=GEN_BATCH, page_size=16)
        failures.append("mla: PagedInferenceEngine accepted an MLA model")
    except ValueError as e:
        log(f"[mla] PagedInferenceEngine over {cfg.name} raises: {e}")
        if "no paged KV path" not in str(e):
            failures.append(f"mla: paged refusal {e}")
    n = counts_read()
    log(f"[mla] launches over the whole MLA path: {n} (expected 0 each)")
    if any(n.values()):
        failures.append(f"mla: kernels launched on the MLA path: {n}")
    info["launches"] = n
    app.close()
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[mla] phase 9b in {info['seconds']:.1f} s")


# --- phase 10: the modality-frontend families (vlm, encdec) ----------------

FRONTEND_SEED = 21
# per family: the extras' key, the forward's length, the prompt lengths
# and max_len (whisper's max_target_positions)
FRONTEND = {
    "llama-3.2-vision-11b": dict(tag="vlm", extra="image_embeds",
                                 fwd_len=256, prompts=(17, 300),
                                 max_len=GEN_MAX_LEN),
    "whisper-base": dict(tag="whisper", extra="frames", fwd_len=64,
                         prompts=(4, 64), max_len=448),
}


class cross_attend:
    """Within a ``with`` block, wraps ``attention.attend`` for its cross
    calls (keys of the cross length, queries of another): keeps the first
    one's projected q, k and v, and with ``fp32`` runs each in float32,
    the precision JAX's promotion gives the float32 image or audio K/V
    (the port casts them to q's dtype at K1)."""

    def __init__(self, cross_len, fp32=False):
        self.cross_len, self.fp32 = cross_len, fp32
        self.first = None

    def __enter__(self):
        from repro_torch.models import attention
        self.orig = orig = attention.attend

        def attend(p, q, k, v, cfg, **kw):
            if k.shape[1] == self.cross_len != q.shape[1]:
                if self.first is None:
                    self.first = (q, k, v)
                if self.fp32:
                    q, k, v = q.float(), k.float(), v.float()
            return orig(p, q, k, v, cfg, **kw)
        attention.attend = attend
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.attend = self.orig


def bound_use(got, want, tol):
    """The largest share of allclose's bound an element uses:
    max |got - want| / (atol + rtol |want|)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs()
                  / (tol["atol"] + tol["rtol"] * want.abs())).max())


def cross_layer_check(failures, tag, extra, qkv):
    """The first cross-attention of the forward, from its projected q, k
    and v: K1 against its plain version at the bf16 tolerance scaled to
    the output, and the other row's K/V (another input of the same scale)
    must move the output beyond that tolerance, so that a cross path
    reading the wrong input fails the first comparison."""
    import torch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    q, k, v = qkv
    k, v = k.to(q.dtype), v.to(q.dtype)
    out = flash_attention(q, k, v, causal=False).float()
    ref = flash_attention_plain(q, k, v, causal=False).float()
    other = flash_attention(q, k.roll(1, 0), v.roll(1, 0),
                            causal=False).float()
    tol = scaled_tol(str(q.dtype).split(".")[-1], ref)
    err = float((out - ref).abs().max())
    gap = float((other - out).abs().max())
    ok = (bool(torch.isfinite(out).all())
          and torch.allclose(out, ref, **tol)
          and not torch.allclose(other, out, **tol))
    log(f"[{tag}] first cross-attention of the forward, q {tuple(q.shape)} "
        f"over k/v {tuple(k.shape)}: kernel vs plain max_abs_err {err:.3e} "
        f"at max|ref| {float(ref.abs().max()):.3e} (rtol {tol['rtol']}, "
        f"atol {tol['atol']:.3e}); the other row's {extra} moves it by "
        f"{gap:.3e} ({'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append(f"{tag}: first cross-attention: err {err}, another "
                        f"{extra} moves it by {gap}, atol {tol['atol']}")
    return {"max_abs_err": err, "other_input_gap": gap, "atol": tol["atol"],
            "max_abs_ref": float(ref.abs().max())}


def frontend_counts(cfg):
    """K1 launches per forward or prefill and K2 per tick: vlm's 32 self
    layers and 8 cross blocks, each once; whisper's 6 encoder layers and
    its decoder's 6 self and 6 cross attentions (K2: the decoder's 12)."""
    if cfg.vlm:
        return cfg.num_layers, cfg.num_layers
    return cfg.encdec.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers


def range_ms(prof, name) -> float:
    """Device time (ms) of the kernels launched inside every
    ``record_function(name)`` range of a profile (the library kernels':
    a launch through the kernels' ctypes libraries is not attributed to
    the range)."""
    from torch.autograd import DeviceType
    us = 0.0
    for e in prof.events():
        if (e.name == name
                and getattr(e, "device_type", None) == DeviceType.CPU):
            t = getattr(e, "device_time_total", None)
            us += t if t is not None else e.cuda_time_total
    return us / 1e3


class cross_calls:
    """Within a ``with`` block, records for every K1 and K2 call, in call
    order, whether it attends the cross K/V (keys of the cross length) or
    the self cache, and runs ``vlm._cross_kv`` inside a ``cross_kv``
    range."""

    def __init__(self, cross_len):
        self.cross_len = cross_len
        self.k1, self.k2 = [], []

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.models import attention, vlm
        self.saved = [(m, n, getattr(m, n)) for m, n in (
            (attention, "flash_attention"), (attention, "decode_attention"),
            (vlm, "_cross_kv"))]

        def labelled(calls, fn):
            def run(q, k, *a, **kw):
                calls.append("cross" if k.shape[1] == self.cross_len
                             else "self")
                return fn(q, k, *a, **kw)
            return run

        def cross_kv(*a, **kw):
            with record_function("cross_kv"):
                return self.saved[2][2](*a, **kw)
        attention.flash_attention = labelled(self.k1, self.saved[0][2])
        attention.decode_attention = labelled(self.k2, self.saved[1][2])
        vlm._cross_kv = cross_kv
        return self

    def __exit__(self, *exc):
        for m, n, orig in self.saved:
            setattr(m, n, orig)


def kernel_ms_by_call(prof, names, labels):
    """Device time (ms) of the kernels named by ``names``, summed by the
    label of the call that launched them: the kernels in launch order,
    each call's first kernel opening it (K2's combine kernel closes the
    call its split kernel opened).  None where the kernels and the calls
    do not pair up."""
    from torch.autograd import DeviceType
    evts = sorted((e for e in prof.events()
                   if getattr(e, "device_type", None) == DeviceType.CUDA
                   and any(n in e.name for n in names)),
                  key=lambda e: e.time_range.start)
    out = dict.fromkeys(set(labels), 0.0)
    i = -1
    for e in evts:
        if "combine" not in e.name:
            i += 1
        if not 0 <= i < len(labels):
            return None
        out[labels[i]] += e.time_range.elapsed_us() / 1e3
    return out if i + 1 == len(labels) else None


def frontend_profile(engine, batch, cross_len, out_dir, tag):
    """One prefill and one tick (B = 8) under torch.profiler: kernel time
    on the device, host clock, and the device time of K1's (prefill) or
    K2's (tick) cross and self launches and of the image K/V
    projections."""
    from collections import Counter
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = engine.device
    B = batch["tokens"].shape[0]
    samp = {"temperature": torch.zeros(B, device=dev),
            "top_k": torch.zeros(B, dtype=torch.int32, device=dev),
            "top_p": torch.ones(B, device=dev),
            "key": torch.zeros((B, 2), dtype=torch.int64, device=dev),
            "regime": "greedy"}
    ctr = torch.zeros(B, dtype=torch.int32, device=dev)
    logits, state = engine.prefill(batch, engine.new_state(B))
    tok = engine.sample(logits, samp, ctr)
    tok, state, ctr = engine.decode_sample(tok, state, samp, ctr)
    torch.cuda.synchronize()
    out = {}
    calls = {"prefill": lambda: engine.prefill(batch, engine.new_state(B)),
             "tick": lambda: engine.decode_sample(tok, state, samp, ctr)}
    for name, fn in calls.items():
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t)
        with cross_calls(cross_len) as cc, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # the range's own device row and the launch queue's stalls are
        # not kernel time
        stalls = device_ms(prof, ("Command Buffer Full",))
        total = device_ms(prof, ()) - device_ms(prof, ("cross_kv",)) - stalls
        parts = {"cross_kv": range_ms(prof, "cross_kv")}
        for kname, kernels_, labels in (("k1", K1_KERNELS, cc.k1),
                                        ("k2", K2_KERNELS, cc.k2)):
            by = kernel_ms_by_call(prof, kernels_, labels)
            for which in ("cross", "self"):   # None: not paired
                parts[f"{kname}_{which}"] = (None if by is None
                                             else by.get(which, 0.0))
        rec = {"device_ms": total, "host_clock_ms": host,
               "launch_queue_full_ms": stalls,
               "k1_launches": dict(Counter(cc.k1)),
               "k2_launches": dict(Counter(cc.k2)),
               **{f"{r}_ms": v for r, v in parts.items()}}

        def part(r):
            v = parts[r]
            return ("not paired" if v is None else
                    f"{v:.3f} ms ({100 * v / max(total, 1e-9):.1f}%)")
        log(f"[{tag}] profile of one {name} (B={B}): kernel time on the "
            f"device {total:.3f} ms (launch-queue stalls {stalls:.3f} ms "
            f"left out), host clock {host:.2f} ms; K1 launches "
            f"{rec['k1_launches']}: cross {part('k1_cross')}, self "
            f"{part('k1_self')}; K2 launches {rec['k2_launches']}: cross "
            f"{part('k2_cross')}, self {part('k2_self')}; image K/V "
            f"projections {part('cross_kv')}")
        if out_dir:
            out_dir.mkdir(parents=True, exist_ok=True)
            (out_dir / f"{tag}_{name}_profile.txt").write_text(
                prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=30))
        out[name] = rec
    del state
    return out


def frontend_workload(vocab, lo, hi, seed):
    """12 requests, prompts of lo-hi tokens: even ones greedy, odd ones
    sampled (temperature 0.8, top_k 50, top_p 0.9) with consecutive seeds,
    so one ``generate`` of the sampled six draws their streams; request i
    carries image (i // 2) % 2 of the two."""
    import numpy as np
    from repro_torch.core import SamplingParams
    r = np.random.default_rng(seed)
    lens = r.integers(lo, hi + 1, SCHED_REQUESTS)
    lens[0], lens[-1] = lo, hi
    work = []
    for i, n in enumerate(lens):
        extra = ({} if i % 2 == 0 else
                 dict(temperature=0.8, top_k=50, top_p=0.9,
                      seed=FRONTEND_SEED + i // 2))
        work.append((r.integers(0, vocab, n).tolist(),
                     SamplingParams(max_new_tokens=GEN_TOKENS, **extra)))
    return work, [(i // 2) % 2 for i in range(SCHED_REQUESTS)]


def frontend_phase(failures, kernels, profile_dir, base_bytes, arch):
    """Phases 10 (llama-3.2-vision-11b) and 10b (whisper-base): full width
    and depth, bf16, seed 0, vlm's gates opened, image embeddings or frames
    from a numpy seed, through forward, ``generate`` and the dense
    ``SchedulerService``."""
    import numpy as np
    import torch
    from repro_torch.core import (InferenceEngine, PagedInferenceEngine,
                                  SamplingParams, SchedulerService,
                                  SpeculativeEngine)
    from repro_torch.core.batching import pad_sequences
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    sp = FRONTEND[arch]
    tag, extra = sp["tag"], sp["extra"]
    t_phase = time.perf_counter()
    info = {"card": nvidia_smi_line()}
    kernels[0][tag] = info
    memory_back(failures, base_bytes, tag)
    cfg = get_config(arch)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(0, "cuda")
    if cfg.vlm:     # tanh(0) would silence every cross block
        params["cross/gate_attn"].fill_(1.0)
        params["cross/gate_mlp"].fill_(1.0)
    torch.cuda.synchronize()
    k1_fwd, k2_tick = frontend_counts(cfg)
    dims = ((cfg.vlm.image_tokens, cfg.vlm.vision_dim) if cfg.vlm
            else (cfg.encdec.encoder_frames, cfg.d_model))
    info["config"] = {"layers": cfg.num_layers, "params_gb": param_gb(params),
                      "cross_len": dims[0], "extra_dim": dims[1],
                      "k1_per_forward": k1_fwd, "k2_per_tick": k2_tick}
    depth = (f"{cfg.num_layers} layers ({len(cfg.vlm.cross_attn_layers)} "
             f"cross blocks)" if cfg.vlm else
             f"{cfg.encdec.encoder_layers} encoder + {cfg.num_layers} "
             f"decoder layers")
    log(f"[{tag}] {cfg.name} at full width and depth: {depth}, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {extra} "
        f"{dims} float32, {cfg.dtype}, seed 0"
        + (", gates opened to 1" if cfg.vlm else "")
        + f"; {info['config']['params_gb']:.2f} GB of weights, built in "
        f"{time.perf_counter() - t0:.1f} s; K1 {k1_fwd} per forward, K2 "
        f"{k2_tick} per tick")
    r = np.random.default_rng(FRONTEND_SEED)
    # two images (or recordings) of one scale
    images = r.normal(0, 1, (2, *dims)).astype(np.float32)
    dev = params["embed"].device

    def rows(idx):
        return images[np.asarray(idx) % 2]

    # A: one forward, kernels vs plain versions, and another image
    S = sp["fwd_len"]
    toks = torch.from_numpy(r.integers(0, cfg.vocab_size, (
        GEN_BATCH, S)).astype(np.int32)).to(dev)
    ex = torch.from_numpy(rows(range(GEN_BATCH))).to(dev)
    with torch.no_grad():
        counts_reset()
        with cross_attend(dims[0]) as xa:
            kern = model.forward(params, {"tokens": toks, extra: ex})
        n = counts_read()
        with plain_kernels():
            plain = model.forward(params, {"tokens": toks, extra: ex})
        other = model.forward(params, {"tokens": toks,
                                       extra: ex.roll(1, 0)})
        with cross_attend(dims[0], fp32=True):
            faithful = model.forward(params, {"tokens": toks, extra: ex})
        layer = cross_layer_check(failures, tag, extra, xa.first)
    want = dict.fromkeys(K_NAMES, 0)
    want["flash_attention"] = k1_fwd
    err = float((kern.float() - plain.float()).abs().max())
    gap = float((kern.float() - other.float()).abs().max())
    use = bound_use(kern, plain, LOGITS_TOL)
    fp32_gap = float((kern.float() - faithful.float()).abs().max())
    # a kernel path that read the wrong image would be off by about gap
    ok = (tuple(kern.shape) == (GEN_BATCH, S, cfg.vocab_size)
          and bool(torch.isfinite(kern.float()).all())
          and torch.allclose(kern.float(), plain.float(), **LOGITS_TOL)
          and err <= gap / 2)
    log(f"[{tag}] forward B={GEN_BATCH} S={S}: logits {tuple(kern.shape)} vs "
        f"the plain path: max_abs_err {err:.3e} at |logit| <= "
        f"{float(plain.float().abs().max()):.3f}, {100 * use:.1f}% of "
        f"LOGITS_TOL's bound at its worst element; each row's {extra} "
        f"swapped for the other's (one scale) moves the logits by up to "
        f"{gap:.3e}, {gap / max(err, 1e-30):.2f}x the kernels' error (at "
        f"least 2x; {'ok' if ok else 'FAIL'}); launches {n} (expected "
        f"{want}); the cross-attention in float32 on the float32 {extra}'s "
        f"K/V, as JAX runs it, moves the logits by {fp32_gap:.3e}")
    if not ok:
        failures.append(f"{tag} forward vs plain: err {err}, another "
                        f"{extra} moves the logits by {gap}")
    if n != want:
        failures.append(f"{tag} forward: launches {n}, expected {want}")
    info["forward"] = {"max_abs_err": err, "image_gap": gap,
                       "logits_tol_use": use, "launches": n,
                       "fp32_cross_gap": fp32_gap, "cross_layer": layer}
    del kern, plain, other, faithful, xa

    # B: InferenceEngine.generate with extras
    lo, hi = sp["prompts"]
    lens = r.integers(lo, hi + 1, GEN_BATCH)
    lens[0], lens[1], lens[-1] = lo, (lo + hi) // 3, hi
    prompts = [r.integers(0, cfg.vocab_size, k).tolist() for k in lens]
    engine = InferenceEngine(model, params, max_len=sp["max_len"],
                             max_batch=GEN_BATCH)
    gen_ex = {extra: rows(range(GEN_BATCH))}
    res, gen = moe_generate(failures, engine, prompts, k1_fwd, tag,
                            extras=gen_ex, tick_layers=k2_tick)
    info["generate"] = gen
    tokens, lengths = pad_sequences(prompts, engine.seq_buckets)
    batch = {"tokens": torch.from_numpy(tokens).to(dev),
             "lengths": torch.from_numpy(lengths).to(dev),
             extra: torch.from_numpy(gen_ex[extra]).to(dev)}
    teacher = torch.tensor(res.tokens, dtype=torch.int32, device=dev)
    kern = teacher_forced(engine, batch, teacher)
    with plain_kernels():
        plain = teacher_forced(engine, batch, teacher)
    errs = [float((a - b).abs().max()) for a, b in zip(kern, plain)]
    ok = all(bool(torch.isfinite(a).all()) and torch.allclose(
        a, b, **LOGITS_TOL) for a, b in zip(kern, plain))
    log(f"[{tag}] teacher-forced logits, kernels vs plain versions, prefill "
        f"+ {FORCED_STEPS} decode steps at B={GEN_BATCH}: max_abs_err per "
        f"step {[f'{e:.3e}' for e in errs]} ({'ok' if ok else 'FAIL'})")
    if not ok:
        failures.append(f"{tag}: teacher-forced logits vs plain: {errs}")
    gen["teacher_forced_max_abs_err"] = errs
    del kern, plain
    consistency = []
    for i in range(2):
        prompt, stream = prompts[i], res.tokens[i]
        seq = prompt + stream[:FORCED_STEPS]
        one = {extra: torch.from_numpy(rows([i])).to(dev)}
        with torch.no_grad():
            full = model.forward(params, {"tokens": torch.tensor(
                [seq], dtype=torch.int32, device=dev), **one})[0].float()
        want_l = full[len(prompt) - 1:]
        got = prefill_decode(engine, prompt, stream, FORCED_STEPS,
                             extras=one)
        tol = 2e-2 * (float(want_l.abs().max()) + 1.0)
        e = [float((g - w).abs().max()) for g, w in zip(got, want_l)]
        ok = all(bool(torch.isfinite(g).all()) for g in got) and max(e) < tol
        log(f"[{tag}] B=1 prefill ({len(prompt)} tokens) + {FORCED_STEPS} "
            f"decode steps vs one forward over {len(seq)} tokens: max_abs_err "
            f"per step {[f'{x:.3e}' for x in e]}, bound {tol:.3e} "
            f"({'ok' if ok else 'FAIL'})")
        if not ok:
            failures.append(f"{tag}: prefill + decode vs forward, row {i}: "
                            f"errs {e}, bound {tol}")
        consistency.append({"prompt": len(prompt), "max_abs_err": max(e),
                            "bound": tol})
    gen["forward_consistency"] = consistency

    # C: the dense SchedulerService, every request with its image
    work, which = frontend_workload(cfg.vocab_size, lo, hi,
                                    FRONTEND_SEED + 1)
    greedy = [i for i in range(SCHED_REQUESTS) if i % 2 == 0]
    sampled = [i for i in range(SCHED_REQUESTS) if i % 2 == 1]
    refs, ref_rows = {}, {}
    for idx, sampling in ((greedy, None), (sampled, SamplingParams(
            max_new_tokens=GEN_TOKENS, temperature=0.8, top_k=50, top_p=0.9,
            seed=FRONTEND_SEED))):
        with LogitsProbe(engine) as gprobe:
            out = engine.generate([work[i][0] for i in idx],
                                  max_new_tokens=GEN_TOKENS,
                                  sampling=sampling, extras={
                                      extra: rows([which[i] for i in idx])})
        for row, i in enumerate(idx):
            refs[i] = out.tokens[row]
            ref_rows[i] = (gprobe, row)
    svc = SchedulerService(engine, num_slots=SCHED_SLOTS)
    try:
        with LogitsProbe(engine, svc.scheduler) as probe:
            rec, outs = drive_counted(
                failures, svc, work, f"{tag} dense", k1_fwd, 0.0, 0,
                extras=[{extra: images[w]} for w in which],
                tick_layers=k2_tick)
    finally:
        svc.close()
    ids = rec.pop("req_ids")
    parted = 0
    for k in range(SCHED_REQUESTS):
        d = first_divergence([refs[k]], [outs[k]])
        if d is None:
            continue
        parted += 1
        j = d[1]
        ls = probe.get(probe.logits, (None, ids[k]), j)
        gprobe, row = ref_rows[k]
        lg = gprobe.get(gprobe.logits, (None, row), j)
        if ls is None or lg is None:
            failures.append(f"{tag}: request {k} parts from generate's at "
                            f"token {j} with no recorded logits")
            continue
        gap, close, margin, amax = logits_gap(ls, lg)
        log(f"[{tag}] request {k} parts from generate's stream at token {j} "
            f"({outs[k][j]} against {refs[k][j]}): the two runs' logits "
            f"differ by {gap:.4e} at |logit| <= {amax:.3f}, generate's top-2 "
            f"margin {margin:.4e}: "
            + ("within LOGITS_TOL" if close else "NOT within LOGITS_TOL"))
        if not close:
            failures.append(f"{tag}: request {k} token {j}: scheduler vs "
                            f"generate logits gap {gap:.4e}")
    log(f"[{tag}] SchedulerService streams vs generate's (the same "
        f"prompts, images and seeds): {SCHED_REQUESTS - parted} of "
        f"{SCHED_REQUESTS} identical")
    rec["parted_from_generate"] = parted
    info["scheduler"] = rec
    kernels[1][f"{tag}_launches"] = rec["launches"]["decode_attention"]
    kernels[0][f"{tag}_launches"] = (
        n["flash_attention"] + rec["launches"]["flash_attention"])

    # neither family pages or speculates, in JAX or here
    for what, build in (
            ("PagedInferenceEngine", lambda: PagedInferenceEngine(
                model, params, max_len=sp["max_len"] // 16 * 16,
                max_batch=GEN_BATCH, page_size=16)),
            ("SpeculativeEngine", lambda: SpeculativeEngine(engine,
                                                            engine))):
        try:
            build()
            failures.append(f"{tag}: {what} accepted {cfg.name}")
        except ValueError as e:
            log(f"[{tag}] {what} over {cfg.name} raises: {e}")

    # D (vlm): where a prefill and a tick spend their time
    if profile_dir and cfg.vlm:
        info["profile"] = frontend_profile(engine, batch, dims[0],
                                           Path(profile_dir), tag)
    del engine, params, model
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[{tag}] phase {'10' if cfg.vlm else '10b'} in "
        f"{info['seconds']:.1f} s")


# --- phase 12: training --------------------------------------------------------

TRAIN_ARCH = "h2o-danube-1.8b"
# At danube's vocab of 32000 what a few dozen steps can learn of the
# synthetic data is the head's calibration: the loss starts at 10.78
# (ln 32000 = 10.37 plus the random head's spread), so it can fall by at
# most about 0.41.  Measured on the card (PERF.md §6): lr 1e-3 rises
# first and falls 0.14 in 30 steps, 0.29 in 60; lr 3e-4 falls 0.17 in 30
# and 0.29 in 60 steps.  100 steps at 3e-4 give the margin room.
TRAIN_STEPS = 100
TRAIN_LR = 3e-4
TRAIN_LOSS_DROP = 0.3       # tests/test_training.py::test_loss_decreases
WHISPER_TRAIN_STEPS = 4
WHISPER_TRAIN_SEQ = 64
# Phase 12 B's bounds, kernels against plain versions on one step's loss
# and every leaf's gradient (relative L2 error): bf16 at danube's full
# width and depth, and the same model on float32 copies of its weights
# (K1's float32 kernels, where only rounding differs).  Set from the
# first chip run of the unfaulted kernels (bf16: loss 8.2e-5, worst leaf
# 2.18e-2, layers/attn/wq; float32: 0 and 6.4e-6 on the CUDA-core
# kernels, 0 and 6.36e-6 on the TF32 x 3 ones) with margin, so that
# each fault of scripts/k1_bwd_fault.py fails them: the diagonal fault
# gave 0.24 (both dtypes), the Delta fault 2.24, the last-tile fault 2.8e-2
# in bf16 (within bf16's noise) and 1.8e-2 in float32.  bf16's noise
# hides a fault of that size from "rel_l2", so "ratio" holds the bf16
# kernels to the bf16 plain versions' own distance from one common
# reference, the plain float32 gradients: for every leaf, the kernels'
# relative L2 distance from it over the plain versions' distance from it.
# Unfaulted, the largest ratio was 1.0078 (layers/ln1/scale; wq 0.998 at
# 2.24e-2 from float32); the last-tile fault gave 1.269 (wq, 2.84e-2).
GRAD_BOUNDS = {"bfloat16": {"loss": 1e-3, "rel_l2": 4e-2, "ratio": 1.1},
               "float32": {"loss": 1e-5, "rel_l2": 1e-4}}


def step_counts(steps, fwd, bwd):
    want = dict.fromkeys(K_NAMES, 0)
    want["flash_attention"] = steps * fwd
    want["flash_attention_bwd"] = steps * bwd
    return want


# the leaves whose gradients come straight out of a backward kernel: K1's
# attention projections, K4's time-mix (r, k, v, decay, bonus), K5's
# Mamba-2 projections and decays
KERNEL_LEAVES = ("/attn/", "/w_r", "/w_k", "/w_v", "/dw_a2", "/first",
                 "mamba/in_proj", "mamba/a_log", "mamba/dt_bias")


def leaf_rel(got, ref):
    """Each leaf's relative L2 distance of ``got`` from ``ref``."""
    return {k: float((got[k].float() - ref[k].float()).norm()
                     / ref[k].float().norm().clamp(min=1e-30))
            for k in ref}


def step_grads(model, params, batch, plain):
    """One step's (loss, gradients, launch counts) through the kernels, or
    through the plain versions with ``plain``."""
    import torch
    from repro_torch.training import train_loop
    counts_reset()
    if plain:
        with plain_kernels():
            loss, _, grads = train_loop._grads(model, params, batch,
                                               remat=True)
    else:
        loss, _, grads = train_loop._grads(model, params, batch, remat=True)
    n = counts_read()
    torch.cuda.synchronize()
    return float(loss), grads, n


def grad_check(model, params, batch, ref, dt, tag="train B"):
    """Phase 12 B at one dtype: the loss difference and the largest
    relative L2 error of a leaf's gradient, kernels against plain versions
    on the same batch, and the kernels' launch counts.  In bf16 also each
    leaf's ratio of distances from ``ref`` (the plain float32 gradients),
    kernels over plain versions; in float32 the plain versions are ``ref``
    itself ((loss, grads))."""
    import torch
    kl, kg, n = step_grads(model, params, batch, plain=False)
    if dt == "float32":
        pl, pg = ref
    else:
        pl, pg, _ = step_grads(model, params, batch, plain=True)
    rel = leaf_rel(kg, pg)
    worst = max(rel, key=rel.get)
    out = {"loss_kernels": kl, "loss_plain": pl, "loss_diff": abs(kl - pl),
           "rel_l2_max": rel[worst], "worst_leaf": worst,
           "rel_l2_attention": {k: v for k, v in rel.items()
                                if any(p in k for p in KERNEL_LEAVES)},
           "launches": n}
    if dt != "float32":
        dk, dp = leaf_rel(kg, ref[1]), leaf_rel(pg, ref[1])
        ratio = {k: dk[k] / dp[k] if dp[k] > 0 else
                 (1.0 if dk[k] == 0 else float("inf")) for k in dk}
        top = max(ratio, key=ratio.get)
        out.update(ratio_max=ratio[top], ratio_leaf=top,
                   vs_float32={k: {"kernels": dk[k], "plain": dp[k]}
                               for k in dk if k == top or any(
                                   p in k for p in KERNEL_LEAVES)})
    log(f"[{tag}] {model.config.name} {dt}: loss kernels {kl:.6f} plain "
        f"{pl:.6f} (diff "
        f"{out['loss_diff']:.3e}); largest relative L2 gradient error "
        f"{rel[worst]:.3e} ({worst}); the leaves that feed the kernels "
        + ", ".join(f"{k} {v:.2e}" for k, v in
                    out["rel_l2_attention"].items())
        + (f"; distance from the float32 plain gradients, kernels / plain: "
           f"largest ratio {out['ratio_max']:.4f} ({out['ratio_leaf']}), "
           + ", ".join(f"{k} {v['kernels']:.3e} / {v['plain']:.3e}"
                       for k, v in out["vs_float32"].items())
           if "ratio_max" in out else "")
        + f"; launches {n}")
    del kg, pg
    return out


def gradient_phase(failures, arch=TRAIN_ARCH, bounds=None, want=None,
                   tag="train B", layers=None):
    """Phase 12 B (h2o-danube-1.8b) and 13 C (the recurrent families): the
    arch at full width and depth (the first ``layers`` layers where given:
    the init draws layer by layer, so they are the full model's first
    layers), the training phase's initial weights (seed 0) and first
    batch: one step's loss and every leaf's gradient through the kernels
    against the plain versions, on float32 copies of the weights and in
    bf16, within ``bounds`` (``GRAD_BOUNDS``), with the kernels' launches
    ``want(cfg)`` of the config as cut (K1's of one danube step by
    default); the plain float32 gradients are also the common reference
    of bf16's ratio."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import DataConfig, SyntheticLM
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    bounds = GRAD_BOUNDS if bounds is None else bounds
    want = (step_counts(1, 2 * cfg.num_layers, cfg.num_layers)
            if want is None else want(cfg))
    model = build_model(cfg)
    params = model.init(0, "cuda")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, num_dialects=1))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch_at(0).items()}
    p32 = {k: v.float() for k, v in params.items()}
    ref_loss, ref, _ = step_grads(model, p32, batch, plain=True)
    out = {}
    for dt in ("float32", "bfloat16"):
        r = grad_check(model, p32 if dt == "float32" else params, batch,
                       (ref_loss, ref), dt, tag)
        if dt == "float32":
            del p32
        gc.collect()
        torch.cuda.empty_cache()
        bound = bounds[dt]
        r["bounds"] = bound
        out[dt] = r
        if (r["loss_diff"] > bound["loss"]
                or r["rel_l2_max"] > bound["rel_l2"]
                or r.get("ratio_max", 0.0) > bound.get("ratio", 1.0)
                or r["launches"] != want):
            failures.append(f"{tag} {arch} {dt}: loss diff "
                            f"{r['loss_diff']}, rel L2 {r['rel_l2_max']} "
                            f"({r['worst_leaf']}), ratio {r.get('ratio_max')}"
                            f" ({r.get('ratio_leaf')}), bounds {bound}, "
                            f"launches {r['launches']} (expected {want})")
    del params, ref
    gc.collect()
    torch.cuda.empty_cache()
    return out


def profile_train_step(trainer, batch, out_dir, groups=None,
                       name="train_step"):
    """One more training step under torch.profiler: device time by
    kernel group (K1's forward and backward and the GEMMs unless
    ``groups`` names others) and the host clock of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.params, trainer.opt_state, m = trainer._step_fn(
            trainer.params, trainer.opt_state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
    host = 1e3 * (time.perf_counter() - t0)
    groups = groups or {"k1_forward": K1_KERNELS,
                        "k1_backward": K1_BWD_KERNELS,
                        "gemm": ("gemm", "Gemm", "sm90_xmma", "cutlass",
                                 "nvjet")}
    out = {"host_ms": host, "device_ms": device_ms(prof, ())}
    for g, names in groups.items():
        out[f"{g}_ms"] = device_ms(prof, names)
    out["other_ms"] = out["device_ms"] - sum(out[f"{g}_ms"] for g in groups)
    if out_dir:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
        (Path(out_dir) / f"{name}.txt").write_text(
            prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=40))
    log(f"[train] one {trainer.model.config.name} step under the profiler: "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def counted_step(failures, trainer, batch, arch, resident, peak):
    """Phase 14's numbers of one training run: the growth of the peak over
    what was resident before it (B), and one more, untimed step under a
    ``costs.Counter`` on the card, its flops and bytes and the kernels'
    launches as their wrappers count them where they launch (C).  Every
    wrapper call the counter saw must have launched its kernel once."""
    import torch
    from repro_torch.analysis import costs
    torch.cuda.synchronize()
    counts_reset()
    with costs.Counter() as c:
        trainer.params, trainer.opt_state, _ = trainer._step_fn(
            trainer.params, trainer.opt_state, batch)
    n = counts_read()
    calls = {k: v["calls"] for k, v in c.kernels.items()}
    out = {"measured_peak": peak - resident, "flops": c.flops,
           "bytes": c.bytes, "calls": calls,
           "launches": {k: v for k, v in n.items() if v}}
    log(f"[fits] {arch}: peak growth over the resident {resident} bytes "
        f"{out['measured_peak']} bytes; one more step under the counter: "
        f"flops {c.flops:.6e}, bytes {c.bytes:.6e}, wrapper calls {calls}, "
        f"launches {out['launches']}")
    if calls != out["launches"]:
        failures.append(f"fits C {arch}: the counter saw wrapper calls "
                        f"{calls}, the kernels launched {out['launches']}")
    return out


def training_phase(failures, kernels, profile_dir, base_bytes, fits):
    """Phase 12: h2o-danube-1.8b trained through ``launch.train`` at full
    width and depth (A), its gradients held against the plain versions
    (B), and whisper-base trained a few steps (C)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.training import (DataConfig, OptimizerConfig,
                                      SyntheticLM, Trainer, TrainerConfig,
                                      checkpoint)
    t_phase = time.perf_counter()
    info = {"card": nvidia_smi_line()}
    kernels[0]["training"] = info
    memory_back(failures, base_bytes, "train")
    root = tempfile.mkdtemp(prefix="flexserve-train-")
    try:
        # A. launch.train at full width and depth
        cfg = get_config(TRAIN_ARCH)
        layers = cfg.num_layers
        argv = ["--arch", TRAIN_ARCH, "--full", "--steps", str(TRAIN_STEPS),
                "--seq-len", str(TRAIN_SEQ), "--batch", str(TRAIN_BATCH),
                "--lr", str(TRAIN_LR), "--log-every", "1", "--ckpt-dir",
                root]
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        counts_reset()
        t0 = time.perf_counter()
        trainer, hist = launch_train.train(launch_train.parse_args(argv))
        wall = time.perf_counter() - t0
        n = counts_read()
        peak = torch.cuda.max_memory_allocated()
        want = step_counts(TRAIN_STEPS, 2 * layers, layers)
        losses = [h["loss"] for h in hist]
        step_s = np.diff([0.0] + [h["wall_s"] for h in hist])
        drop = losses[0] - losses[-1]
        nparams = sum(v.numel() for v in trainer.params.values())
        info["A"] = {"steps": TRAIN_STEPS, "seq_len": TRAIN_SEQ,
                     "batch": TRAIN_BATCH, "params": nparams,
                     "losses": losses, "loss_drop": drop,
                     "step_s_median": float(np.median(step_s[1:])),
                     "first_step_s": float(step_s[0]), "wall_s": wall,
                     "peak_memory_gb": peak / 1e9, "launches": n,
                     "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ
                     / float(np.median(step_s[1:]))}
        next(k for k in kernels if k["name"] == "flash_attention_bwd")[
            "launches"] = n["flash_attention_bwd"]
        log(f"[train] A: launch.train {' '.join(argv[:-1])} DIR: "
            f"{TRAIN_ARCH} at full width and depth ({layers} layers, "
            f"{nparams / 1e9:.3f} B params, bf16, remat, fp32 moments); "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (drop {drop:.4f}, "
            f"needed {TRAIN_LOSS_DROP}); step median "
            f"{info['A']['step_s_median']:.3f} s (first "
            f"{step_s[0]:.2f} s), {info['A']['tokens_per_s']:.0f} tokens/s; "
            f"peak memory {peak / 1e9:.2f} GB; launches {n} (expected "
            f"{want}); on {info['card']}")
        log(f"[train] A: losses {[round(x, 4) for x in losses]}")
        if n != want:
            failures.append(f"train A: launches {n}, expected {want}")
        if not (np.isfinite(losses).all() and drop >= TRAIN_LOSS_DROP):
            failures.append(f"train A: loss {losses[0]} -> {losses[-1]}")
        # the final checkpoint, restored bit for bit
        path = os.path.join(root, f"step_{TRAIN_STEPS}.ckpt")
        like = {"params/" + k: v for k, v in trainer.params.items()}
        restored, meta = checkpoint.restore(path, like, device="cuda")
        same = meta.get("step") == TRAIN_STEPS and all(
            torch.equal(restored["params/" + k], v)
            for k, v in trainer.params.items())
        info["A"]["checkpoint_bitwise"] = same
        log(f"[train] A: {path} ({os.path.getsize(path) / 1e9:.2f} GB) "
            f"restored bit for bit: {same}")
        if not same:
            failures.append("train A: the checkpoint did not restore the "
                            "trained params bit for bit")
        del restored
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH,
                                      num_dialects=1))
        batch = {k: torch.as_tensor(v, device="cuda")
                 for k, v in data.batch_at(0).items()}
        fits[TRAIN_ARCH] = counted_step(failures, trainer, batch, TRAIN_ARCH,
                                        resident, peak)
        info["profile"] = profile_train_step(
            trainer, batch, Path(profile_dir) if profile_dir else None)
        if not info["profile"]["k1_backward_ms"] > 0:
            failures.append(f"train A: the profiled device time of "
                            f"{K1_BWD_KERNELS} reads 0 in a step")

        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        # B. one step's gradients, kernels against plain versions
        info["B"] = gradient_phase(failures)

        # C. whisper-base, a few steps at full size: K1's backward on the
        # fp32 encoder (S = 1500) and bf16 cross-attention (Skv = 1500)
        wcfg = get_config("whisper-base")
        wmodel = build_model(wcfg)
        frames = np.random.default_rng(FRONTEND_SEED).normal(
            0, 1, (TRAIN_BATCH, wcfg.encdec.encoder_frames,
                   wcfg.d_model)).astype(np.float32)
        wdata = SyntheticLM(DataConfig(vocab_size=wcfg.vocab_size,
                                       seq_len=WHISPER_TRAIN_SEQ,
                                       global_batch=TRAIN_BATCH,
                                       num_dialects=1))

        def with_frames():
            for b in wdata:
                yield dict(b, frames=frames)
        wtr = Trainer(wmodel, OptimizerConfig(
            peak_lr=1e-3, warmup_steps=2, total_steps=WHISPER_TRAIN_STEPS),
            TrainerConfig(total_steps=WHISPER_TRAIN_STEPS, log_every=1),
            seed=0, device="cuda")
        counts_reset()
        t0 = time.perf_counter()
        whist = wtr.fit(with_frames(), log=lambda _: None)
        wn = counts_read()
        enc, dec = wcfg.encdec.encoder_layers, wcfg.num_layers
        # the encoder once; the decoder's self and cross twice (remat)
        wwant = step_counts(WHISPER_TRAIN_STEPS, enc + 4 * dec,
                            enc + 2 * dec)
        wl = [h["loss"] for h in whist]
        info["C"] = {"steps": WHISPER_TRAIN_STEPS, "losses": wl,
                     "launches": wn, "wall_s": time.perf_counter() - t0}
        log(f"[train] C: whisper-base at full size ({enc} + {dec} layers, "
            f"float32 frames {frames.shape}, tokens {WHISPER_TRAIN_SEQ}) "
            f"{WHISPER_TRAIN_STEPS} steps: losses "
            f"{[round(x, 4) for x in wl]}; launches {wn} (expected "
            f"{wwant}) in {info['C']['wall_s']:.1f} s")
        if wn != wwant or not np.isfinite(wl).all():
            failures.append(f"train C: launches {wn}, expected {wwant}, "
                            f"losses {wl}")
        del wtr, wmodel
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[train] phase 12 in {info['seconds']:.1f} s")


# --- phase 13: training of the recurrent families ---------------------------

RECUR_TRAIN_ARCHS = ("rwkv6-1.6b", "zamba2-2.7b")
RECUR_TRAIN_STEPS = 20
RECUR_TRAIN_LR = 3e-4
# Phase 13 C's depth: rwkv6-1.6b's first 2 of its 24 layers.  Its randomly
# initialised gradient at B=4 x 2048 grows ill-conditioned with depth:
# each K4 launch equals its plain version within 1e-6 (phase 3), yet the
# float32 kernels-vs-plain relative L2 of a step's gradients reads 1.27e-5
# at 2 layers, 7.2e-4 at 4, 8.3e-2 at 8 and 1.85 at 24 (gradient norm 2116
# at the first step), while a planted fault that drops the u bonus from dk
# reads 2.3e-2 at 2 layers, 6.9e-2 at 4 and 0.11 at 8
# (scripts/recurrent_bwd_fault.py --rwkv6-layers); only the cut depth
# tells a fault from rounding.  No kernel is needed for that growth: the
# plain float32 gradients alone move by 7.96e-6 at 2 layers, 0.120 at 8
# and 2.52 at 24 under 1e-6 noise on WKV's output, beside the kernels'
# 1.27e-5, 8.31e-2 and 1.85 (scripts/recurrent_bwd_precision.py
# --sensitivity --card); and at full depth K4's backward on each layer's
# own inputs matches its plain version (``wkv_layer_check``, within
# RECUR_BWD_REL).  zamba2's first 12 of its 54 layers (two
# applications of the shared block) keep the phase inside the script's
# time limit: at full depth its float32 gradients agree to 6.69e-5 and
# each planted K5 fault reads above 0.9, as at the cut depth.
RECUR_GRAD_LAYERS = {"rwkv6-1.6b": 2, "zamba2-2.7b": 12}
# Phase 13 C's bounds, kernels against plain versions on one step's loss
# and every leaf's gradient (relative L2), as phase 12 B's GRAD_BOUNDS:
# float32 copies of the weights, and bf16 as the ratio of each leaf's
# distance from the plain float32 gradients, kernels over plain versions.
# Set from the unfaulted readings on the card with margin (rwkv6 at 2
# layers: float32 loss 0, worst leaf 1.27e-5 (mu_mix); bf16 loss 4.1e-5,
# worst leaf 2.94e-2, largest ratio 1.0036; zamba2 at full depth: float32
# loss 9.5e-7, worst leaf 6.69e-5 (d_skip); bf16 loss 2.4e-4, worst leaf
# 0.243, largest ratio 1.066; at its first 12 layers 0, 3.70e-5 (a_log),
# 1.84e-4, 0.118, 1.07), so that each fault of
# scripts/recurrent_bwd_fault.py fails them: the u bonus dropped from dk
# 2.3e-2 in float32, dlogw's anchor 1.02 (ratio 24.9), K5's carry 0.918
# (ratio 3.66) at full depth and 1.37 (7.98) at 12 layers, dl's cross
# term 0.975 (4.16) and 1.02 (5.65).
RECUR_GRAD_BOUNDS = {
    "rwkv6-1.6b": {"bfloat16": {"loss": 1e-3, "rel_l2": 0.1, "ratio": 1.1},
                   "float32": {"loss": 1e-5, "rel_l2": 1e-4}},
    "zamba2-2.7b": {"bfloat16": {"loss": 1e-3, "rel_l2": 0.5, "ratio": 1.15},
                    "float32": {"loss": 1e-5, "rel_l2": 2e-4}},
}


def recurrent_step_counts(cfg, steps):
    """The launches of ``steps`` training steps under remat: each remat'd
    layer's kernel twice forward and once backward (rwkv6: K4 in every
    layer; zamba2: K5 in every Mamba-2 layer), zamba2's shared block (not
    remat'd, as in JAX) K1 once forward and once backward per
    application."""
    want = dict.fromkeys(K_NAMES, 0)
    L = cfg.num_layers
    if cfg.family == "ssm":
        want["wkv6"], want["wkv6_bwd"] = 2 * L * steps, L * steps
    else:
        napp = L // cfg.hybrid.shared_block_period
        want["ssd"], want["ssd_bwd"] = 2 * L * steps, L * steps
        want["flash_attention"] = napp * steps
        want["flash_attention_bwd"] = napp * steps
    return want


def recurrent_grads(failures, arch):
    """Phase 13 C for one family: ``gradient_phase`` at its depth
    (``RECUR_GRAD_LAYERS``), bounds and launch counts."""
    out = gradient_phase(failures, arch, RECUR_GRAD_BOUNDS[arch],
                         lambda cfg: recurrent_step_counts(cfg, 1),
                         "train13 C", RECUR_GRAD_LAYERS[arch])
    out["layers"] = RECUR_GRAD_LAYERS[arch]
    return out


def wkv_layer_check(failures, cfg):
    """Phase 13 C's full-depth check of K4's backward on the model's own
    activations: one float32 step of ``cfg`` (at full width and depth, A's
    initial weights and first batch) through the kernels, taking each
    ``Wkv6Fn`` backward's inputs (the saved r, k, v, logw, u, s0 and the
    cotangents) as the step hands them over; then on each layer's inputs
    the kernels' backward against the plain backward and against autograd
    of the plain forward, every gradient within RECUR_BWD_REL of its
    largest entry.  Returns the worst reading of each leaf over the
    layers."""
    import torch
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_bwd_plain, wkv6_plain
    from repro_torch.models import build_model
    from repro_torch.training import DataConfig, SyntheticLM
    model = build_model(cfg)
    params = {k: v.float() for k, v in model.init(0, "cuda").items()}
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, num_dialects=1))
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in data.batch_at(0).items()}
    taken = []
    fn = wkv_ops.Wkv6Fn
    own = fn.__dict__["backward"]

    def taking(ctx, dy, dsT):
        # a remat'd layer's saved tensors unpack once: the real backward
        # reads them from a stand-in for ctx
        saved = ctx.saved_tensors
        taken.append([t.detach().clone() for t in saved]
                     + [dy.detach().clone(),
                        None if dsT is None else dsT.detach().clone()])
        return own.__func__(types.SimpleNamespace(
            saved_tensors=saved, needs_input_grad=ctx.needs_input_grad),
            dy, dsT)
    fn.backward = staticmethod(taking)
    try:
        from repro_torch.training import train_loop
        train_loop._grads(model, params, batch, remat=True)
    finally:
        fn.backward = own
    del params, model
    gc.collect()
    if len(taken) != cfg.num_layers:
        failures.append(f"train13 C: {len(taken)} K4 backward calls taken "
                        f"in a {cfg.num_layers}-layer step")
    names = ("dr", "dk", "dv", "dlogw", "du", "ds0")
    worst = dict.fromkeys(names, 0.0)
    # autograd runs the layers backward: the first taken is the last layer
    i = len(taken)
    while taken:
        ins = taken.pop(0)
        i -= 1
        got = wkv_ops.wkv6_bwd(*ins)
        plain = wkv6_bwd_plain(*ins)
        *xs, dy, dT = ins
        leaves = [t.clone().requires_grad_(True) for t in xs]
        with torch.enable_grad():
            y, sT = wkv6_plain(*leaves)
            loss = (y * dy).sum() + (0.0 if dT is None else (sT * dT).sum())
            auto = torch.autograd.grad(loss, leaves)
        del y, sT, loss, leaves
        for want, what in ((plain, "the plain backward"),
                           (auto, "autograd of the plain forward")):
            rec = grads_check(failures, "wkv6_bwd", f"{cfg.name} layer {i} "
                              f"of {cfg.num_layers}, the step's own inputs, "
                              f"against {what}", got, want, names)
            for k, v in rec["rel_err"].items():
                worst[k] = max(worst[k], v)
        del got, plain, auto, ins
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train13] C: {cfg.name} at full depth, K4's backward on each "
        f"layer's own inputs: worst over the layers of each gradient's "
        f"largest error over its largest entry "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (bound {RECUR_BWD_REL})")
    return {"layers": cfg.num_layers, "rel_err_worst": worst,
            "bound": RECUR_BWD_REL}


def recurrent_train_phase(failures, kernels, profile_dir, base_bytes, fits):
    """Phase 13: rwkv6-1.6b and zamba2-2.7b trained through ``launch.train``
    at full width and depth (A, B), and at their initial weights and first
    batch one step's gradients through the kernels against the plain
    versions (C)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.launch import train as launch_train
    from repro_torch.training import DataConfig, SyntheticLM, checkpoint
    t_phase = time.perf_counter()
    info = {"card": nvidia_smi_line()}
    by_name = {k["name"]: k for k in kernels}
    by_name["wkv6_bwd"]["training"] = info
    groups = {"k4_forward": wkv_ops.KERNEL_NAMES,
              "k4_backward": wkv_ops.BWD_KERNEL_NAMES,
              "k5_forward": ssd_ops.KERNEL_NAMES,
              "k5_backward": ssd_ops.BWD_KERNEL_NAMES,
              "k1_forward": K1_KERNELS, "k1_backward": K1_BWD_KERNELS,
              "gemm": ("gemm", "Gemm", "sm90_xmma", "cutlass", "nvjet")}
    for part, arch in zip("AB", RECUR_TRAIN_ARCHS):
        t_part = time.perf_counter()
        memory_back(failures, base_bytes, f"train13 {arch}")
        root = tempfile.mkdtemp(prefix="flexserve-train13-")
        try:
            cfg = get_config(arch)
            argv = ["--arch", arch, "--full", "--steps",
                    str(RECUR_TRAIN_STEPS), "--seq-len", str(TRAIN_SEQ),
                    "--batch", str(TRAIN_BATCH), "--lr", str(RECUR_TRAIN_LR),
                    "--log-every", "1", "--ckpt-dir", root]
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            counts_reset()
            t0 = time.perf_counter()
            trainer, hist = launch_train.train(launch_train.parse_args(argv))
            wall = time.perf_counter() - t0
            n = counts_read()
            peak = torch.cuda.max_memory_allocated()
            want = recurrent_step_counts(cfg, RECUR_TRAIN_STEPS)
            losses = [h["loss"] for h in hist]
            step_s = np.diff([0.0] + [h["wall_s"] for h in hist])
            median = float(np.median(step_s[1:]))
            nparams = sum(v.numel() for v in trainer.params.values())
            rec = {"arch": arch, "steps": RECUR_TRAIN_STEPS,
                   "seq_len": TRAIN_SEQ, "batch": TRAIN_BATCH,
                   "layers": cfg.num_layers, "d_model": cfg.d_model,
                   "params": nparams, "losses": losses,
                   "step_s_median": median, "first_step_s": float(step_s[0]),
                   "wall_s": wall, "peak_memory_gb": peak / 1e9,
                   "launches": n,
                   "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / median}
            info[part] = rec
            bwd = "wkv6_bwd" if cfg.family == "ssm" else "ssd_bwd"
            by_name[bwd]["launches"] = n[bwd]
            by_name[bwd]["launches_per_step"] = n[bwd] // RECUR_TRAIN_STEPS
            log(f"[train13] {part}: launch.train {' '.join(argv[:-1])} DIR: "
                f"{arch} at full width and depth ({cfg.num_layers} layers, "
                f"d_model {cfg.d_model}, {nparams / 1e9:.3f} B params, bf16, "
                f"remat, fp32 moments); loss {losses[0]:.4f} -> "
                f"{losses[-1]:.4f}; step median {median:.3f} s (first "
                f"{step_s[0]:.2f} s), {rec['tokens_per_s']:.0f} tokens/s; "
                f"peak memory {peak / 1e9:.2f} GB; launches {n} (expected "
                f"{want}); on {info['card']}")
            log(f"[train13] {part}: losses {[round(x, 4) for x in losses]}")
            if n != want:
                failures.append(f"train13 {part}: launches {n}, expected "
                                f"{want}")
            if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
                failures.append(f"train13 {part}: loss {losses[0]} -> "
                                f"{losses[-1]}")
            path = os.path.join(root, f"step_{RECUR_TRAIN_STEPS}.ckpt")
            like = {"params/" + k: v for k, v in trainer.params.items()}
            restored, meta = checkpoint.restore(path, like, device="cuda")
            same = meta.get("step") == RECUR_TRAIN_STEPS and all(
                torch.equal(restored["params/" + k], v)
                for k, v in trainer.params.items())
            rec["checkpoint_bitwise"] = same
            log(f"[train13] {part}: {path} ({os.path.getsize(path) / 1e9:.2f}"
                f" GB) restored bit for bit: {same}")
            if not same:
                failures.append(f"train13 {part}: the checkpoint did not "
                                f"restore the trained params bit for bit")
            del restored, like
            data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=TRAIN_SEQ,
                                          global_batch=TRAIN_BATCH,
                                          num_dialects=1))
            batch = {k: torch.as_tensor(v, device="cuda")
                     for k, v in data.batch_at(0).items()}
            fits[arch] = counted_step(failures, trainer, batch, arch,
                                      resident, peak)
            rec["profile"] = profile_train_step(
                trainer, batch, Path(profile_dir) if profile_dir else None,
                groups, arch)
            kname = "k4" if cfg.family == "ssm" else "k5"
            if not (rec["profile"][f"{kname}_forward_ms"] > 0
                    and rec["profile"][f"{kname}_backward_ms"] > 0):
                failures.append(f"train13 {part}: the profiled device time "
                                f"of {kname}'s kernels reads 0 in a step")
            del trainer, batch
        finally:
            shutil.rmtree(root, ignore_errors=True)
            gc.collect()
            torch.cuda.empty_cache()
        info[part]["seconds"] = time.perf_counter() - t_part
        log(f"[train13] {part}: {arch} in {info[part]['seconds']:.1f} s "
            f"(training, checkpoint, restore, profiled step)")
    # C. one step's gradients, kernels against plain versions
    info["C"] = {}
    for arch in RECUR_TRAIN_ARCHS:
        t0 = time.perf_counter()
        info["C"][arch] = recurrent_grads(failures, arch)
        if arch == "rwkv6-1.6b":
            info["C"][arch]["full_depth_layers"] = wkv_layer_check(
                failures, get_config(arch))
        info["C"][arch]["seconds"] = time.perf_counter() - t0
        log(f"[train13] C: {arch} in {info['C'][arch]['seconds']:.1f} s")
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[train13] phase 13 in {info['seconds']:.1f} s")


# --- phase 14: what fits one card ---------------------------------------------

TRAIN_SHAPE = (f"train_b{TRAIN_BATCH}x{TRAIN_SEQ}", TRAIN_SEQ, TRAIN_BATCH,
               "train")         # phases 12 A and 13 A, B
# the meta pass's peak against the card's, either way: every reading of
# the five (chip_smoke.py's runs on the H100) sat within 0.01%
FIT_TOL = 0.005
FLOPS_TOL = 0.005       # a counted step on the card against the meta pass
BYTES_TOL = 0.02
# A's worker processes: every core but the one that runs B's passes
SWEEP_JOBS = max(1, min(8, len(os.sched_getaffinity(0)) - 1))
SWEEP_TIMEOUT_S = 300


def plans():
    """Phase 14 B's and C's steps: (name, arch, InputShape, max_len), each
    under the flags its phase ran with (fp32 moments; the port's defaults
    otherwise)."""
    from repro_torch.configs import InputShape
    from repro_torch.core.batching import BucketSpec
    bucket = BucketSpec.pow2(GEN_MAX_LEN, min_size=16).bucket_for(
        GEN_PROMPT_MAX)
    return ([(arch, arch, InputShape(*TRAIN_SHAPE), None)
             for arch in (TRAIN_ARCH, *RECUR_TRAIN_ARCHS)]
            + [(f"{ARCH} prefill", ARCH,
                InputShape("engine_prefill", bucket, GEN_BATCH, "prefill"),
                GEN_MAX_LEN),
               (f"{ARCH} tick", ARCH,
                InputShape("engine_tick", GEN_MAX_LEN, GEN_BATCH, "decode"),
                GEN_MAX_LEN)])


def fit_check(failures, what, predicted, measured):
    """One of phase 14 B's comparisons: the meta pass's bytes against the
    card's, within FIT_TOL either way."""
    ratio = predicted / measured if measured else float("inf")
    ok = abs(ratio - 1) <= FIT_TOL
    log(f"[fits] B: {what}: dry-run {predicted} bytes "
        f"({predicted / 2 ** 30:.3f} GiB), card {measured} bytes "
        f"({measured / 2 ** 30:.3f} GiB): {ratio:.4f}x "
        f"({'within' if ok else 'OUTSIDE'} {FIT_TOL:.1%})")
    if not ok:
        failures.append(f"fits B {what}: dry-run {predicted} bytes against "
                        f"the card's {measured} ({ratio:.4f}x)")
    return {"predicted": predicted, "measured": measured, "ratio": ratio}


def fits_phase(failures, kernels, fits):
    """Phase 14: what fits one card.  A: the dry-run's sweep over every
    (arch x shape) in worker processes and its roofline table; B: the meta
    pass's peak bytes against the card's for the training runs of phases
    12 and 13 and the yi-9b prefill and tick of phase 5; C: the counted
    training steps' flops, bytes and launches against the meta pass of the
    same step.  It runs after every timed phase, so that its CPU work
    shares the host with none of them."""
    import shutil
    import tempfile
    import torch
    from repro_torch import opt
    from repro_torch.analysis import roofline
    from repro_torch.configs import ASSIGNED_ARCHS, SHAPES
    from repro_torch.launch import dryrun
    t_phase = time.perf_counter()
    info = {"card": nvidia_smi_line(),
            "total_memory": torch.cuda.get_device_properties(0).total_memory}
    kernels[0]["fits"] = info
    log(f"[fits] the card's memory: {info['total_memory']} bytes "
        f"(roofline.HBM_BYTES {roofline.HBM_BYTES}); on {info['card']}")
    if info["total_memory"] != roofline.HBM_BYTES:
        log("[fits] the card reports another memory size than "
            "roofline.HBM_BYTES: 'fits' is judged against the constant")
    tmp = Path(tempfile.mkdtemp(prefix="flexserve-dryrun-"))
    try:
        # A's sweep: a meta-device pass needs no card, so none is visible
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
        with open(tmp / "sweep.log", "w") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                 "--jobs", str(SWEEP_JOBS), "--out", str(tmp / "records")],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)
            try:
                # B's and C's plans, here meanwhile
                planned = {}
                with opt.flags(opt_bf16_moments=False):
                    for name, arch, shape, max_len in plans():
                        planned[name] = (shape, dryrun.run_one(
                            arch, shape, max_len=max_len, verbose=False))
                info["plans_s"] = time.perf_counter() - t_phase
                try:
                    rc = proc.wait(timeout=SWEEP_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    rc = None
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        tail = (tmp / "sweep.log").read_text().splitlines()[-3:]
        records = (roofline.load_results(str(tmp / "records"))
                   if (tmp / "records").is_dir() else [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # A. the sweep
    status = {(r["arch"], r["shape"]): r["status"] for r in records}
    ok = [r for r in records if r["status"] == "ok"]
    want = len(ASSIGNED_ARCHS) * len(SHAPES)
    skipped = [k for k, v in status.items() if v == "skipped"]
    bad = [r for r in ok if not (r["cost"]["flops"] > 0
                                 and r["memory"]["argument_bytes"] > 0)]
    info["A"] = {"rc": rc, "seconds": time.perf_counter() - t_phase,
                 "jobs": SWEEP_JOBS, "ok": len(ok), "skipped": skipped,
                 "trace_s": sum(r["trace_s"] for r in ok)}
    log(f"[fits] A: python -m repro_torch.launch.dryrun --all --jobs "
        f"{SWEEP_JOBS} (no card visible): exit {rc} in "
        f"{info['A']['seconds']:.1f} s, {len(ok)} ok, skipped {skipped}, of "
        f"{want} combos; {info['A']['trace_s']:.1f} s of meta passes; its "
        f"last lines {tail}")
    if (rc != 0 or len(status) != want or len(ok) != want - 1
            or skipped != [("whisper-base", "long_500k")] or bad):
        failures.append(f"fits A: the dry-run sweep: exit {rc}, {len(ok)} "
                        f"ok of {want}, skipped {skipped}, without flops or "
                        f"arguments {[(r['arch'], r['shape']) for r in bad]}")
    rows = [roofline.analyze(r) for r in ok]
    for line in roofline.table(rows).splitlines():
        log(f"[fits] A: {line}")
    info["A"]["rows"] = {f"{r.arch} {r.shape}": {
        "gib": r.bytes_per_chip / 2 ** 30, "fits": r.fits_hbm,
        "dominant": r.dominant, "useful": r.useful_ratio} for r in rows}
    fitting = [f"{r.arch} {r.shape} ({r.dominant})" for r in rows
               if r.fits_hbm]
    log(f"[fits] A: fit one card ({roofline.HBM_BYTES / 2 ** 30:.2f} GiB): "
        f"{len(fitting)} of {len(rows)}: {', '.join(fitting)}")

    # B and C. the meta pass of each measured step
    info["B"], info["C"] = {}, {}
    for arch in (TRAIN_ARCH, *RECUR_TRAIN_ARCHS):
        got = fits.get(arch)
        if got is None or arch not in planned:
            failures.append(f"fits: no measurement or plan of {arch}'s "
                            f"training")
            continue
        rec = planned[arch][1]
        info["B"][arch] = fit_check(
            failures, f"{arch} training (B={TRAIN_BATCH} x {TRAIN_SEQ}, "
            f"remat, fp32 moments): the peak",
            rec["memory"]["peak_bytes"], got["measured_peak"])
        info["B"][arch]["meta_trace_s"] = rec["trace_s"]
        df = got["flops"] / rec["cost"]["flops"] - 1
        db = got["bytes"] / rec["cost"]["bytes_accessed"] - 1
        planned_calls = {k: v["calls"] for k, v in rec["kernels"].items()}
        info["C"][arch] = {"flops": [rec["cost"]["flops"], got["flops"]],
                           "bytes": [rec["cost"]["bytes_accessed"],
                                     got["bytes"]],
                           "planned_calls": planned_calls,
                           "launches": got["launches"]}
        c_ok = (abs(df) <= FLOPS_TOL and abs(db) <= BYTES_TOL
                and planned_calls == got["launches"])
        log(f"[fits] C: {arch}: one step counted on the card against "
            f"the meta pass: flops {got['flops']:.6e} / "
            f"{rec['cost']['flops']:.6e} ({df:+.4%}), bytes "
            f"{got['bytes']:.6e} / {rec['cost']['bytes_accessed']:.6e} "
            f"({db:+.4%}), launches on the card {got['launches']} / "
            f"calls planned {planned_calls} ({'ok' if c_ok else 'OUTSIDE'} "
            f"{FLOPS_TOL:.1%} / {BYTES_TOL:.0%})")
        if not c_ok:
            failures.append(f"fits C {arch}: flops {df:+.4%}, bytes "
                            f"{db:+.4%}, launches {got['launches']} vs "
                            f"planned calls {planned_calls}")
    yi = fits.get(ARCH)
    if yi is None:
        failures.append("fits: no measurement of the yi-9b engine")
    else:
        for kind in ("prefill", "tick"):
            shape, rec = planned.get(f"{ARCH} {kind}", (None, None))
            if rec is None or (kind == "prefill"
                               and shape.seq_len != yi["bucket"]):
                failures.append(f"fits: the yi-9b {kind}'s plan {shape} "
                                f"is not phase 5's (bucket {yi['bucket']})")
                continue
            mem = rec["memory"]
            info["B"][f"{ARCH} {kind}"] = fit_check(
                failures, f"{ARCH} {kind} (B={GEN_BATCH}, "
                f"{shape.seq_len if kind == 'prefill' else 1} tokens a row, "
                f"max_len {GEN_MAX_LEN}): the growth over the resident "
                f"params, state and batch",
                mem["peak_bytes"] - mem["argument_bytes"], yi[kind])
    info["seconds"] = time.perf_counter() - t_phase
    log(f"[fits] phase 14 in {info['seconds']:.1f} s (B's and C's plans "
        f"{info['plans_s']:.1f} s, beside the sweep)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="also profile one ensemble forward, one decode "
                         "tick, one dense and one paged scheduler tick, "
                         "one recurrent ensemble forward, a prefill and "
                         "a tick of rwkv6 and zamba2, qwen3-moe's "
                         "prefill and ticks, and a llama-3.2-vision "
                         "prefill and tick with torch.profiler and write "
                         "the tables under DIR")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi_line()
    log(f"[device] {torch.cuda.get_device_name(0)}; {smi}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from repro_torch.kernels import common
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_block import ops as fb_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    t0 = time.perf_counter()
    builds = (fa_ops.build, fa_ops.build_bwd, da_ops.build, wkv_ops.build,
              ssd_ops.build, wkv_ops.build_bwd, ssd_ops.build_bwd,
              fb_ops.build, bf16_p_library)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as ex:
        for fut in [ex.submit(b) for b in builds]:    # one nvcc each
            fut.result()
    log(f"[build] kernels built in {time.perf_counter() - t0:.1f}s")
    for name, rec in common.build_log.items():
        log(f"[build] {name}: {rec['seconds']:.1f}s -> {rec['library']}")
        entry = ""
        for line in str(rec["ptxas"]).splitlines():
            if "Compiling entry" in line:       # the mangled template args
                m = re.search(r"(\w+_kernel)I(\w*?)EEv", line)
                # a plain function: its length-prefixed name
                plain = [c.group(2) for c in re.finditer(
                    r"(?=(\d+)(\w+?_kernel)E)", line)
                    if len(c.group(2)) == int(c.group(1))]
                entry = (f"{m.group(1)}<{m.group(2)}>" if m else
                         plain[0] if plain else line)
            elif "registers" in line or "spill" in line:
                log(f"[build]   {entry}: {line.split(':', 1)[-1].strip()}")

    failures = []
    fits = {}
    # the products: wgmma in K1 and its backward; mma.sync in K2/K3 (bf16),
    # K4, K5 and their backward (TF32)
    sass, spills = {}, {}
    for name, op in (("flash_attention", "HGMMA"),
                     ("flash_attention_bwd", "HGMMA"),
                     ("decode_attention", "HMMA"), ("rwkv6_wkv", "HMMA"),
                     ("mamba2_ssd", "HMMA"), ("rwkv6_wkv_bwd", "HMMA"),
                     ("mamba2_ssd_bwd", "HMMA")):
        sass[name] = sass_counts(str(common.build_log[name]["library"]))
        spills[name] = ptxas_spills(str(common.build_log[name]["ptxas"]))
        log(f"[build] {name} SASS tensor-core instructions: "
            f"{sass[name] or 'cuobjdump not found'}; ptxas spill bytes over "
            f"its kernels: {spills[name]}")
        if sass[name] and not sass[name][op]:
            failures.append(f"{name}: no {op} in its SASS")
    for name, names in TF32_KERNELS.items():
        if sass[name] and not sass[name]["HMMA"]:
            failures.append(f"{name}: no HMMA (its TF32 x 3 kernels) in its "
                            f"SASS")
        tf32 = entry_spills(str(common.build_log[name]["ptxas"]), names)
        log(f"[build] {name} float32 tensor-core kernels' spill bytes: "
            f"{tf32}")
        if len(tf32) != 4 * len(names) or any(tf32.values()):
            failures.append(f"{name}: TF32 x 3 kernels' spills {tf32} (one "
                            f"entry per head dim 64, 80, 96, 128 expected)")
    spills["fused_block"] = ptxas_spills(
        str(common.build_log["fused_block"]["ptxas"]))
    log(f"[build] fused_block ptxas spill bytes over its kernels: "
        f"{spills['fused_block']}")
    for name in ("rwkv6_wkv_bwd", "mamba2_ssd_bwd", "fused_block"):
        if any(spills[name].values()):
            failures.append(f"{name}: ptxas spills {spills[name]}")
    # ptxas serialises a wgmma whose registers it cannot keep in flight: a
    # design failure in K1's backward (its CUDA-core kernels have no wgmma,
    # so any such line is from a tensor-core instantiation)
    for name in ("flash_attention", "flash_attention_bwd"):
        for line in str(common.build_log[name]["ptxas"]).splitlines():
            if "wgmma" in line and "serialized" in line:
                log(f"[build] {name} ptxas: {line.strip()}")
                if name == "flash_attention_bwd":
                    failures.append(f"{name}: ptxas serialised a wgmma: "
                                    f"{line.strip()}")
    t_start = time.perf_counter()
    clock = [t_start]

    def lap(name):
        now = time.perf_counter()
        log(f"[timing] {name} in {now - clock[0]:.1f} s ({now - t_start:.1f} "
            f"s since the build)")
        clock[0] = now

    kernels = kernel_phase(failures)
    lap("phase 3, K1")
    kernels += decode_kernel_phase(failures)
    lap("phase 3, K2")
    kernels += paged_decode_kernel_phase(failures)
    lap("phase 3, K3")
    p_split_phase(failures, kernels)
    lap("phase 3, K2/K3 with P as hi + lo parts against P in bf16")
    kernels += wkv_kernel_phase(failures) + ssd_kernel_phase(failures)
    lap("phase 3, K4 and K5")
    kernels.append(bwd_kernel_phase(failures))
    lap("phase 3, K1's backward")
    kernels += [wkv_bwd_kernel_phase(failures),
                ssd_bwd_kernel_phase(failures)]
    lap("phase 3, K4's and K5's backward")
    libs = ("flash_attention", "decode_attention", "decode_attention",
            "rwkv6_wkv", "mamba2_ssd", "flash_attention_bwd",
            "rwkv6_wkv_bwd", "mamba2_ssd_bwd")
    if len(kernels) != len(libs):
        failures.append(f"{len(kernels)} kernels-line entries for "
                        f"{len(libs)} libraries")
    for entry, lib in zip(kernels, libs):
        entry["sass"] = sass[lib]
        entry["spill_bytes"] = spills[lib]
    base_bytes = torch.cuda.memory_allocated()
    app = main_path_phase(failures, kernels, args.profile)
    lap("phase 4")
    block = block_kernel_phase(failures)
    block.update(block_forward_phase(
        failures, app.ensemble,
        app.registry.get(f"{ARCH}#0").model.config.num_layers))
    kernels.append({"name": "fused_block", **block})
    lap("phase 4b")
    generate_phase(failures, kernels, app, args.profile, fits)
    lap("phase 5")
    scheduler_phase(failures, kernels, app, args.profile)
    lap("phase 6")
    refs = http_generate_phase(failures, kernels, app, args.profile)
    spec_phase(failures, kernels, app, refs, args.profile)
    lap("phases 6b and 6c")
    e4m3_phase(failures, kernels, app, args.profile)
    lap("phase 11")
    app.close()
    del app                     # the two yi-9b members' 35 GB
    gc.collect()
    torch.cuda.empty_cache()
    app = recurrent_ensemble_phase(failures, kernels, args.profile)
    engines, greedy = recurrent_engine_phase(failures, kernels, app,
                                             args.profile)
    recurrent_scheduler_phase(failures, kernels, engines, greedy)
    app.close()
    del app, engines            # the recurrent members
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 7")
    control_plane_phase(failures, kernels, args.profile)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 8")
    moe_phase(failures, kernels, args.profile, base_bytes)
    gc.collect()
    torch.cuda.empty_cache()
    mla_phase(failures, kernels, args.profile, base_bytes)
    lap("phases 9 and 9b")
    for arch in FRONTEND:
        gc.collect()
        torch.cuda.empty_cache()
        frontend_phase(failures, kernels, args.profile, base_bytes, arch)
    lap("phases 10 and 10b")
    gc.collect()
    torch.cuda.empty_cache()
    training_phase(failures, kernels, args.profile, base_bytes, fits)
    lap("phase 12")
    gc.collect()
    torch.cuda.empty_cache()
    recurrent_train_phase(failures, kernels, args.profile, base_bytes, fits)
    lap("phase 13")
    fits_phase(failures, kernels, fits)
    lap("phase 14")

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
