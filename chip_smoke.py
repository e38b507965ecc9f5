"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Usage, from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  0  card: the name and power limit as nvidia-smi reports them; TF32 off.
  1  build: every CUDA source under deepspeed_tpu_torch/csrc/ compiled with
     nvcc for sm_90a (one nvcc per source, in parallel), with build seconds.
  2  kernels against their plain PyTorch versions on the card, at the
     serving paths' shapes and at other dtypes / head dims / GQA / ragged
     query counts: the paged decode kernel and the paged multi-token
     kernel (at T=1 also against the decode kernel), both kernels' int8
     modes at phase 3c's shapes and others (pools quantized by the codec,
     a page at scale 0, garbage codes
     in the scratch page, bf16 and fp32 q, GQA H16/KV4, D 64/128/256), and
     the contiguous decode kernel (B8 Smax256 H16 D64 bf16, generate's
     shape, and Smax 4096 and 8192, D128, D256, GQA, fp32/fp16, pos 0 /
     ragged / Smax-1, garbage past pos); each error as max abs and as max
     abs over max |ref|. Each kernel and mode timed with CUDA events at its main
     shape (device time, the host's enqueueing hidden behind a device-side
     sleep; and per call with the host's launch path) beside the plain
     version, one PyTorch library call computing the same function, and
     the bound (bytes moved over 3.35 TB/s, or operations over peak); the
     contiguous decode also at a long cache (B2 Smax4096 pos 4095) beside
     SDPA, with its launch plan (heads and warps a block, chunks). The
     paged decode kernel's split-K plan at the 36-page verify shape of
     3b/3c in both modes: pos on the first and last row of every chunk,
     inside one page and past the table, each call against the plain
     version and repeated bit for bit; both modes also timed at a long
     table (B2, 256 pages of 16, pos 4095) beside the library call and the
     bound. The paged multi-token kernel's launch plan (query heads and
     tokens a unit, units, chunks, rows a chunk) at 3b/3c's chunk shape in
     both modes, with the unit's last query on the first and last row of
     every chunk and past the table, each call against the plain version
     and repeated bit for bit.
  3  serve: gpt2-medium in bf16 (seeded random weights) through
     init_inference(...).serve() with the default serving section; 16
     requests of mixed lengths must all finish with their full token count
     and no leaked pages, and the decode kernel must have launched exactly
     n_layer times per decode step (the serving programs replay as
     captured CUDA graphs here and in every later serving phase; a replay
     adds its capture's launches to the counts, which phase 21 holds
     against the kernels a profiler trace sees).
  3b serve gpt2-medium bf16 with speculative decode (k=4), the prefix cache
     and chunked prefill (64-token chunks) on: 16 requests, 8 sharing a
     256-token system prompt, 8 cold up to 512 tokens. All must finish with
     no leaked pages and nonzero prefix hits, chunk prefills and verify
     steps; the multi-token kernel must have launched n_layer times per
     chunk-program call and the decode kernel n_layer x (k+1) times per
     verify step.
  3c the same model, traffic and features with int8 KV pages
     (kv_cache_dtype="int8"): all 16 finish with prefix hits, no leaked
     pages after the index is released; the int8 modes' launches exact
     (multi-token n_layer x chunk calls, decode n_layer x (k+1) x verify
     steps, the full-precision modes 0); the code bytes of the pools half
     the bf16 pools' of 3b and the scales L x P x KV x 2 x 4 bytes, counted
     on the tensors.
  4  fp32 greedy streams at gpt2-medium width and 4 layers, from one set
     of weights: the default path on the card (kernels) against the CPU
     (plain versions); then with the three features on, the card against
     the CPU and the card against the card's features-off streams; then the
     same three pairs with int8 KV pages. Each pair must be identical,
     except at a tie (top-2 logit margin < 1e-4), which is reported as
     such.
  5  the flash-attention kernels (forward; backward = delta, dk/dv, dq)
     against their plain versions on the card: o, lse, dq, dk and dv at the
     training shape (B8 S1024 H16 D64 bf16 causal) and at fp32, fp16, D128,
     D256, non-causal, GQA H16/KV4, window 256, ragged S=1000, one long
     sequence (B1 H4 S8192), fp32 D256 S4224 (past the TPU's resident
     budget), S=128, D128 fp16 non-causal GQA at ragged S1088 and D128
     under a window, each by max abs error and by max abs error over max
     |ref|; forward and backward timed at the training shape beside the
     plain versions, SDPA as the library yardstick (backward = its
     forward+backward minus its forward) and the bound, the backward
     repeated bit for bit; the forward also at S128 B8 H16 (generate's
     prefill bucket) and S8192 B1 H4 beside SDPA, the backward at D128,
     S128 (causal and not) and S8192 beside SDPA and the bound.
  6  train gpt2-medium (24 layers, E1024, H16, vocab 50257, S=1024) in bf16
     on an fp32 master through dtt.initialize(...): micro 8 x gas 2, AdamW,
     WarmupLR, clipping 1.0, 12 steps on one seeded token batch. Losses must
     be finite and fall; the flash forward and backward kernels must have
     launched exactly 24 x 2 x 12 times each and the fused AdamW kernel
     exactly once a step. Step ms (median of steps 3-12), tokens/s, MFU
     from the analytic flops, peak memory, then a torch.profiler pass over
     2 steps (device idle share, top kernels, the flash and optimizer
     kernels' shares). Every training phase runs the step as one captured
     CUDA graph (the first step eagerly, the second captures, later ones
     replay; a replay adds its capture's launches), its loss scale, LR,
     optimizer count and dropout keys on the card; phase 23 holds it
     against the same program run eagerly.
  6b the same model with remat on, 2 steps for each policy: "full",
     forward launches == 2 x backward launches (the backward re-runs each
     block's forward); "attn" and "dots", forward launches == backward
     launches (the attention output and its lse are kept, the backward
     never re-runs the attention forward); peak memory of each.
  7  fp32 training at gpt2-medium width and 4 layers (S=256, micro 2 x gas
     2, 3 steps) from one set of weights, with AdamW and with Lamb: the
     card (kernels, the fused optimizer included) against the CPU (plain
     versions); step-1 loss within 1e-5 relative, later losses within
     1e-4, the max parameter difference printed; and the card's run
     against the same run updating through the optimizer's plain version
     on the card (the same gradients): losses within 1e-6 relative.
  9  offline generate: gpt2-medium bf16 through
     init_inference(...).generate(ids [8, 128], max_new_tokens=128): one
     warm-up, then 3 timed calls (ms per generated token, tokens/s; the
     entry's prefill and decode step replay as CUDA graphs); the decode
     kernel must have launched exactly 24 x 127 times in the first.
     A 100-token prompt (bucketed to 128) gives the tokens of the
     unbucketed engine, and fp32 greedy tokens at gpt2-medium width and 4
     layers are the CPU's, both except at a tie.
  10 the block-sparse kernels (forward, dq, dk/dv) against their plain
     versions, chained as training runs them: o, lse, dq, dk, dv at 18
     cases (the GPT-2 and BERT main shapes; fixed, bigbird, bslongformer,
     variable and dense layouts, the dense one also against the flash
     kernel; a custom layout whose first query block sees nothing, whose
     rows must give o = 0 and lse = +1e30; blocks 16/32/64/128, D 64/128,
     fp32/fp16/bf16, S 128-4096, so every route: wgmma for all three
     kernels at every block (paired 64-row units at 64/128, grouped units
     of query blocks for the forward and dq and of key blocks for dk/dv at
     16/32), FMA at fp32, each case printing each kernel's route; q/k/v as
     views of a [B, S, 3E] projection), each by max abs error and max abs
     error over max |ref|,
     o/lse and dq/dk/dv repeating bit for bit over two calls;
     each kernel timed at the GPT-2 shape (B2 S4096 H16 D64 bf16, fixed
     unidirectional, block 64) and the BERT shape (B16 S512 H16 D64 bf16,
     fixed bidirectional, block 16) beside its plain version, SDPA with the
     layout's dense boolean mask, the bound, and the dense flash kernels.
  11 train gpt2-medium in bf16 at S4096 with the block-sparse section
     through dtt.initialize(...): micro 2 x gas 2, AdamW, 10 steps on one
     batch; losses finite and falling, each block-sparse kernel launched
     exactly 24 x 2 x 10 times, flash launches and dense-masked calls 0;
     step ms, tokens/s, peak memory, a profiler pass over 2 steps.
  12 pre-train bert-large (MLM + NSP) in bf16 at S512 with the default
     sparse section (fixed bidirectional, block 16): micro 16, Adam, 10
     steps on one full-length batch; the same checks (24 x 1 x 10). Phases
     11 and 12 update through the fused AdamW kernel, once a step.
  13 fp32 block-sparse training at full width and 4 layers, card against
     CPU: GPT-2 at S1024 (block 64) and BERT at S256 (block 16), 3 steps
     each; step-1 loss within 1e-5 relative, later losses within 1e-4.
  14 the fused AdamW and LAMB kernels against their plain versions on the
     card: 3, 1000 and 8192 elements, an unaligned view, bf16 grads, the
     masked tree of gpt2-medium (16 leaves, 354.8M parameters) in the three
     Adam modes, LAMB on bert-large's pre-training tree (30 leaves, 336.2M
     parameters, phase 15's) and on a tree with a
     zero-norm leaf, clamp on and off, 1 and 5 steps; each by max abs error
     and max abs error over max |ref| (p, m and v). Each kernel timed at its
     main tree (AdamW: gpt2-medium; LAMB: bert-large), CUDA events, beside
     the plain version, the library call (torch._fused_adamw_ over the two
     decay groups; LAMB has none) and the bound (28 bytes a parameter over
     3.35 TB/s).
  15 pre-train bert-large (MLM + NSP) in bf16, dense, through
     dtt.initialize(...) with LAMB (lr 1e-3, betas 0.9/0.999, eps 1e-6, wd
     0.01), WarmupLR, clipping 1.0: micro 64 x gas 1 at S128, full-length
     rows without a mask, 10 steps on one batch (the S128 stage of
     DeepSpeed's BERT LAMB recipe). Losses finite and falling; the LAMB
     kernel launched exactly 2 x 10 times, the flash forward and backward
     exactly 24 x 10 each; step ms, tokens/s, peak memory, a profiler pass
     over 2 steps; then phase 12's step ms beside phase 15's.
  16 the threefry kernel (csrc/threefry.cu) against its plain versions on
     the card, bit for bit: dropout forward and backward in bf16, fp16 and
     f32 at phase 6's activation shape [8, 1024, 1024], at an odd size and
     at 8 k + 1 .. 7 elements (the scalar tail past the 16-byte vectors),
     rates 0.1 and 0.5, and on a view one element past a 16-byte boundary
     (into an aligned output and into an equally misaligned one: the
     scalar walk, and a scalar head before the vectors); uniform_rows at
     R1 x n 8*50257 (generate's draw)
     and R16 x n 50257 (a serving step's), over [0, 1) and [tiny, 1). Each
     timed with CUDA events beside its plain version, one PyTorch call
     (F.dropout, torch.rand: other streams of bits, timed only) and the
     bound (71 instructions an element for dropout, 72 for a uniform, at
     the card's issue ceiling of 132 x 128 x 1.98e9 a second, against the
     bytes at 3.35 TB/s). Then phase 28's (e) (below).
  17 phase 6's training at dropout 0.1, 12 steps: losses finite and
     falling; the dropout launches exactly 2 x (1 + 2 x 24) x gas x 12
     (derived and printed first), flash and AdamW as in phase 6; step ms
     beside phase 6's.
  18 fp32 at gpt2-medium width, 4 layers, dropout 0.1 (phase 7's weights,
     batch and AdamW): card against CPU, the masks equal bit for bit, so
     phase 7's tolerance holds.
  19 weight-only int8: gpt2-medium through init_inference(dtype="int8"),
     phase 3's 16 requests at 1 group and at quantization_setting 64, and
     3c's traffic and features with int8 KV pages; every request finished,
     launches exact, weight bytes against bf16's, decode tokens/s, TPOT and
     TTFT beside phase 3's and 3c's. Then fp32 compute over int8 codes at 4
     layers: the codes equal on the card and the CPU, greedy streams (fp32
     and int8 pages) and generate's tokens equal under phase 4's tie rule.
  20 sampled streams (temperature 0.8, top-k 50, top-p 0.95): fp32 at 4
     layers, serving (default; chunked prefill with the prefix cache) and
     generate, card against CPU, identical except at a tie of the sampler
     (top-2 margin of gumbel + masked logits / T below 1e-4 at the first
     differing token); bf16 at full width, 16 sampled requests all
     finished with one uniform_rows launch a prefill and a decode step, and
     generate B8 128 + 64 with 64.
  21 captured programs (utils/graphs.py), against the same programs run
     eagerly (the private switch graphs._EAGER), in one process: generate
     on gpt2-medium bf16, B8, prompts of 128 and 100 tokens (one 128
     bucket, one cache entry), 128 new tokens, greedy and sampled: tokens
     identical, launches exact and equal (decode 24 x 127, uniform_rows 128
     sampled), ms a generated token and tokens/s each side, the graphs'
     capture ms, the device's idle share each side (profile_generate over
     a 32-token call: the profiler's processing of the eager call set
     this phase's pace on a slow host, 6.2 min of 1071 s); the
     LRU at generate_cache_size 2 driven as TestGenerateCacheLRU drives it,
     then one more call, whose eviction must give back the evicted KV
     cache's bytes (memory_allocated); then phases 3, 3b, 3c and 20's
     serving traffic, eager then captured: streams identical, launches
     exact and equal, len(executables) == expected_executables, decode
     tokens/s, TPOT p50/p99 and TTFT p50 each side. The counts are checked
     against the trace: in profiled runs (profile_generate greedy each
     side; profile_serving's 3c and sampled traffic captured) each
     program kernel's events in torch.profiler's
     trace must equal the launches counted over the same run (decode 24 x
     31 in the profiled generate call, and so on). Every phase before it
     runs the captured programs (phase 4's fp32 card runs among them, card
     against CPU), with each number beside the card's name and power limit.
  22 the telemetry plane on the serving path (deepspeed_tpu_torch/telemetry):
     22a gpt2-medium bf16 with phase 3's traffic, 22b with 3b's
     (speculation k=4, the prefix cache, 64-token chunks), each served
     captured twice, with the plane off and then with the whole plane on
     (telemetry config: trace and Prometheus files in a temporary
     directory, the request trace, the KV heat tracer, the metrics
     journal, the watchdog with straggler_factor 3), two SLO classes and
     two tenants: streams identical on and off, launches exact and equal,
     len(executables) == expected_executables, one terminal record a
     request, the trace's TTFT/TPOT quantiles and the journal's
     quantile_over_time equal to stats(), the heat ledger reconciled with
     the allocator and the prefix index at drain (22b: prefix registers
     and hits in the ledger), the Prometheus file parsed, hbm_bytes_in_use
     above 0 and at most hbm_bytes_limit, jit_compiles_total equal to the
     graphs captured. 22c: generate B8 128 + 32 on the plane, twice: the
     records' compiled_cache_hit false then true, the tokens those of the
     engine without the plane. 22d: the plane's cost, alternating off /
     on / on / off twice on 22a's and 22b's traffic (each a warm run, then
     4 timed runs on the same engine): decode tokens/s, TPOT p50/p99
     (exact percentiles over the timed requests) and the host's wall time
     a scheduler step (µs, median and mean; the host sets the pace); then
     the plane's cost a step, paired: an engine with the plane and one
     without serve the same traffic in lockstep, a step each in turn, and
     the mean and median of the per-step differences (on minus off, with
     the standard error) are printed, each beside the card's name and
     power limit.
  23 the training step as one captured program against the same program
     run eagerly (utils/graphs.py's private switch), in one process, each
     run's sides from the same weights and batches, every step closed by a
     sync: phase 6's, 12's and 17's configurations (6 steps a side; step
     ms, tokens/s, capture ms, peak memory, and the device idle share of a
     torch.profiler pass over 2 steps, each side; in a profiled captured
     step each training kernel's events in the trace equal the launches
     counted);
     fp16 with a dynamic scale from 2^19 and hysteresis 1 at gpt2-medium
     width, 2 layers, micro 1 x S32 (6 steps): the overflow steps
     skipped on the same steps captured and eager, and on the CPU through
     the first applied step; fp32 at gpt2-medium width, 4
     layers with dropout 0.1 and AdamW, and bert-large 4 layers
     block-sparse S512 with LAMB (4 steps): losses and parameters captured
     = eager bit for bit, and in a profiled captured step each training
     kernel's events in the trace equal the launches counted; bf16 losses
     printed side by side; launches equal
     in every run. Then InferenceEngine.forward (B8 S512 bf16): one program
     an input shape, logits captured = eager bit for bit, ms a call.
  24 phase 6's training with the training telemetry plane on (step trace
     and Prometheus file in a temporary directory, sample_every 1, the
     watchdog): one train_step record a step (losses those train_batch
     returned, prepare/dispatch/sync spans, hbm, samples/s, comm_bytes {}
     on one device), the Prometheus file parsed (steps_total,
     jit_step_cache_size 1, step_seconds, throughput), no anomaly; then
     the plane's cost a step: an engine with it off and one with it on
     step in lockstep (off / on, then on / off), medians of each.
  25 the host KV tier on the serving path (serving/tiering.py): gpt2-medium
     bf16, captured, 3b's features at 4 slots, over 3 rounds of 16
     requests (4 distinct 256-token system prompts, each re-hit by 4
     requests with tails of 8-128 tokens a round, budgets 16-64): a roomy
     512-page pool without the tier (the reference), a 128-page pool with
     it (host budget 256 pages; LRU demotes each idle prompt's chain while
     the next is served, and the next round restores it through the
     serving_kv_restore program) and the 128-page pool without it (the
     prefixes recomputed): the tiered streams equal the reference's,
     launches exact (decode n_layer x (k+1) x verify steps, multitoken
     n_layer x chunk calls) in every run, spills at least half the
     traffic's distinct prefix pages, restores > 0, no crc failure,
     len(executables) == expected_executables == 4 with the restore
     program, the heat ledger reconciled with the allocator, the index and
     the host store at drain, check_no_leaks across both tiers; one
     corrupted host buffer a cold miss with the same stream. The same with
     int8 pages (codes and scales spill). Prints the restore's device ms a
     page (CUDA events around the call) and wall ms, the bytes a page,
     TTFT p50 of restored hits beside recomputed prefixes', decode tokens/s
     and TPOT p50 beside phase 3b's.
  26 resilience (resilience/, checkpoint/, elasticity/preemption.py):
     phase 6's training captured, 4 steps, a resilient async save at step
     2, then a new engine whose step program is captured first loads the
     tag and replays steps 3-4: losses and every state leaf equal the
     uninterrupted run bit for bit, the state tensors the same objects;
     the snapshot's step-path ms, the write's seconds and GB/s (crc32 and
     fsync) and the load's seconds. At gpt2-medium width, 2 layers, micro
     2 x S256: crash_saves leaves the previous tag loadable bit for bit; a
     corrupted newest tag walks back; nan_loss under the watchdog's
     rollback equals the clean run without the poisoned batch bit for bit;
     SIGTERM through a PreemptionGuard checkpoints and the resume is equal.
     Then phase 3's traffic with serving_stall at admissions 1, 6 and 11
     and retry_max 2: every request finished with the clean stream,
     retried 3, no leaks.
  27 the serving fleet and the trace-replay harness (serving/fleet.py,
     serving/replay.py): gpt2-medium bf16, 25's section at 4 slots with the
     host tier on; the seeded workload (24 requests, 3 Zipf tenants sharing
     system prompts, lognormal prompts median 128 clipped to 512, 64 new
     tokens) under a ReplayClock. (a) one engine under replay(), bf16 then
     int8 pages; (b) a 2-replica FleetRouter over the same InferenceEngine
     under replay_fleet(), the most loaded replica preempted at the last
     arrival with live decode sessions: >= 1 ok migration, every stream
     equal to (a)'s (or a tie at the bf16 margin, counted), every request
     finished, no leak on either replica, executables as expected, the
     paged decode and multi-token launches equal to 3b's formulas summed
     over the replicas, the migration row buffers freed with the replicas;
     (c) the first migration payload corrupted: crc_failed counted, the
     session requeued and finished with (a)'s stream; (d) a SIGTERM from
     FaultInjector.deliver_sigterm on the router's handler: the victim
     drains, every request finishes, nothing leaks. Prints migrations by
     status, bytes a migration, the blackout by part (export, manifest
     write, validate, load, adopt), TTFT/TPOT p50/p99 of the fleet against
     the single engine (wall time at step resolution) and stats().
  28 comm/ on NCCL and ZeRO stages 1-3 at world 1 (comm/, parallel/,
     runtime/zero/): a world-1 NCCL group from RANK/WORLD_SIZE/MASTER_ADDR
     and a free MASTER_PORT. (a) every collective on CUDA tensors equals
     its input, the comms logger's records carry each op's count and bytes,
     measure() prints its table. (b) phase 6's run (gpt2-medium bf16, micro
     8 x gas 2, AdamW, WarmupLR, clipping 1.0) at zero_optimization.stage
     0, 1, 2 and 3 with mesh {dp: -1}, 4 steps each (the first eager, the
     second captured, then replays): stages 1-3's losses and final master
     equal stage 0's bit for bit, flash launches 24 x 2 x 4 each way and
     fused AdamW 4, the collectives of step 1 by kind equal to the stage's
     plan; step ms (median of steps 3-4) and memory_breakdown() by stage.
     (c) phase 15's LAMB run (bert-large) at stage 2 against stage 0, 3
     steps: equal bit for bit, LAMB launches 2 a step. (d) a resilient save
     at stage 3 (gpt2-medium width, 4 layers) loaded into a stage-0 engine:
     the next step's loss and master equal the unbroken run's bit for bit.
     (e), in phase 16: the dropout kernel at element offset numel / 2 (a
     [4] key with shard 1) equals the second half of the full draw bit for
     bit and its plain version; offsets past 2^32 against the plain
     version; timed beside the offset-0 kernel.
  29 the serving placements (serving/placement.py): (a) gpt2 (124M) bf16
     at world 1 over NCCL, 3b's features at bf16 and int8 pages on 12
     requests: an explicit placement {tp: 1} equals the default engine
     (streams, program names, launches, captured replays), stats()'s
     placement printed; (b) two processes sharing the card over gloo
     (NCCL refuses two ranks on one card; `chip_smoke.py --phase29-rank`,
     started after phase 1 built the kernels): tp 2 (6 heads a rank,
     eager: a gloo group's all-reduces cannot be captured) and
     disaggregated at tp 1 (captured), bf16 and int8 pages: both ranks'
     streams equal, and (a)'s under the bf16 tie rule; per-rank pool bytes
     half of (a)'s at tp 2; the paged kernels' launches per rank exact;
     12 handoffs; TPOT per rank, handoff bytes and mean ms, and the comms
     logger's calls with their measured latency.
  29c the fleet over placements (serving/fleet.py over serving.placement
     windows): the single-engine reference (gpt2 124M fp32, no placement)
     on the card, then four processes sharing the card over gloo
     (`chip_smoke.py --phase29c-rank`) run a FleetRouter of 2 replicas x
     placement {tp: 2} (windows ranks [0, 2) and [2, 4), 6 of 12 KV heads a
     rank) under a ReplayClock: 8 requests routed to r0 by affinity, 4
     rounds, r0 preempted and its live sessions migrated to r1 (every KV
     head gathered from r0's window, re-sharded over r1's): every rank's
     streams token-identical to the reference with 0 ties, paged decode
     launches on every rank, each migration's ms.
  30 the decoder at the Mistral-7B v0.1 shape (vocab 32000, E 4096, H 32,
     KV 8, D 128, F 14336 SwiGLU, RMSNorm, rope theta 10000, sliding
     window 4096, untied head; PHASE30_LAYERS of its 32 layers), bf16
     weights drawn on the card from a seeded generator: row 1 at B1 S8192
     with the window biting and GQA, and row 6 at H32 KV8 D128 over a
     544-row cache, each against its plain version and timed beside it,
     SDPA and the bound; then init_inference(DecoderConfig, params): a
     full-sequence forward at B1 S8192 (flash launches = 3 x layers) and
     greedy generate of 32 tokens from a 512-token prompt (decode launches
     = 3 x 31 x layers), forward ms and decode tokens/s; the forward's next
     token against generate's first (or a bf16 tie); when transformers
     imports, a tiny random LLaMA injected at fp32 against HF's logits and
     greedy stream (else one line saying that step did not run and why).
  8  (last, after 30) the script's total seconds, then one JSON line of per-kernel numbers, every kernel and
     mode with its launches on the path that ported it (the block-sparse
     kernels: phase 11's, and the three at blocks 16/32 at BERT's shape
     with phase 12's; fused AdamW: phase 6's; fused LAMB: phase 15's;
     the threefry dropout: phase 17's; uniform_rows: phase 20's bf16
     serving; rows 1 and 6 again at the decoder's shapes with phase 30's
     launches), then the last line {"ok": true, "device": {...}} with
     "count": 1, the cards the run used.

Without a CUDA device it exits 1 before printing any result. It imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

import deepspeed_tpu_torch as dtt
from deepspeed_tpu_torch.models import bert, gpt2
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import decode_attention as tda
from deepspeed_tpu_torch.ops import dropout as tdo
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_adam as fadam
from deepspeed_tpu_torch.ops import op_builder
from deepspeed_tpu_torch.ops import paged_decode_attention as pda
from deepspeed_tpu_torch.ops import paged_multitoken_attention as pma
from deepspeed_tpu_torch.ops import prng
from deepspeed_tpu_torch.ops import sampling as tsamp
from deepspeed_tpu_torch.ops import sparse_attention as sac
from deepspeed_tpu_torch.ops.attention import gather_pool_pages
from deepspeed_tpu_torch.ops.launches import LAUNCHES, counts, reset
from deepspeed_tpu_torch.ops.quantizer import quantize_kv_pages
from deepspeed_tpu_torch.ops.sparse_attention import from_ds_config
from deepspeed_tpu_torch.runtime.config import SparseAttentionConfig
from deepspeed_tpu_torch.serving import RequestStatus
from deepspeed_tpu_torch.serving.kv_cache import pages_for
from deepspeed_tpu_torch.serving.scheduler import exact_percentiles
from deepspeed_tpu_torch.telemetry.request_trace import load_request_records, score_requests
from deepspeed_tpu_torch.tools.profile_serving import (
    FEATURES_SECTION,
    mixed_requests,
    profile_serve,
    shared_prefix_requests,
)
from deepspeed_tpu_torch.tools.profile_training import (
    BLOCK_SPARSE_KERNELS,
    FLASH_KERNELS,
    GPT2_SPARSE_SECTION,
    OPTIMIZER_KERNELS,
    analytic_train_flops_per_token,
    print_profile,
    profile_steps,
    traced_step,
    train_config,
    workload,
)
from deepspeed_tpu_torch.tools.profile_generate import profile_generate
from deepspeed_tpu_torch.tools.time_attention_kernels import time_ms
from deepspeed_tpu_torch.utils import graphs
from deepspeed_tpu_torch.utils.weights import params_from_numpy, params_to_numpy, tree_leaves

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-5, torch.float16: 1e-2, torch.bfloat16: 1e-2}
# max abs error over max |ref| of the int8 modes and the contiguous decode
# kernel: fp32 sums in another order; a 16-bit output rounds to 8 / 11 bits
# (one ulp of the largest output is ~4e-3 of it in bf16)
REL_TOL = {torch.float32: 1e-5, torch.float16: 1e-2, torch.bfloat16: 1e-2}
TIE_MARGIN = 1e-4
# bucketed against unbucketed bf16 generate: the prefill's GEMMs run over
# another number of rows, so bf16 logits may differ in their last bits; a
# differing token is a tie when its top-2 logit margin is below this
BF16_TIE_MARGIN = 5e-2
# flash kernels against their plain versions, max abs error: fp32 sums in
# another order (1e-5); bf16/fp16 round p, ds and the outputs to 8 / 11 bits
FLASH_TOL = {torch.float32: 1e-5, torch.float16: 2e-2, torch.bfloat16: 2e-2}
# and max abs error over max |ref|, which does not shrink with the outputs'
# scale: a one-ulp flip of every bf16 output gives about 7e-3 of max |ref|,
# while a systematic error of 5% or a query tile left out of dk/dv gives
# about 5e-2. lse is f32 at every dtype.
FLASH_REL_TOL = {torch.float32: 1e-5, torch.float16: 1.5e-2, torch.bfloat16: 1.5e-2}
LSE_REL_TOL = 1e-5
# the decode-path kernels' entries in the launch registry (ops/launches.py)
K_DECODE, K_PAGED, K_PAGED8 = tda.KERNELS + pda.KERNELS
K_MT, K_MT8 = pma.KERNELS


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def phase(n, title):
    print(f"== phase {n}: {title}", flush=True)


# ---------------------------------------------------------------------------
# phase 2 helpers
# ---------------------------------------------------------------------------

def make_case(B, H, KV, D, page, P, n, pos, dtype, inactive=(), layers=1, seed=0, T=None):
    """Random q ([B, H, D], or [B, T, H, D] given T) and pools on the card,
    distinct pages per active slot, scratch-page tables for the inactive
    slots, and the per-slot position (``pos`` of the decode kernel, ``base``
    of the multi-token kernel)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(*((B, H, D) if T is None else (B, T, H, D)), generator=g,
                    device="cuda").to(dtype)
    k = torch.randn(layers, P, KV, page, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(layers, P, KV, page, D, generator=g, device="cuda").to(dtype)
    rs = np.random.RandomState(seed)
    bt = rs.choice(np.arange(1, P), (B, n), replace=False).astype(np.int32)
    for b in inactive:
        bt[b] = 0
    return (q, k, v, torch.from_numpy(bt).cuda(),
            torch.tensor(pos, dtype=torch.int32, device="cuda"))


# (kernel wrapper, its plain version)
DECODE = (pda.paged_decode_attention, pda.paged_decode_attention_ref)
MULTITOKEN = (pma.paged_multitoken_attention, pma.paged_multitoken_attention_ref)


def kernel_error(kernel, plain, q, k, v, bt, pos):
    """Max abs error of ``kernel`` against its f32 ``plain`` version."""
    out = kernel(q, k, v, bt, pos)
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == q.dtype, "kernel output shape/dtype")
    check(bool(torch.isfinite(out).all()), "kernel output not finite")
    ref = plain(q.float(), k.float(), v.float(), bt, pos)
    return float((out.float() - ref).abs().max())


def make_int8_case(B, H, KV, D, page, P, n, pos, dtype, inactive=(), layers=1, seed=0, T=None):
    """:func:`make_case` with int8 pools: random f32 pages quantized by the
    codec (scales ``[layers, P, KV, 2]``), garbage codes in the scratch page
    0, and the second table entry of the slot with the largest ``pos`` left
    at scale 0 (a never-written page inside a live range, which reads 0)."""
    q, _, _, bt, pos_t = make_case(B, H, KV, D, page, P, n, pos, dtype, inactive, 1, seed, T)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    kq, ks = quantize_kv_pages(torch.randn(layers, P, KV, page, D, generator=g, device="cuda"))
    vq, vs = quantize_kv_pages(torch.randn(layers, P, KV, page, D, generator=g, device="cuda"))
    kq[:, 0] = torch.randint(-127, 128, kq[:, 0].shape, generator=g, device="cuda").to(torch.int8)
    sc = torch.stack([ks, vs], dim=-1).contiguous()
    if n > 1:
        sc[:, bt[int(np.argmax(pos)), 1]] = 0.0
    return q, kq, vq, sc, bt, pos_t


def errors(out, ref):
    """(max abs error, max abs error / max |ref|) of a kernel's output."""
    check(bool(torch.isfinite(out).all()), "kernel output not finite")
    err = float((out.float() - ref.float()).abs().max())
    return err, err / max(float(ref.float().abs().max()), 1e-30)


def int8_error(kernel, plain, q, kq, vq, sc, bt, pos):
    """:func:`errors` of an int8-mode kernel against its plain version (f32
    q, the same codes and scales)."""
    out = kernel(q, kq, vq, bt, pos, scales=sc)
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == q.dtype, "int8 kernel output shape/dtype")
    return errors(out, plain(q.float(), kq, vq, bt, pos, scales=sc))


def decode_case(B, S, H, KV, D, dtype, layers=1, seed=0):
    """Random q ``[B, H, D]`` and a stacked ``[layers, B, S, KV, D]`` cache
    on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(layers, B, S, KV, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(layers, B, S, KV, D, generator=g, device="cuda").to(dtype)
    return q, k, v


def device_pos(pos):
    """``pos`` as the contiguous decode kernel reads it: int32 ``[1]`` on
    the card."""
    return torch.full((1,), pos, dtype=torch.int32, device="cuda")


def decode_error(q, k, v, pos):
    """:func:`errors` of the contiguous decode kernel against its plain
    version, with huge garbage in every row past ``pos`` (which the kernel
    must never read and the plain version masks)."""
    k, v = k.clone(), v.clone()
    k[:, pos + 1:], v[:, pos + 1:] = 1e4, -1e4
    out = tda.decode_attention(q, k, v, device_pos(pos))
    torch.cuda.synchronize()
    check(out.shape == q.shape and out.dtype == q.dtype, "decode kernel output shape/dtype")
    return errors(out, tda.decode_attention_ref(q.float(), k.float(), v.float(), pos))


def library_decode(q, k, v, pos):
    """The contiguous decode as one library call (a yardstick only): SDPA
    of the one query over rows 0..pos."""
    gqa = {"enable_gqa": True} if k.shape[2] != q.shape[1] else {}
    return F.scaled_dot_product_attention(
        q[:, :, None], k[:, : pos + 1].transpose(1, 2), v[:, : pos + 1].transpose(1, 2), **gqa
    )[:, :, 0]


def decode_bound(q, k, pos):
    """Least time of one contiguous decode call: rows 0..pos of K and V, q
    and the output moved once, against 4·D flops per (query head, row)."""
    B, H, D = q.shape
    KV = k.shape[2]
    nbytes = 2 * B * (pos + 1) * KV * D * k.element_size() + 2 * q.numel() * q.element_size()
    flops = 4 * B * H * (pos + 1) * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[k.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_attention(q, k, v, bt, pos, scales=None):
    """The same function as one PyTorch library call (timed as a yardstick
    only; the port never calls it): gather the pages (and dequantize an
    int8 pool's to q's dtype), then SDPA with the position mask. ``q [B,
    H, D]`` is one query at ``pos``; ``q [B, T, H, D]`` has query t at
    ``pos + t`` (the [B, 1, T, S] mask)."""
    one = q.dim() == 3
    if one:
        q = q[:, None]
    B, T, H, D = q.shape
    KV = k.shape[1]
    kd, vd = gather_pool_pages(k, v, bt, scales)
    kd = kd.to(q.dtype).transpose(2, 3).reshape(B, -1, KV, D).transpose(1, 2)
    vd = vd.to(q.dtype).transpose(2, 3).reshape(B, -1, KV, D).transpose(1, 2)
    S = kd.shape[2]
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= pos.long()[:, None, None] + torch.arange(T, device=q.device)[None, :, None])
    gqa = {"enable_gqa": True} if KV != H else {}
    o = torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), kd, vd, attn_mask=mask[:, None], **gqa
    ).transpose(1, 2)
    return o[:, 0] if one else o


def bound(q, k_layer, bt, pos, scales=None, pv_at_q_rate=False):
    """Least time for one call (``q`` and ``pos`` as in
    :func:`library_attention`): the live K/V rows (keys up to each slot's
    last query, within its table), q, the output, the table and pos each
    moved once over HBM (an int8 pool: 1-byte codes plus the live pages'
    [KV, 2] f32 scales), against the score and weighted-sum flops of every
    query's visible keys at the inputs' peak; the larger wins. An int8
    pool's scores can run at q's rate (its codes are integers that bf16
    holds exactly, and the page's scale factors out of q·k), its weighted
    sum at the f32 rate where P is not rounded (the decode kernel) and at
    q's rate where it goes to the tensor cores (``pv_at_q_rate``: the
    multi-token kernel's tensor-core route)."""
    if q.dim() == 3:
        q = q[:, None]
    B, T, H, D = q.shape
    KV, page = k_layer.shape[1], k_layer.shape[2]
    cap = bt.shape[1] * page
    p = pos.long().cpu()
    n_live = (p + T).clamp(max=cap)
    kv_bytes = int(2 * n_live.sum() * KV * D * k_layer.element_size())
    if scales is not None:
        kv_bytes += int(((n_live + page - 1) // page).sum()) * KV * 2 * 4
    nbytes = kv_bytes + 2 * q.numel() * q.element_size() + bt.numel() * 4 + pos.numel() * 4
    visible = (p[:, None] + torch.arange(T)[None, :] + 1).clamp(max=cap)
    product_flops = int(2 * visible.sum() * H * D)  # each of q·k and P·V
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    score_dt, pv_dt = (k_layer.dtype,) * 2 if scales is None else (q.dtype, torch.float32)
    if pv_at_q_rate:
        pv_dt = q.dtype
    t_ops = (product_flops / PEAK_OPS_PER_S[score_dt]
             + product_flops / PEAK_OPS_PER_S[pv_dt]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3/4 helpers
# ---------------------------------------------------------------------------

def compare_streams(label, a_reqs, b_reqs, margin_limit=TIE_MARGIN):
    """Greedy streams identical, except at a tie (top-2 margin below
    ``margin_limit``, TIE_MARGIN by default, in either run at the first
    differing token). → ties."""
    ties = 0
    for i, (a, b) in enumerate(zip(a_reqs, b_reqs)):
        if a.tokens == b.tokens:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)
        margin = min(a.margins[t], b.margins[t])
        print(f"{label}: request {i}: streams differ at token {t}, top-2 logit margin "
              f"{margin:.3e}")
        check(margin < margin_limit, f"{label}: request {i} differs at token {t} with margin "
                                     f"{margin:.3e} >= {margin_limit} (not a tie)")
        print(f"{label}: request {i}: a tie (margin < {margin_limit}), not a fault")
        ties += 1
    n_tok = sum(len(r.tokens) for r in a_reqs)
    print(f"{label}: {len(a_reqs) - ties} of {len(a_reqs)} identical, {ties} ties, "
          f"{n_tok} tokens compared")
    return ties


def compare_generated(label, eng, a, b, prompt_len, margin_limit):
    """Two ``generate`` outputs ``[B, S + new]``: each row identical, or a
    tie: at the first differing token the top-2 margin of ``eng``'s logits
    for the prefix before it is below ``margin_limit``. → ties."""
    ties = 0
    for r in range(a.shape[0]):
        if np.array_equal(a[r], b[r]):
            continue
        t = int(np.nonzero(a[r] != b[r])[0][0])
        logits = eng.forward({"input_ids": a[r:r + 1, :t]})[0, -1].float()
        top2 = torch.topk(logits, 2).values
        margin = float(top2[0] - top2[1])
        print(f"{label}: row {r}: differs at new token {t - prompt_len}, top-2 logit margin "
              f"{margin:.3e}")
        check(margin < margin_limit, f"{label}: row {r} differs with margin {margin:.3e} >= "
                                     f"{margin_limit} (not a tie)")
        ties += 1
    print(f"{label}: {a.shape[0] - ties} of {a.shape[0]} rows identical, {ties} ties, "
          f"{a.shape[0] * (a.shape[1] - prompt_len)} tokens compared")
    return ties


# ---------------------------------------------------------------------------
# phase 5-7 helpers
# ---------------------------------------------------------------------------

def flash_case(B, S, H, KV, D, dtype, seed=0):
    """Random q, k, v and dO (scaled by 0.1, so that the grads' max abs
    errors read against FLASH_TOL) on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dtype)
    k = torch.randn(B, S, KV, D, generator=g, device="cuda").to(dtype)
    v = torch.randn(B, S, KV, D, generator=g, device="cuda").to(dtype)
    do = (torch.randn(B, S, H, D, generator=g, device="cuda") * 0.1).to(dtype)
    return q, k, v, do


def scaled_error(got, ref):
    """max |got - ref| / max |ref|."""
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max())


def flash_errors(q, k, v, do, causal=True, window=None):
    """Max abs error and :func:`scaled_error` of the kernels' o, lse, dq, dk,
    dv against the plain versions' on the same inputs → (abs, scaled)."""
    o, lse = fa.flash_attention_fwd(q, k, v, causal, None, window)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, causal, None, window)
    torch.cuda.synchronize()
    got = dict(zip(("o", "lse", "dq", "dk", "dv"), (o, lse) + grads))
    for name, t in got.items():
        check(bool(torch.isfinite(t).all()), f"flash {name} not finite")
    o_r, lse_r = fa.flash_attention_fwd_ref(q, k, v, causal, None, window)
    ref = dict(zip(("o", "lse", "dq", "dk", "dv"),
                   (o_r, lse_r) + fa.flash_attention_bwd_ref(q, k, v, o_r, lse_r, do, causal,
                                                             None, window)))
    out, scaled = {}, {}
    for name in got:
        check(got[name].shape == ref[name].shape and got[name].dtype == ref[name].dtype,
              f"flash {name}: shape/dtype {got[name].shape} {got[name].dtype} against "
              f"{ref[name].shape} {ref[name].dtype}")
        out[name] = float((got[name].float() - ref[name].float()).abs().max())
        scaled[name] = scaled_error(got[name], ref[name])
    return out, scaled


def visible_pairs(S, causal, window):
    """(query, key) pairs a causal / windowed / full attention computes."""
    if not causal:
        return S * S
    w = window or 0
    if w <= 0 or w >= S:
        return S * (S + 1) // 2
    return w * (w + 1) // 2 + (S - w) * w


def flash_bound(q, k, causal, window, backward):
    """Least time of one forward (2 products) or backward (5 products: the
    function's s, dv, dp, dq, dk) call: each input read once and each output
    written once over HBM, against its flops at the dtype's peak."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    it = q.element_size()
    qo, kv = B * S * H * D * it, B * S * KV * D * it
    lse = B * H * S * 4
    nbytes = (4 * qo + 4 * kv + lse) if backward else (2 * qo + 2 * kv + lse)
    flops = 2 * D * (5 if backward else 2) * B * H * visible_pairs(S, causal, window)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_flash_launches():
    reset(fa.KERNELS)


def reset_optimizer_launches():
    reset(fadam.KERNELS)


@contextlib.contextmanager
def plain_update():
    """The optimizers update through the fused kernel's plain version on the
    card while this is open (phase 7's kernel-against-plain comparison of
    whole runs); the dispatch is restored on exit."""
    saved = fadam.multi_tensor_adam, fadam.multi_tensor_lamb
    fadam.multi_tensor_adam, fadam.multi_tensor_lamb = (fadam.multi_tensor_adam_ref_,
                                                        fadam.multi_tensor_lamb_ref_)
    try:
        yield
    finally:
        fadam.multi_tensor_adam, fadam.multi_tensor_lamb = saved


def check_optimizer_launches(label, steps, kernel="fused_adamw"):
    """The fused optimizer's launches since the last reset: once a step for
    AdamW, twice for LAMB, and none of the other."""
    per = 2 if kernel == "fused_lamb" else 1
    want = {k: (per * steps if k == kernel else 0) for k in fadam.KERNELS}
    check(counts(fadam.KERNELS) == want, f"{label}: fused optimizer launches "
          f"{counts(fadam.KERNELS)}, expected {want}")
    return LAUNCHES[kernel]


# ---------------------------------------------------------------------------
# phase 10-13 helpers
# ---------------------------------------------------------------------------

def reset_block_sparse_counts():
    reset(bsa.KERNELS)
    for key in bsa.DENSE_CALLS:
        bsa.DENSE_CALLS[key] = 0


def bs_layout(kind, H, blk, causal):
    """A sparsity config (or, for "custom", an explicit layout whose first
    query block lists only the block above the diagonal) by name."""
    attention = "unidirectional" if causal else "bidirectional"
    if kind == "gpt2":
        return from_ds_config(GPT2_SPARSE_SECTION, H)
    if kind == "bert":
        return from_ds_config(SparseAttentionConfig(), H)
    if kind == "fixed":
        return sac.FixedSparsityConfig(num_heads=H, block=blk, num_local_blocks=4,
                                       attention=attention)
    if kind == "bigbird":
        return sac.BigBirdSparsityConfig(num_heads=H, block=blk, different_layout_per_head=True,
                                         num_random_blocks=2, attention=attention)
    if kind == "bslongformer":
        return sac.BSLongformerSparsityConfig(num_heads=H, block=blk, attention=attention)
    if kind == "variable":
        return sac.VariableSparsityConfig(num_heads=H, block=blk, num_random_blocks=1,
                                          local_window_blocks=[2, 4], global_block_indices=[0, 5],
                                          attention=attention)
    if kind == "dense":
        return sac.DenseSparsityConfig(num_heads=H, block=blk)
    raise ValueError(kind)


def bs_lists(kind, S, H, blk, causal):
    if kind == "custom":
        nb = S // blk
        layout = np.tril(np.ones((H, nb, nb), bool))
        layout[:, 0, 0] = False
        layout[:, 0, 1] = True
        return bsa.lists_from_layout(layout, blk, "cuda")
    return bsa.index_lists(bs_layout(kind, H, blk, causal), S, "cuda")


def bs_case(B, S, H, D, dtype, seed=0):
    """q, k, v as strided views of one [B, S, 3E] projection (as GPT-2 hands
    them over) and dO (scaled by 0.1), on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(B, S, 3 * H * D, generator=g, device="cuda").to(dtype)
    q, k, v = (t.unflatten(-1, (H, D)) for t in qkv.split(H * D, dim=-1))
    do = (torch.randn(B, S, H, D, generator=g, device="cuda") * 0.1).to(dtype)
    return q, k, v, do


def bs_errors(q, k, v, do, lists, causal):
    """The forward, dq and dk/dv kernels chained as training runs them,
    against the plain versions chained the same way: max abs error and max
    abs error / max |ref| of o, lse (rows with a finite lse; the poisoned
    rows must be poisoned in both), dq, dk, dv → (abs, scaled, o, poisoned
    rows). A second forward, dq and dk/dv call must repeat the first bit for
    bit."""
    o, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
    o2, lse2 = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
    torch.cuda.synchronize()
    check(torch.equal(o, o2) and torch.equal(lse, lse2),
          "block-sparse o/lse: a second call differs from the first")
    del o2, lse2
    delta = bsa.block_sparse_delta(o, do)
    dq = bsa.block_sparse_attention_dq(q, k, v, do, lse, delta, lists, causal)
    dk, dv = bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta, lists, causal)
    again = (bsa.block_sparse_attention_dq(q, k, v, do, lse, delta, lists, causal),
             *bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta, lists, causal))
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
          "block-sparse dq/dk/dv: a second call differs from the first")
    del again
    o_r, lse_r = bsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal)
    grads_r = bsa.block_sparse_attention_bwd_ref(q, k, v, o_r, lse_r, do, lists, causal)
    poison = lse_r == 1e30
    check(torch.equal(lse == 1e30, poison), "block-sparse lse: poisoned rows differ")
    got = {"o": o, "lse": lse[~poison], "dq": dq, "dk": dk, "dv": dv}
    ref = {"o": o_r, "lse": lse_r[~poison], "dq": grads_r[0], "dk": grads_r[1],
           "dv": grads_r[2]}
    out, scaled = {}, {}
    for name in got:
        check(bool(torch.isfinite(got[name]).all()), f"block-sparse {name} not finite")
        check(got[name].shape == ref[name].shape and got[name].dtype == ref[name].dtype,
              f"block-sparse {name}: shape/dtype {got[name].shape} {got[name].dtype} against "
              f"{ref[name].shape} {ref[name].dtype}")
        out[name] = float((got[name].float() - ref[name].float()).abs().max())
        scaled[name] = scaled_error(got[name], ref[name])
    return out, scaled, o, int(poison.sum())


def bs_route(q, blk):
    """The kernels a shape takes: "wgmma" (the TMA + wgmma kernels;
    "grouped units" at blocks of 16 and 32) or "FMA" (fp32)."""
    if bsa.wgmma_route(q):
        return "wgmma (grouped units)" if blk < 64 else "wgmma"
    return "FMA"


def bs_pairs(lists, causal):
    """(query, key) pairs one batch row computes over all heads: each active
    block's blk x blk, a diagonal block's blk (blk + 1) / 2 under the causal
    rule, a block above the diagonal none."""
    lay = lists.layout
    blk = lists.block
    if not causal:
        return int(lay.sum()) * blk * blk
    n = lay.shape[1]
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    below = int((lay & (j < i)[None]).sum())
    diag = int((lay & (j == i)[None]).sum())
    return below * blk * blk + diag * blk * (blk + 1) // 2


# the block-sparse kernels: (kernel, source suffix, pallas_call line of the
# JAX kernel it replaces, its outputs)
BS_KERNELS = (("fwd", "fwd", 176, ("o", "lse")), ("dq", "bwd", 208, ("dq",)),
              ("dkv", "bwd", 226, ("dk", "dv")))
# per kernel: tensors of q's shape moved (read or written), [B, H, S] f32
# rows moved, products per computed (query, key) pair
BS_WORK = {"fwd": (4, 1, 2), "dq": (5, 2, 3), "dkv": (6, 2, 4)}


def bs_bound(q, lists, causal, which):
    """Least time of one call of kernel ``which``: each input read once and
    each output written once over HBM (fwd: q, k, v, o, lse; dq: q, k, v,
    dO, dq, lse, delta; dk/dv: q, k, v, dO, dk, dv, lse, delta), against the
    products its function needs over this run's computed pairs at the
    dtype's peak (fwd: s, P·V; dq: s, dp, dS·K; dk/dv: s, P^T·dO, dp,
    dS^T·Q); the larger wins."""
    B, S, H, D = q.shape
    big, rows, products = BS_WORK[which]
    nbytes = big * B * S * H * D * q.element_size() + rows * B * H * S * 4
    flops = 2 * D * products * B * bs_pairs(lists, causal)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def train_phase(label, module, conf, batch, steps, n_layer, profile_kernels, sparse=True,
                opt_kernel="fused_adamw"):
    """Train ``steps`` steps on one batch through initialize(...) with the
    counts at 0 → (engine, counts read right after). ``sparse``: the run
    launches the block-sparse kernels only, else the flash kernels only;
    ``opt_kernel`` the fused optimizer kernel it updates through."""
    eng, _, _, _ = dtt.initialize(model=module, config=conf, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_block_sparse_counts()
    reset_flash_launches()
    reset_optimizer_launches()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    sparse_n, flash_n = counts(bsa.KERNELS), counts(fa.KERNELS)
    n = dict(sparse_n, **bsa.DENSE_CALLS, **flash_n, flash=sum(flash_n.values()),
             sparse=sum(sparse_n.values()))
    n[opt_kernel] = check_optimizer_launches(label, steps, opt_kernel)
    peak = torch.cuda.max_memory_allocated()
    gas = eng.gradient_accumulation_steps
    want = n_layer * gas * steps
    check(all(np.isfinite(losses)), f"{label}: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"{label}: loss did not fall: {losses}")
    mine, other = (bsa.KERNELS, "flash") if sparse else (fa.KERNELS, "sparse")
    check(all(n[k] == want for k in mine),
          f"{label}: attention launches {n}, expected {want} each "
          f"(= {n_layer} x {gas} x {steps})")
    check(n[other] == 0 and n["sparse_attention_dense"] == 0,
          f"{label}: {other} launches {n[other]}, dense calls "
          f"{n['sparse_attention_dense']}, expected 0")
    S = batch["input_ids"].shape[1]
    tokens = eng.train_batch_size * S
    step_ms = statistics.median(step_s[2:]) * 1e3
    n["step_ms"] = step_ms
    print("losses " + " ".join(f"{x:.4f}" for x in losses))
    print(f"{'block-sparse' if sparse else 'flash'} launches: "
          + ", ".join(f"{k} {n[k]}" for k in mine)
          + f" (= {n_layer} x {gas} x {steps} each); {other} launches {n[other]}, dense "
          f"masked calls {n['sparse_attention_dense']}; {opt_kernel} launches "
          f"{n[opt_kernel]} ({2 if opt_kernel == 'fused_lamb' else 1} x {steps})")
    print(f"step ms (median of steps 3-{steps}, each closed by a sync) {step_ms:.2f}, steps "
          + " ".join(f"{x * 1e3:.1f}" for x in step_s)
          + f"; tokens/s {tokens / (step_ms / 1e3):.1f} ({tokens} tokens a step); peak memory "
          f"{peak / 2**30:.2f} GiB")
    print_profile(profile_steps(eng, batch, 2, kernels=profile_kernels))
    return eng, n


def cpu_card_losses(label, module, conf, tree, batch, n_layer, steps=3):
    """fp32 training from one set of weights on the card (kernels) and the
    CPU (plain versions): step-1 loss within 1e-5 relative, later losses
    within 1e-4, and the card run on the block-sparse kernels alone."""
    losses = {}
    for dev in ("cuda", "cpu"):
        reset_block_sparse_counts()
        reset_flash_launches()
        reset_optimizer_launches()
        eng, _, _, _ = dtt.initialize(model=module, config=conf,
                                      model_parameters=params_from_numpy(tree, dev), device=dev)
        losses[dev] = [float(eng.train_batch(batch)["loss"]) for _ in range(steps)]
        if dev == "cuda":
            want = n_layer * eng.gradient_accumulation_steps * steps
            check(all(LAUNCHES[k] == want for k in bsa.KERNELS)
                  and not any(LAUNCHES[k] for k in fa.KERNELS)
                  and bsa.DENSE_CALLS["sparse_attention_dense"] == 0,
                  f"{label} card run: launches {counts(bsa.KERNELS)}, flash "
                  f"{counts(fa.KERNELS)}, dense {bsa.DENSE_CALLS}")
            check_optimizer_launches(f"{label} card run", steps)
        else:
            check_optimizer_launches(f"{label} CPU run", 0)
        del eng
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    print(f"{label}: losses card " + " ".join(f"{x:.7f}" for x in losses["cuda"]) + ", CPU "
          + " ".join(f"{x:.7f}" for x in losses["cpu"]) + ", relative differences "
          + " ".join(f"{x:.3e}" for x in rel))
    check(rel[0] <= 1e-5, f"{label}: fp32 step-1 loss card vs CPU: relative {rel[0]} > 1e-5")
    check(max(rel[1:]) <= 1e-4, f"{label}: fp32 later losses card vs CPU: relative {rel} > 1e-4")
    return rel


# ---------------------------------------------------------------------------
# phase 14 helpers
# ---------------------------------------------------------------------------

# max abs error over max |ref| of p, m and v, the fused optimizer kernels
# against their plain versions: both compute in f32 (the plain version on
# the card divides by the bias corrections as a multiply by their
# reciprocal; LAMB's norms are double sums in the kernel, f32 reductions in
# the plain version)
OPT_REL_TOL = 1e-6


def opt_case(leaves, seed, gdtype=torch.float32, offset=0):
    """Copies of f32 ``leaves`` and grads, m and v (as after a few steps)
    beside them, drawn on their device; ``offset`` > 0 makes every operand
    an unaligned view."""
    dev = leaves[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(t, scale):
        base = torch.randn(t.numel() + offset, generator=gen, device=dev) * scale
        return base[offset:].view(t.shape)

    ps = [draw(p, 1.0).copy_(p) for p in leaves]
    gs = [draw(p, 1e-2).to(gdtype) if gdtype != torch.float32 else draw(p, 1e-2)
          for p in leaves]
    ms = [draw(p, 1e-3) for p in leaves]
    vs = [draw(p, 1e-2).square_() for p in leaves]
    return ps, gs, ms, vs


def opt_errors(kernel, plain, case, steps, **kw):
    """``steps`` updates by the kernel and by its plain version, each on its
    own copy of the case → (max abs error, max abs error / max |ref|) over
    p, m and v."""
    ps, gs, ms, vs = case
    mine = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    ref = [[t.clone() for t in ts] for ts in (ps, ms, vs)]
    for step in range(1, steps + 1):
        kernel(mine[0], gs, mine[1], mine[2], step, **kw)
        plain(ref[0], gs, ref[1], ref[2], step, **kw)
    torch.cuda.synchronize()
    err = rel = 0.0
    for got, want in zip(mine, ref):
        e = max(float((a - b).abs().max()) for a, b in zip(got, want) if b.numel())
        r = max(float(b.abs().max()) for b in want if b.numel())
        err, rel = max(err, e), max(rel, e / max(r, 1e-30))
    return err, rel


def opt_bound(leaves, grads, flops_per_param):
    """Least time of one update: p, g, m, v read once and p, m, v written
    once, against the update's f32 operations at the f32 peak."""
    n = sum(p.numel() for p in leaves)
    nbytes = 6 * 4 * n + sum(g.numel() * g.element_size() for g in grads)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops_per_param * n / PEAK_OPS_PER_S[torch.float32] * 1e3
    return ((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), nbytes


def library_adamw(ps, gs, ms, vs, wds, lr, betas, eps):
    """torch._fused_adamw_ over the leaf lists, one call per decay group
    (the masked AdamW is two groups), as a timed function of the call
    index; the port never calls it."""
    steps = [torch.ones((), device=ps[0].device) for _ in ps]
    groups = [([i for i, w in enumerate(wds) if w == wd], wd) for wd in sorted(set(wds))]

    def call(_):
        for idx, wd in groups:
            torch._fused_adamw_([ps[i] for i in idx], [gs[i] for i in idx], [ms[i] for i in idx],
                                [vs[i] for i in idx], [], [steps[i] for i in idx], lr=lr,
                                beta1=betas[0], beta2=betas[1], weight_decay=wd, eps=eps,
                                amsgrad=False, maximize=False)
    return call


def optimizer_kernels_phase(device="cuda", gpt_name="gpt2-medium", bert_name="bert-large"):
    """Phase 14: the fused AdamW / LAMB kernels against their plain versions
    at the cases of the module docstring, each kernel timed at its main
    tree → (errors by case, times by kernel)."""
    gen14 = torch.Generator(device=device).manual_seed(14)

    def flat14(n):
        return [torch.randn(n, generator=gen14, device=device)]

    cfg_g = gpt2.get_config(gpt_name)
    gpt_leaves = tree_leaves(gpt2.init_params(cfg_g, gen14, device, torch.float32))
    gpt_wds = [0.1 if p.ndim >= 2 else 0.0 for p in gpt_leaves]
    cfg_b = bert.get_config(bert_name, pretraining=True)
    bert_leaves = tree_leaves(bert.init_params(cfg_b, gen14, device, torch.float32))
    # gpt2-medium 16 leaves; bert-large with its MLM and NSP heads (phase 15's
    # tree) 30
    check(len(gpt_leaves) == 16 and len(bert_leaves) == 30,
          f"leaves: {gpt_name} {len(gpt_leaves)}, {bert_name} {len(bert_leaves)}")
    adam_kw = dict(lr=3e-4, betas=(0.9, 0.95), eps=1e-8)
    lamb_kw = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-6)
    zero_leaf = [torch.zeros(64, 64, device=device)] + flat14(70001) + flat14(3)
    cases14 = [
        ("adamw n3", "adam", opt_case(flat14(3), 1), 3, dict(weight_decays=[0.1])),
        ("adamw n1000", "adam", opt_case(flat14(1000), 2), 3, dict(weight_decays=[0.1])),
        ("adamw n8192", "adam", opt_case(flat14(8192), 3), 3, dict(weight_decays=[0.1])),
        ("adamw unaligned n1000", "adam", opt_case(flat14(1000), 4, offset=1), 3,
         dict(weight_decays=[0.1])),
        ("adamw bf16 grads n65539", "adam", opt_case(flat14(65539), 5, torch.bfloat16), 3,
         dict(weight_decays=[0.1])),
    ] + [
        (f"gpt2-medium tree {mode}", "adam", None, 1, dict(weight_decays=gpt_wds, mode=mode))
        for mode in ("decoupled", "l2", "none")
    ] + [
        ("lamb bert-large tree", "lamb", None, 1, dict(weight_decays=[0.01] * len(bert_leaves))),
    ] + [
        (f"lamb zero-norm leaf {'clamped' if clamp else 'unclamped'} {steps} steps", "lamb",
         opt_case(zero_leaf, 6), steps,
         dict(weight_decays=[0.01] * 3, **(dict(min_trust=0.01, max_trust=10.0) if clamp
                                            else {})))
        for clamp in (False, True) for steps in (1, 5)
    ]
    errs14 = {}
    for name, kind, case, steps, kw in cases14:
        if case is None:  # the main trees, drawn once each
            case = opt_case(gpt_leaves if kind == "adam" else bert_leaves, 7)
        if kind == "adam":
            kernel, plain, kw = fadam.multi_tensor_adam, fadam.multi_tensor_adam_ref_, \
                dict(adam_kw, **kw)
        else:
            kernel, plain, kw = fadam.multi_tensor_lamb, fadam.multi_tensor_lamb_ref_, \
                dict(lamb_kw, **kw)
        errs14[name] = opt_errors(kernel, plain, case, steps, **kw)
        print(f"{name}: max abs error {errs14[name][0]:.3e}, / max |ref| "
              f"{errs14[name][1]:.3e}")
        check(errs14[name][1] <= OPT_REL_TOL,
              f"{name}: max abs error / max |ref| {errs14[name][1]} > {OPT_REL_TOL}")
        del case
    # LAMB's determinism: two runs of the kernel on the same inputs agree bit for bit
    case = opt_case(bert_leaves[:4], 8)
    runs = []
    for _ in range(2):
        p14 = [t.clone() for t in case[0]]
        fadam.multi_tensor_lamb(p14, case[1], [t.clone() for t in case[2]],
                                [t.clone() for t in case[3]], 1, weight_decays=[0.01] * 4,
                                **lamb_kw)
        runs.append(p14)
    check(all(torch.equal(a, b) for a, b in zip(*runs)), "LAMB kernel runs differ")
    del case, runs, p14
    # the device block: a device count and lr give the Python numbers' bits,
    # and a skipped step (the fp16 overflow flag) writes nothing, in the
    # kernels and in their plain versions
    for kind, leaves in (("adam", gpt_leaves[:4]), ("lamb", bert_leaves[:4])):
        kernel, plain, kw = ((fadam.multi_tensor_adam, fadam.multi_tensor_adam_ref_,
                              dict(adam_kw, weight_decays=[0.1] * 4)) if kind == "adam" else
                             (fadam.multi_tensor_lamb, fadam.multi_tensor_lamb_ref_,
                              dict(lamb_kw, weight_decays=[0.01] * 4)))
        lr = kw.pop("lr")
        case = opt_case(leaves, 10)
        for fn in (kernel, plain):
            host = [[t.clone() for t in ts] for ts in (case[0], case[2], case[3])]
            dev = [[t.clone() for t in ts] for ts in (case[0], case[2], case[3])]
            fn(host[0], case[1], host[1], host[2], 3, lr, **kw)
            fn(dev[0], case[1], dev[1], dev[2], torch.full((), 3, dtype=torch.int32,
                                                           device=device),
               torch.full((), lr, dtype=torch.float32, device=device), **kw)
            skipped = [[t.clone() for t in ts] for ts in (case[0], case[2], case[3])]
            fn(skipped[0], case[1], skipped[1], skipped[2], 3, lr,
               skip=torch.ones((), dtype=torch.bool, device=device), **kw)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for x, y in zip(host, dev) for a, b in zip(x, y)),
                  f"phase 14 {kind} {fn.__name__}: device count / lr differ from Python ones")
            check(all(torch.equal(a, b) for x, y in zip(skipped, (case[0], case[2], case[3]))
                      for a, b in zip(x, y)),
                  f"phase 14 {kind} {fn.__name__}: a skipped step changed p, m or v")
        print(f"{kind}: the device block (int32 count, f32 lr) equal to Python numbers bit for "
              "bit, and skip=True leaves p, m and v bit for bit, kernel and plain version")
        del case, host, dev, skipped
    # each kernel timed at its main tree, in place (each call one more step)
    times14 = {}
    for kind, leaves in (("adam", gpt_leaves), ("lamb", bert_leaves)):
        ps, gs, ms, vs = opt_case(leaves, 9)
        if kind == "adam":
            kernel, plain = fadam.multi_tensor_adam, fadam.multi_tensor_adam_ref_
            kw = dict(adam_kw, weight_decays=gpt_wds, mode="decoupled")
            flops = 15  # a parameter: moments 7, direction 4, decay 2, apply 2
        else:
            kernel, plain = fadam.multi_tensor_lamb, fadam.multi_tensor_lamb_ref_
            kw = dict(lamb_kw, weight_decays=[0.01] * len(leaves))
            flops = 19  # as AdamW, and the two squares-and-adds of the norms
        # as the training step calls it: the count and lr device scalars, the
        # device block's one-element ops before each launch included
        lr_t = torch.full((), kw.pop("lr"), dtype=torch.float32, device=device)
        count = torch.ones((), dtype=torch.int32, device=device)
        ms_k, call_k = time_ms(lambda i: kernel(ps, gs, ms, vs, count, lr_t, **kw), 20,
                               warmup=3)
        ms_p, _ = time_ms(lambda i: plain(ps, gs, ms, vs, count, lr_t, **kw), 5, warmup=2)
        lib = None
        if kind == "adam":
            lib, _ = time_ms(library_adamw(ps, gs, ms, vs, gpt_wds, **adam_kw), 20, warmup=3)
        del lr_t, count
        (bnd, by), nbytes = opt_bound(ps, gs, flops)
        n = sum(p.numel() for p in ps)
        times14[kind] = dict(ms=ms_k, plain_ms=ms_p, library_ms=lib, bound_ms=bnd, bound_by=by)
        print(f"{'fused AdamW, gpt2-medium' if kind == 'adam' else 'fused LAMB, bert-large'} "
              f"tree ({len(ps)} leaves, {n} parameters): kernel {ms_k:.4f} ms (per call with "
              f"the host's launch path {call_k:.4f}), plain {ms_p:.4f} ms, library "
              + (f"{lib:.4f} ms" if lib is not None else "none")
              + f", bound {bnd:.4f} ms ({by}: {nbytes} bytes); {nbytes / ms_k / 1e6:.1f} GB/s, "
              f"{bnd / ms_k:.3f} of bound")
        del ps, gs, ms, vs
    return errs14, times14


# ---------------------------------------------------------------------------
# phase 16-20 helpers
# ---------------------------------------------------------------------------

# The card's ceiling for 32-bit lane instructions of any kind: 4
# schedulers an SM each issue one warp instruction a clock, 128 thread
# instructions a clock on 132 SMs at 1.98 GHz, the f32 peak of 67 TFLOP/s
# counted as FMAs. No assignment of the threefry kernel's integer work to
# pipes (the 64 INT32 lanes, adds moved to the FMA pipe as IMAD) beats it.
ISSUE_OPS_PER_S = PEAK_OPS_PER_S[torch.float32] / 2
# instructions an element needs, counted from the function: threefry2x32 of
# one counter pair is 20 rounds x (add, rotate, xor) = 60; the counter plus
# the key, 2 adds of which x0's folds into round 1's add (a three-input
# IADD3) = 1; 5 key injections x 2 adds, of which the 4 into x0 before a
# round fold into its add = 6; the final x0 ^ x1 = 1 -> 68. Loop, index and
# address arithmetic and 16-bit conversions are not counted (a floor).
THREEFRY_HASH_OPS = 20 * 3 + 1 + 6 + 1
# dropout adds the keep test, the quotient and the select; a uniform the
# mantissa (shift and or, one LEA.HI), the subtract of 1, the fma and the max
THREEFRY_OPS = {"dropout": THREEFRY_HASH_OPS + 3, "uniform_rows": THREEFRY_HASH_OPS + 4}
SAMPLING = dict(temperature=0.8, top_k=50, top_p=0.95)


def reset_threefry_launches():
    reset(prng.KERNELS)


def threefry_bound(entry, elements, bytes_moved):
    """(bound ms, what bounds it) for ``elements`` drawn by ``entry``
    (``THREEFRY_OPS``) and ``bytes_moved`` read and written once."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = elements * THREEFRY_OPS[entry] / ISSUE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dropout_launches_per_pass(n_layer):
    """The dropouts of one GPT-2 forward: the embedding's, then the
    attention output's and the MLP output's in every layer."""
    return 1 + 2 * n_layer


def sampled_margin(cpu_eng, prefix, key, row=0, rows=1):
    """The sampler's top-2 margin for the token after ``prefix`` on the CPU
    engine: its perturbed scores, gumbel(key) + the masked logits / T, row
    ``row`` of a ``[rows, V]`` draw. A token that differs between two runs
    is a tie when this margin is below TIE_MARGIN."""
    logits = cpu_eng.forward({"input_ids": np.asarray(prefix)[None]})[:, -1].float()
    lg = logits / torch.tensor(SAMPLING["temperature"], dtype=torch.float32)
    lg = tsamp.top_p_mask(tsamp.top_k_mask(lg, SAMPLING["top_k"]), SAMPLING["top_p"])
    g = prng.gumbel(key, (rows, lg.shape[-1]))[row]
    top2 = torch.topk(g + lg[0], 2).values
    return float(top2[0] - top2[1])


def request_key(seed, budget, t):
    """The key that draws a request's token t (the serving schedule)."""
    if t == 0:
        return prng.PRNGKey(seed)
    return prng.split(prng.fold_in(prng.PRNGKey(seed), 1), budget - 1)[t - 1]


def compare_sampled_streams(label, card, cpu, cpu_eng):
    """Sampled serving streams [(request, budget)] of the card and the CPU:
    identical, or a tie at the first differing token (the sampler's top-2
    margin below TIE_MARGIN). → ties."""
    ties = 0
    for i, ((a, budget), (b, _)) in enumerate(zip(card, cpu)):
        if a.tokens == b.tokens:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)
        prefix = list(np.asarray(a.prompt)) + a.tokens[:t]
        margin = sampled_margin(cpu_eng, prefix, request_key(a.seed, budget, t))
        print(f"{label}: request {i}: streams differ at token {t}, sampler top-2 margin "
              f"{margin:.3e}")
        check(margin < TIE_MARGIN, f"{label}: request {i} differs at token {t} with margin "
                                   f"{margin:.3e} >= {TIE_MARGIN} (not a tie)")
        ties += 1
    print(f"{label}: {len(card) - ties} of {len(card)} identical, {ties} ties, "
          f"{sum(len(r.tokens) for r, _ in card)} tokens compared")
    return ties


def compare_sampled_generated(label, a, b, prompt_len, seed, cpu_eng):
    """Two sampled ``generate`` outputs ``[B, S + new]`` (one key for the
    batch a step): rows identical or a tie, as above. → ties."""
    ties = 0
    rows, new = a.shape[0], a.shape[1] - prompt_len
    for r in range(rows):
        if np.array_equal(a[r], b[r]):
            continue
        t = int(np.nonzero(a[r] != b[r])[0][0]) - prompt_len
        key = (prng.PRNGKey(seed) if t == 0
               else prng.split(prng.fold_in(prng.PRNGKey(seed), 1), new - 1)[t - 1])
        margin = sampled_margin(cpu_eng, a[r, :prompt_len + t], key, r, rows)
        print(f"{label}: row {r}: differs at new token {t}, sampler top-2 margin {margin:.3e}")
        check(margin < TIE_MARGIN, f"{label}: row {r} differs with margin {margin:.3e} >= "
                                   f"{TIE_MARGIN} (not a tie)")
        ties += 1
    print(f"{label}: {rows - ties} of {rows} rows identical, {ties} ties, {rows * new} tokens "
          "compared")
    return ties


def tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def named_leaves(tree, prefix=""):
    """{path: tensor} of a parameter tree, a quantized weight's fields
    included."""
    if isinstance(tree, dict):
        return {name: leaf for k, v in tree.items()
                for name, leaf in named_leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, tuple):
        return {f"{prefix}{f}": v for f, v in zip(tree._fields, tree)}
    return {prefix[:-1]: tree}


def serve_phase(label, eng, section, traffic, vocab):
    """Serve ``traffic(srv)`` → (stats, requests): every request finished
    with its budget, no leaked pages (the prefix index released)."""
    srv = eng.serve(section)
    reqs = traffic(srv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = exact_stats(srv)
    check(len(done) == len(reqs), f"{label}: {len(done)} of {len(reqs)} requests completed")
    for req, budget in reqs:
        check(req.status == RequestStatus.FINISHED and len(req.tokens) == budget
              and all(0 <= x < vocab for x in req.tokens),
              f"{label}: request {req.id}: {req.status} {req.detail}, {len(req.tokens)} of "
              f"{budget} tokens")
    srv.check_no_leaks()
    srv.release_prefix_cache()
    srv.allocator.check_no_leaks()
    st["wall_s"] = wall
    return st, reqs


def exact_stats(srv):
    """``srv.stats()`` with its ``ttft`` and ``tpot`` entries replaced by
    exact percentiles over the completed requests (each request's TTFT
    and mean TPOT): ``stats()`` interpolates over histogram buckets, as the
    JAX engine does, and between 2.5 and 5 ms a bucket is as coarse as
    the TPOT it would report. The printouts name them exact."""
    return dict(srv.stats(), **exact_percentiles(srv.completed))


def serving_numbers(st):
    return (f"decode tokens/s {st['decode_tokens_per_s']:.1f}, (exact percentiles) TPOT p50 "
            f"{st['tpot']['p50_s'] * 1e3:.3f} ms, TTFT p50 {st['ttft']['p50_s'] * 1e3:.2f} ms, "
            f"wall {st['wall_s']:.3f} s")


def four_layer_tree(seed=7):
    """gpt2-medium width at 4 layers, seeded fp32 weights as numpy (phase
    4's and 9's tree for seed 7)."""
    cfg4 = gpt2.get_config("gpt2-medium", n_layer=4)
    return cfg4, params_to_numpy(gpt2.init_params(
        cfg4, torch.Generator(device="cuda").manual_seed(seed), "cuda", torch.float32))


def threefry_kernels_phase():
    """Phase 16: the dropout kernel (forward and backward) and uniform_rows
    against their plain versions on the card, bit for bit, then timed. →
    {"dropout": numbers, "uniform_rows": numbers} at the main shapes."""
    S16 = (8, 1024, 1024)  # phase 6's activations: micro 8 x S1024 x E1024
    g = torch.Generator(device="cuda").manual_seed(16)
    key = prng.fold_in(prng.PRNGKey(1), 16)
    drop_err = uni_err = 0.0
    # the main shape, an odd size, and tails past the 16-byte vectors (8 k +
    # 1 .. 7 elements: the kernel's scalar tail after 8-wide bf16/fp16 and
    # 4-wide f32 vectors)
    for shape in (S16, (3, 1001, 7)) + tuple((8 * 1000 + t,) for t in range(1, 8)):
        for dt in (torch.bfloat16, torch.float16, torch.float32):
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            dy = torch.randn(shape, generator=g, device="cuda").to(dt)
            for rate in (0.1, 0.5):
                xg = x.clone().requires_grad_(True)
                y = tdo.dropout(xg, key, rate)
                (gx,) = torch.autograd.grad(y, xg, dy)
                y_ref, g_ref = tdo.dropout_ref(x, key, rate), tdo.dropout_ref(dy, key, rate)
                torch.cuda.synchronize()
                y = y.detach()
                drop_err = max(drop_err, float((y.float() - y_ref.float()).abs().max()),
                               float((gx.float() - g_ref.float()).abs().max()))
                check(torch.equal(y, y_ref) and torch.equal(gx, g_ref),
                      f"dropout {shape} {dt} rate {rate}: kernel differs from its plain version "
                      f"(forward {int((y != y_ref).sum())}, backward {int((gx != g_ref).sum())} "
                      "elements)")
                print(f"dropout {shape} {str(dt).replace('torch.', '')} rate {rate}: forward and "
                      f"backward equal to the plain version bit for bit, kept "
                      f"{float((y_ref != 0).float().mean()):.5f}")
    # the kernel reads its key from device memory: a device key (a slot of a
    # training step's key table) and a host key (copied up) draw the same
    # bits, and a slot rewritten in place is read anew
    dkey = prng.device_keys(key, "cuda")
    table = prng.device_keys(np.stack([prng.PRNGKey(0), key]), "cuda")
    x = torch.randn(S16, generator=g, device="cuda").to(torch.bfloat16)
    y_host = prng.dropout_kernel(x, key, 0.1)
    y_dev = prng.dropout_kernel(x, dkey, 0.1)
    y_slot = prng.dropout_kernel(x, table[1], 0.1)
    table[1].copy_(table[0])
    y_other = prng.dropout_kernel(x, table[1], 0.1)
    torch.cuda.synchronize()
    check(torch.equal(y_host, y_dev) and torch.equal(y_host, y_slot)
          and torch.equal(y_other, tdo.dropout_ref(x, prng.PRNGKey(0), 0.1)),
          "phase 16: the dropout kernel's device keys draw other bits than its host keys")
    print("dropout keys from device memory: a device key, a key-table slot and a host key "
          "draw the same mask, and a rewritten slot draws its new key's (bit for bit)")
    del x, y_host, y_dev, y_slot, y_other, table
    # a misaligned view (x starts one element past a 16-byte boundary while
    # its output is aligned: the kernel's scalar walk), and an aligned view
    # with a head (both one element in)
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        base = torch.randn(8 * 4099 + 3, generator=g, device="cuda").to(dt)
        x = base[1:]
        check(x.data_ptr() % 16 != 0, "phase 16: the misaligned view is aligned")
        for rate in (0.1, 0.5):
            y = prng.dropout_kernel(x, key, rate)
            y_ref = tdo.dropout_ref(x, key, rate)
            out_view = torch.empty_like(base)[1:]
            lib = op_builder.load("threefry")
            p, c = prng.keep_scale(rate, dt)
            r, mul = prng.reciprocal_is_exact(rate, dt)
            err = lib.threefry_dropout_launch(x.data_ptr(), out_view.data_ptr(), x.numel(),
                                              dkey.data_ptr(), prng.keep_threshold(p), c, r,
                                              int(mul),
                                              prng.DTYPES[dt], 2,
                                              torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"phase 16: launch into a view failed ({err})")
            torch.cuda.synchronize()
            drop_err = max(drop_err, float((y.float() - y_ref.float()).abs().max()))
            check(torch.equal(y, y_ref) and torch.equal(out_view, y_ref),
                  f"dropout misaligned view {dt} rate {rate}: kernel differs from its plain "
                  f"version ({int((y != y_ref).sum())} / {int((out_view != y_ref).sum())} "
                  "elements)")
        print(f"dropout {str(dt).replace('torch.', '')}, a view one element past a 16-byte "
              f"boundary ({x.numel()} elements), into an aligned output and into a view as "
              "misaligned as x: equal to the plain version bit for bit")
    out = {}
    x = torch.randn(S16, generator=g, device="cuda").to(torch.bfloat16)
    ms, _ = time_ms(lambda i: prng.dropout_kernel(x, dkey, 0.1), 50)
    plain_ms, _ = time_ms(lambda i: tdo.dropout_ref(x, dkey, 0.1), 5, warmup=2)
    lib_ms, _ = time_ms(lambda i: F.dropout(x, 0.1, training=True), 50)
    nbytes = 2 * x.numel() * x.element_size()
    bound, by = threefry_bound("dropout", x.numel(), nbytes)
    out["dropout"] = dict(max_abs_err=drop_err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                          bound_by=by, library_ms=lib_ms)
    print(f"dropout bf16 {S16} rate 0.1, device ms per call: kernel {ms:.4f}, plain "
          f"{plain_ms:.4f}, library (F.dropout, another stream of bits) {lib_ms:.4f}, bound "
          f"{bound:.5f} ({by}: {THREEFRY_OPS['dropout']} instructions an element at "
          f"{ISSUE_OPS_PER_S:.4e}/s; {nbytes} bytes at 3.35 TB/s); kernel at "
          f"{bound / ms:.3f} of bound")
    # 28e, the element offset (a data-parallel rank's slice of the global
    # draw): a [4] device key with shard s draws elements [s n, (s + 1) n)
    full = prng.dropout_kernel(x, key, 0.1)
    n_half = x.numel() // 2
    for s_idx, part in ((0, x[:4]), (1, x[4:])):
        skey = prng.device_keys(prng.shard_key(key, s_idx), "cuda")
        y = prng.dropout_kernel(part, skey, 0.1)
        y_ref = tdo.dropout_ref(part, skey, 0.1)
        torch.cuda.synchronize()
        check(torch.equal(y, full[4 * s_idx:4 * s_idx + 4]) and torch.equal(y, y_ref),
              f"28e: dropout at element offset {s_idx * n_half} differs from the full draw's "
              f"slice ({int((y != full[4 * s_idx:4 * s_idx + 4]).sum())}) or from its plain "
              f"version ({int((y != y_ref).sum())})")
    # offsets past 2^32 (the counter's high word) and a slice whose counters
    # cross 2^32 (the kernel's 64-bit walk), against the plain version
    small = torch.randn(8000 + 3, generator=g, device="cuda").to(torch.bfloat16)
    for s_idx in (2 ** 32 // small.numel(), 2 ** 32 // small.numel() + 1, 3 * 2 ** 20 + 7):
        skey = prng.device_keys(prng.shard_key(key, s_idx), "cuda")
        y, y_ref = prng.dropout_kernel(small, skey, 0.1), tdo.dropout_ref(small, skey, 0.1)
        torch.cuda.synchronize()
        check(torch.equal(y, y_ref), f"28e: dropout at shard {s_idx} (offset "
                                     f"{s_idx * small.numel()}) differs from its plain version")
    skey = prng.device_keys(prng.shard_key(key, 1), "cuda")
    ms_off, _ = time_ms(lambda i: prng.dropout_kernel(x, skey, 0.1), 50)
    ms_0, _ = time_ms(lambda i: prng.dropout_kernel(x, dkey, 0.1), 50)
    print(f"28e: dropout at element offset {n_half} (shard 1 of [4, 1024, 1024]) equals the "
          "second half of the full draw bit for bit, and shard 0 the first; offsets past 2^32 "
          "and a slice across 2^32 equal the plain version. Device ms per call at "
          f"{S16}: offset {x.numel()} (shard 1) {ms_off:.4f}, offset 0 (a [2] key) {ms_0:.4f}, "
          f"the same call's ratio {ms_off / ms_0:.4f}")
    out["dropout_offset_ms"] = ms_off
    del x, full, small
    V = 50257
    for R, n in ((1, 8 * V), (16, V)):
        keys = prng.split(prng.PRNGKey(R), R)
        for lo in (0.0, prng.TINY_F32):
            got = prng.uniform_rows_kernel(keys, n, lo, 1.0, "cuda")
            ref = prng.uniform_rows_ref(keys, n, lo, 1.0, "cuda")
            uni_err = max(uni_err, float((got - ref).abs().max()))
            check(torch.equal(got, ref), f"uniform_rows R{R} n{n} min {lo}: kernel differs from "
                                         f"its plain version ({int((got != ref).sum())} elements)")
        ms, _ = time_ms(lambda i: prng.uniform_rows_kernel(keys, n, prng.TINY_F32, 1.0, "cuda"), 50)
        plain_ms, _ = time_ms(lambda i: prng.uniform_rows_ref(keys, n, prng.TINY_F32, 1.0,
                                                              "cuda"), 5, warmup=2)
        lib_ms, _ = time_ms(lambda i: torch.rand(R, n, device="cuda"), 50)
        bound, by = threefry_bound("uniform_rows", R * n, 4 * R * n + 8 * R)
        if R == 16:  # a serving step's draw at 16 slots: the main shape
            out["uniform_rows"] = dict(max_abs_err=uni_err, ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound, bound_by=by, library_ms=lib_ms)
        print(f"uniform_rows R{R} x n{n} (min 0 and tiny: equal to the plain version bit for "
              f"bit), device ms per call: kernel {ms:.4f}, plain {plain_ms:.4f}, library "
              f"(torch.rand, another stream) {lib_ms:.4f}, bound {bound:.5f} ({by}: "
              f"{THREEFRY_OPS['uniform_rows']} instructions an element); kernel at "
              f"{bound / ms:.3f} of bound")
    return out


def dropout_training_phase(step_ms_ref=None, steps=12):
    """Phase 17: phase 6's training at dropout 0.1: losses finite and
    falling, the dropout launches exact, flash and AdamW as in phase 6. →
    the dropout launches."""
    cfg = gpt2.get_config("gpt2-medium", dropout=0.1)
    conf = train_config(micro=8, gas=2)
    eng, _, _, _ = dtt.initialize(model=gpt2.make_module(cfg), config=conf, seed=0)
    S = cfg.n_positions
    batch = {"input_ids": np.random.RandomState(5).randint(
        0, cfg.vocab_size, (eng.train_batch_size, S)).astype(np.int32)}  # phase 6's batch
    gas = eng.gradient_accumulation_steps
    per_pass = dropout_launches_per_pass(cfg.n_layer)
    want = 2 * per_pass * gas * steps
    print(f"expected dropout launches: {per_pass} a micro-batch forward (1 embedding + 2 x "
          f"{cfg.n_layer} layers), the same in the backward, x {gas} micro-batches x {steps} "
          f"steps = {want} (no remat: nothing recomputed)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    reset_optimizer_launches()
    reset_threefry_launches()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(eng.train_batch(batch)["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = LAUNCHES["threefry_dropout"]
    fwd, bwd = LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_bwd"]
    check_optimizer_launches("phase 17", steps)
    check(all(np.isfinite(losses)), f"phase 17: non-finite losses {losses}")
    check(losses[-1] < losses[0], f"phase 17: loss did not fall: {losses}")
    check(launches == want, f"phase 17: dropout launches {launches} != {want}")
    check(LAUNCHES["threefry_uniform_rows"] == 0, "phase 17: uniform_rows launched")
    want_flash = cfg.n_layer * gas * steps
    check(fwd == want_flash and bwd == want_flash,
          f"phase 17: flash launches {fwd} / {bwd}, expected {want_flash} each")
    step_ms = statistics.median(step_s[2:]) * 1e3
    tokens = eng.train_batch_size * S
    print("losses " + " ".join(f"{x:.4f}" for x in losses))
    print(f"dropout launches {launches} (= {want}); flash {fwd} / {bwd} (= {want_flash} each); "
          f"fused AdamW {steps}")
    print(f"step ms (median of steps 3-{steps}) {step_ms:.2f} at dropout 0.1"
          + ("" if step_ms_ref is None else
             f" against {step_ms_ref:.2f} without (phase 6, this call)")
          + "; steps " + " ".join(f"{x * 1e3:.1f}" for x in step_s)
          + f"; tokens/s {tokens / (step_ms / 1e3):.1f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def dropout_card_cpu_phase():
    """Phase 18: fp32 at gpt2-medium width, 4 layers, dropout 0.1 (phase 7's
    weights, batch and AdamW): the card's losses against the CPU's, the
    masks equal bit for bit, so phase 7's tolerance holds."""
    cfg = gpt2.get_config("gpt2-medium", n_layer=4, dropout=0.1)
    _, tree = four_layer_tree(seed=11)
    batch = {"input_ids": np.random.RandomState(7).randint(
        0, cfg.vocab_size, (4, 256)).astype(np.int32)}
    conf = train_config(micro=2, gas=2)
    conf.pop("bf16")
    want = 2 * dropout_launches_per_pass(cfg.n_layer) * 2 * 3
    losses = {}
    for dev in ("cuda", "cpu"):
        reset_threefry_launches()
        eng, _, _, _ = dtt.initialize(model=gpt2.make_module(cfg), config=conf,
                                      model_parameters=params_from_numpy(tree, dev), device=dev)
        losses[dev] = [float(eng.train_batch(batch)["loss"]) for _ in range(3)]
        got = LAUNCHES["threefry_dropout"]
        check(got == (want if dev == "cuda" else 0),
              f"phase 18 {dev} run: dropout launches {got}")
        del eng
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
    print("losses card " + " ".join(f"{x:.7f}" for x in losses["cuda"]) + ", CPU "
          + " ".join(f"{x:.7f}" for x in losses["cpu"]) + ", relative differences "
          + " ".join(f"{x:.3e}" for x in rel) + f"; dropout launches on the card {want}")
    check(rel[0] <= 1e-5, f"phase 18: step-1 loss card vs CPU: relative {rel[0]} > 1e-5")
    check(max(rel[1:]) <= 1e-4, f"phase 18: later losses card vs CPU: relative {rel} > 1e-4")


def int8_weights_phase(st_3=None, st_3c=None):
    """Phase 19: weight-only int8 serving at full width (phase 3's traffic
    at 1 and 64 groups, 3c's features with int8 KV pages), then fp32
    compute over int8 codes at 4 layers, card against CPU."""
    cfg = gpt2.get_config("gpt2-medium")
    spec_k = FEATURES_SECTION["speculative"]["k"]
    for label, conf in (("1 group", None), ("quantization_setting 64",
                                            {"quantization_setting": 64})):
        eng = dtt.init_inference(cfg, dtype="int8", seed=0, config=conf)
        groups = 1 if conf is None else 64
        w = eng.params["blocks"]["mlp"]["c_fc_w"]
        check(eng.quantized and eng.dtype == torch.bfloat16 and w.q.dtype == torch.int8
              and w.q.shape[1] == groups, f"phase 19 {label}: {w.q.shape}")
        qbytes = tree_bytes(eng.params)
        # the bf16 tree: 2 bytes for each code's weight and each other
        # element; the [L, G, 1, O] scales exist only beside the codes
        bf16_bytes = sum(t.numel() * 2 for t in tree_leaves(eng.params)
                         if t.dtype == torch.int8 or t.dim() != 4)
        LAUNCHES[K_PAGED] = LAUNCHES[K_PAGED8] = 0
        torch.cuda.reset_peak_memory_stats()
        st, _ = serve_phase(f"phase 19 {label}", eng, None,
                            lambda s: mixed_requests(s, 16, cfg.vocab_size, seed=1234),
                            cfg.vocab_size)
        check(LAUNCHES[K_PAGED] == cfg.n_layer * st["decode_steps"],
              f"phase 19 {label}: decode launches {LAUNCHES[K_PAGED]} != {cfg.n_layer} x "
              f"{st['decode_steps']}")
        print(f"int8 weights, {label}: weight bytes {qbytes} against bf16 {bf16_bytes} "
              f"({qbytes / bf16_bytes:.4f}); 16 of 16 finished; decode launches {LAUNCHES[K_PAGED]} "
              f"(= {cfg.n_layer} x {st['decode_steps']}); " + serving_numbers(st)
              + ("" if st_3 is None else
                 f" (phase 3, bf16 weights, this call: {serving_numbers(st_3)})")
              + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if conf is None:
            LAUNCHES[K_PAGED] = LAUNCHES[K_PAGED8] = 0
            LAUNCHES[K_MT] = LAUNCHES[K_MT8] = 0
            stc, _ = serve_phase(
                "phase 19 int8 weights + 3c", eng, dict(FEATURES_SECTION, kv_cache_dtype="int8"),
                lambda s: shared_prefix_requests(s, cfg.vocab_size, seed=4321, n_shared=8,
                                                 n_cold=8, system_len=256, tails=(8, 128),
                                                 cold_lens=(64, 512), budgets=(16, 64)),
                cfg.vocab_size)
            check(stc["prefix_hits_partial"] + stc["prefix_hits_full"] > 0
                  and LAUNCHES[K_MT8] == cfg.n_layer * stc["chunk_prefills"]
                  and LAUNCHES[K_PAGED8] == cfg.n_layer * (spec_k + 1) * stc["spec_steps"]
                  and LAUNCHES[K_PAGED] + LAUNCHES[K_MT] == 0,
                  f"phase 19 int8 weights + 3c: {stc}, launches {LAUNCHES[K_PAGED8]} "
                  f"{LAUNCHES[K_MT8]}")
            print(f"int8 weights + int8 KV pages + 3c's features: 16 of 16 finished, prefix hits "
                  f"{stc['prefix_hits_partial'] + stc['prefix_hits_full']}, int8 launches "
                  f"multitoken {LAUNCHES[K_MT8]} (= {cfg.n_layer} x {stc['chunk_prefills']}), "
                  f"decode {LAUNCHES[K_PAGED8]} (= {cfg.n_layer} x {spec_k + 1} x "
                  f"{stc['spec_steps']}); " + serving_numbers(stc)
                  + ("" if st_3c is None else f" (3c, bf16 weights: {serving_numbers(st_3c)})"))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # fp32 compute over int8 codes (64 groups) at gpt2-medium width, 4
    # layers: the card's codes equal the CPU's, and the greedy streams
    # (fp32 and int8 KV pages) and generate's tokens match under the tie rule
    cfg4, tree = four_layer_tree()
    engs = {dev: dtt.init_inference(cfg4, params=params_from_numpy(tree, dev),
                                    dtype=torch.float32, device=dev,
                                    config={"quantization_setting": 64})
            for dev in ("cuda", "cpu")}
    card, cpu = named_leaves(engs["cuda"].params), named_leaves(engs["cpu"].params)
    check(card.keys() == cpu.keys() and all(torch.equal(card[k].cpu(), cpu[k]) for k in card),
          "phase 19: the card's int8 codes or scales differ from the CPU's")
    print(f"int8 codes and scales of {len(card)} leaves equal on the card and the CPU")
    for kv in (None, "int8"):
        streams = {}
        for dev in ("cuda", "cpu"):
            s = engs[dev].serve(None if kv is None else {"kv_cache_dtype": kv},
                                track_margins=True)
            rq = mixed_requests(s, 8, cfg4.vocab_size, seed=99)
            s.run()
            s.check_no_leaks()
            streams[dev] = [r for r, _ in rq]
        compare_streams(f"int8 weights (64 groups, fp32 compute), KV {kv or 'fp32'}, card vs CPU",
                        streams["cuda"], streams["cpu"])
    ids = np.random.RandomState(19).randint(0, cfg4.vocab_size, (4, 100)).astype(np.int32)
    compare_generated("int8 weights generate, card vs CPU", engs["cpu"],
                      engs["cuda"].generate(ids, max_new_tokens=32),
                      engs["cpu"].generate(ids, max_new_tokens=32), 100, TIE_MARGIN)


def sampled_phase(st_3=None):
    """Phase 20: sampled serving and generate, fp32 at 4 layers card
    against CPU under the sampler's tie rule, then bf16 at full width with
    exact uniform_rows launches. → the serving run's uniform_rows launches."""
    cfg4, tree = four_layer_tree()
    runs, engs = {}, {}
    for dev in ("cuda", "cpu"):
        engs[dev] = dtt.init_inference(cfg4, params=params_from_numpy(tree, dev),
                                       dtype=torch.float32, device=dev)
        for name, section in (("default", {}), ("chunked + prefix cache",
                                                {"max_slots": 4, "prefill_chunk_tokens": 32,
                                                 "prefix_cache": {"enabled": True}})):
            s = engs[dev].serve(dict(section, **SAMPLING))
            rq = (mixed_requests(s, 8, cfg4.vocab_size, seed=99) if name == "default" else
                  shared_prefix_requests(s, cfg4.vocab_size, seed=77, n_shared=4, n_cold=4,
                                         system_len=64, tails=(1, 64), cold_lens=(8, 128),
                                         budgets=(16, 64)))
            s.run()
            s.check_no_leaks()
            for req, budget in rq:
                check(req.status == RequestStatus.FINISHED and len(req.tokens) == budget,
                      f"phase 20 {dev} {name}: request {req.id} {req.status}")
            runs[dev, name] = rq
    for name in ("default", "chunked + prefix cache"):
        compare_sampled_streams(f"sampled fp32 serving, {name}, card vs CPU",
                                runs["cuda", name], runs["cpu", name], engs["cpu"])
    ids = np.random.RandomState(20).randint(0, cfg4.vocab_size, (4, 100)).astype(np.int32)
    compare_sampled_generated("sampled fp32 generate, card vs CPU",
                              engs["cuda"].generate(ids, max_new_tokens=32, seed=5, **SAMPLING),
                              engs["cpu"].generate(ids, max_new_tokens=32, seed=5, **SAMPLING),
                              100, 5, engs["cpu"])
    del engs
    gc.collect()
    # bf16 at full width: every request finishes; one uniform_rows launch
    # for each sampled token step (a prefill, a decode step, a generate step)
    eng = dtt.init_inference("gpt2-medium", seed=0)
    vocab, L = eng.model_config.vocab_size, eng.model_config.n_layer
    srv = eng.serve(dict(SAMPLING))
    reqs = mixed_requests(srv, 16, vocab, seed=1234)  # phase 3's traffic, sampled
    torch.cuda.synchronize()
    reset_threefry_launches()
    LAUNCHES[K_PAGED] = 0
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    st = dict(exact_stats(srv), wall_s=time.perf_counter() - t0)
    launches = LAUNCHES["threefry_uniform_rows"]
    check(len(done) == 16 and all(r.status == RequestStatus.FINISHED and len(r.tokens) == b
                                  and all(0 <= x < vocab for x in r.tokens) for r, b in reqs),
          f"phase 20: {len(done)} of 16 finished")
    srv.check_no_leaks()
    check(launches == st["decode_steps"] + st["prefills"]
          and LAUNCHES[K_PAGED] == L * st["decode_steps"] and LAUNCHES["threefry_dropout"] == 0,
          f"phase 20: uniform_rows launches {launches} != decode steps {st['decode_steps']} + "
          f"prefills {st['prefills']}; decode {LAUNCHES[K_PAGED]}")
    print(f"sampled bf16 serving: 16 of 16 finished; uniform_rows launches {launches} (= "
          f"{st['decode_steps']} decode steps + {st['prefills']} prefills), decode kernel "
          f"{LAUNCHES[K_PAGED]}; " + serving_numbers(st)
          + ("" if st_3 is None else f" (greedy, phase 3: {serving_numbers(st_3)})"))
    del srv
    ids = np.random.RandomState(21).randint(0, vocab, (8, 128)).astype(np.int32)
    eng.generate(ids, max_new_tokens=64, seed=3, **SAMPLING)  # warm-up
    reset_threefry_launches()
    t0 = time.perf_counter()
    out = eng.generate(ids, max_new_tokens=64, seed=3, **SAMPLING)
    wall = time.perf_counter() - t0
    check(out.shape == (8, 192) and LAUNCHES["threefry_uniform_rows"] == 64
          and ((out[:, 128:] >= 0) & (out[:, 128:] < vocab)).all(),
          f"phase 20 generate: {out.shape}, launches {counts(prng.KERNELS)}")
    print(f"sampled bf16 generate B8 128 + 64: uniform_rows launches 64 (one a token step), "
          f"{wall * 1e3 / 64:.3f} ms per generated token")
    return launches


# ---------------------------------------------------------------------------
# phase 21 helpers
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def eager_programs(on=True):
    """Programs built inside run uncaptured: the private switch of
    ``utils/graphs.py``, for the capture-against-eager comparison only."""
    prev, graphs._EAGER = graphs._EAGER, on
    try:
        yield
    finally:
        graphs._EAGER = prev


# the kernels that run inside the inference programs
PROGRAM_KERNELS = (K_DECODE, K_PAGED, K_PAGED8, K_MT, K_MT8, "threefry_uniform_rows")


def program_counts():
    """The launch counts of the programs' kernels now, by name."""
    return counts(PROGRAM_KERNELS)


def reset_program_counts():
    reset(PROGRAM_KERNELS)


def until_traced(run, attempts=3):
    """``run()`` → a profiled run's numbers with ``traced``; up to
    ``attempts`` runs, the first whose every kernel's events equal its
    launches counted (the trace can lose a device record, at its start and
    in a long process mid-run: PERF.md's PR 16 findings; a kernel a program
    lacks is missing from every trace) → that run's numbers, with
    ``attempts``."""
    for n in range(1, attempts + 1):
        r = run()
        if all(seen == counted for _, seen, counted in r["traced"]):
            break
    r["attempts"] = n
    return r


def check_traced(label, traced):
    """A profiled run's program kernels: each one's events in the trace
    equal the launches its wrapper counted in that run (a replay adds its
    capture's count), so the counts phase 21 prints are kernels that ran →
    a summary for the printout."""
    check(any(counted for _, _, counted in traced) and
          all(seen == counted for _, seen, counted in traced),
          f"phase 21 {label}: kernels in the trace against launches counted {traced}")
    return f"{label}: " + ", ".join(f"{name.strip(':<_')} {seen} = {counted}"
                                    for name, seen, counted in traced if counted)


def generate_sides(engines, ids_by_len, new, kw):
    """``generate`` on the captured and the eager engine: per side, a call
    a prompt length to warm up (the captured side a second, which captures
    its entry), then one timed call a length → {side: {length: (tokens,
    wall s, counts)}}."""
    out = {}
    for side, eng in engines.items():
        with eager_programs(side == "eager"):
            for _ in range(1 if side == "eager" else 2):
                for ids in ids_by_len.values():
                    eng.generate(ids, max_new_tokens=new, **kw)
            out[side] = {}
            for n, ids in ids_by_len.items():
                torch.cuda.synchronize()
                reset_program_counts()
                t0 = time.perf_counter()
                toks = eng.generate(ids, max_new_tokens=new, **kw)
                out[side][n] = (toks, time.perf_counter() - t0, program_counts())
    return out


def entry_programs(eng):
    return [p for entry in eng._generate_cache.values() for p in entry.programs]


def serve_sides(eng, section, traffic):
    """One serving engine a side over ``traffic``, eager first → {side:
    (stats, [tokens per request], launch counts, the engine's programs)}."""
    out = {}
    for side in ("eager", "captured"):
        with eager_programs(side == "eager"):
            srv = eng.serve(section)
        reqs = traffic(srv)
        torch.cuda.synchronize()
        reset_program_counts()
        t0 = time.perf_counter()
        srv.run()
        torch.cuda.synchronize()
        st = dict(exact_stats(srv), wall_s=time.perf_counter() - t0)
        n = program_counts()
        for req, budget in reqs:
            check(req.status == RequestStatus.FINISHED and len(req.tokens) == budget,
                  f"phase 21 {side}: request {req.id} {req.status}, {len(req.tokens)} of {budget}")
        srv.check_no_leaks()
        srv.release_prefix_cache()
        srv.allocator.check_no_leaks()
        check(len(srv.executables) == srv.expected_executables,
              f"phase 21 {side}: {len(srv.executables)} programs, expected "
              f"{srv.expected_executables}")
        out[side] = (st, [list(r.tokens) for r, _ in reqs], n, list(srv.executables))
        del srv
    return out


def captured_programs_phase(smi):
    """Phase 21: the compiled-program contract on the card, captured CUDA
    graphs against the same programs run eagerly, in one process."""
    eng = dtt.init_inference("gpt2-medium", seed=0)
    cfg = eng.model_config
    L, vocab = cfg.n_layer, cfg.vocab_size
    engines = {"captured": eng, "eager": dtt.init_inference(cfg, params=eng.params)}
    ids = np.random.RandomState(21).randint(0, vocab, (8, 128)).astype(np.int32)
    by_len = {128: ids, 100: ids[:, :100]}
    new = 128
    gen = {}
    for mode, kw in (("greedy", {}), ("sampled", dict(SAMPLING, seed=3))):
        res = generate_sides(engines, by_len, new, kw)
        for n in by_len:
            (tc, wc, cc), (te, we, ce) = res["captured"][n], res["eager"][n]
            check(np.array_equal(tc, te), f"phase 21 generate {mode} prompt {n}: captured "
                  f"tokens differ from eager in {int((tc != te).sum())} places")
            want = {K_DECODE: L * (new - 1),
                    "threefry_uniform_rows": new if mode == "sampled" else 0}
            for side, c in (("captured", cc), ("eager", ce)):
                check(all(c[k] == v for k, v in want.items()) and c[K_PAGED] == 0,
                      f"phase 21 generate {mode} {side} prompt {n}: launches {c}, want {want}")
            gen[mode, n] = (wc, we)
            print(f"generate {mode} B8 prompt {n} (bucket 128) + {new}: tokens identical "
                  f"captured / eager; launches equal ({cc[K_DECODE]} decode = {L} x "
                  f"{new - 1}, {cc['threefry_uniform_rows']} uniform_rows); ms per generated token "
                  f"captured {wc * 1e3 / new:.3f} / eager {we * 1e3 / new:.3f}, tokens/s "
                  f"{8 * new / wc:.1f} / {8 * new / we:.1f} ({smi})")
    progs = entry_programs(eng)
    check(len(eng._generate_cache) == 2 and all(p.graph is not None for p in progs),
          f"phase 21: {len(eng._generate_cache)} generate entries (want one a sampling key, "
          "both prompt lengths in the 128 bucket's), graphs "
          f"{[p.graph is not None for p in progs]}")
    check(not any(p.graph is not None for p in entry_programs(engines["eager"])),
          "phase 21: the eager engine captured a graph")
    print(f"generate cache: {len(eng._generate_cache)} entries (greedy, sampled), "
          f"{len(progs)} graphs, capture ms " + ", ".join(
              f"{p.name} {p.capture_ms:.1f}" for p in progs)
          + f"; replays {sum(p.replays for p in progs)}")
    # idle share of the device, each side (profile_generate, B8 128 + 32:
    # the profiler's processing of an eager call's events sets the pace
    # on a slow host, so the profiled call is 32 tokens long)
    idle = {side: until_traced(lambda e=e, side=side: profile_generate(
        e, ids, 32, eager=side == "eager")) for side, e in engines.items()}
    print("generate under torch.profiler: " + "; ".join(
        f"{side} wall {r['wall_s'] * 1e3:.1f} ms, device busy {r['device_busy_s'] * 1e3:.1f} "
        f"ms, idle share {r['idle_share']:.3f}, {r['graphs']} graphs"
        for side, r in idle.items()) + f" ({smi})")
    traced = [check_traced(f"generate greedy {side} (profiled calls {r['attempts']})",
                           r["traced"]) for side, r in idle.items()]
    del engines["eager"]

    # the LRU cap, as TestGenerateCacheLRU drives it, and the memory an
    # eviction gives back
    lru = dtt.init_inference(cfg, params=eng.params, config={"generate_cache_size": 2})
    for m in (1, 2, 1, 3):
        lru.generate(ids, max_new_tokens=m)
    check(len(lru._generate_cache) == 2 and lru.generate_cache_evictions == 1
          and {k[1] for k in lru._generate_cache} == {1, 3},
          f"phase 21 LRU: keys {list(lru._generate_cache)}, evictions "
          f"{lru.generate_cache_evictions}")
    out2 = lru.generate(ids, max_new_tokens=2)
    check(out2.shape == (8, 130) and lru.generate_cache_evictions == 2,
          f"phase 21 LRU: {out2.shape}, evictions {lru.generate_cache_evictions}")
    victim = next(iter(lru._generate_cache.values()))
    victim_bytes = sum(t.numel() * t.element_size()
                       for t in (victim.state.cache.k, victim.state.cache.v))
    del victim
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    lru.generate(ids[:1, :4], max_new_tokens=1)  # evicts the least recent entry
    m1 = torch.cuda.memory_allocated()
    check(lru.generate_cache_evictions == 3 and m1 <= m0 - 0.9 * victim_bytes,
          f"phase 21 LRU: memory {m0} -> {m1} bytes after evicting a {victim_bytes}-byte cache")
    print(f"generate_cache_size 2: keys (max_new) {sorted(k[1] for k in lru._generate_cache)}"
          f", evictions {lru.generate_cache_evictions} (TestGenerateCacheLRU's sequence, then "
          f"one more); memory_allocated {m0 / 2**20:.1f} -> {m1 / 2**20:.1f} MiB after "
          f"evicting an entry with a {victim_bytes / 2**20:.1f} MiB KV cache")
    del lru

    # the logits, through the margins track_margins records for every token
    # (top-1 minus top-2 of its step's logits): the same kernels in the same
    # order, so captured and eager should agree bit for bit
    margins = {}
    for side in ("eager", "captured"):
        with eager_programs(side == "eager"):
            srv = eng.serve(None, track_margins=True)
        reqs = mixed_requests(srv, 8, vocab, seed=77)
        srv.run()
        margins[side] = [(list(r.tokens), list(r.margins)) for r, _ in reqs]
        del srv
    check([t for t, _ in margins["captured"]] == [t for t, _ in margins["eager"]],
          "phase 21: captured and eager streams differ under track_margins")
    diff = max(abs(a - b) for (_, ma), (_, mb) in zip(margins["captured"], margins["eager"])
               for a, b in zip(ma, mb))
    print(f"serving logits, captured against eager (the top-2 margin of every token of 8 "
          f"requests): max difference {diff:.3e}" + (" (bit for bit)" if diff == 0 else ""))

    # serving: phases 3, 3b, 3c and 20's traffic, eager then captured
    spec_k = FEATURES_SECTION["speculative"]["k"]
    shared = lambda s: shared_prefix_requests(  # noqa: E731
        s, vocab, seed=4321, n_shared=8, n_cold=8, system_len=256, tails=(8, 128),
        cold_lens=(64, 512), budgets=(16, 64))
    mixed = lambda s: mixed_requests(s, 16, vocab, seed=1234)  # noqa: E731
    serving = {}
    for label, section, traffic in (
            ("3 default", None, mixed),
            ("3b features", FEATURES_SECTION, shared),
            ("3c int8 features", dict(FEATURES_SECTION, kv_cache_dtype="int8"), shared),
            ("20 sampled", dict(SAMPLING), mixed)):
        res = serve_sides(eng, section, traffic)
        (sc, tc, cc, pc), (se, te, ce, pe) = res["captured"], res["eager"]
        check(tc == te, f"phase 21 {label}: captured streams differ from eager in "
              f"{sum(a != b for a, b in zip(tc, te))} requests")
        check(cc == ce, f"phase 21 {label}: launches captured {cc} != eager {ce}")
        if "features" in label:
            kind = K_PAGED8 if "int8" in label else K_PAGED
            mt = K_MT8 if "int8" in label else K_MT
            check(cc[kind] == L * (spec_k + 1) * sc["spec_steps"]
                  and cc[mt] == L * sc["chunk_prefills"],
                  f"phase 21 {label}: launches {cc}, verify steps {sc['spec_steps']}, "
                  f"chunks {sc['chunk_prefills']}")
        else:
            check(cc[K_PAGED] == L * sc["decode_steps"],
                  f"phase 21 {label}: launches {cc}, decode steps {sc['decode_steps']}")
        check(all(p.graph is not None for p in pc if p.calls >= 2)
              and not any(p.graph is not None for p in pe),
              f"phase 21 {label}: graphs captured {[p.graph is not None for p in pc]}, "
              f"eager {[p.graph is not None for p in pe]}")
        serving[label] = (sc, se)
        print(f"serve {label}: streams identical captured / eager, launches equal {cc}; "
              f"{len(pc)} programs = expected ({', '.join(p.name for p in pc)}), capture ms "
              + ", ".join(f"{p.capture_ms:.1f}" for p in pc if p.capture_ms is not None)
              + f", replays {sum(p.replays for p in pc)}")
        for side, st in (("captured", sc), ("eager", se)):
            print(f"  {side}: decode tokens/s {st['decode_tokens_per_s']:.1f}, (exact) TPOT p50 "
                  f"{st['tpot']['p50_s'] * 1e3:.3f} ms, p99 {st['tpot']['p99_s'] * 1e3:.3f} ms, "
                  f"TTFT p50 {st['ttft']['p50_s'] * 1e3:.2f} ms, wall {st['wall_s']:.3f} s "
                  f"({smi})")
    # the counts above against the kernels a trace sees in captured runs of
    # the same traffic kinds (profile_serving's warm-up run, then a
    # profiled one): 3c's has the paged decode and multi-token kernels
    # (the int8 instances; bf16's are held to eager's counts above), 20's
    # the paged decode and uniform_rows
    for label, kw in (("serve 3c int8 features captured", dict(features=True, int8=True)),
                      ("serve 20 sampled captured", dict(sampled=True))):
        r = until_traced(lambda kw=kw: profile_serve(
            eng, 16, 4321 if kw.get("features") else 1234, **kw))
        traced.append(check_traced(f"{label} (profiled runs {r['attempts']})", r["traced"]))
        del r
    print("kernels in the profiler's trace = launches counted: " + "; ".join(traced))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return gen, idle, serving


# ---------------------------------------------------------------------------
# phase 22: the telemetry plane on the serving path
# ---------------------------------------------------------------------------

TENANTS = ("acme", "globex")
SLO_SECTION = {"classes": {"chat": {"ttft_target_s": 0.5, "tpot_target_s": 0.01},
                           "batch": {"ttft_target_s": 5.0}},
               "default_class": "batch"}


def telemetry_plane(root):
    """The whole plane of ``deepspeed_tpu_torch.telemetry`` under ``root``."""
    return {"telemetry": {
        "enabled": True, "trace_path": root, "prometheus_path": os.path.join(root, "serving.prom"),
        "watchdog": {"enabled": True, "straggler_factor": 3.0,
                     "capture_dir": os.path.join(root, "anomalies")},
        "request_trace": {"enabled": True}, "kv_heat": {"enabled": True},
        "timeseries": {"enabled": True, "interval_s": 0.05}}}


def tagged(srv):
    """``srv`` whose submits carry a tenant and an SLO class, alternating."""
    submit, n = srv.submit, itertools.count()

    def tagged_submit(*args, **kw):
        i = next(n)
        return submit(*args, tenant=TENANTS[i % 2], slo_class=("chat", "batch")[i // 2 % 2],
                      **kw)

    srv.submit = tagged_submit
    return srv


def parse_prometheus(path):
    """{name{labels}: value} of a Prometheus text file; raises on a line
    that is not a comment or ``name value``."""
    out = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            name, value = line.rsplit(" ", 1)
            out[name] = float(value)
    return out


def telemetry_serve(label, eng, section, traffic, L, spec_k):
    """One captured serving run of ``traffic`` with the plane off (``eng``
    has none) or on → (tokens per request, launch counts, stats, engine)."""
    srv = tagged(eng.serve(dict(section or {}, slo=SLO_SECTION)))
    reqs = traffic(srv)
    torch.cuda.synchronize()
    reset_program_counts()
    srv.run()
    torch.cuda.synchronize()
    n = program_counts()
    st = srv.stats()
    for req, budget in reqs:
        check(req.status == RequestStatus.FINISHED and len(req.tokens) == budget,
              f"phase {label}: request {req.id} {req.status} {req.detail}, "
              f"{len(req.tokens)} of {budget}")
    srv.check_no_leaks()
    check(len(srv.executables) == srv.expected_executables,
          f"phase {label}: {len(srv.executables)} programs, expected {srv.expected_executables}")
    if section:
        want = {K_PAGED: L * (spec_k + 1) * st["spec_steps"], K_MT: L * st["chunk_prefills"]}
    else:
        want = {K_PAGED: L * st["decode_steps"], K_MT: 0}
    check(all(n[k] == v for k, v in want.items()),
          f"phase {label}: launches {n}, want {want}")
    return [list(r.tokens) for r, _ in reqs], n, st, srv


def check_plane(label, eng, srv, st, n_requests, features):
    """The plane's records against the engine: → a summary for the printout."""
    tel = eng.telemetry
    reg = tel.registry
    # the heat ledger against the allocator and the index, before the drain
    # releases anything
    led = srv._heat_decode
    err = led.reconcile(srv.allocator, srv.prefix_cache)
    check(err is None, f"phase {label}: heat ledger against the allocator: {err}")
    if features:
        check(led.prefix_registered > 0 and led.prefix_hits > 0,
              f"phase {label}: heat ledger registers {led.prefix_registered}, hits "
              f"{led.prefix_hits}")
    srv.drain()  # flushes the request trace
    recs = load_request_records(srv.tracer.file_path)
    check(len(recs) == n_requests and len({r["id"] for r in recs}) == n_requests,
          f"phase {label}: {len(recs)} trace records for {n_requests} requests")
    score = score_requests(recs)["overall"]
    for metric in ("ttft", "tpot"):
        for q in ("p50", "p99"):
            check(score[f"{metric}_{q}_s"] == st[metric][f"{q}_s"],
                  f"phase {label}: trace {metric} {q} {score[f'{metric}_{q}_s']} != stats() "
                  f"{st[metric][f'{q}_s']}")
    j = srv._journal
    j.snapshot(srv.clock())
    for metric, fam in (("ttft", "serving_ttft_seconds"), ("tpot", "serving_tpot_seconds")):
        for q, key in ((0.5, "p50_s"), (0.99, "p99_s")):
            got = j.quantile_over_time(fam, q)
            check(got == st[metric][key],
                  f"phase {label}: journal {fam} q{q} {got} != stats() {st[metric][key]}")
    captured = sum(p.graph is not None for p in srv.executables)
    compiles = reg.get("jit_compiles_total").value()
    check(compiles == captured,
          f"phase {label}: jit_compiles_total {compiles} != graphs captured {captured}")
    in_use, limit = (reg.get("hbm_bytes_in_use").value(), reg.get("hbm_bytes_limit").value())
    check(0 < in_use <= limit, f"phase {label}: hbm_bytes_in_use {in_use}, limit {limit}")
    tel.flush()
    prom = parse_prometheus(tel.config.prometheus_path)
    check(prom.get('serving_requests_total{status="finished"}') == n_requests
          and "serving_ttft_seconds_count" in prom,
          f"phase {label}: Prometheus file {len(prom)} samples")
    classes = st["slo"]["classes"]
    return (f"{len(recs)} trace records (one a request), trace and journal TTFT/TPOT "
            f"p50/p99 = stats() ({st['ttft']['p50_s'] * 1e3:.3f} / "
            f"{st['tpot']['p50_s'] * 1e3:.3f} ms, bucket-interpolated), heat ledger reconciled "
            f"(registers {led.prefix_registered}, hits {led.prefix_hits}, "
            f"{st['kv_heat']['records']} records), journal {st['timeseries']['snapshots']} "
            f"snapshots, Prometheus {len(prom)} samples, hbm_bytes_in_use "
            f"{in_use / 2**30:.2f} of {limit / 2**30:.2f} GiB, jit_compiles_total "
            f"{compiles:.0f} = graphs; SLO attainment " + ", ".join(
                f"{c} {v['met']}/{v['evaluated']}" for c, v in classes.items())
            + f"; stragglers {st['stragglers']}")


def timed_serve(eng, section, traffic, reps=4):
    """A warm run of ``traffic`` (the programs capture), then ``reps``
    timed runs of it on the same engine, each scheduler step timed on the
    host clock → the numbers over the timed steps and requests."""
    srv = tagged(eng.serve(dict(section or {}, slo=SLO_SECTION)))
    traffic(srv)
    srv.run()
    tok0, sec0 = srv._decode_tokens, srv._h_step.stats()[0]  # decode tokens, step seconds
    torch.cuda.synchronize()
    step_s, reqs = [], []
    for _ in range(reps):
        reqs += [r for r, _ in traffic(srv)]
        while srv.queue or any(sl.request is not None for sl in srv.slots):
            t0 = time.perf_counter()
            srv.step()
            step_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    ex = exact_percentiles(reqs)
    out = {"decode_tokens_per_s": (srv._decode_tokens - tok0) / (srv._h_step.stats()[0] - sec0),
           "tpot_p50_ms": ex["tpot"]["p50_s"] * 1e3, "tpot_p99_ms": ex["tpot"]["p99_s"] * 1e3,
           "step_us_median": statistics.median(step_s) * 1e6,
           "step_us_mean": statistics.mean(step_s) * 1e6, "steps": len(step_s),
           "step_s": step_s}
    srv.release_prefix_cache()
    del srv
    return out


def busy(srv):
    return bool(srv.queue) or any(sl.request is not None for sl in srv.slots)


def paired_steps(off_eng, on_eng, section, traffic, reps=4):
    """The plane's host cost a step, paired: an engine without the plane
    and one with it serve the same traffic in lockstep, one scheduler step
    each in turn (the order swapped every step), after a warm run each.
    Their decisions are the same step for step (the streams are), so step
    i of one is step i of the other → the per-step wall times of each."""
    srvs = {side: tagged(eng.serve(dict(section or {}, slo=SLO_SECTION)))
            for side, eng in (("off", off_eng), ("on", on_eng))}
    for srv in srvs.values():
        traffic(srv)
        srv.run()
    torch.cuda.synchronize()
    times = {"off": [], "on": []}
    reqs = {"off": [], "on": []}
    for _ in range(reps):
        for side, srv in srvs.items():
            reqs[side] += [r for r, _ in traffic(srv)]
        i = 0
        while busy(srvs["off"]) or busy(srvs["on"]):
            for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
                t0 = time.perf_counter()
                srvs[side].step()
                times[side].append(time.perf_counter() - t0)
            i += 1
    check([r.tokens for r in reqs["on"]] == [r.tokens for r in reqs["off"]],
          "phase 22d: lockstep streams differ on / off")
    for srv in srvs.values():
        srv.release_prefix_cache()
    del srvs
    return times


def telemetry_phase(smi):
    """Phase 22: the telemetry plane on the serving path (22a-22d)."""
    base = dtt.init_inference("gpt2-medium", seed=0)
    cfg = base.model_config
    L, vocab = cfg.n_layer, cfg.vocab_size
    spec_k = FEATURES_SECTION["speculative"]["k"]
    shared = lambda s: shared_prefix_requests(  # noqa: E731
        s, vocab, seed=4321, n_shared=8, n_cold=8, system_len=256, tails=(8, 128),
        cold_lens=(64, 512), budgets=(16, 64))
    mixed = lambda s: mixed_requests(s, 16, vocab, seed=1234)  # noqa: E731
    cells = (("22a", None, mixed), ("22b", FEATURES_SECTION, shared))
    engines = {}
    with tempfile.TemporaryDirectory(prefix="telemetry-") as root:
        for label, section, traffic in cells:
            phase(label, f"serve gpt2-medium bf16 ({'3b' if section else '3'}'s traffic) with "
                         "the telemetry plane off, then on")
            off = dtt.init_inference(cfg, params=base.params)
            toks_off, n_off, _, srv = telemetry_serve(label, off, section, traffic, L, spec_k)
            del srv
            on = dtt.init_inference(cfg, params=base.params,
                                    config=telemetry_plane(os.path.join(root, label)))
            toks_on, n_on, st, srv = telemetry_serve(label, on, section, traffic, L, spec_k)
            check(toks_on == toks_off, f"phase {label}: streams with the plane on differ from "
                  f"off in {sum(a != b for a, b in zip(toks_on, toks_off))} requests")
            check(n_on == n_off, f"phase {label}: launches on {n_on} != off {n_off}")
            summary = check_plane(label, on, srv, st, len(toks_on), section is not None)
            srv.release_prefix_cache()
            del srv
            print(f"streams identical on / off, launches equal {n_on}; {summary} ({smi})")
            engines[label] = (off, on)

        phase("22c", "generate B8 128 + 32 on the plane: compiled_cache_hit false, then true")
        ids = np.random.RandomState(22).randint(0, vocab, (8, 128)).astype(np.int32)
        off, on = engines["22a"]
        want = off.generate(ids, max_new_tokens=32)
        before = on.telemetry.registry.get("jit_compiles_total").value()
        got = [on.generate(ids, max_new_tokens=32) for _ in range(2)]
        check(all(np.array_equal(g, want) for g in got), "phase 22c: tokens differ from the "
              "engine without the plane")
        on.telemetry.flush()
        with open(on.telemetry.tracer.file_path) as fh:
            recs = [json.loads(ln) for ln in fh if '"inference_step"' in ln]
        check([r["compiled_cache_hit"] for r in recs] == [False, True]
              and all(r["hbm"]["bytes_in_use"] > 0 for r in recs),
              f"phase 22c: records {[(r['compiled_cache_hit'], r['hbm']) for r in recs]}")
        reg = on.telemetry.registry
        compiles = reg.get("jit_compiles_total").value() - before
        check(compiles == 2 and reg.get("generate_cache_size").value() == 1,
              f"phase 22c: {compiles} captures, cache size "
              f"{reg.get('generate_cache_size').value()}")
        print(f"generate records: compiled_cache_hit {[r['compiled_cache_hit'] for r in recs]}, "
              f"{[round(r['tokens_per_sec'], 1) for r in recs]} tokens/s, "
              f"hbm_bytes_in_use {recs[-1]['hbm']['bytes_in_use'] / 2**30:.2f} GiB, 2 graphs "
              f"captured (jit_compiles_total), tokens = the engine without the plane ({smi})")

        phase("22d", "the plane's cost: off / on / on / off, twice, on 22a's and 22b's traffic")
        cost = {}
        for label, section, traffic in cells:
            off, on = engines[label]
            runs = {"off": [], "on": []}
            for side in ("off", "on", "on", "off", "off", "on", "on", "off"):
                r = timed_serve(on if side == "on" else off, section, traffic)
                runs[side].append(r)
                gc.collect()
                print(f"{label} {side}: decode tokens/s {r['decode_tokens_per_s']:.1f}, "
                      f"(exact) TPOT p50 {r['tpot_p50_ms']:.3f} ms, p99 "
                      f"{r['tpot_p99_ms']:.3f} ms; a scheduler step {r['step_us_median']:.1f} us "
                      f"median, {r['step_us_mean']:.1f} mean ({r['steps']} steps) ({smi})",
                      flush=True)
            pooled = {side: [t for r in rs for t in r["step_s"]] for side, rs in runs.items()}
            d_med = (statistics.median(pooled["on"]) - statistics.median(pooled["off"])) * 1e6
            d_mean = (statistics.mean(pooled["on"]) - statistics.mean(pooled["off"])) * 1e6
            spread = [r["step_us_median"] for r in runs["off"]]
            print(f"{label}: runs on minus off: median step {d_med:.1f} us, mean {d_mean:.1f} "
                  f"us; the off runs' medians span {min(spread):.1f}-{max(spread):.1f} us "
                  f"({smi})")
            times = paired_steps(off, on, section, traffic)
            diff = [(a - b) * 1e6 for a, b in zip(times["on"], times["off"])]
            se = statistics.stdev(diff) / len(diff) ** 0.5
            cost[label] = {"paired_us_median": statistics.median(diff),
                           "paired_us_mean": statistics.mean(diff), "paired_us_se": se,
                           "runs_us_median": d_med, "runs_us_mean": d_mean}
            print(f"{label}: the plane costs {statistics.mean(diff):.1f} +- {se:.1f} us a "
                  f"scheduler step (mean +- standard error of {len(diff)} paired steps in "
                  f"lockstep, on minus off; median {statistics.median(diff):.1f} us; a step "
                  f"{statistics.median(times['off']) * 1e6:.1f} us median off, "
                  f"{statistics.median(times['on']) * 1e6:.1f} on) ({smi})", flush=True)
        for _, on in engines.values():
            on.telemetry.close()  # its files go with the directory
        del engines
    del base
    gc.collect()
    torch.cuda.empty_cache()
    return cost


# ---------------------------------------------------------------------------
# phase 23: the training step as one captured program, against eager
# ---------------------------------------------------------------------------

# every kernel a training step can launch, by its registry entry
TRAINING_COUNTED = fa.KERNELS + bsa.KERNELS + fadam.KERNELS + ("threefry_dropout",)


def train_sides(label, module, conf, batch, steps, tree=None, profile=False, sides=None,
                cpu_steps=None):
    """The same training run on each side ("eager": the step's program
    uncaptured; "captured": a CUDA graph; "cpu": the plain versions, for
    ``cpu_steps(results so far)`` steps), each from the same weights
    (``tree``, else the seed), every step closed by a sync → {side:
    numbers}; the captured side's "traced" is a profiled step's kernel
    events against its launches, ``profile`` adds a 2-step profile a side."""
    out = {}
    for side in sides or ("eager", "captured"):
        dev = "cpu" if side == "cpu" else "cuda"
        n_steps = cpu_steps(out) if side == "cpu" else steps
        with eager_programs(side == "eager"):
            eng, _, _, _ = dtt.initialize(
                model=module, config=conf, seed=0, device=dev,
                model_parameters=None if tree is None else params_from_numpy(tree, dev))
            if dev == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            reset(TRAINING_COUNTED)
            losses, flags, step_s = [], [], []
            for _ in range(n_steps):
                t0 = time.perf_counter()
                m = eng.train_batch(batch)
                losses.append(float(m["loss"]))
                flags.append(bool(m["overflow"]))
                if dev == "cuda":
                    torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t0)
        prog = next(p for sig, p in eng._programs.items() if sig[0] == "train")
        r = dict(losses=losses, flags=flags, counts=training_counts(),
                 step_ms=statistics.median(step_s[2:] or step_s) * 1e3, step_s=step_s,
                 peak=torch.cuda.max_memory_allocated() if dev == "cuda" else 0,
                 params=params_to_numpy(eng.params), graph=prog.graph is not None,
                 capture_ms=prog.capture_ms, programs=eng.jit_step_cache_size,
                 tokens=eng.train_batch_size * batch["input_ids"].shape[1],
                 skipped=eng.skipped_steps, global_step=eng.get_global_step())
        check(all(np.isfinite(x) for x, f in zip(losses, flags) if not f),
              f"phase 23 {label} {side}: non-finite losses {losses}")
        check(r["programs"] == 1 and r["graph"] == (side == "captured"),
              f"phase 23 {label} {side}: {r['programs']} training programs, graph {r['graph']}")
        if profile and dev == "cuda":
            r["profile"] = profile_steps(eng, batch, 2, kernels=TRAINING_PROFILE_KERNELS)
        if side == "captured":
            r["traced"] = until_traced(lambda: {"traced": traced_step(eng, batch)})["traced"]
        out[side] = r
        del eng, prog
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


TRAINING_PROFILE_KERNELS = FLASH_KERNELS + BLOCK_SPARSE_KERNELS + OPTIMIZER_KERNELS


def check_trained_trace(label, traced):
    """A profiled captured step's training kernels: each one's events in the
    trace equal the launches counted (``profile_training.traced_step``)."""
    check(any(counted for _, _, counted in traced)
          and all(seen == counted for _, seen, counted in traced),
          f"phase 23 {label}: kernels in the trace against launches counted {traced}")
    print("  captured, a profiled step: kernels in the trace = launches counted: "
          + ", ".join(f"{n.strip(':<_')} {s} = {c}" for n, s, c in traced if c))


def training_counts():
    return counts(TRAINING_COUNTED)


def compare_sides(label, res, bitwise, smi):
    """Captured against eager: launches equal, losses (and with
    ``bitwise`` the parameters) equal bit for bit or printed side by side,
    the overflow flags equal; each side's numbers printed → the largest
    relative loss difference."""
    c, e = res["captured"], res["eager"]
    check(c["counts"] == e["counts"] and any(c["counts"].values()),
          f"phase 23 {label}: launches captured {c['counts']} != eager {e['counts']}")
    check(c["flags"] == e["flags"],
          f"phase 23 {label}: overflow steps captured {c['flags']} != eager {e['flags']}")
    rel = max(abs(a - b) / abs(b) for a, b, f in zip(c["losses"], e["losses"], e["flags"])
              if not f) if not all(e["flags"]) else 0.0
    if bitwise:
        check(c["losses"] == e["losses"], f"phase 23 {label}: losses captured {c['losses']} "
              f"!= eager {e['losses']}")
        same = all(np.array_equal(a, b) for a, b in zip(tree_leaves(c["params"]),
                                                        tree_leaves(e["params"])))
        check(same, f"phase 23 {label}: parameters captured != eager after "
              f"{len(c['losses'])} steps")
    else:
        check(rel <= 2e-2, f"phase 23 {label}: losses captured {c['losses']} against eager "
              f"{e['losses']}: relative {rel}")
    n = {k: v for k, v in c["counts"].items() if v}
    print(f"{label}: launches equal captured / eager {n}; losses "
          + ("equal bit for bit, parameters equal bit for bit" if bitwise else
             f"side by side (max relative difference {rel:.3e})"))
    print("  captured " + " ".join(f"{x:.6f}" for x in c["losses"]))
    print("  eager    " + " ".join(f"{x:.6f}" for x in e["losses"]))
    for side, r in (("captured", c), ("eager", e)):
        extra = ""
        if "profile" in r:
            p = r["profile"]
            extra = (f", idle share {p['idle_share']:.4f} (profiled 2 steps: wall "
                     f"{p['wall_s'] * 1e3:.2f} ms, device busy {p['device_busy_s'] * 1e3:.2f} ms)")
        print(f"  {side}: step ms {r['step_ms']:.3f} (median of steps 3-{len(r['step_s'])}; "
              + " ".join(f"{x * 1e3:.1f}" for x in r["step_s"])
              + f"), tokens/s {r['tokens'] / (r['step_ms'] / 1e3):.1f}, peak memory "
              f"{r['peak'] / 2**30:.2f} GiB"
              + (f", capture ms {r['capture_ms']:.1f}" if r["capture_ms"] is not None else "")
              + extra + f" ({smi})")
    return rel


def captured_training_phase(smi):
    """Phase 23: the training step's program captured against the same
    program run eagerly, in one process, at phase 6's, 12's and 17's
    configurations, fp16 with overflows (and the CPU's overflow steps),
    fp32 bit for bit; then InferenceEngine.forward. → {run: (captured,
    eager) numbers}."""
    out = {}
    cfg6 = gpt2.get_config("gpt2-medium")
    conf6 = train_config(micro=8, gas=2)
    batch6 = {"input_ids": np.random.RandomState(5).randint(
        0, cfg6.vocab_size, (16, cfg6.n_positions)).astype(np.int32)}  # phase 6's batch
    _, module12, conf12, batch12 = workload("bert-large", sparse=True)
    cfg17 = gpt2.get_config("gpt2-medium", dropout=0.1)
    runs = (("6: gpt2-medium bf16, micro 8 x gas 2 x S1024, AdamW", gpt2.make_module(cfg6),
             conf6, batch6),
            ("12: bert-large bf16 block-sparse S512, micro 16, Adam", module12, conf12, batch12),
            ("17: gpt2-medium bf16 at dropout 0.1", gpt2.make_module(cfg17), conf6, batch6))
    for label, module, conf, batch in runs:
        res = train_sides(label, module, conf, batch, 6, profile=True)
        compare_sides(label, res, bitwise=False, smi=smi)
        check_trained_trace(label, res["captured"]["traced"])
        out[label] = (res["captured"], res["eager"])
        del res
    # fp16, dynamic scale from 2^19 with hysteresis 1: the first steps
    # overflow and are skipped (the scale halves each time), on the same
    # steps captured, eager and on the CPU. A CPU without half-precision
    # GEMMs runs the fp16 products slowly (20-50 s a step at 32 tokens), so
    # the rows are short, the depth 2 layers, and the CPU side runs through
    # the card's first applied step.
    cfg4 = gpt2.get_config("gpt2-medium", n_layer=4)
    cfg2 = gpt2.get_config("gpt2-medium", n_layer=2)
    tree2 = params_to_numpy(gpt2.init_params(
        cfg2, torch.Generator(device="cuda").manual_seed(11), "cuda", torch.float32))
    batch16 = {"input_ids": np.random.RandomState(16).randint(
        0, cfg4.vocab_size, (1, 32)).astype(np.int32)}
    conf16 = train_config(micro=1, gas=1)
    conf16.pop("bf16")
    conf16["fp16"] = {"enabled": True, "loss_scale": 0, "initial_scale_power": 19,
                      "hysteresis": 1}
    label = "fp16 dynamic (2^19, hysteresis 1), gpt2-medium width, 2 layers, micro 1 x S32"

    def through_first_applied(out):
        flags = out["captured"]["flags"]
        return min(len(flags), (flags.index(False) + 1) if False in flags else len(flags))

    res = train_sides(label, gpt2.make_module(cfg2), conf16, batch16, 6, tree=tree2,
                      sides=("eager", "captured", "cpu"), cpu_steps=through_first_applied)
    compare_sides(label, res, bitwise=False, smi=smi)
    flags, cpu_flags = res["captured"]["flags"], res["cpu"]["flags"]
    check(cpu_flags == flags[:len(cpu_flags)] and any(flags) and not all(flags),
          f"phase 23 fp16: overflow steps captured {flags}, CPU {cpu_flags}")
    check(res["captured"]["skipped"] == sum(flags)
          and res["captured"]["global_step"] == len(flags) - sum(flags),
          f"phase 23 fp16: skipped {res['captured']['skipped']}, global step "
          f"{res['captured']['global_step']}, flags {flags}")
    rel_cpu = max(abs(a - b) / abs(b) for a, b in zip(res["cpu"]["losses"],
                                                      res["captured"]["losses"]))
    print("  overflow steps (1 = skipped) captured / eager: "
          + "".join(str(int(f)) for f in flags) + ", CPU (through the first applied step): "
          + "".join(str(int(f)) for f in cpu_flags) + f"; skipped_steps "
          f"{res['captured']['skipped']}, global_step {res['captured']['global_step']}; CPU "
          f"losses within {rel_cpu:.3e} relative of the card's, "
          f"{statistics.mean(res['cpu']['step_s']):.1f} s a CPU step")
    out[label] = (res["captured"], res["eager"])
    # fp32: the captured step equal to eager bit for bit, losses and
    # parameters (phase 18's dropout run; a 4-layer bert-large sparse LAMB)
    conf32 = train_config(micro=2, gas=2)
    conf32.pop("bf16")
    _, tree4 = four_layer_tree(seed=11)
    batch18 = {"input_ids": np.random.RandomState(7).randint(
        0, cfg4.vocab_size, (4, 256)).astype(np.int32)}  # phase 18's batch
    cfg18 = gpt2.get_config("gpt2-medium", n_layer=4, dropout=0.1)
    _, module13, conf13, batch13 = workload("bert-large", sparse=True, n_layer=4, micro=4,
                                            optimizer="Lamb", seq=512)
    conf13.pop("bf16")
    for label, module, conf, batch, tree in (
            ("fp32 gpt2-medium width, 4 layers, dropout 0.1, AdamW (phase 18's)",
             gpt2.make_module(cfg18), conf32, batch18, tree4),
            ("fp32 bert-large, 4 layers, block-sparse S512, LAMB", module13, conf13, batch13,
             None)):
        res = train_sides(label, module, conf, batch, 4, tree=tree)
        compare_sides(label, res, bitwise=True, smi=smi)
        check_trained_trace(label, res["captured"]["traced"])
        out[label] = (res["captured"], res["eager"])
        del res
    # InferenceEngine.forward: one program an input shape, captured = eager
    eng = dtt.init_inference("gpt2-medium", seed=0)
    with eager_programs():
        eager = dtt.init_inference(eng.model_config, params=eng.params)
    ids = np.random.RandomState(23).randint(0, eng.model_config.vocab_size, (8, 512))
    logits, fwd_ms = {}, {}
    for side, e in (("eager", eager), ("captured", eng)):
        with eager_programs(side == "eager"):
            for _ in range(2):
                e({"input_ids": ids})
            reset(fa.KERNELS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                logits[side] = e({"input_ids": ids})
            torch.cuda.synchronize()
            fwd_ms[side] = (time.perf_counter() - t0) / 5 * 1e3
            check(LAUNCHES["flash_attention_fwd"] == 5 * eng.model_config.n_layer,
                  f"phase 23 forward {side}: flash launches {counts(fa.KERNELS)}")
    prog = eng._forward_programs[ids.shape]
    check(torch.equal(logits["captured"], logits["eager"]) and prog.graph is not None,
          "phase 23: InferenceEngine.forward logits captured != eager")
    print(f"InferenceEngine.forward B8 S512 bf16: logits captured = eager bit for bit, flash "
          f"launches {5 * eng.model_config.n_layer} a side (= 5 x {eng.model_config.n_layer}); "
          f"ms a call captured {fwd_ms['captured']:.3f} / eager {fwd_ms['eager']:.3f}, capture "
          f"ms {prog.capture_ms:.1f} ({smi})")
    del eng, eager, logits, prog
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 24: the training telemetry plane
# ---------------------------------------------------------------------------

def training_plane(root, sample_every=1):
    return {"enabled": True, "trace_path": root, "prometheus_path": os.path.join(root, "m.prom"),
            "sample_every": sample_every, "flush_interval": 1,
            "watchdog": {"enabled": True, "capture_dir": os.path.join(root, "cap")}}


def training_telemetry_phase(smi, steps=6):
    """Phase 24: phase 6's training with the telemetry plane on (step trace,
    Prometheus file, sample_every 1, the watchdog): one train_step record a
    step, the file parsed, no anomaly; then the plane's cost a step, an
    engine with the plane off and one with it on in lockstep."""
    cfg = gpt2.get_config("gpt2-medium")
    conf = train_config(micro=8, gas=2)
    batch = {"input_ids": np.random.RandomState(5).randint(
        0, cfg.vocab_size, (16, cfg.n_positions)).astype(np.int32)}
    module = gpt2.make_module(cfg)
    with tempfile.TemporaryDirectory(prefix="train-telemetry-") as root:
        eng, _, _, _ = dtt.initialize(model=module, seed=0,
                                      config=dict(conf, telemetry=training_plane(root)))
        losses = [float(eng.train_batch(batch)["loss"]) for _ in range(steps)]
        tel = eng.telemetry
        tel.flush()
        with open(tel.tracer.file_path) as fh:
            recs = [json.loads(ln) for ln in fh]
        train = [r for r in recs if r["kind"] == "train_step"]
        check([r["step"] for r in train] == list(range(1, steps + 1))
              and [r["loss"] for r in train] == losses,
              f"phase 24: train_step records {[r['step'] for r in train]}, losses "
              f"{[r.get('loss') for r in train]} against {losses}")
        last = train[-1]
        check(set(last["spans"]["children"]) == {"prepare", "dispatch", "sync"}
              and last["hbm"]["bytes_in_use"] > 0 and last["comm_bytes"] == {}
              and last["samples_per_sec"] > 0 and last["overflow"] == 0.0,
              f"phase 24: the last record {last}")
        check(not [r for r in recs if r["kind"] == "anomaly"] and not eng._watchdog.anomalies,
              f"phase 24: anomalies {eng._watchdog.anomalies}")
        prom = parse_prometheus(tel.config.prometheus_path)
        n_steps = prom.get('steps_total{kind="train"}')
        check(n_steps == steps
              and prom.get("jit_step_cache_size") == 1
              and prom.get('step_seconds_count{kind="train"}') == steps
              and "train_loss" in prom and prom.get("throughput_samples_per_sec", 0) > 0,
              f"phase 24: Prometheus file {prom}")
        print(f"{steps} steps: {len(train)} train_step records (steps 1-{steps}, losses equal "
              f"to train_batch's), spans {last['spans']}, samples/s "
              f"{last['samples_per_sec']}, hbm in use "
              f"{last['hbm']['bytes_in_use'] / 2**30:.2f} GiB, comm_bytes {{}} (one device); "
              f"Prometheus {len(prom)} samples (steps_total {n_steps:.0f}, jit_step_cache_size {prom['jit_step_cache_size']:.0f}, "
              f"throughput_samples_per_sec {prom['throughput_samples_per_sec']:.2f}); no anomaly "
              f"({smi})")
        del eng, tel
        gc.collect()
        torch.cuda.empty_cache()
        # the plane's cost: engines off and on in lockstep, each pair of steps
        # in the order off, on, on, off (as 22d pairs serving steps)
        off, _, _, _ = dtt.initialize(model=module, config=conf, seed=0)
        on, _, _, _ = dtt.initialize(model=module, seed=0,
                                     config=dict(conf, telemetry=training_plane(
                                         os.path.join(root, "paired"))))
        times = {"off": [], "on": []}
        for i in range(2 + 2 * steps):
            for side in (("off", "on") if i % 2 == 0 else ("on", "off")):
                e = off if side == "off" else on
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e.train_batch(batch)
                torch.cuda.synchronize()
                if i >= 2:
                    times[side].append(time.perf_counter() - t0)
        ms = {k: statistics.median(v) * 1e3 for k, v in times.items()}
        print(f"the plane's cost a step (phase 6's step, {len(times['on'])} paired steps, "
              f"off / on alternating): off {ms['off']:.3f} ms, on {ms['on']:.3f} ms (median), "
              f"on - off {ms['on'] - ms['off']:.3f} ms ({smi})")
        del off, on
        gc.collect()
        torch.cuda.empty_cache()
    return ms


# ---------------------------------------------------------------------------
# phase 25-26 helpers: the host KV tier and the resilience plane
# ---------------------------------------------------------------------------

def tier_rounds(vocab, seed, rounds=3, n_prompts=4, per_prompt=4, system_len=256,
                tails=(8, 128), budgets=(16, 64)):
    """Phase 25's traffic, 3b's shape: ``n_prompts`` distinct
    ``system_len``-token system prompts, each re-hit in every round by
    ``per_prompt`` requests (the prompt + a tail of its own), grouped by
    prompt, so the pool serves the prompts in turn → [[(prompt, budget)]]
    a round, drawn from ``seed``."""
    rs = np.random.RandomState(seed)
    systems = [rs.randint(0, vocab, system_len) for _ in range(n_prompts)]
    out = []
    for _ in range(rounds):
        rnd = []
        for system in systems:
            for _ in range(per_prompt):
                tail = rs.randint(0, vocab, int(rs.randint(tails[0], tails[1] + 1)))
                rnd.append((np.concatenate([system, tail]).astype(np.int32),
                            int(rs.randint(budgets[0], budgets[1] + 1))))
        out.append(rnd)
    return out


def prefix_page_count(rounds, page):
    """The distinct full prompt pages of the traffic: what the prefix index
    registers over the run (one chain key a page)."""
    keys = set()
    for rnd in rounds:
        for prompt, _ in rnd:
            parent = None
            for j in range(len(prompt) // page):
                parent = (parent, tuple(int(t) for t in prompt[j * page:(j + 1) * page]))
                keys.add(parent)
    return len(keys)


def serve_rounds(srv, rounds, kernels, n_layer, spec_k, label):
    """Serve each round to its end (``run()``), then the next → (streams,
    stats, requests a round). Every request finishes with its budget;
    the kernels' launches are reset before and read after, and must equal
    n_layer x the calls of the programs that launch them."""
    for k in kernels:
        LAUNCHES[k] = 0
    reqs = []
    t0 = time.perf_counter()
    for r, rnd in enumerate(rounds):
        subs = [srv.submit(p, max_new_tokens=b, seed=100 * r + i) for i, (p, b) in enumerate(rnd)]
        srv.run()
        reqs.append(subs)
    sync()
    wall = time.perf_counter() - t0
    st = dict(exact_stats(srv), wall_s=wall)
    dec, mt = (LAUNCHES[k] for k in kernels)
    for subs, rnd in zip(reqs, rounds):
        for req, (_, budget) in zip(subs, rnd):
            check(req.status == RequestStatus.FINISHED and len(req.tokens) == budget,
                  f"{label}: request {req.id}: {req.status} {req.detail}, {len(req.tokens)} of "
                  f"{budget} tokens")
    check(dec > 0 and mt > 0 and dec == n_layer * (spec_k + 1) * st["spec_steps"]
          and mt == n_layer * st["chunk_prefills"],
          f"{label}: launches decode {dec}, multitoken {mt}; verify steps {st['spec_steps']}, "
          f"chunk calls {st['chunk_prefills']}")
    streams = [[list(q.tokens) for q in subs] for subs in reqs]
    return streams, dict(st, launches=(dec, mt)), reqs


def sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def host_tier_phase(smi, ref_3b=None, model="gpt2-medium", dtype=torch.bfloat16, device=None,
                    overrides=None, tight_pages=128, host_pages=256):
    """Phase 25: gpt2-medium bf16, captured, with the prefix cache and the
    host tier on. The same rounds served by a roomy pool without the tier
    (the reference), by a tight pool with it (LRU demotes each prompt's
    idle chain while the others are served, and the next round restores
    it) and by the tight pool without it (the prefix recomputed): the
    tiered streams equal the reference's, launches per program equal, the
    spills at least half the traffic's prefix pages, restores > 0,
    len(executables) == expected_executables with the restore program, no
    leaks at drain across the allocator, the index, the host store and the
    heat ledger; the same with int8 pages (codes and scales spill); one
    corrupted host buffer is a cold miss with the same stream. Prints the
    restore's device and wall ms a page, the bytes a page, TTFT p50 of a
    restored hit beside a recomputed prefix's, and decode tokens/s and
    TPOT p50 beside phase 3b's. → (the paged decode and multi-token
    launches of the tiered bf16 run, of the int8 one)."""
    from deepspeed_tpu_torch.telemetry.kv_heat import KVHeatTracer

    cfg = gpt2.get_config(model, **(overrides or {}))
    eng = dtt.init_inference(cfg, dtype=dtype, seed=0, device=device)
    spec_k = FEATURES_SECTION["speculative"]["k"]
    page = FEATURES_SECTION["page_size"]
    rounds = tier_rounds(cfg.vocab_size, seed=2525)
    n_prefix = prefix_page_count(rounds, page)
    tiered = {"enabled": True, "host_budget_pages": host_pages}
    out = {}
    for kv in ("bf16", "int8"):
        # 4 slots: one prompt's requests at a time, so an idle prompt's
        # chain is the index's LRU when the next prompt's admissions need
        # pages (held only by the index, it demotes rather than drops)
        base = dict(FEATURES_SECTION, max_slots=4,
                    **({"kv_cache_dtype": "int8"} if kv == "int8" else {}))
        kernels = (K_PAGED8, K_MT8) if kv == "int8" else (K_PAGED, K_MT)
        ref, st_ref, ref_reqs = serve_rounds(eng.serve(base), rounds, kernels, cfg.n_layer,
                                             spec_k, f"phase 25 {kv} roomy, no tier")
        with tempfile.TemporaryDirectory(prefix="kv-tier-") as root:
            heat = KVHeatTracer(os.path.join(root, "heat.jsonl"))
            srv = eng.serve(dict(base, num_pages=tight_pages, tiering=tiered), heat_tracer=heat)
            tier = srv.tiering
            # measurement hooks: each restore's device span (CUDA events
            # around the program call) and wall time, and the requests
            # whose admission restored pages
            spans, restored_ids = [], set()
            restore_exec, prefetch = tier._restore_exec, srv._tier_prefetch

            def timed_restore(k, v, s, pid):
                ev = ((torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                      if srv.device.type == "cuda" else None)
                t0 = time.perf_counter()
                if ev:
                    ev[0].record()
                restore_exec(k, v, s, pid)
                if ev:
                    ev[1].record()
                spans.append((ev, time.perf_counter() - t0))

            def traced_prefetch(req, now):
                n = tier.restores
                busy = prefetch(req, now)
                if tier.restores > n:
                    restored_ids.add(req.id)
                return busy

            tier._restore_exec, srv._tier_prefetch = timed_restore, traced_prefetch
            got, st, reqs = serve_rounds(srv, rounds, kernels, cfg.n_layer, spec_k,
                                         f"phase 25 {kv} tiered")
            ts = st["kv_tiering"]
            check(got == ref, f"phase 25 {kv}: tiered streams differ from the reference in "
                  f"{sum(a != b for ra, rb in zip(got, ref) for a, b in zip(ra, rb))} requests")
            check(ts["spills"] >= n_prefix / 2 and ts["restores"] > 0 and ts["crc_failures"] == 0
                  and ts["restore_misses"] == 0,
                  f"phase 25 {kv}: spills {ts['spills']} (prefix pages {n_prefix}), restores "
                  f"{ts['restores']}, misses {ts['restore_misses']}, crc {ts['crc_failures']}")
            check(len(srv.executables) == srv.expected_executables == 4
                  and srv.executables[-1].name.startswith("serving_kv_restore"),
                  f"phase 25 {kv}: executables {[p.name for p in srv.executables]}, expected "
                  f"{srv.expected_executables}")
            per = {s: (x[0] / (cfg.n_layer * (spec_k + 1) * x[2]), x[1] / (cfg.n_layer * x[3]))
                   for s, x in (("ref", st_ref["launches"] + (st_ref["spec_steps"],
                                                            st_ref["chunk_prefills"])),
                                ("tier", st["launches"] + (st["spec_steps"], st["chunk_prefills"])))}
            check(per["ref"] == per["tier"], f"phase 25 {kv}: launches per program {per}")
            # one corrupted host buffer: a cold miss, the same stream
            pc, store = srv.prefix_cache, tier.store
            victim = next((i for i, (p, _) in enumerate(rounds[0])
                           if pc.chain_keys(p)[0] in store), None)
            if victim is None:
                pc.evict(keep=0)  # every chain to the host tier
                tier.flush()
                victim = 0
            p0, b0 = rounds[0][victim]
            key = pc.chain_keys(p0)[0]
            tier.flush()
            page_k = store.k_codes[store._entries[key].slot]
            page_k.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[page_k.element_size()]
                        ).view(-1)[0] ^= 1  # one bit of one value
            misses, crcs = ts["restore_misses"], ts["crc_failures"]
            r = srv.submit(p0, max_new_tokens=b0, seed=victim)
            srv.run()
            ts2 = tier.stats()
            check(list(r.tokens) == ref[0][victim] and ts2["crc_failures"] == crcs + 1
                  and ts2["restore_misses"] >= misses + 1,
                  f"phase 25 {kv}: corrupted buffer: tokens equal "
                  f"{list(r.tokens) == ref[0][victim]}, crc {ts2['crc_failures']}, misses "
                  f"{ts2['restore_misses']}")
            srv.drain()
            led = srv._heat_decode
            err = led.reconcile(srv.allocator, pc, host_store=store)
            check(err is None, f"phase 25 {kv}: heat ledger at drain: {err}")
            srv.check_no_leaks()
            srv.release_prefix_cache()
            srv.allocator.check_no_leaks()
            check(led.reconcile(srv.allocator, pc, host_store=store) is None,
                  f"phase 25 {kv}: heat ledger after release")
            srv.detach_heat()
            heat.close()
            tier.close()
        sync()
        dev_ms = [e[0].elapsed_time(e[1]) for e, _ in spans if e]
        wall_ms = [w * 1e3 for _, w in spans]
        # the requests whose admission restored pages, by (round, index)
        restored = [(r, i) for r, subs in enumerate(reqs) for i, q in enumerate(subs)
                    if q.id in restored_ids]
        # the tight pool without the tier: the demoted prefixes recompute
        off_streams, st_off, off_reqs = serve_rounds(
            eng.serve(dict(base, num_pages=tight_pages)), rounds, kernels, cfg.n_layer, spec_k,
            f"phase 25 {kv} tight, no tier")
        recomputed = sum(off_reqs[r][i].prefix_shared_tokens < reqs[r][i].prefix_shared_tokens
                         for r, i in restored)
        same = sum(a == b for ra, rb in zip(off_streams, ref) for a, b in zip(ra, rb))

        def ttft(run):
            return (statistics.median(run[r][i].ttft_s for r, i in restored) * 1e3
                    if restored else float("nan"))
        print(f"{kv}: spills {ts['spills']} ({n_prefix} distinct prefix pages in the traffic), "
              f"restores {ts['restores']}, host evictions {ts['host_evictions']}, orphan drops "
              f"{ts['orphan_drops']}; 4 slots, pool {tight_pages} pages (roomy "
              f"{FEATURES_SECTION['num_pages']}), host budget {host_pages} pages; launches "
              f"decode / multitoken {st['launches']} tiered, {st_ref['launches']} roomy "
              f"(per program equal: {per['tier']}); executables "
              f"{len(srv.executables)}")
        dev = statistics.median(dev_ms) if dev_ms else float("nan")
        print(f"{kv}: restore a page: device {dev:.4f} ms (CUDA events around the call: the "
              f"page's upload from pinned memory + the scatter; median of {len(dev_ms)}; "
              f"{store.page_bytes / dev / 1e6:.2f} GB/s), "
              f"wall {statistics.median(wall_ms):.4f} ms (the call, host side), "
              f"{store.page_bytes} bytes a page ({store.page_bytes / 2**20:.3f} MiB); "
              f"{smi}")
        print(f"{kv}: TTFT p50 of the {len(restored)} requests whose admission restored pages: "
              f"{ttft(reqs):.2f} ms with the tier, {ttft(off_reqs):.2f} ms the same requests "
              f"in the tight pool without it ({recomputed} of them recomputed part of their "
              f"prefix; its streams equal the reference's in {same} of "
              f"{sum(len(x) for x in ref)}), {ttft(ref_reqs):.2f} ms in the roomy pool (a "
              f"device hit); {smi}")
        line = (f"{kv}: tiered decode tokens/s {st['decode_tokens_per_s']:.1f}, (exact) TPOT p50 "
                f"{st['tpot']['p50_s'] * 1e3:.3f} ms; roomy without the tier "
                f"{st_ref['decode_tokens_per_s']:.1f}, {st_ref['tpot']['p50_s'] * 1e3:.3f} ms")
        if ref_3b is not None and kv == "bf16":
            line += (f"; phase 3b {ref_3b['decode_tokens_per_s']:.1f}, "
                     f"{ref_3b['tpot']['p50_s'] * 1e3:.3f} ms")
        print(line + f"; {smi}")
        out[kv] = st["launches"]
    del eng
    gc.collect()
    return out


def state_equal(a, b):
    """Every state leaf of two engines equal bit for bit."""
    sa, sb = a.state_leaves(), b.state_leaves()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def host_state(eng):
    return {k: v.detach().cpu().clone() for k, v in eng.state_leaves().items()}


def state_is(eng, host):
    return all(torch.equal(v.cpu(), host[k]) for k, v in eng.state_leaves().items())


def resilience_phase(smi, model="gpt2-medium", device=None, fault_layers=2, fault_seq=256,
                     main_micro=8, main_seq=None, overrides=None):
    """Phase 26: (a) phase 6's training (captured) with a resilient async
    save at step 2 and a new engine that loads the tag after its own program
    is captured and replays steps 3-4: losses and every state leaf equal the
    uninterrupted run bit for bit; (b) at gpt2-medium width, 2 layers:
    ``crash_saves`` leaves the previous tag loadable, a corrupted newest tag
    walks back, ``nan_loss`` under the watchdog's rollback equals the clean
    run without the poisoned batch bit for bit, SIGTERM through a
    PreemptionGuard checkpoints and the resume is equal; (c) the serving
    stall at retry_max 2 finishes every request with the clean stream and
    leaks nothing. Prints the snapshot's step-path ms, the write's seconds
    and GB/s and the load's seconds. → launches (flash forward, backward,
    fused AdamW) of (a)."""
    from deepspeed_tpu_torch.elasticity.preemption import PreemptionGuard
    from deepspeed_tpu_torch.resilience import FaultInjected, FaultInjector, find_latest_valid
    from deepspeed_tpu_torch.runtime.config import FaultInjectionConfig
    from deepspeed_tpu_torch.serving.scheduler import ServingEngine

    def engine(cfg, conf, seed=0):
        e, _, _, _ = dtt.initialize(model=gpt2.make_module(cfg), config=conf, seed=seed,
                                    device=device)
        return e

    def batches(cfg, rows, S, n, seed):
        rs = np.random.RandomState(seed)
        return [{"input_ids": rs.randint(0, cfg.vocab_size, (rows, S)).astype(np.int32)}
                for _ in range(n)]

    with tempfile.TemporaryDirectory(prefix="resilience-") as root:
        # (a) resume at full size
        cfg = gpt2.get_config(model, **(overrides or {}))
        S = main_seq or cfg.n_positions
        conf = dict(train_config(micro=main_micro, gas=2), resilience={"enabled": True})
        bs = batches(cfg, 2 * main_micro, S, 6, seed=26)
        e1 = engine(cfg, conf)
        reset_flash_launches()
        reset_optimizer_launches()
        l1 = [float(e1.train_batch(b)["loss"]) for b in bs[:2]]
        sync()
        d = os.path.join(root, "resume")
        t0 = time.perf_counter()
        e1.save_checkpoint(d)
        snap_ms = e1.last_snapshot_s * 1e3
        e1.flush_checkpoints()
        write_s = time.perf_counter() - t0 - e1.last_snapshot_s
        writer = next(iter(e1._ckpt_writers.values()))
        check(writer.last_error is None and writer.saves_committed == 1,
              f"phase 26: the async save failed: {writer.last_error}")
        # a later save's snapshot reuses the pinned buffers (the first one
        # allocated them): the same copy again, timed alone
        from deepspeed_tpu_torch.resilience.writer import snapshot_to_host

        t0 = time.perf_counter()
        snapshot_to_host(e1.state_leaves(), out=e1._snap_bufs)
        resnap_ms = (time.perf_counter() - t0) * 1e3
        nbytes = sum(v.numel() * v.element_size() for v in e1.state_leaves().values())
        l1 += [float(e1.train_batch(b)["loss"]) for b in bs[2:4]]
        launches = (LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_bwd"],
                    LAUNCHES["fused_adamw"])
        check(device == "cpu" or all(n > 0 for n in launches),
              f"phase 26: launches flash / AdamW {launches}")
        e2 = engine(cfg, conf, seed=1)
        for b in bs[4:6]:  # its program warmed up and captured before the load
            e2.train_batch(b)
        prog = next(iter(e2._programs.values()))
        check(device == "cpu" or prog.graph is not None, "phase 26: e2's step is not captured")
        held = dict(e2.state_leaves())
        sync()
        t0 = time.perf_counter()
        e2.load_checkpoint(d)
        sync()
        load_s = time.perf_counter() - t0
        check(all(v is held[k] for k, v in e2.state_leaves().items()),
              "phase 26: the load rebound state tensors")
        replays = prog.replays
        l2 = [float(e2.train_batch(b)["loss"]) for b in bs[2:4]]
        check(device == "cpu" or prog.replays == replays + 2,
              f"phase 26: the resumed steps did not replay ({prog.replays - replays})")
        check(l2 == l1[2:] and state_equal(e1, e2),
              f"phase 26: resumed losses {l2} against {l1[2:]}, states equal "
              f"{state_equal(e1, e2)}")
        print(f"resume: losses {' '.join(f'{x:.6f}' for x in l1)}; resumed steps 3-4 "
              f"{' '.join(f'{x:.6f}' for x in l2)} (bit for bit, every state leaf too); "
              f"launches flash fwd / bwd / AdamW {launches}")
        print(f"checkpoint of {nbytes / 1e9:.3f} GB ({len(e1.state_leaves())} leaves: fp32 master, "
              f"two moments, counters): snapshot on the step path {snap_ms:.1f} ms (the "
              f"first save, pinned buffers allocated; {resnap_ms:.1f} ms into them again, "
              f"{nbytes / resnap_ms / 1e6:.2f} GB/s), write "
              f"{write_s:.3f} s ({nbytes / write_s / 1e9:.3f} GB/s, crc32 + fsync, async), load "
              f"{load_s:.3f} s (validate + read + copy in place); {smi}")
        del e1, e2, prog, held
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

        # (b) the fault cases at gpt2-medium width, few layers
        cfgf = gpt2.get_config(model, **dict(overrides or {}, n_layer=fault_layers))
        base = train_config(micro=2, gas=1)
        fb = batches(cfgf, 2, fault_seq, 4, seed=27)

        def res(**kw):
            return dict(base, resilience={"enabled": True, **kw})

        # crash mid-save: the previous tag stays loadable
        d = os.path.join(root, "crash")
        e = engine(cfgf, res(fault_injection={"enabled": True, "crash_saves": [2]}))
        e.train_batch(fb[0])
        after1 = host_state(e)
        e.save_checkpoint(d, tag="s1")
        e.train_batch(fb[1])
        e.save_checkpoint(d, tag="s2")
        e.flush_checkpoints()
        w = next(iter(e._ckpt_writers.values()))
        e2 = engine(cfgf, res(), seed=1)
        e2.load_checkpoint(d)
        check(isinstance(w.last_error, FaultInjected) and os.path.isdir(d + "/s2.tmp")
              and e2.get_global_step() == 1 and state_is(e2, after1),
              f"phase 26 crash_saves: error {w.last_error!r}, global step {e2.get_global_step()}")
        # a corrupted newest tag walks back
        d = os.path.join(root, "walk")
        ew = engine(cfgf, res(async_checkpoint=False))
        ew.train_batch(fb[0])
        ew.save_checkpoint(d, tag="t1")
        after1 = host_state(ew)
        ew.train_batch(fb[1])
        ew.save_checkpoint(d, tag="t2")
        with open(os.path.join(d, "t2", "00000.bin"), "r+b") as fh:
            word = fh.read(4)
            fh.seek(0)
            fh.write(bytes(x ^ 0xFF for x in word))
        e3 = engine(cfgf, res(), seed=1)
        e3.load_checkpoint(d)
        check(find_latest_valid(d)[0] == "t1" and e3.get_global_step() == 1
              and state_is(e3, after1),
              f"phase 26 walk-back: tag {find_latest_valid(d)}, global step {e3.get_global_step()}")
        print("crash_saves: the torn s2.tmp skipped, s1 loaded bit for bit; a corrupted newest "
              "tag t2 walked back to t1 bit for bit")
        del e, e2, e3, ew
        # nan_loss under the rollback: the clean run minus the poisoned batch
        plane = {"enabled": True, "trace_path": os.path.join(root, "tel"),
                 "watchdog": {"enabled": True, "policy": "rollback", "warmup_steps": 100,
                              "capture_dir": os.path.join(root, "anomalies")}}
        ef = engine(cfgf, dict(res(snapshot_every=1, fault_injection={
            "enabled": True, "nan_loss_steps": [2]}), telemetry=plane))
        held = dict(ef.state_leaves())
        outf = [ef.train_batch(b) for b in fb]
        ec = engine(cfgf, dict(res(snapshot_every=1), telemetry=plane))
        outc = [ec.train_batch(b) for b in (fb[0], fb[2], fb[3])]
        lf = [float(outf[i]["loss"]) for i in (0, 2, 3)]
        lc = [float(m["loss"]) for m in outc]
        check(outf[1].get("rolled_back") is True and lf == lc and state_equal(ef, ec)
              and ef.global_steps == 3 and ef.get_global_step() == 3
              and all(v is held[k] for k, v in ef.state_leaves().items()),
              f"phase 26 rollback: rolled back {outf[1].get('rolled_back')}, losses {lf} "
              f"against {lc}, states equal {state_equal(ef, ec)}")
        print(f"nan_loss at call 2 under rollback: losses {' '.join(f'{x:.6f}' for x in lf)} = "
              f"the clean run without the poisoned batch, bit for bit (every state leaf too)")
        del ef, ec, outf, outc, held
        # SIGTERM through a PreemptionGuard: checkpoint, then an equal resume
        d = os.path.join(root, "preempt")
        e = engine(cfgf, res(fault_injection={"enabled": True, "sigterm_steps": [2]}))
        stopped = None
        with PreemptionGuard(e, d) as guard:
            for i, b in enumerate(fb):
                e.train_batch(b)
                if guard.should_stop():
                    path = guard.checkpoint_and_log()
                    stopped = i
                    break
        e2 = engine(cfgf, res(), seed=1)
        e2.load_checkpoint(d)
        la = [float(e.train_batch(b)["loss"]) for b in fb[2:]]
        lb = [float(e2.train_batch(b)["loss"]) for b in fb[2:]]
        check(stopped == 1 and la == lb and state_equal(e, e2),
              f"phase 26 SIGTERM: stopped after call {stopped}, losses {la} against {lb}")
        print(f"SIGTERM after call 2: checkpointed at {os.path.basename(path)}, the resumed run "
              f"equal bit for bit ({' '.join(f'{x:.6f}' for x in lb)})")
        del e, e2
        gc.collect()

    # (c) the serving stall with retries
    cfgs = gpt2.get_config(model, **(overrides or {}))
    eng = dtt.init_inference(cfgs, dtype=torch.bfloat16, seed=0, device=device)
    clean = eng.serve()
    creqs = mixed_requests(clean, 16, cfgs.vocab_size, seed=1234)
    clean.run()
    inj = FaultInjector(FaultInjectionConfig(enabled=True, stall_requests=[1, 6, 11]))
    srv = ServingEngine(eng, {"retry_max": 2, "retry_backoff_s": 0.0}, fault_injector=inj)
    LAUNCHES[K_PAGED] = 0
    sreqs = mixed_requests(srv, 16, cfgs.vocab_size, seed=1234)
    srv.run()
    st = srv.stats()
    ok = all(a.status == b.status == RequestStatus.FINISHED and a.tokens == b.tokens
             for (a, _), (b, _) in zip(creqs, sreqs))
    check(ok and st["retried"] == 3 and sum(r.retries for r, _ in sreqs) == 3
          and (device == "cpu" or LAUNCHES[K_PAGED] > 0),
          f"phase 26 serving stall: streams equal {ok}, retried {st['retried']}")
    srv.check_no_leaks()
    print(f"serving_stall at admissions 1, 6, 11 with retry_max 2: 16/16 finished with the "
          f"clean streams, retried {st['retried']}, decode launches {LAUNCHES[K_PAGED]}, no "
          f"leaks")
    return launches


# ---------------------------------------------------------------------------
# phase 27: the serving fleet and the seeded trace-replay harness
# ---------------------------------------------------------------------------

# the replay harness's traffic: 24 requests from 3 Zipf tenants sharing
# system prompts, lognormal prompts (median 128, clipped to 512), 64 new
# tokens each, under a virtual clock advancing FLEET_STEP_S a step
FLEET_WORKLOAD = dict(n_requests=24, seed=2727, n_tenants=3, tenant_zipf_s=1.1,
                      prompt_len_median=128.0, max_prompt_len=512, prefix_fraction=0.5,
                      max_new_tokens=64, base_interarrival_s=0.05)
FLEET_STEP_S = 0.01


def wall_marks(obj):
    """Wrap ``obj.step`` (a serving engine's or a fleet's, under a
    ``ReplayClock``) to record each step's wall start and end, after the
    device's work, by the virtual time it ran at → {t: [start, end]}."""
    marks = {}
    step = obj.step

    def timed():
        t = obj.clock()
        t0 = time.perf_counter()
        out = step()
        sync()
        marks.setdefault(t, [t0, None])[1] = time.perf_counter()
        return out

    obj.step = timed
    return marks


def wall_latency(reqs, marks):
    """Each request's TTFT (its submit step's start to the end of the step
    that emitted its first token) and mean TPOT (the end of its first
    emitting step to the end of its last, over the gaps) in wall time at
    step resolution → {"ttft": {p50_s, p99_s}, "tpot": {...}} (exact
    percentiles)."""
    ttft, tpot = [], []
    for r in reqs:
        ttft.append(marks[r.t_first_token][1] - marks[r.t_submit][0])
        if len(r.t_emissions) > 1:
            tpot.append((marks[r.t_emissions[-1]][1] - marks[r.t_emissions[0]][1])
                        / (len(r.t_emissions) - 1))
    return {name: {f"p{q}_s": float(np.percentile(v, q)) for q in (50, 99)}
            for name, v in (("ttft", ttft), ("tpot", tpot))}


def compare_tie_streams(label, eng, ref, got, margin_limit):
    """Two runs' requests, in order: each stream identical, or a tie: at
    the first differing token the top-2 margin of ``eng``'s logits for the
    reference's prefix before it is below ``margin_limit`` (phase 4's rule
    at the bf16 margin). → the number of ties."""
    ties = 0
    for i, (a, b) in enumerate(zip(ref, got)):
        if a.tokens == b.tokens:
            continue
        t = next(j for j, (x, y) in enumerate(zip(a.tokens, b.tokens)) if x != y)
        ids = np.concatenate([np.asarray(a.prompt, np.int32),
                              np.asarray(a.tokens[:t], np.int32)])[None]
        top2 = torch.topk(eng.forward({"input_ids": ids})[0, -1].float(), 2).values
        margin = float(top2[0] - top2[1])
        print(f"{label}: request {i}: streams differ at token {t}, top-2 logit margin "
              f"{margin:.3e}")
        check(margin < margin_limit, f"{label}: request {i} differs at token {t} with margin "
                                     f"{margin:.3e} >= {margin_limit} (not a tie)")
        ties += 1
    print(f"{label}: {len(ref) - ties} of {len(ref)} streams bit-identical, {ties} ties "
          f"(margin < {margin_limit}), {sum(len(r.tokens) for r in ref)} tokens compared")
    return ties


@contextlib.contextmanager
def migration_parts(fleet):
    """Time every migration of ``fleet`` by part: export (the gather and
    the host copies), the manifest write (crc32, fsync), validate, load
    (the manifest and the arrays read back), adopt (the upload and the
    scatter, synchronized), and the whole ``_migrate_session`` call →
    yields the list of {part: s} dicts, one a migration."""
    from deepspeed_tpu_torch.serving import fleet as fleet_mod

    parts, cur = [], {}

    def timed(name, fn, synced=False):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if synced:
                sync()
            cur[name] = cur.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    saved = {n: getattr(fleet_mod, n)
             for n in ("write_tag", "validate_tag", "read_manifest", "load_arrays")}
    for n, part in (("write_tag", "write"), ("validate_tag", "validate"),
                    ("read_manifest", "load"), ("load_arrays", "load")):
        setattr(fleet_mod, n, timed(part, saved[n]))
    for rep in fleet.replicas:
        rep.srv.export_session = timed("export", rep.srv.export_session)
        rep.srv.adopt_session = timed("adopt", rep.srv.adopt_session, synced=True)
    migrate = fleet._migrate_session

    def timed_migrate(src, slot_i, now):
        cur.clear()
        t0 = time.perf_counter()
        ok = migrate(src, slot_i, now)
        parts.append(dict(cur, total=time.perf_counter() - t0, ok=ok))
        return ok

    fleet._migrate_session = timed_migrate
    try:
        yield parts
    finally:
        for n, fn in saved.items():
            setattr(fleet_mod, n, fn)


def fleet_launch_check(label, fleet, kernels, n_layer, spec_k):
    """The paged decode and multi-token launches of a fleet run against the
    sum over the replicas of phase 3b's per-program formulas (the
    migration programs launch no attention kernel) → (dec, mt)."""
    dec, mt = (LAUNCHES[k] for k in kernels)
    steps = sum(r.srv.stats()["spec_steps"] for r in fleet.replicas)
    chunks = sum(r.srv.stats()["chunk_prefills"] for r in fleet.replicas)
    check(dec > 0 and mt > 0 and dec == n_layer * (spec_k + 1) * steps
          and mt == n_layer * chunks,
          f"{label}: launches decode {dec}, multitoken {mt}; verify steps {steps}, chunk "
          f"calls {chunks} over the replicas")
    return dec, mt


def close_fleet(label, fleet):
    """Drain, audit every replica, close the router and the replicas' host
    tiers, and drop them: the migration programs' static row buffers must
    be freed with their replica (weak references die)."""
    import weakref

    fleet.drain()
    fleet.check_no_leaks()
    for rep in fleet.replicas:
        check(len(rep.srv.executables) == rep.srv.expected_executables
              and not any(p.name.startswith(("serving_kv_gather", "serving_kv_scatter"))
                          for p in rep.srv.executables),
              f"{label} {rep.rid}: executables {[p.name for p in rep.srv.executables]}, "
              f"expected {rep.srv.expected_executables}")
    rows = [weakref.ref(t) for rep in fleet.replicas for t in rep.srv._migrate_rows]
    fleet.close()
    for rep in fleet.replicas:
        rep.srv.release_prefix_cache()
        rep.srv.allocator.check_no_leaks()
        rep.srv.tiering.close()
    return rows


def fleet_phase(smi, model="gpt2-medium", dtype=torch.bfloat16, device=None, overrides=None):
    """Phase 27: the serving fleet and the replay harness at full width.
    (a) one un-migrated engine under ``replay`` of the seeded workload, bf16
    then int8 pages; (b) a 2-replica ``FleetRouter`` over the same engine
    under ``replay_fleet`` with the most loaded replica preempted at the last
    arrival, holding live decode sessions: migrations ``ok``, every stream
    equal to (a)'s or a tie, every request finished, no leak on either
    replica, executables as expected, launches exact, the row buffers freed
    with the replicas; (c) the first payload corrupted: counted
    ``crc_failed``, requeued, finished with (a)'s stream; (d) a SIGTERM from
    the fault injector on the router's handler: the victim drains, every
    request finishes, nothing leaks. Prints the migrations by status, the
    bytes and the blackout a migration by part, TTFT/TPOT of the fleet
    against the single engine and the fleet's ``stats()``."""
    import glob

    from deepspeed_tpu_torch.resilience import FaultInjector
    from deepspeed_tpu_torch.runtime.config import FaultInjectionConfig
    from deepspeed_tpu_torch.serving import (
        FleetRouter, ReplayClock, WorkloadSpec, generate_workload, replay, replay_fleet,
    )

    cfg = gpt2.get_config(model, **(overrides or {}))
    eng = dtt.init_inference(cfg, dtype=dtype, seed=0, device=device)
    spec_k = FEATURES_SECTION["speculative"]["k"]
    L = cfg.n_layer
    items = generate_workload(WorkloadSpec(vocab_size=cfg.vocab_size, **FLEET_WORKLOAD))
    # two thirds into the arrivals: the replicas hold decode sessions and,
    # below saturation, the peer has free slots to adopt them
    preempt_at = items[2 * len(items) // 3].t_arrival
    budget = FLEET_WORKLOAD["max_new_tokens"]
    base = dict(FEATURES_SECTION, max_slots=4, tiering={"enabled": True})
    fleet_cfg = {"enabled": True, "replicas": 2}
    plens = [len(it.prompt) for it in items]
    print(f"workload: {len(items)} requests, tenants "
          f"{sorted(set(it.tenant for it in items))}, prompt lengths {min(plens)}..{max(plens)} "
          f"(median {statistics.median(plens):.0f}), {budget} new tokens each, arrivals over "
          f"{items[-1].t_arrival:.3f} s of virtual time at {FLEET_STEP_S} s a step; 4 slots a "
          f"replica; preemption at t={preempt_at:.3f}")

    def finished(label, reqs):
        for r in reqs:
            check(r.status == RequestStatus.FINISHED and len(r.tokens) == budget
                  and all(0 <= x < cfg.vocab_size for x in r.tokens),
                  f"{label}: request {r.id}: {r.status} {r.detail}, {len(r.tokens)} of "
                  f"{budget} tokens")

    refs = {}
    out = {}
    for kv in ("bf16", "int8"):
        section = dict(base, **({"kv_cache_dtype": "int8"} if kv == "int8" else {}))
        kernels = (K_PAGED8, K_MT8) if kv == "int8" else (K_PAGED, K_MT)

        # (a) the reference: one engine, nothing migrates
        srv = eng.serve(section, clock=ReplayClock())
        marks = wall_marks(srv)
        for k in kernels:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        res = replay(srv, items, step_dt=FLEET_STEP_S)
        sync()
        wall_ref = time.perf_counter() - t0
        ref = res["requests"]
        finished(f"phase 27 {kv} single engine", ref)
        st = srv.stats()
        dec, mt = (LAUNCHES[k] for k in kernels)
        check(dec == L * (spec_k + 1) * st["spec_steps"] and mt == L * st["chunk_prefills"],
              f"phase 27 {kv} single engine: launches {dec}, {mt}, verify steps "
              f"{st['spec_steps']}, chunks {st['chunk_prefills']}")
        lat_ref = wall_latency(ref, marks)
        srv.drain()
        srv.check_no_leaks()
        srv.release_prefix_cache()
        srv.tiering.close()
        del srv
        refs[kv] = ref

        # (b) the fleet, the most loaded replica preempted at the last arrival
        fleet = FleetRouter(eng, dict(section, fleet=fleet_cfg), clock=ReplayClock())
        marks = wall_marks(fleet)
        live, free = [], []
        preempt = fleet._preempt_replica

        def counted_preempt(rep, preempt=preempt, live=live, fleet=fleet):
            live.append(sum(1 for s in rep.srv.slots if s.request is not None
                            and not s.prefilling and s.request.tokens))
            free.extend(sum(1 for s in r.srv.slots if s.request is None)
                        for r in fleet.replicas if r is not rep)
            preempt(rep)

        fleet._preempt_replica = counted_preempt
        for k in kernels:
            LAUNCHES[k] = 0
        t0 = time.perf_counter()
        with migration_parts(fleet) as parts:
            res = replay_fleet(fleet, items, step_dt=FLEET_STEP_S, preempt_at=preempt_at)
        sync()
        wall_fleet = time.perf_counter() - t0
        got = res["requests"]
        fst = fleet.stats()
        finished(f"phase 27 {kv} fleet", got)
        check(len(live) == 1 and live[0] >= 1 and fst["fleet"]["alive"] == 1,
              f"phase 27 {kv}: the victim held {live} live decode sessions, {fst['fleet']}")
        check(fst["fleet"]["migrations_ok"] >= 1 and fst["fleet"]["migrations_crc_failed"] == 0,
              f"phase 27 {kv}: migrations {fst['fleet']}")
        dec, mt = fleet_launch_check(f"phase 27 {kv} fleet", fleet, kernels, L, spec_k)
        ties = compare_tie_streams(f"phase 27 {kv} fleet against the single engine", eng, ref,
                                   got, BF16_TIE_MARGIN)
        lat = wall_latency(got, marks)
        ok_parts = [p for p in parts if p["ok"]]
        n_ok = int(fst["fleet"]["migrations_ok"])
        mig_bytes = fst["fleet"]["migration_bytes"] / max(n_ok, 1)
        victim = next(r for r in fleet.replicas if not r.alive)
        dest = next(r for r in fleet.replicas if r.alive)
        calls = (getattr(victim.srv._migrate_gather, "calls", 0),
                 getattr(dest.srv._migrate_scatter, "calls", 0))
        check(calls == (len(parts), n_ok),
              f"phase 27 {kv}: gather / scatter calls {calls}, migrations {len(parts)} "
              f"({n_ok} ok)")
        print(f"{kv}: fleet of 2 over one engine: replicas {[r.rid for r in fleet.replicas]}, "
              f"routed {[r.routed for r in fleet.replicas]}, victim {victim.rid} with {live[0]} "
              f"live decode sessions at t={preempt_at:.3f} (the peer {free[0]} free slots); "
              f"migrations ok {n_ok}, crc_failed "
              f"{fst['fleet']['migrations_crc_failed']:.0f}, no_capacity "
              f"{fst['fleet']['migrations_no_capacity']:.0f}, requeues "
              f"{fst['fleet']['requeues']:.0f}; streams bit-identical to the single engine "
              f"{len(ref) - ties} of {len(ref)}, ties {ties}")
        print(f"{kv}: launches decode {dec} = {L} x {spec_k + 1} x verify steps summed over the "
              f"replicas, multitoken {mt} = {L} x chunk calls summed (the migration programs "
              f"launch no attention kernel); executables a replica "
              f"{[len(r.srv.executables) for r in fleet.replicas]} = expected "
              f"{fleet.replicas[0].srv.expected_executables}; gather {victim.srv._migrate_gather.name} "
              f"captured {victim.srv._migrate_gather.graph is not None}")

        def q(key):
            v = [p.get(key, 0.0) * 1e3 for p in ok_parts]
            return f"{key} p50 {statistics.median(v):.2f} / max {max(v):.2f}" if v else key
        print(f"{kv}: a migration moves {mig_bytes:.0f} bytes ({mig_bytes / 2**20:.3f} MiB: "
              f"k and v rows of {victim.srv.pages_per_slot} pages"
              + (" + the int8 scales" if kv == "int8" else "") + "); blackout ms: "
              + ", ".join(q(k) for k in ("total", "export", "write", "validate", "load", "adopt"))
              + f" (wall, {len(ok_parts)} migrations; {smi})")
        print(f"{kv}: TTFT p50 / p99 (wall, step resolution) fleet "
              f"{lat['ttft']['p50_s'] * 1e3:.2f} / {lat['ttft']['p99_s'] * 1e3:.2f} ms against the "
              f"single engine {lat_ref['ttft']['p50_s'] * 1e3:.2f} / "
              f"{lat_ref['ttft']['p99_s'] * 1e3:.2f} ms; TPOT p50 / p99 fleet "
              f"{lat['tpot']['p50_s'] * 1e3:.3f} / {lat['tpot']['p99_s'] * 1e3:.3f} ms against "
              f"{lat_ref['tpot']['p50_s'] * 1e3:.3f} / {lat_ref['tpot']['p99_s'] * 1e3:.3f} ms; "
              f"replay wall {wall_fleet:.3f} s against {wall_ref:.3f} s ({smi})")
        print(f"{kv}: fleet stats() {json.dumps(fst, default=str)}")
        rows = close_fleet(f"phase 27 {kv}", fleet)
        del fleet, victim, dest, res, got, parts, ok_parts, counted_preempt, preempt, marks
        gc.collect()
        check(rows and all(r() is None for r in rows),
              f"phase 27 {kv}: {sum(r() is not None for r in rows)} of {len(rows)} migration "
              "row buffers outlived their replica")
        out[kv] = (dec, mt)

    # (c) the first payload corrupted after its crc was recorded
    sub = items[:12]
    flipped = []

    def corrupt(tag_dir, req):
        if flipped:
            return
        fname = sorted(glob.glob(os.path.join(tag_dir, "*.bin")))[0]
        with open(fname, "r+b") as fh:
            b = fh.read(1)
            fh.seek(0)
            fh.write(bytes([b[0] ^ 0xFF]))
        flipped.append(req.id)

    fleet = FleetRouter(eng, dict(base, fleet=fleet_cfg), clock=ReplayClock())
    fleet.on_migration_payload = corrupt
    res = replay_fleet(fleet, sub, step_dt=FLEET_STEP_S, preempt_at=sub[-1].t_arrival)
    fst = fleet.stats()["fleet"]
    finished("phase 27 corrupted payload", res["requests"])
    check(len(flipped) == 1 and fst["migrations_crc_failed"] == 1 and fst["requeues"] >= 1,
          f"phase 27 corrupted payload: flipped {flipped}, {fst}")
    hit = next(r for r in res["requests"] if r.id == flipped[0])
    ref_hit = refs["bf16"][next(i for i, r in enumerate(res["requests"]) if r is hit)]
    compare_tie_streams("phase 27 corrupted payload's session against the single engine", eng,
                        [ref_hit], [hit], BF16_TIE_MARGIN)
    compare_tie_streams("phase 27 (c) every stream against the single engine", eng,
                        refs["bf16"][:len(sub)], res["requests"], BF16_TIE_MARGIN)
    print(f"corrupted payload (request {flipped[0]}): fleet_migrations_total"
          f"{{status=\"crc_failed\"}} {fst['migrations_crc_failed']:.0f}, ok "
          f"{fst['migrations_ok']:.0f}, requeues {fst['requeues']:.0f}; requeued on "
          f"{hit.replica} and finished with {len(hit.tokens)} tokens")
    close_fleet("phase 27 (c)", fleet)
    del fleet, res, hit

    # (d) a SIGTERM from the fault injector on the router's handler
    inj = FaultInjector(FaultInjectionConfig(enabled=True, sigterm_steps=[12]))
    fleet = FleetRouter(eng, dict(base, fleet=dict(fleet_cfg, install_sigterm=True)))
    prev = None
    try:
        subs = [fleet.submit(it.prompt, max_new_tokens=it.max_new_tokens, seed=it.seed,
                             tenant=it.tenant, slo_class=it.slo_class) for it in sub]
        steps = 0
        while (any(rep.srv.queue or any(s.request is not None for s in rep.srv.slots)
                   for rep in fleet.alive()) or fleet._pending_preemption()):
            if inj.fire("sigterm", steps):
                check(inj.deliver_sigterm(), "phase 27 (d): no SIGTERM handler installed")
            fleet.step()
            steps += 1
            check(steps < 4000, "phase 27 (d): the fleet did not drain")
        fst = fleet.stats()["fleet"]
        finished("phase 27 SIGTERM", subs)
        check(inj.counts().get("sigterm") == 1 and fst["alive"] == 1
              and fst["migrations_ok"] + fst["requeues"] >= 1,
              f"phase 27 (d): sigterm {inj.counts()}, {fst}")
        compare_tie_streams("phase 27 (d) SIGTERM streams against the single engine", eng,
                            refs["bf16"][:len(sub)], subs, BF16_TIE_MARGIN)
        print(f"SIGTERM at fleet step 12: victim "
              f"{next(r.rid for r in fleet.replicas if not r.alive)} drained, migrations ok "
              f"{fst['migrations_ok']:.0f}, requeues {fst['requeues']:.0f}, {len(subs)} of "
              f"{len(sub)} finished, {steps} steps")
    finally:
        prev = signal.getsignal(signal.SIGTERM)
        close_fleet("phase 27 (d)", fleet)
    check(signal.getsignal(signal.SIGTERM) is not prev,
          "phase 27 (d): close() left the router's SIGTERM handler installed")
    del fleet, eng
    gc.collect()
    return out


# ---------------------------------------------------------------------------
# phase 28: comm/ on NCCL and ZeRO stages 1-3 at world 1
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def zero_run(label, module, conf, batch, steps, stage, extra=None):
    """``steps`` steps of ``conf`` at ZeRO ``stage`` over ``mesh: {dp: -1}``
    with the counts at 0 (step 1 eager, 2 captured, then replays, each
    closed by a sync) → (engine, losses, step seconds, the comms logger's
    calls of step 1 by kind, the training kernels' launches)."""
    from deepspeed_tpu_torch import comm

    c = dict(conf, mesh={"dp": -1}, zero_optimization={"stage": stage}, **(extra or {}))
    eng, *_ = dtt.initialize(model=module, config=c, seed=0)
    check(eng.distributed and eng.zero_optimization_stage() == stage,
          f"{label}: the engine is not on the process group at stage {stage}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    reset_optimizer_launches()
    losses, step_s, step_comms = [], [], {}
    for i in range(steps):
        comm.comms_logger.reset()
        t0 = time.perf_counter()
        m = eng.train_batch(batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            step_comms = comm.comms_logger.counts()
    launches = dict(counts(fa.KERNELS), **counts(fadam.KERNELS))
    return eng, losses, step_s, step_comms, launches


def zero_phase(smi):
    """Phase 28: the collectives on NCCL at world 1, then ZeRO stages 1-3
    against stage 0 bit for bit on the captured training step (GPT-2 with
    AdamW, BERT with LAMB), a stage-3 resilient tag loaded at stage 0, and
    the collectives a step against each stage's plan."""
    from deepspeed_tpu_torch import comm

    t_phase = time.perf_counter()
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    comm.init_distributed(dist_backend="nccl", verbose=False)
    check(torch.distributed.get_backend() == "nccl" and comm.get_world_size() == 1,
          "28a: the process group is not NCCL at world 1")
    comm.comms_logger.configure(enabled=True)
    comm.comms_logger.reset()
    phase("28a", "collectives on NCCL at world 1: each equals its input, the logger's records")
    x = torch.randn(64, 48, device="cuda", generator=torch.Generator(device="cuda").manual_seed(28))
    outs = {
        "all_reduce sum": comm.all_reduce(x.clone()), "all_reduce mean": comm.all_reduce(
            x.clone(), op="mean"), "all_reduce max": comm.all_reduce(x.clone(), op="max"),
        "all_gather dim 0": comm.all_gather(x), "all_gather dim 1": comm.all_gather(
            x, gather_dim=1), "reduce_scatter dim 1": comm.reduce_scatter(x, scatter_dim=1),
        "all_to_all": comm.all_to_all(x, split_dim=0, concat_dim=1),
        "broadcast": comm.broadcast(x.clone()), "ppermute": comm.ppermute(x, perm=[(0, 0)]),
        "ring_shift": comm.ring_shift(x)}
    comm.barrier()
    torch.cuda.synchronize()
    for name, y in outs.items():
        check(torch.equal(y, x), f"28a: {name} at world 1 differs from its input")
    recs = comm.comms_logger.comms_dict
    want = {("all_reduce", "world"): (3, 3 * x.numel() * 4),
            ("all_gather", "world"): (2, 2 * x.numel() * 4),
            ("reduce_scatter", "world"): (1, x.numel() * 4),
            ("all_to_all", "world"): (1, x.numel() * 4), ("broadcast", "world"): (1, x.numel() * 4),
            ("ppermute", "world"): (1, x.numel() * 4)}
    got = {k: (r["count"], r["bytes"]) for k, r in recs.items()}
    check(got == want, f"28a: comms logger records {got}, expected {want}")
    print("every collective equal to its input bit for bit (sum, mean, max, gather along dims 0 "
          "and 1, reduce-scatter along dim 1, all-to-all, broadcast, ppermute, ring_shift); the "
          f"logger's records (op, axis) -> (count, bytes): {got}")
    comm.comms_logger.measure(iters=20)
    print(comm.log_summary())
    comm.comms_logger.reset()

    phase("28b", "gpt2-medium bf16 (phase 6's run) at ZeRO stages 0-3 on the process group, "
                 "4 steps each: stages 1-3 against stage 0 bit for bit")
    cfg = gpt2.get_config("gpt2-medium")
    conf = train_config(micro=8, gas=2)
    batch = {"input_ids": np.random.RandomState(5).randint(
        0, cfg.vocab_size, (16, cfg.n_positions)).astype(np.int32)}
    steps = 4
    base = None
    for stage in range(4):
        eng, losses, step_s, step_comms, launches = zero_run(
            f"28b stage {stage}", gpt2.make_module(cfg), conf, batch, steps, stage)
        master = [t.detach().clone() for t in tree_leaves(eng.full_params())]
        plan = {k: v for k, v in eng.collective_plan().items() if v}
        want_flash = cfg.n_layer * eng.gradient_accumulation_steps * steps
        check(launches["flash_attention_fwd"] == want_flash == launches["flash_attention_bwd"],
              f"28b stage {stage}: flash launches {launches}, expected {want_flash} each")
        check(launches["fused_adamw"] == steps and launches["fused_lamb"] == 0,
              f"28b stage {stage}: fused optimizer launches {launches}")
        check(step_comms == plan, f"28b stage {stage}: collectives a step {step_comms}, the "
                                  f"stage's plan {plan}")
        check(all(np.isfinite(losses)), f"28b stage {stage}: losses {losses}")
        mem = eng.memory_breakdown()
        step_ms = statistics.median(step_s[2:]) * 1e3
        if base is None:
            base = (losses, master)
        else:
            check(losses == base[0], f"28b stage {stage}: losses {losses} != stage 0's {base[0]}")
            check(all(torch.equal(a, b) for a, b in zip(master, base[1])),
                  f"28b stage {stage}: the final master differs from stage 0's")
        print(f"stage {stage}: losses " + " ".join(f"{v:.6f}" for v in losses)
              + (" (stage 0's, bit for bit; the final master too)" if stage else "")
              + f"; flash launches {want_flash} each way (= {cfg.n_layer} x "
              f"{eng.gradient_accumulation_steps} x {steps}), fused AdamW {steps}; collectives a "
              f"step {step_comms} (the stage's plan); step ms (median of steps 3-4) "
              f"{step_ms:.2f}, steps " + " ".join(f"{v * 1e3:.1f}" for v in step_s)
              + f"; master {mem['param_bytes'] / 2**30:.3f} GiB, optimizer state "
              f"{mem['optimizer_state_bytes'] / 2**30:.3f} GiB, in use "
              f"{mem['bytes_in_use'] / 2**30:.2f} GiB, peak {mem['peak_bytes_in_use'] / 2**30:.2f}"
              f" GiB ({smi})")
        del eng, master
        gc.collect()
        torch.cuda.empty_cache()
    del base

    phase("28c", "bert-large LAMB (phase 15's run) at ZeRO stage 2 against stage 0, 3 steps")
    cfg15, module15, conf15, batch15 = workload("bert-large", optimizer="Lamb")
    runs = {}
    for stage in (0, 2):
        eng, losses, step_s, step_comms, launches = zero_run(
            f"28c stage {stage}", module15, conf15, batch15, 3, stage)
        check(launches["fused_lamb"] == 2 * 3 and launches["fused_adamw"] == 0,
              f"28c stage {stage}: LAMB launches {launches}, expected 2 x 3")
        plan = {k: v for k, v in eng.collective_plan().items() if v}
        check(step_comms == plan, f"28c stage {stage}: collectives {step_comms}, plan {plan}")
        runs[stage] = (losses, [t.detach().clone() for t in tree_leaves(eng.full_params())])
        print(f"stage {stage}: losses " + " ".join(f"{v:.6f}" for v in losses)
              + f"; LAMB launches 6 (= 2 x 3); collectives a step {step_comms}; step ms "
              f"(step 3) {step_s[2] * 1e3:.2f} ({smi})")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    check(runs[2][0] == runs[0][0] and all(torch.equal(a, b) for a, b in zip(runs[2][1],
                                                                             runs[0][1])),
          "28c: LAMB at stage 2 differs from stage 0")
    print("LAMB at stage 2 (its sharded leaves' norm partials all-reduced between the two "
          "launches) equals stage 0 bit for bit: losses and the final master")
    del runs, batch15

    phase("28d", "a resilient save at stage 3 loaded into a stage-0 engine: the next step bit "
                 "for bit (gpt2-medium width, 4 layers)")
    cfg_d = gpt2.get_config("gpt2-medium", n_layer=4)
    conf_d = dict(train_config(micro=4, gas=2),
                  resilience={"enabled": True, "async_checkpoint": False})
    batch_d = {"input_ids": np.random.RandomState(6).randint(
        0, cfg_d.vocab_size, (8, cfg_d.n_positions)).astype(np.int32)}
    with tempfile.TemporaryDirectory() as d:
        eng3, _, _, _, _ = zero_run("28d stage 3", gpt2.make_module(cfg_d), conf_d, batch_d, 3, 3)
        t0 = time.perf_counter()
        eng3.save_checkpoint(d, tag="z3")
        save_s = time.perf_counter() - t0
        want_loss = float(eng3.train_batch(batch_d)["loss"])
        want = [t.detach().clone() for t in tree_leaves(eng3.full_params())]
        del eng3
        c0 = dict(conf_d, mesh={"dp": -1}, zero_optimization={"stage": 0})
        eng0, *_ = dtt.initialize(model=gpt2.make_module(cfg_d), config=c0, seed=1)
        t0 = time.perf_counter()
        eng0.load_checkpoint(d, tag="z3")
        load_s = time.perf_counter() - t0
        got_loss = float(eng0.train_batch(batch_d)["loss"])
        got = tree_leaves(eng0.full_params())
        check(got_loss == want_loss and all(torch.equal(a, b) for a, b in zip(got, want)),
              f"28d: the stage-0 resume ({got_loss}) differs from the unbroken stage-3 run "
              f"({want_loss})")
        print(f"stage-3 tag (save {save_s:.2f} s, load {load_s:.2f} s) loaded at stage 0: the "
              f"next loss {got_loss:.6f} and the master equal the unbroken run's bit for bit")
        del eng0, got, want
    gc.collect()
    torch.cuda.empty_cache()
    comm.comms_logger.configure(enabled=False)
    comm.comms_logger.reset()
    comm.destroy_process_group()
    print(f"phase 28: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 29: tensor-parallel and disaggregated serving placements
# ---------------------------------------------------------------------------

# gpt2 (124M) serves phase 29: at tp 2 each rank holds 6 of its 12 heads
PHASE29_MODEL = "gpt2"
PHASE29_SECTIONS = {"bf16": FEATURES_SECTION, "int8": dict(FEATURES_SECTION, kv_cache_dtype="int8")}
PHASE29_PLACEMENTS = {"tp2": {"tp": 2}, "disaggregated": {"disaggregate": True}}


def phase29_traffic(srv, vocab):
    """3b/3c's traffic, shorter: 12 requests, 6 sharing a 256-token system
    prompt, 6 cold up to 384 tokens, budgets 16-48."""
    return shared_prefix_requests(srv, vocab, seed=2929, n_shared=6, n_cold=6, system_len=256,
                                  tails=(8, 96), cold_lens=(64, 384), budgets=(16, 48))


def phase29_serve(eng, section, vocab, comms=False):
    """One served run of ``section`` with margins, the paged kernels'
    counts at 0 just before and read just after → a JSON-able record.
    ``comms``: the comms logger on for the run, then each recorded op's
    latency measured at its size on its group (``measure``: on the device
    its tensors lay on, so a CUDA tensor handed to gloo is timed with its
    host staging, as the run paid it)."""
    from deepspeed_tpu_torch import comm

    srv = eng.serve(section, track_margins=True)
    reqs = phase29_traffic(srv, vocab)
    for k in (K_PAGED, K_PAGED8, K_MT, K_MT8):
        LAUNCHES[k] = 0
    if comms:
        comm.comms_logger.configure(enabled=True)
        comm.comms_logger.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: LAUNCHES[k] for k in (K_PAGED, K_PAGED8, K_MT, K_MT8)}
    log = {}
    if comms:
        comm.comms_logger.configure(enabled=False)
        comm.comms_logger.measure(groups={"tp": srv.decode_placement.group}, iters=20)
        log = {f"{op} {axis}": {"count": r["count"], "bytes": r["bytes"], "ms": r["time_ms"]}
               for (op, axis), r in sorted(comm.comms_logger.comms_dict.items())}
        comm.comms_logger.reset()
    st = srv.stats()
    ex = exact_percentiles(srv.completed)
    rec = {
        "done": len(done),
        "requests": [{"tokens": list(map(int, r.tokens)), "margins": [float(m) for m in r.margins],
                      "status": r.status, "budget": int(b)} for r, b in reqs],
        "launches": launches, "wall_s": wall, "comms": log,
        "names": [p.name for p in srv.executables], "expected": srv.expected_executables,
        "captures": [p.captures for p in srv.executables],
        "replays": sum(p.replays for p in srv.executables),
        "pool_bytes": {ps.placement.name: sum(t.numel() * t.element_size() for t in ps.pools())
                       for ps in (srv.decode_set, srv.prefill_set)},
        "tpot_p50_s": ex["tpot"]["p50_s"], "ttft_p50_s": ex["ttft"]["p50_s"],
        "stats": {k: st.get(k) for k in ("placement", "decode_steps", "spec_steps",
                                         "chunk_prefills", "kv_handoffs", "kv_handoff_bytes",
                                         "kv_handoff_latency_mean_s", "decode_tokens_per_s")},
    }
    srv.drain()
    srv.release_prefix_cache()
    srv.check_no_leaks()
    del srv
    return rec


def phase29_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One of phase 29b's ranks (``chip_smoke.py --phase29-rank``): a gloo
    process group on the card it shares with the other rank, gpt2 bf16
    from seed 0, every placement of :data:`PHASE29_PLACEMENTS` at bf16 and
    int8 pages; the records to ``out_dir/rank{rank}.json``."""
    from deepspeed_tpu_torch import comm

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # two ranks share the host's cores: one intra-op thread each (the card
    # does the compute), so neither spins on the other's cores
    torch.set_num_threads(1)
    comm.init_distributed(dist_backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                          rank=rank, world_size=world, verbose=False)
    cfg = gpt2.get_config(PHASE29_MODEL)
    eng = dtt.init_inference(cfg, dtype=torch.bfloat16, seed=0)
    out = {}
    for plc_name, plc in PHASE29_PLACEMENTS.items():
        for kv, section in PHASE29_SECTIONS.items():
            out[f"{plc_name} {kv}"] = phase29_serve(eng, dict(section, placement=plc),
                                                    cfg.vocab_size, comms=True)
            gc.collect()
            torch.cuda.empty_cache()
    comm.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def as_requests(rec):
    return [types.SimpleNamespace(tokens=r["tokens"], margins=r["margins"])
            for r in rec["requests"]]


def placement_phase(smi):
    """Phase 29: (a) gpt2 bf16 at world 1 over NCCL, the default engine
    against an explicit ``placement: {tp: 1}``; (b) two processes sharing
    the card over gloo, at tp 2 and disaggregated, against (a)."""
    from deepspeed_tpu_torch import comm

    t_phase = time.perf_counter()
    phase("29a", "gpt2 bf16 at world 1 over NCCL: the default engine against an explicit "
                 "placement {tp: 1}, all features, bf16 and int8 pages")
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(free_port()))
    comm.init_distributed(dist_backend="nccl", verbose=False)
    check(torch.distributed.get_backend() == "nccl" and comm.get_world_size() == 1,
          "29a: the process group is not NCCL at world 1")
    cfg = gpt2.get_config(PHASE29_MODEL)
    L, spec_k = cfg.n_layer, FEATURES_SECTION["speculative"]["k"]
    eng = dtt.init_inference(cfg, dtype=torch.bfloat16, seed=0)
    ref = {kv: phase29_serve(eng, section, cfg.vocab_size)
           for kv, section in PHASE29_SECTIONS.items()}
    tp1 = phase29_serve(eng, dict(PHASE29_SECTIONS["int8"], placement={"tp": 1}), cfg.vocab_size)
    want = ref["int8"]
    for key in ("names", "launches", "replays", "expected", "captures"):
        check(tp1[key] == want[key], f"29a: {key} {tp1[key]} != the default engine's {want[key]}")
    check([r["tokens"] for r in tp1["requests"]] == [r["tokens"] for r in want["requests"]],
          "29a: the explicit tp-1 placement's streams differ from the default engine's")
    for kv, rec in ref.items():
        for r in rec["requests"]:
            check(r["status"] == RequestStatus.FINISHED and len(r["tokens"]) == r["budget"],
                  f"29a {kv}: a request {r['status']} with {len(r['tokens'])} tokens")
        st = rec["stats"]
        ld = rec["launches"][K_PAGED8 if kv == "int8" else K_PAGED]
        lm = rec["launches"][K_MT8 if kv == "int8" else K_MT]
        check(ld == L * (spec_k + 1) * st["spec_steps"] and lm == L * st["chunk_prefills"]
              and rec["replays"] > 0, f"29a {kv}: launches {rec['launches']}, {st}")
        print(f"29a {kv} pages: {rec['done']} requests, programs {rec['names']} (captured, "
              f"{rec['replays']} replays), decode launches {ld} (= {L} x {spec_k + 1} x "
              f"{st['spec_steps']}), multitoken {lm} (= {L} x {st['chunk_prefills']}); TPOT p50 "
              f"{rec['tpot_p50_s'] * 1e3:.3f} ms, TTFT p50 {rec['ttft_p50_s'] * 1e3:.2f} ms "
              f"(exact), wall {rec['wall_s']:.3f} s ({smi})")
    print(f"29a: placement {{tp: 1}} = the default engine: streams, program names, launches "
          f"{tp1['launches']}, captured replays {tp1['replays']}; stats()['placement'] "
          f"{json.dumps(tp1['stats']['placement'])}")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    comm.destroy_process_group()

    phase("29b", "two processes sharing the card over gloo (NCCL refuses two ranks on one "
                 "card): gpt2 bf16 at tp 2 (6 local heads) and disaggregated at tp 1, bf16 and "
                 "int8 pages, against 29a")
    with tempfile.TemporaryDirectory() as d:
        port = free_port()
        logs = [open(os.path.join(d, f"log{r}.txt"), "w") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase29-rank",
                                   str(r), "2", str(port), d], stdout=logs[r], stderr=logs[r])
                 for r in range(2)]
        try:
            for p in procs:
                p.wait(timeout=300)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                print(open(os.path.join(d, f"log{r}.txt")).read()[-6000:])
            check(p.returncode == 0, f"29b: rank {r} exited {p.returncode}")
        got = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(2)]
    ref_pool = {kv: ref[kv]["pool_bytes"]["shared"] for kv in ref}
    for key in got[0]:
        plc_name, kv = key.split()
        a, b = got
        check([r["tokens"] for r in a[key]["requests"]] == [r["tokens"] for r in b[key]["requests"]],
              f"29b {key}: the ranks' streams differ")
        for r in a[key]["requests"]:
            check(r["status"] == RequestStatus.FINISHED and len(r["tokens"]) == r["budget"],
                  f"29b {key}: a request {r['status']} with {len(r['tokens'])} tokens")
        # tp 2 sums each row-parallel product in another order: bf16 ties
        # may flip. Disaggregation runs 29a's programs on another rank, so
        # its streams are 29a's bit for bit: no tie is excused
        ties = compare_streams(f"29b {key} against 29a", as_requests(ref[kv]), as_requests(a[key]),
                               BF16_TIE_MARGIN if plc_name == "tp2" else TIE_MARGIN)
        check(plc_name == "tp2" or ties == 0,
              f"29b {key}: {ties} streams differ from 29a's, which they equal bit for bit")
        kd, km = (K_PAGED8, K_MT8) if kv == "int8" else (K_PAGED, K_MT)
        st = a[key]["stats"]
        steps, chunks = st["spec_steps"], st["chunk_prefills"]
        if plc_name == "tp2":
            for r, rec in enumerate(got):
                check(rec[key]["pool_bytes"]["shared"] * 2 == ref_pool[kv],
                      f"29b {key} rank {r}: pool bytes {rec[key]['pool_bytes']} against 29a's "
                      f"{ref_pool[kv]}")
                check(rec[key]["launches"][kd] == L * (spec_k + 1) * steps
                      and rec[key]["launches"][km] == L * chunks,
                      f"29b {key} rank {r}: launches {rec[key]['launches']}")
                check(not any(rec[key]["captures"]), f"29b {key}: a gloo tp program captured")
        else:
            dec, pre = got[0][key]["launches"], got[1][key]["launches"]
            check(dec[kd] == L * (spec_k + 1) * steps and dec[km] == 0
                  and pre[km] == L * chunks and pre[kd] == 0,
                  f"29b {key}: decode rank launches {dec}, prefill rank {pre}")
            check(st["kv_handoffs"] == len(a[key]["requests"]) and st["kv_handoff_bytes"] > 0,
                  f"29b {key}: handoffs {st}")
            check(all(all(rec[key]["captures"]) for rec in got)
                  and all(rec[key]["replays"] > 0 for rec in got),
                  f"29b {key}: tp-1 placements' programs not captured")
        print(f"29b {key}: {len(a[key]['requests'])} requests on 2 ranks, streams equal across "
              f"ranks, {ties} ties against 29a; programs {a[key]['names']} (captured "
              f"{a[key]['captures']})")
        for r, rec in enumerate(got):
            x = rec[key]
            print(f"  rank {r}: paged kernel launches {x['launches']}, pool bytes "
                  f"{x['pool_bytes']} (29a's {ref_pool[kv]}), TPOT p50 {x['tpot_p50_s'] * 1e3:.3f}"
                  f" ms, TTFT p50 {x['ttft_p50_s'] * 1e3:.2f} ms (exact), decode steps "
                  f"{x['stats']['decode_steps']}, wall {x['wall_s']:.3f} s ({smi})")
        print("  collectives of the run on rank 0 (op axis: calls, bytes, measured ms a call "
              "on the recorded tensors' device): " + ", ".join(
                  f"{k}: {v['count']}, {v['bytes']}, "
                  + (f"{v['ms']:.4f}" if v["ms"] is not None else "not measured")
                  for k, v in a[key]["comms"].items()))
        if plc_name == "disaggregated":
            print(f"  handoffs {st['kv_handoffs']}, {st['kv_handoff_bytes']} bytes (logical), "
                  f"mean {st['kv_handoff_latency_mean_s'] * 1e3:.3f} ms a handoff ({smi})")
    print(f"phase 29: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 29c: the fleet over placements
# ---------------------------------------------------------------------------

# 2 replicas x placement {tp: 2} of gpt2 (124M) at fp32 (a tp-2 all-reduce
# sums in another order; fp32 keeps greedy streams clear of bf16 ties)
PHASE29C_SECTION = {"max_slots": 4, "page_size": 16, "num_pages": 128, "max_prompt_len": 128,
                    "max_new_tokens": 32}
PHASE29C_FLEET = {"fleet": {"enabled": True, "replicas": 2}, "placement": {"tp": 2}}
PHASE29C_STEPS = 4  # rounds before replica r0 is preempted


def phase29c_requests(vocab):
    """8 requests, prompts of 16-112 tokens, 24 new tokens each."""
    rs = np.random.RandomState(2929)
    return [(rs.randint(0, vocab, (n,)).astype(np.int32), 24)
            for n in (16, 40, 64, 112, 24, 88, 56, 32)]


def phase29c_rank(rank: int, world: int, port: int, out_dir: str) -> None:
    """One of phase 29c's four ranks (``chip_smoke.py --phase29c-rank``): a
    gloo process group on the shared card, gpt2 fp32 from seed 0, a
    ``FleetRouter`` of two tp-2 replicas (windows ranks [0, 2) and [2, 4))
    under a ``ReplayClock``; the requests, ``PHASE29C_STEPS`` rounds, r0
    preempted (its live sessions migrate to r1, each timed), rounds to the
    end; the record to ``out_dir/rank{rank}.json``."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.serving import FleetRouter, ReplayClock

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    comm.init_distributed(dist_backend="gloo", init_method=f"tcp://127.0.0.1:{port}",
                          rank=rank, world_size=world, verbose=False)
    cfg = gpt2.get_config(PHASE29_MODEL)
    eng = dtt.init_inference(cfg, dtype=torch.float32, seed=0)
    clock = ReplayClock()
    fleet = FleetRouter(eng, dict(PHASE29C_SECTION, **PHASE29C_FLEET), clock=clock)
    mig_ms = []
    migrate = fleet._migrate_session

    def timed_migration(*a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = migrate(*a)
        torch.cuda.synchronize()
        mig_ms.append((time.perf_counter() - t0) * 1e3)
        return ok

    fleet._migrate_session = timed_migration
    reqs = phase29c_requests(cfg.vocab_size)
    for k in (K_PAGED, K_MT):
        LAUNCHES[k] = 0
    t0 = time.perf_counter()
    subs = [fleet.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
    for _ in range(PHASE29C_STEPS):
        fleet.step()
        clock.advance(0.01)
    live = sum(1 for s in fleet.replica("r0").srv.slots
               if s.request is not None and not s.prefilling and s.request.tokens)
    fleet.preempt("r0")
    while not (fleet._idle() and not fleet._pending_preemption()):
        fleet.step()
        clock.advance(0.01)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = fleet.stats()["fleet"]
    out = {"tokens": [list(map(int, r.tokens)) for r in subs],
           "status": [r.status for r in subs], "replicas": [r.replica for r in subs],
           "live_at_preempt": live, "migration_ms": mig_ms, "wall_s": wall,
           "launches": {k: LAUNCHES[k] for k in (K_PAGED, K_MT)},
           "windows": [r.srv.decode_placement.ranks for r in fleet.replicas],
           "heads": [int(r.srv.k_pool.shape[2]) for r in fleet.replicas],
           "fleet": {k: st[k] for k in ("migrations_ok", "migrations_crc_failed",
                                        "migrations_no_capacity", "migration_bytes", "requeues")}}
    fleet.drain()
    fleet.check_no_leaks()
    fleet.close()
    comm.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def fleet_placement_phase(smi):
    """Phase 29c: the single-engine reference on the card (gpt2 fp32, no
    placement), then four processes sharing the card over gloo run the
    fleet of two tp-2 replicas with r0's live sessions migrated to r1:
    every rank's streams token-identical to the reference with 0 ties."""
    t_phase = time.perf_counter()
    cfg = gpt2.get_config(PHASE29_MODEL)
    eng = dtt.init_inference(cfg, dtype=torch.float32, seed=0)
    srv = eng.serve(dict(PHASE29C_SECTION), track_margins=True)
    reqs = phase29c_requests(cfg.vocab_size)
    ref = [srv.submit(p, max_new_tokens=n, seed=i) for i, (p, n) in enumerate(reqs)]
    srv.run()
    srv.drain()
    srv.check_no_leaks()
    del srv, eng
    gc.collect()
    torch.cuda.empty_cache()
    world = 4
    with tempfile.TemporaryDirectory() as d:
        port = free_port()
        logs = [open(os.path.join(d, f"log{r}.txt"), "w") for r in range(world)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase29c-rank",
                                   str(r), str(world), str(port), d], stdout=logs[r],
                                  stderr=logs[r]) for r in range(world)]
        try:
            for p in procs:
                p.wait(timeout=300)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                print(open(os.path.join(d, f"log{r}.txt")).read()[-6000:])
            check(p.returncode == 0, f"29c: rank {r} exited {p.returncode}")
        got = [json.load(open(os.path.join(d, f"rank{r}.json"))) for r in range(world)]
    ref_tokens = [list(map(int, r.tokens)) for r in ref]
    for r, rec in enumerate(got):
        check(rec["windows"] == [[0, 1], [2, 3]], f"29c rank {r}: windows {rec['windows']}")
        check(rec["heads"] == [6 if i == r // 2 else 0 for i in range(2)],
              f"29c rank {r}: pool heads {rec['heads']}")
        check(rec["live_at_preempt"] >= 1 and rec["fleet"]["migrations_ok"] >= 1
              and rec["fleet"]["migrations_crc_failed"] == 0,
              f"29c rank {r}: live {rec['live_at_preempt']}, {rec['fleet']}")
        check(all(s == RequestStatus.FINISHED for s in rec["status"]),
              f"29c rank {r}: statuses {rec['status']}")
        check(rec["launches"][K_PAGED] > 0, f"29c rank {r}: paged decode launches "
                                            f"{rec['launches']}")
        diff = [i for i, (a, b) in enumerate(zip(ref_tokens, rec["tokens"])) if a != b]
        check(not diff, f"29c rank {r}: streams {diff} differ from the single engine's (0 ties "
                        "allowed)")
    a = got[0]
    print(f"29c: 4 ranks, windows {a['windows']} (6 of 12 KV heads a rank), {len(reqs)} "
          f"requests routed to r0 by affinity, {a['live_at_preempt']} live at r0's preemption; "
          f"migrations ok {a['fleet']['migrations_ok']}, bytes {a['fleet']['migration_bytes']}, "
          f"requeues {a['fleet']['requeues']}; every rank's streams token-identical to the "
          f"single engine's, 0 ties; replicas {a['replicas']}")
    for r, rec in enumerate(got):
        ms = rec["migration_ms"]
        print(f"  rank {r}: paged decode launches {rec['launches'][K_PAGED]}, migration ms "
              f"{', '.join(f'{x:.2f}' for x in ms)} (mean {statistics.mean(ms):.2f}), fleet wall "
              f"{rec['wall_s']:.3f} s ({smi})")
    print(f"phase 29c: {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 30: the decoder family at full width
# ---------------------------------------------------------------------------

# Mistral-7B v0.1's published config.json: vocab 32000, hidden 4096, 32
# heads, 8 KV heads, intermediate 14336 (SwiGLU), RMSNorm eps 1e-5, rope
# theta 10000, sliding window 4096, untied head; 32 layers
MISTRAL_7B = dict(vocab_size=32000, n_positions=32768, n_embd=4096, n_layer=32, n_head=32,
                  ffn_dim=14336, layer_norm_epsilon=1e-5, pos_emb="rope", rope_style="neox",
                  rope_theta=10000.0, norm="rmsnorm", mlp_type="swiglu", n_kv_head=8,
                  tie_embeddings=False)
PHASE30_LAYERS = 32
PHASE30_WINDOW = 4096
PHASE30_SEQ = 8192  # the full-sequence forward: the window bites
PHASE30_PROMPT, PHASE30_NEW = 512, 32


def mistral_params(cfg, seed=0, dtype=torch.bfloat16):
    """Random weights of ``cfg`` drawn on the card from a seeded
    ``torch.Generator`` in ``dtype``: normal(0, 0.02) matrices, unit norm
    scales."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    L, E, F_, KVD = cfg.n_layer, cfg.n_embd, cfg.ffn_dim, cfg.kv_heads * cfg.head_dim

    def nrm(*shape):
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype).mul_(0.02)

    def ones(*shape):
        return torch.ones(shape, device="cuda", dtype=dtype)

    return {"wte": nrm(cfg.vocab_size, E), "lm_head_w": nrm(E, cfg.vocab_size),
            "ln_f": {"scale": ones(E)},
            "blocks": {"ln_1": {"scale": ones(L, E)}, "ln_2": {"scale": ones(L, E)},
                       "attn": {"wq": nrm(L, E, E), "wk": nrm(L, E, KVD), "wv": nrm(L, E, KVD),
                                "wo": nrm(L, E, E)},
                       "mlp": {"fc_gate_w": nrm(L, E, F_), "fc_in_w": nrm(L, E, F_),
                               "fc_out_w": nrm(L, F_, E)}}}


def phase30_flash(window):
    """Row 1 at phase 30's forward shape (B1 S8192 H32 KV8 D128 bf16, the
    window): the kernel against its plain version, timed beside the plain
    version, SDPA with the band as a mask and the bound. The plain version
    runs a KV group (4 query heads) at a time, which bounds its [S, S]
    scores' memory: the same function, 8 calls."""
    q, k, v, _ = flash_case(1, PHASE30_SEQ, 32, 8, 128, torch.bfloat16, seed=300)
    o, lse = fa.flash_attention_fwd(q, k, v, True, None, window)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(o).all()), "30: flash output not finite")
    err, scaled, rep = 0.0, 0.0, 4
    for g in range(8):
        o_r, lse_r = fa.flash_attention_fwd_ref(q[:, :, g * rep:(g + 1) * rep], k[:, :, g:g + 1],
                                                v[:, :, g:g + 1], True, None, window)
        got = o[:, :, g * rep:(g + 1) * rep]
        err = max(err, float((got.float() - o_r.float()).abs().max()),
                  float((lse[:, g * rep:(g + 1) * rep] - lse_r).abs().max()))
        scaled = max(scaled, scaled_error(got, o_r))
        del o_r, lse_r
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    i = torch.arange(PHASE30_SEQ, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    ms, _ = time_ms(lambda _: fa.flash_attention_fwd(q, k, v, True, None, window), 20, warmup=3)

    def plain(_):  # the plain version over the 8 KV groups, one after another
        for g in range(8):
            fa.flash_attention_fwd_ref(q[:, :, g * rep:(g + 1) * rep], k[:, :, g:g + 1],
                                       v[:, :, g:g + 1], True, None, window)

    plain_ms, _ = time_ms(plain, 2, warmup=1)
    lib_ms, _ = time_ms(lambda _: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band,
                                                                 enable_gqa=True), 5, warmup=2)
    bnd, by = flash_bound(q, k, True, window, backward=False)
    del q, k, v, o, lse, qt, kt, vt, band
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, scaled=scaled, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bnd, bound_by=by)


def phase30_decode():
    """Row 6 at phase 30's decode shape (B1, a 544-row cache, H32 KV8 D128
    bf16, a layer's slice of a 32-layer cache): the kernel against its
    plain version at the first and last decode positions, timed over the
    layers at pos 543 beside the plain version, SDPA and the bound."""
    S = PHASE30_PROMPT + PHASE30_NEW
    L = PHASE30_LAYERS
    q, k, v = decode_case(1, S, 32, 8, 128, torch.bfloat16, layers=L, seed=301)
    errs = [decode_error(q, k[0], v[0], p) for p in (PHASE30_PROMPT, S - 1)]
    err, rel = max(e for e, _ in errs), max(r for _, r in errs)
    pos = S - 1
    dpos = device_pos(pos)
    ms, _ = time_ms(lambda i: tda.decode_attention(q, k[i % L], v[i % L], dpos), 320)
    plain_ms, _ = time_ms(lambda i: tda.decode_attention_ref(q, k[i % L], v[i % L], pos), 32)
    lib_ms, _ = time_ms(lambda i: library_decode(q, k[i % L], v[i % L], pos), 64)
    bnd, by = decode_bound(q, k[0], pos)
    del q, k, v
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, scaled=rel, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bnd, bound_by=by)


def phase30_llama_injection(smi):
    """A tiny random LLaMA (GQA, 2 layers, D64) from its transformers
    config class, injected on the card at fp32 through
    ``init_inference(model=...)``: logits within 5e-3 of HF's on the CPU
    (the plain route) and HF's greedy stream."""
    try:
        import transformers
    except ImportError as e:
        print(f"30: the HF injection step did not run: transformers does not import here ({e})")
        return
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        hidden_size=256, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=512, vocab_size=512, max_position_embeddings=256,
        tie_word_embeddings=False)).eval()
    eng = dtt.init_inference(model=hf, dtype=torch.float32)
    ids = np.random.RandomState(30).randint(0, 512, (1, 48))
    with torch.no_grad():
        ref = hf(torch.tensor(ids)).logits.numpy()
        ref_gen = hf.generate(torch.tensor(ids), max_new_tokens=8, do_sample=False,
                              pad_token_id=0).numpy()
    reset(fa.KERNELS + tda.KERNELS)
    got = eng({"input_ids": ids}).cpu().numpy()
    gen = eng.generate(ids, max_new_tokens=8)
    lc = counts(fa.KERNELS + tda.KERNELS)
    err = float(np.abs(got - ref).max())
    check(err < 5e-3, f"30: injected LLaMA logits {err} from HF's")
    check(np.array_equal(gen, ref_gen), "30: injected LLaMA's greedy stream differs from HF's")
    check(lc["flash_attention_fwd"] > 0 and lc["decode_attention"] > 0,
          f"30: injected LLaMA launches {lc}")
    print(f"30: HF LlamaForCausalLM (transformers {transformers.__version__}) injected on the card "
          f"at fp32: logits max abs err {err:.3e} against HF on the CPU (tolerance 5e-3), greedy "
          f"stream equal to HF's; launches {lc} ({smi})")


def decoder_phase(smi):
    """Phase 30: rows 1 and 6 against their plain versions at the
    Mistral-7B shapes; then the decoder at Mistral-7B v0.1's width through
    ``init_inference(DecoderConfig, params)``: a full-sequence forward at
    B1 S8192 (the flash kernel with the 4096 window biting, GQA 32/8) and
    greedy ``generate`` of 32 tokens from a 512-token prompt (the decode
    kernel at H32 KV8 D128), the kernels' counts at 0 just before each and
    read just after; the HF injection step when transformers imports."""
    from deepspeed_tpu_torch.models import decoder

    t_phase = time.perf_counter()
    flash30 = phase30_flash(PHASE30_WINDOW)
    check(flash30["max_abs_err"] <= FLASH_TOL[torch.bfloat16]
          and flash30["scaled"] <= FLASH_REL_TOL[torch.bfloat16],
          f"30: flash against its plain version {flash30}")
    dec30 = phase30_decode()
    check(dec30["max_abs_err"] <= TOL[torch.bfloat16] and dec30["scaled"] <= REL_TOL[torch.bfloat16],
          f"30: decode kernel against its plain version {dec30}")
    for name, r in (("flash_attention_fwd B1 S8192 H32 KV8 D128 window 4096", flash30),
                    ("decode_attention B1 S544 pos 543 H32 KV8 D128", dec30)):
        print(f"30 {name} bf16: max abs err {r['max_abs_err']:.3e}; device ms per call: kernel "
              f"{r['ms']:.4f}, plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']}), kernel at {r['bound_ms'] / r['ms']:.3f} "
              f"of bound ({smi})")
    cfg = decoder.DecoderConfig(**dict(MISTRAL_7B, n_layer=PHASE30_LAYERS,
                                       local_windows=(PHASE30_WINDOW,) * PHASE30_LAYERS))
    params = mistral_params(cfg)
    nparams = sum(t.numel() for t in tree_leaves(params))
    eng = dtt.init_inference(cfg, params=params, dtype=torch.bfloat16)
    print(f"30: the Mistral-7B v0.1 shape at {cfg.n_layer} of its 32 layers, {nparams / 1e9:.3f}B "
          f"parameters, bf16 weights drawn on the card from seed 0")
    rs = np.random.RandomState(30)
    ids = rs.randint(0, cfg.vocab_size, (1, PHASE30_SEQ))
    reset(fa.KERNELS + tda.KERNELS)
    fwd_times = []
    for _ in range(3):  # eager, capture, replay
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = eng({"input_ids": ids})
        torch.cuda.synchronize()
        fwd_times.append((time.perf_counter() - t0) * 1e3)
    fwd_launches = counts(fa.KERNELS)["flash_attention_fwd"]
    check(tuple(logits.shape) == (1, PHASE30_SEQ, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()), "30: forward logits shape or values")
    check(fwd_launches == 3 * cfg.n_layer, f"30: flash launches {fwd_launches} for 3 forwards")
    del logits
    torch.cuda.empty_cache()
    prompt = ids[:, :PHASE30_PROMPT]
    reset(fa.KERNELS + tda.KERNELS)
    gen_times = []
    for _ in range(3):  # eager, captured, replayed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(prompt, max_new_tokens=PHASE30_NEW)
        gen_times.append(time.perf_counter() - t0)
    gen30 = counts(tda.KERNELS)["decode_attention"]
    check(gen30 == 3 * (PHASE30_NEW - 1) * cfg.n_layer
          and counts(fa.KERNELS)["flash_attention_fwd"] == 0,
          f"30: generate launches decode {gen30}, flash {counts(fa.KERNELS)}")
    new = out[:, PHASE30_PROMPT:]
    check(out.shape == (1, PHASE30_PROMPT + PHASE30_NEW) and (new >= 0).all()
          and (new < cfg.vocab_size).all(), "30: generated tokens")
    # the prompt's last logits two ways: the forward's flash route (the
    # window inert at 512) and generate's prefill (the plain route): the
    # first token agrees unless the top-2 margin is a bf16 tie
    last = eng({"input_ids": prompt})[0, -1].float()
    top2 = torch.topk(last, 2).values
    margin = float(top2[0] - top2[1])
    check(int(last.argmax()) == int(new[0, 0]) or margin < BF16_TIE_MARGIN,
          f"30: the forward's next token {int(last.argmax())} != generate's {int(new[0, 0])} "
          f"(margin {margin})")
    fwd_ms = statistics.mean(fwd_times[2:])
    print(f"30: forward B1 S{PHASE30_SEQ} (flash, window {PHASE30_WINDOW} biting, GQA 32/8): "
          f"ms {', '.join(f'{t:.1f}' for t in fwd_times)} (eager, capture, replay), "
          f"{PHASE30_SEQ / fwd_ms * 1e3:.0f} tokens/s on the replay; flash launches "
          f"{fwd_launches} (= 3 x {cfg.n_layer}) ({smi})")
    print(f"30: generate {PHASE30_NEW} tokens from a {PHASE30_PROMPT}-token prompt: "
          f"{', '.join(f'{t:.3f}' for t in gen_times)} s (eager, capture, replay), "
          f"{PHASE30_NEW / gen_times[-1]:.1f} tokens/s replayed (prefill included), decode "
          f"launches {gen30} (= 3 x {PHASE30_NEW - 1} x {cfg.n_layer}); the forward's next "
          f"token {'equals' if int(last.argmax()) == int(new[0, 0]) else 'ties'} generate's "
          f"(margin {margin:.3f}) ({smi})")
    del eng, params, out, last
    gc.collect()
    torch.cuda.empty_cache()
    phase30_llama_injection(smi)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 30: {time.perf_counter() - t_phase:.1f} s")
    return (dict(flash30, launches=fwd_launches), dict(dec30, launches=gen30))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; the port's smoke run needs the card",
              file=sys.stderr)
        return 1
    t_script = time.perf_counter()

    phase(0, "card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    phase(1, "build")
    built = op_builder.build()
    for name, secs in built.items():
        log = op_builder.BUILD_LOG.get(name, {}).get("log", "")
        regs = [int(w.split()[w.split().index("Used") + 1])
                for w in log.splitlines() if "Used" in w and "registers" in w]
        spills = [int(ln.split("bytes spill stores")[0].split(",")[-1])
                  for ln in log.splitlines() if "spill stores" in ln]
        print(f"built {name}: {secs:.2f} s"
              + (f", {len(regs)} kernels, registers {min(regs)}..{max(regs)}, spill stores "
                 f"in {sum(1 for b in spills if b)} (max {max(spills, default=0)} bytes)"
                 if regs else " (cached)"))
    print(f"build total (parallel): {max(built.values()):.2f} s")

    phase(2, "kernels against their plain versions")
    # the serving main path's shape: 8 slots, gpt2-medium heads, page 16,
    # 512-page bf16 pools, 12 pages a slot (128 prompt + 64 new tokens);
    # ragged pos with page-boundary values, two inactive slots on scratch.
    # 24 layers of pools, as the decode step has, so the timed loop walks
    # 24 distinct layers' pages (the live K/V of all of them exceeds L2)
    L = 24
    main_pos = [0, 15, 16, 17, 100, 191, 0, 0]
    q, k, v, bt, pos = make_case(8, 16, 16, 64, 16, 512, 12, main_pos, torch.bfloat16,
                                 inactive=(6, 7), layers=L, seed=1)
    errs = {}
    errs["main bf16 B8 H16 D64 page16"] = kernel_error(*DECODE, q, k[0], v[0], bt, pos)
    cases = [
        ("fp32 pool", dict(B=8, H=16, KV=16, D=64, page=16, P=128, n=12, pos=main_pos,
                           dtype=torch.float32, inactive=(6, 7))),
        ("GQA H16 KV8 fp32", dict(B=4, H=16, KV=8, D=64, page=16, P=64, n=8,
                                  pos=[3, 40, 127, 64], dtype=torch.float32)),
        ("D128 bf16", dict(B=4, H=8, KV=8, D=128, page=16, P=64, n=8,
                           pos=[0, 31, 32, 100], dtype=torch.bfloat16)),
        ("D256 fp16 page64", dict(B=3, H=4, KV=2, D=256, page=64, P=16, n=4,
                                  pos=[63, 64, 255], dtype=torch.float16)),
        ("page8 fp32 long + pos past table", dict(B=2, H=4, KV=4, D=64, page=8, P=160,
                                                   n=64, pos=[511, 1000], dtype=torch.float32)),
        # gpt2's 12 heads at tp 2: each rank's 6 local heads (phase 29b)
        ("H6 bf16 (gpt2 at tp 2)", dict(B=8, H=6, KV=6, D=64, page=16, P=128, n=12,
                                        pos=main_pos, dtype=torch.bfloat16, inactive=(6, 7))),
    ]
    for label, c in cases:
        dtype = c["dtype"]
        cq, ck, cv, cbt, cpos = make_case(**c, seed=2)
        errs[label] = kernel_error(*DECODE, cq, ck[0], cv[0], cbt, cpos)
        check(errs[label] <= TOL[dtype], f"{label}: max abs err {errs[label]} > {TOL[dtype]}")
    check(errs["main bf16 B8 H16 D64 page16"] <= TOL[torch.bfloat16],
          f"main shape: max abs err {errs['main bf16 B8 H16 D64 page16']}")
    for label, e in errs.items():
        print(f"paged_decode_attention {label}: max abs err {e:.3e}")
    lib_err = float((library_attention(q, k[0], v[0], bt, pos).float()
                     - pda.paged_decode_attention_ref(q.float(), k[0].float(), v[0].float(), bt, pos)
                     ).abs().max())
    check(lib_err <= TOL[torch.bfloat16], f"library yardstick disagrees: {lib_err}")

    ms, call_ms = time_ms(lambda i: pda.paged_decode_attention(q, k[i % L], v[i % L], bt, pos), 480)
    plain_ms, plain_call_ms = time_ms(
        lambda i: pda.paged_decode_attention_ref(q, k[i % L], v[i % L], bt, pos), 32)
    lib_ms, lib_call_ms = time_ms(lambda i: library_attention(q, k[i % L], v[i % L], bt, pos), 32)
    bound_ms, bound_by = bound(q, k[0], bt, pos)
    print(f"paged_decode_attention main shape, device ms per call: kernel {ms:.4f}, "
          f"plain {plain_ms:.4f}, library {lib_ms:.4f}, bound {bound_ms:.5f} ({bound_by}), "
          f"kernel at {bound_ms / ms:.3f} of bound")
    print(f"  per call with the host's launch path in the loop: kernel {call_ms:.4f} ms, "
          f"plain {plain_call_ms:.4f} ms, library {lib_call_ms:.4f} ms")
    del k, v

    # the chunk program's shape on phase 3b's path: one slot, a 64-token
    # chunk, gpt2-medium heads, page 16, 512-page bf16 pools, the table of
    # a 512 + 64-token reservation (36 pages); the chunks of a 512-token
    # prompt start at 0, 64, ..., 448. 24 layers of pools, as the chunk
    # program has.
    mt_bases = [0, 64, 256, 448]
    mq, mk, mv, mbt, _ = make_case(1, 16, 16, 64, 16, 512, 36, [0], torch.bfloat16,
                                   layers=L, seed=3, T=64)
    mbase = [torch.tensor([b0], dtype=torch.int32, device="cuda") for b0 in mt_bases]
    mt_errs = {}
    for b0, bb in zip(mt_bases, mbase):
        mt_errs[f"main bf16 B1 T64 H16 D64 page16 base {b0}"] = kernel_error(
            *MULTITOKEN, mq, mk[0], mv[0], mbt, bb)
    mt_main_err = max(mt_errs.values())
    check(mt_main_err <= TOL[torch.bfloat16], f"multitoken main shape: max abs err {mt_main_err}")
    mt_cases = [
        ("ragged B4 T5 bf16, one slot on scratch", dict(
            B=4, T=5, H=16, KV=16, D=64, page=16, P=64, n=6, pos=[14, 30, 47, 0],
            dtype=torch.bfloat16, inactive=(3,))),
        ("GQA H16 KV8 fp32", dict(B=2, T=16, H=16, KV=8, D=64, page=16, P=64, n=8,
                                  pos=[5, 40], dtype=torch.float32)),
        ("D128 bf16", dict(B=2, T=16, H=8, KV=8, D=128, page=16, P=64, n=8,
                           pos=[0, 33], dtype=torch.bfloat16)),
        ("ragged T37 fp16 page8", dict(B=2, T=37, H=16, KV=16, D=64, page=8, P=64, n=24,
                                       pos=[0, 100], dtype=torch.float16)),
        ("D256 fp32 page64", dict(B=2, T=9, H=4, KV=2, D=256, page=64, P=16, n=4,
                                  pos=[60, 130], dtype=torch.float32)),
        ("H6 bf16 T64 (gpt2 at tp 2)", dict(B=1, T=64, H=6, KV=6, D=64, page=16, P=128,
                                            n=36, pos=[64], dtype=torch.bfloat16)),
    ]
    for label, c in mt_cases:
        cq, ck, cv, cbt, cbase = make_case(**c, seed=4)
        mt_errs[label] = kernel_error(*MULTITOKEN, cq, ck[0], cv[0], cbt, cbase)
        check(mt_errs[label] <= TOL[c["dtype"]],
              f"multitoken {label}: max abs err {mt_errs[label]} > {TOL[c['dtype']]}")
    # T = 1: the multi-token kernel against the decode kernel, fp32 and bf16
    for dtype in (torch.float32, torch.bfloat16):
        cq, ck, cv, cbt, cbase = make_case(8, 16, 16, 64, 16, 128, 12, main_pos, dtype,
                                           inactive=(6, 7), seed=5, T=1)
        label = f"T1 {str(dtype).replace('torch.', '')}"
        mt_errs[label] = kernel_error(*MULTITOKEN, cq, ck[0], cv[0], cbt, cbase)
        dec = pda.paged_decode_attention(cq[:, 0].contiguous(), ck[0], cv[0], cbt, cbase)
        mt = pma.paged_multitoken_attention(cq, ck[0], cv[0], cbt, cbase)
        torch.cuda.synchronize()
        vs_dec = float((mt[:, 0].float() - dec.float()).abs().max())
        mt_errs[f"{label} vs decode kernel"] = vs_dec
        check(max(mt_errs[label], vs_dec) <= TOL[dtype],
              f"multitoken {label}: err {mt_errs[label]}, vs decode kernel {vs_dec}")
    for label, e in mt_errs.items():
        print(f"paged_multitoken_attention {label}: max abs err {e:.3e}")
    mt_lib_err = float((library_attention(mq, mk[0], mv[0], mbt, mbase[3]).float()
                        - pma.paged_multitoken_attention_ref(
                            mq.float(), mk[0].float(), mv[0].float(), mbt, mbase[3])
                        ).abs().max())
    check(mt_lib_err <= TOL[torch.bfloat16], f"multitoken library yardstick disagrees: {mt_lib_err}")
    # timed over the four chunk starts in turn (and the 24 layers), so each
    # number is the mean per call over the chunks of a 512-token prompt
    nb = len(mt_bases)
    mt_ms, mt_call_ms = time_ms(
        lambda i: pma.paged_multitoken_attention(mq, mk[i % L], mv[i % L], mbt, mbase[i % nb]),
        480)
    mt_plain_ms, mt_plain_call_ms = time_ms(
        lambda i: pma.paged_multitoken_attention_ref(mq, mk[i % L], mv[i % L], mbt,
                                                     mbase[i % nb]), 32)
    mt_lib_ms, mt_lib_call_ms = time_ms(
        lambda i: library_attention(mq, mk[i % L], mv[i % L], mbt, mbase[i % nb]), 32)
    bounds = [bound(mq, mk[0], mbt, bb, pv_at_q_rate=pma.tensor_core_route(mq, mk[0]))
              for bb in mbase]
    mt_bound_ms = sum(b[0] for b in bounds) / nb
    mt_bound_by = max(set(b[1] for b in bounds), key=[b[1] for b in bounds].count)
    print(f"paged_multitoken_attention main shape (mean over chunk starts {mt_bases}), device "
          f"ms per call: kernel {mt_ms:.4f}, plain {mt_plain_ms:.4f}, library {mt_lib_ms:.4f}, "
          f"bound {mt_bound_ms:.5f} ({mt_bound_by}; per start "
          + ", ".join(f"{b[0]:.5f} {b[1]}" for b in bounds)
          + f"), kernel at {mt_bound_ms / mt_ms:.3f} of bound")
    print(f"  per call with the host's launch path in the loop: kernel {mt_call_ms:.4f} ms, "
          f"plain {mt_plain_call_ms:.4f} ms, library {mt_lib_call_ms:.4f} ms")
    del mk, mv

    # the int8 mode of the paged decode kernel where phase 3c runs it, in
    # the verify steps: 8 slots, 512-page int8 pools (24 layers) and their
    # scales, bf16 q, the table of a 512 + 64-token reservation (36 pages),
    # slots at pos 256..575 (a 256-token shared prompt and its tails, cold
    # prompts up to 512, 64 new tokens) with page-boundary values and two
    # inactive slots on scratch; then other shapes. Each case by max abs
    # error and by max abs error / max |ref|
    i8_n = pages_for(FEATURES_SECTION["max_prompt_len"] + FEATURES_SECTION["max_new_tokens"],
                     FEATURES_SECTION["page_size"])
    i8_pos = [256, 271, 300, 383, 384, 575, 0, 0]
    iq, ikq, ivq, isc, ibt, ipos = make_int8_case(8, 16, 16, 64, 16, 512, i8_n, i8_pos,
                                                  torch.bfloat16, inactive=(6, 7), layers=L,
                                                  seed=21)
    i8_main = f"main bf16 q B8 H16 D64 page16, {i8_n}-page table"
    i8_errs = {i8_main: int8_error(*DECODE, iq, ikq[0], ivq[0], isc[0], ibt, ipos)}
    i8_cases = [
        ("fp32 q", dict(B=8, H=16, KV=16, D=64, page=16, P=512, n=i8_n, pos=i8_pos,
                        dtype=torch.float32, inactive=(6, 7))),
        ("GQA H16 KV4 bf16", dict(B=4, H=16, KV=4, D=64, page=16, P=64, n=8,
                                  pos=[3, 40, 127, 64], dtype=torch.bfloat16)),
        ("GQA H16 KV4 fp32", dict(B=4, H=16, KV=4, D=64, page=16, P=64, n=8,
                                  pos=[3, 40, 127, 64], dtype=torch.float32)),
        ("D128 bf16", dict(B=4, H=8, KV=8, D=128, page=16, P=64, n=8,
                           pos=[0, 31, 32, 100], dtype=torch.bfloat16)),
        ("D256 fp32 page64", dict(B=3, H=4, KV=2, D=256, page=64, P=16, n=4,
                                  pos=[63, 64, 255], dtype=torch.float32)),
        ("D256 bf16 page64", dict(B=3, H=4, KV=2, D=256, page=64, P=16, n=4,
                                  pos=[63, 64, 255], dtype=torch.bfloat16)),
        ("H6 bf16 (gpt2 at tp 2)", dict(B=8, H=6, KV=6, D=64, page=16, P=320, n=i8_n,
                                        pos=i8_pos, dtype=torch.bfloat16, inactive=(6, 7))),
    ]
    for label, c in i8_cases:
        cq, ckq, cvq, csc, cbt, cpos = make_int8_case(**c, seed=22)
        i8_errs[label] = int8_error(*DECODE, cq, ckq[0], cvq[0], csc[0], cbt, cpos)
    for label, (e, r) in i8_errs.items():
        dtype = torch.bfloat16 if label == i8_main else dict(i8_cases)[label]["dtype"]
        print(f"paged_decode_attention int8 {label}: max abs err {e:.3e} (tolerance "
              f"{TOL[dtype]:g}), / max |ref| {r:.3e} (tolerance {REL_TOL[dtype]:g})")
        check(e <= TOL[dtype] and r <= REL_TOL[dtype], f"int8 decode {label}: {e}, {r}")
    i8_lib_err = errors(library_attention(iq, ikq[0], ivq[0], ibt, ipos, isc[0]),
                        pda.paged_decode_attention_ref(iq.float(), ikq[0], ivq[0], ibt, ipos,
                                                       scales=isc[0]))[0]
    check(i8_lib_err <= TOL[torch.bfloat16], f"int8 library yardstick disagrees: {i8_lib_err}")
    i8_ms, i8_call_ms = time_ms(lambda i: pda.paged_decode_attention(
        iq, ikq[i % L], ivq[i % L], ibt, ipos, scales=isc[i % L]), 480)
    i8_plain_ms, _ = time_ms(lambda i: pda.paged_decode_attention_ref(
        iq, ikq[i % L], ivq[i % L], ibt, ipos, scales=isc[i % L]), 32)
    i8_lib_ms, _ = time_ms(lambda i: library_attention(
        iq, ikq[i % L], ivq[i % L], ibt, ipos, isc[i % L]), 32)
    i8_bound_ms, i8_bound_by = bound(iq, ikq[0], ibt, ipos, isc[0])
    print(f"paged_decode_attention int8 main shape, device ms per call: kernel {i8_ms:.4f}, "
          f"plain {i8_plain_ms:.4f}, library (dequantizing gather + SDPA) {i8_lib_ms:.4f}, "
          f"bound {i8_bound_ms:.5f} ({i8_bound_by}), kernel at {i8_bound_ms / i8_ms:.3f} of "
          f"bound; per call with the host's launch path {i8_call_ms:.4f}")
    del ikq, ivq, isc

    # the paged decode kernel's split-K plan (from shapes alone: B, H, KV, D,
    # dtype, page, the table's n pages, the SM count), at the verify shape of
    # 3b/3c (a 36-page table): pos on the first and last row of every chunk,
    # inside one page, at the table's last row and past it, both modes, each
    # call against the plain version and repeated bit for bit
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    split_errs, split_plans = {}, {}
    for mode, itemsize in (("bf16", 2), ("int8", 1)):
        plan = pda.kernel_plan(8, 16, 16, 64, itemsize, 16, i8_n, sms)
        split_plans[mode] = plan
        _, _, splits, chunk = plan
        edges = sorted({0, 5, 15, i8_n * 16 - 1, i8_n * 16 + 40}
                       | {e for c in range(1, splits) for e in (c * chunk - 1, c * chunk)})
        worst = (0.0, 0.0)
        for c0 in range(0, len(edges), 6):
            spos = (edges[c0:c0 + 6] + [0] * 6)[:6] + [0, 0]  # slots 6, 7 on scratch
            if mode == "int8":
                sq, skq, svq, ssc, sbt, sp = make_int8_case(8, 16, 16, 64, 16, 512, i8_n, spos,
                                                            torch.bfloat16, inactive=(6, 7),
                                                            seed=60 + c0)
                call = lambda: pda.paged_decode_attention(  # noqa: E731
                    sq, skq[0], svq[0], sbt, sp, scales=ssc[0])
                ref = pda.paged_decode_attention_ref(sq.float(), skq[0], svq[0], sbt, sp,
                                                     scales=ssc[0])
            else:
                sq, sk, sv, sbt, sp = make_case(8, 16, 16, 64, 16, 512, i8_n, spos,
                                                torch.bfloat16, inactive=(6, 7), seed=60 + c0)
                call = lambda: pda.paged_decode_attention(sq, sk[0], sv[0], sbt, sp)  # noqa: E731
                ref = pda.paged_decode_attention_ref(sq.float(), sk[0].float(), sv[0].float(),
                                                     sbt, sp)
            first, again = call(), call()
            torch.cuda.synchronize()
            check(torch.equal(first, again), f"paged decode {mode} at pos {spos}: two calls differ")
            e = errors(first, ref)
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        split_errs[mode] = worst
        print(f"paged_decode_attention {mode} split edges (plan: heads a block, warps a block, "
              f"chunks, rows a chunk = {plan}; pos {edges}): max abs err {worst[0]:.3e}, / max "
              f"|ref| {worst[1]:.3e}; two calls equal bit for bit")
        check(worst[0] <= TOL[torch.bfloat16] and worst[1] <= REL_TOL[torch.bfloat16],
              f"paged decode {mode} split edges: {worst}")
    print("paged_decode_attention launch plans at the main shapes: bf16 12-page table "
          f"{pda.kernel_plan(8, 16, 16, 64, 2, 16, 12, sms)}, int8 {i8_n}-page table "
          f"{split_plans['int8']}; 1 device launch a call (with more than one live chunk the "
          "last block of a (slot, head group) merges them)")
    # a long table at its last row: B2, 256 pages of 16, pos 4095, 4 layers
    # of pools in turn (past L2), both modes
    paged_long = {}
    for mode in ("bf16", "int8"):
        if mode == "int8":
            lq, lkq, lvq, lsc, lbt, lpos = make_int8_case(2, 16, 16, 64, 16, 520, 256,
                                                          [4095, 4095], torch.bfloat16,
                                                          layers=4, seed=70)
            fn = lambda i: pda.paged_decode_attention(  # noqa: E731
                lq, lkq[i % 4], lvq[i % 4], lbt, lpos, scales=lsc[i % 4])
            lib = lambda i: library_attention(lq, lkq[i % 4], lvq[i % 4], lbt, lpos,  # noqa: E731
                                              lsc[i % 4])
            lb = bound(lq, lkq[0], lbt, lpos, lsc[0])
        else:
            lq, lkq, lvq, lbt, lpos = make_case(2, 16, 16, 64, 16, 520, 256, [4095, 4095],
                                                torch.bfloat16, layers=4, seed=70)
            fn = lambda i: pda.paged_decode_attention(lq, lkq[i % 4], lvq[i % 4], lbt,  # noqa: E731
                                                      lpos)
            lib = lambda i: library_attention(lq, lkq[i % 4], lvq[i % 4], lbt, lpos)  # noqa: E731
            lb = bound(lq, lkq[0], lbt, lpos)
        l_ms, _ = time_ms(fn, 240)
        l_lib_ms, _ = time_ms(lib, 48)
        paged_long[mode] = (l_ms, l_lib_ms, lb)
        print(f"paged_decode_attention {mode} long table B2 H16 D64, 256 pages of 16, pos 4095, "
              f"device ms per call: kernel {l_ms:.4f}, library {l_lib_ms:.4f}, bound "
              f"{lb[0]:.5f} ({lb[1]}), kernel at {lb[0] / l_ms:.3f} of bound; launch "
              f"{pda.kernel_plan(2, 16, 16, 64, 2 if mode == 'bf16' else 1, 16, 256, sms)}")
        del lq, lkq, lvq
    torch.cuda.empty_cache()

    # the int8 mode of the multi-token kernel at the chunk program's shape
    # of phase 3c (timed over the four chunk starts and 24 layers, as above)
    mq, mkq, mvq, msc, mbt, _ = make_int8_case(1, 16, 16, 64, 16, 512, 36, [0], torch.bfloat16,
                                               layers=L, seed=23, T=64)
    i8mt_errs = {}
    for b0, bb in zip(mt_bases, mbase):
        i8mt_errs[f"main bf16 q B1 T64 H16 D64 page16 base {b0}"] = int8_error(
            *MULTITOKEN, mq, mkq[0], mvq[0], msc[0], mbt, bb)
    i8mt_cases = [
        ("ragged B4 T5 bf16, one slot on scratch", dict(
            B=4, T=5, H=16, KV=16, D=64, page=16, P=64, n=6, pos=[14, 30, 47, 0],
            dtype=torch.bfloat16, inactive=(3,))),
        ("GQA H16 KV4 fp32", dict(B=2, T=16, H=16, KV=4, D=64, page=16, P=64, n=8,
                                  pos=[5, 40], dtype=torch.float32)),
        ("GQA H16 KV4 bf16 T64", dict(B=2, T=64, H=16, KV=4, D=64, page=16, P=64, n=8,
                                      pos=[0, 40], dtype=torch.bfloat16)),
        ("D128 bf16", dict(B=2, T=16, H=8, KV=8, D=128, page=16, P=64, n=8,
                           pos=[0, 33], dtype=torch.bfloat16)),
        ("D256 fp32 page64", dict(B=2, T=9, H=4, KV=2, D=256, page=64, P=16, n=4,
                                  pos=[60, 130], dtype=torch.float32)),
        ("H6 bf16 T64 (gpt2 at tp 2)", dict(B=1, T=64, H=6, KV=6, D=64, page=16, P=128,
                                            n=36, pos=[64], dtype=torch.bfloat16)),
    ]
    for label, c in i8mt_cases:
        cq, ckq, cvq, csc, cbt, cbase = make_int8_case(**c, seed=24)
        i8mt_errs[label] = int8_error(*MULTITOKEN, cq, ckq[0], cvq[0], csc[0], cbt, cbase)
    for label, (e, r) in i8mt_errs.items():
        dtype = dict(i8mt_cases)[label]["dtype"] if label in dict(i8mt_cases) else torch.bfloat16
        print(f"paged_multitoken_attention int8 {label}: max abs err {e:.3e} (tolerance "
              f"{TOL[dtype]:g}), / max |ref| {r:.3e} (tolerance {REL_TOL[dtype]:g})")
        check(e <= TOL[dtype] and r <= REL_TOL[dtype], f"int8 multitoken {label}: {e}, {r}")
    i8mt_main_err = max(e for k, (e, _) in i8mt_errs.items() if k.startswith("main"))
    i8mt_ms, i8mt_call_ms = time_ms(lambda i: pma.paged_multitoken_attention(
        mq, mkq[i % L], mvq[i % L], mbt, mbase[i % nb], scales=msc[i % L]), 480)
    i8mt_plain_ms, _ = time_ms(lambda i: pma.paged_multitoken_attention_ref(
        mq, mkq[i % L], mvq[i % L], mbt, mbase[i % nb], scales=msc[i % L]), 32)
    i8mt_lib_ms, _ = time_ms(lambda i: library_attention(
        mq, mkq[i % L], mvq[i % L], mbt, mbase[i % nb], msc[i % L]), 32)
    i8mt_bounds = [bound(mq, mkq[0], mbt, bb, msc[0], pma.tensor_core_route(mq, mkq[0]))
                   for bb in mbase]
    i8mt_bound_ms = sum(b[0] for b in i8mt_bounds) / nb
    i8mt_bound_by = max(set(b[1] for b in i8mt_bounds), key=[b[1] for b in i8mt_bounds].count)
    print(f"paged_multitoken_attention int8 main shape (mean over chunk starts {mt_bases}), "
          f"device ms per call: kernel {i8mt_ms:.4f}, plain {i8mt_plain_ms:.4f}, library "
          f"{i8mt_lib_ms:.4f}, bound {i8mt_bound_ms:.5f} ({i8mt_bound_by}), kernel at "
          f"{i8mt_bound_ms / i8mt_ms:.3f} of bound; per call with the host's launch path "
          f"{i8mt_call_ms:.4f}")
    del mkq, mvq, msc

    # the multi-token kernel's split-K plan (from shapes alone: B, T, H, KV,
    # page, the table's n pages, the SM count) at 3b/3c's chunk shape: the
    # unit's last query (base + 63) on the first and last row of every
    # chunk and past the table, both modes, each call against the plain
    # version and repeated bit for bit
    mt_plan = pma.kernel_plan(1, 64, 16, 16, 16, 36, sms)
    _, _, _, mt_splits, mt_chunk = mt_plan
    mt_edges = sorted({0, 5, 36 * 16 - 64, 36 * 16 - 50}
                      | {max(0, e - 63) for c in range(1, mt_splits)
                         for e in (c * mt_chunk - 1, c * mt_chunk)})
    for mode in ("bf16", "int8"):
        worst = (0.0, 0.0)
        if mode == "int8":
            sq, skq, svq, ssc, sbt, _ = make_int8_case(1, 16, 16, 64, 16, 512, 36, [0],
                                                       torch.bfloat16, seed=80, T=64)
        else:
            sq, skq, svq, sbt, _ = make_case(1, 16, 16, 64, 16, 512, 36, [0], torch.bfloat16,
                                             seed=80, T=64)
            ssc = None
        kw = {} if ssc is None else {"scales": ssc[0]}
        sk_ref, sv_ref = (skq[0], svq[0]) if mode == "int8" else (skq[0].float(), svq[0].float())
        for b0 in mt_edges:
            sb = torch.tensor([b0], dtype=torch.int32, device="cuda")
            first = pma.paged_multitoken_attention(sq, skq[0], svq[0], sbt, sb, **kw)
            again = pma.paged_multitoken_attention(sq, skq[0], svq[0], sbt, sb, **kw)
            torch.cuda.synchronize()
            check(torch.equal(first, again), f"multitoken {mode} at base {b0}: two calls differ")
            e = errors(first, pma.paged_multitoken_attention_ref(sq.float(), sk_ref, sv_ref, sbt,
                                                                 sb, **kw))
            worst = (max(worst[0], e[0]), max(worst[1], e[1]))
        print(f"paged_multitoken_attention {mode} split edges (plan: query heads a unit, tokens "
              f"a unit, units, chunks, rows a chunk = {mt_plan}; bases {mt_edges}): max abs err "
              f"{worst[0]:.3e}, / max |ref| {worst[1]:.3e}; two calls equal bit for bit")
        check(worst[0] <= TOL[torch.bfloat16] and worst[1] <= REL_TOL[torch.bfloat16],
              f"multitoken {mode} split edges: {worst}")
        del skq, svq
    print("paged_multitoken_attention launch plans: 3b/3c chunk (B1 T64 H16, 36-page table) "
          f"{mt_plan}, T1 B8 12-page table {pma.kernel_plan(8, 1, 16, 16, 16, 12, sms)}; "
          "1 device launch a call (with more than one live chunk the last block of a unit "
          "merges them)")

    # the contiguous decode kernel at phase 9's decode step (B8, a 256-row
    # cache: 128 prompt + 128 new tokens, gpt2-medium heads, bf16, a layer's
    # slice of the stacked [24, B, Smax, H, D] cache) and at other shapes;
    # every row past pos holds huge garbage
    dq, dk, dv = decode_case(8, 256, 16, 16, 64, torch.bfloat16, layers=L, seed=31)
    dec_main = "main bf16 B8 Smax256 H16 D64"
    d_errs = {f"{dec_main} pos {p}": decode_error(dq, dk[0], dv[0], p) for p in (0, 137, 255)}
    d_cases = [  # label, (B, S, H, KV, D, dtype), pos
        ("fp32 B8 Smax256 H16 D64", (8, 256, 16, 16, 64, torch.float32), 137),
        ("fp16 B8 Smax256 H16 D64", (8, 256, 16, 16, 64, torch.float16), 255),
        ("Smax4096 bf16 B2 H16", (2, 4096, 16, 16, 64, torch.bfloat16), 4095),
        ("Smax4096 fp32 B2 H16 ragged", (2, 4096, 16, 16, 64, torch.float32), 3001),
        ("Smax8192 bf16 B2 H8", (2, 8192, 8, 8, 64, torch.bfloat16), 8191),
        # chunks planned from Smax: all but the first chunks empty
        ("Smax4096 bf16 B2 H16 pos 100", (2, 4096, 16, 16, 64, torch.bfloat16), 100),
        ("Smax8192 fp32 B2 H8 pos 0", (2, 8192, 8, 8, 64, torch.float32), 0),
        ("D128 bf16 B4 Smax512 H8", (4, 512, 8, 8, 128, torch.bfloat16), 300),
        ("D256 fp32 B2 Smax256 H4", (2, 256, 4, 4, 256, torch.float32), 255),
        ("D256 bf16 B2 Smax256 H4", (2, 256, 4, 4, 256, torch.bfloat16), 0),
        ("GQA H16 KV4 bf16 B4 Smax256", (4, 256, 16, 4, 64, torch.bfloat16), 99),
        ("GQA H16 KV4 fp32 B4 Smax256", (4, 256, 16, 4, 64, torch.float32), 200),
    ]
    d_dtypes = {f"{dec_main} pos {p}": torch.bfloat16 for p in (0, 137, 255)}
    for n, (label, shape, p) in enumerate(d_cases):
        cq, ck, cv = decode_case(*shape, seed=32 + n)
        d_errs[label] = decode_error(cq, ck[0], cv[0], p)
        d_dtypes[label] = shape[-1]
    for label, (e, r) in d_errs.items():
        dtype = d_dtypes[label]
        print(f"decode_attention {label}: max abs err {e:.3e} (tolerance {TOL[dtype]:g}), "
              f"/ max |ref| {r:.3e} (tolerance {REL_TOL[dtype]:g})")
        check(e <= TOL[dtype] and r <= REL_TOL[dtype], f"decode {label}: {e}, {r}")
    d_main_err = max(e for k, (e, _) in d_errs.items() if k.startswith(dec_main))
    d_lib_err = errors(library_decode(dq, dk[0], dv[0], 137),
                       tda.decode_attention_ref(dq.float(), dk[0].float(), dv[0].float(), 137))[0]
    check(d_lib_err <= TOL[torch.bfloat16], f"decode library yardstick disagrees: {d_lib_err}")
    # timed over positions phase 9's decode steps pass through (and the 24
    # layers), so each number is a mean per call over a generation
    dec_pos = [128, 160, 192, 224, 254]
    npos = len(dec_pos)
    dec_pos_t = [device_pos(p) for p in dec_pos]
    d_ms, d_call_ms = time_ms(lambda i: tda.decode_attention(dq, dk[i % L], dv[i % L],
                                                             dec_pos_t[i % npos]), 480)
    d_plain_ms, _ = time_ms(lambda i: tda.decode_attention_ref(dq, dk[i % L], dv[i % L],
                                                               dec_pos[i % npos]), 32)
    d_lib_ms, _ = time_ms(lambda i: library_decode(dq, dk[i % L], dv[i % L], dec_pos[i % npos]),
                          32)
    d_bounds = [decode_bound(dq, dk[0], p) for p in dec_pos]
    d_bound_ms = sum(b[0] for b in d_bounds) / npos
    d_bound_by = max(set(b[1] for b in d_bounds), key=[b[1] for b in d_bounds].count)
    print(f"decode_attention main shape (mean over pos {dec_pos}), device ms per call: kernel "
          f"{d_ms:.4f}, plain {d_plain_ms:.4f}, library (SDPA over rows 0..pos) {d_lib_ms:.4f}, "
          f"bound {d_bound_ms:.5f} ({d_bound_by}), kernel at {d_bound_ms / d_ms:.3f} of bound; "
          f"per call with the host's launch path {d_call_ms:.4f}")
    print("decode_attention launch (heads a block, warps a block, chunks, rows a chunk): "
          f"main shape {tda.kernel_plan(8, 16, 16, 64, 2, 256, sms)}, planned from Smax "
          "alone, pos read on the card; 1 device launch a call (with more than one chunk the "
          "last block of a head merges the live ones)")
    del dk, dv
    torch.cuda.empty_cache()
    # the long cache at its last row, where the split matters most (4
    # layers' caches in turn: 134 MB, past L2)
    lq, lk, lv = decode_case(2, 4096, 16, 16, 64, torch.bfloat16, layers=4, seed=45)
    pos4095 = device_pos(4095)
    dl_ms, _ = time_ms(lambda i: tda.decode_attention(lq, lk[i % 4], lv[i % 4], pos4095), 240)
    dl_lib_ms, _ = time_ms(lambda i: library_decode(lq, lk[i % 4], lv[i % 4], 4095), 96)
    dl_bound, dl_by = decode_bound(lq, lk[0], 4095)
    print(f"decode_attention long cache B2 Smax4096 H16 D64 bf16 pos 4095, device ms per call: "
          f"kernel {dl_ms:.4f}, library (SDPA) {dl_lib_ms:.4f}, bound {dl_bound:.5f} ({dl_by}), "
          f"kernel at {dl_bound / dl_ms:.3f} of bound; launch "
          f"{tda.kernel_plan(2, 16, 16, 64, 2, 4096, sms)}")
    del lq, lk, lv
    torch.cuda.empty_cache()

    phase(3, "serve gpt2-medium bf16 (the main path)")
    cfg = gpt2.get_config("gpt2-medium")
    eng = dtt.init_inference(cfg, dtype=torch.bfloat16, seed=0)
    srv = eng.serve()
    reqs = mixed_requests(srv, 16, cfg.vocab_size, seed=1234)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES[K_PAGED] = 0
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES[K_PAGED]
    st = exact_stats(srv)
    check(len(done) == 16, f"{len(done)} of 16 requests completed")
    for req, budget in reqs:
        check(req.status == RequestStatus.FINISHED, f"request {req.id}: {req.status} {req.detail}")
        check(len(req.tokens) == budget, f"request {req.id}: {len(req.tokens)} of {budget} tokens")
        check(all(0 <= t < cfg.vocab_size for t in req.tokens), f"request {req.id}: token out of vocab")
    srv.check_no_leaks()
    steps = st["decode_steps"]
    check(steps > 0 and launches == cfg.n_layer * steps,
          f"kernel launches {launches} != n_layer {cfg.n_layer} x decode steps {steps}")
    print(f"requests {len(done)} finished, decode steps {steps}, kernel launches {launches} "
          f"(= {cfg.n_layer} x {steps}), wall {wall:.3f} s")
    print(f"decode tokens/s {st['decode_tokens_per_s']:.1f} (host clock over steps ending in "
          f"the token read), tokens/s end to end {st['tokens_per_s']:.1f}, "
          f"(exact) TTFT p50 {st['ttft']['p50_s'] * 1e3:.2f} ms, TPOT p50 {st['tpot']['p50_s'] * 1e3:.3f} ms, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    st_3 = dict(st, wall_s=wall)
    del srv

    phase("3b", "serve gpt2-medium bf16 with speculation, the prefix cache and chunked "
                "prefill (the slice's path)")
    spec_k = FEATURES_SECTION["speculative"]["k"]
    srv = eng.serve(FEATURES_SECTION)
    reqs = shared_prefix_requests(srv, cfg.vocab_size, seed=4321, n_shared=8, n_cold=8,
                                  system_len=256, tails=(8, 128), cold_lens=(64, 512),
                                  budgets=(16, 64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES[K_PAGED] = 0
    LAUNCHES[K_MT] = 0
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec_launches_3b, mt_launches = LAUNCHES[K_PAGED], LAUNCHES[K_MT]
    st = exact_stats(srv)
    check(len(done) == 16, f"{len(done)} of 16 requests completed")
    for req, budget in reqs:
        check(req.status == RequestStatus.FINISHED, f"request {req.id}: {req.status} {req.detail}")
        check(len(req.tokens) == budget, f"request {req.id}: {len(req.tokens)} of {budget} tokens")
        check(all(0 <= t < cfg.vocab_size for t in req.tokens), f"request {req.id}: token out of vocab")
    srv.check_no_leaks()
    released = srv.release_prefix_cache()
    srv.allocator.check_no_leaks()
    hits = st["prefix_hits_partial"] + st["prefix_hits_full"]
    check(hits > 0, f"no prefix hits: {st}")
    check(st["chunk_prefills"] > 0 and st["spec_steps"] > 0, f"no chunks or verify steps: {st}")
    check(mt_launches == cfg.n_layer * st["chunk_prefills"],
          f"multitoken launches {mt_launches} != n_layer {cfg.n_layer} x chunk-program calls "
          f"{st['chunk_prefills']}")
    check(dec_launches_3b == cfg.n_layer * (spec_k + 1) * st["spec_steps"],
          f"decode launches {dec_launches_3b} != {cfg.n_layer} x {spec_k + 1} x verify steps "
          f"{st['spec_steps']}")
    print(f"requests {len(done)} finished, prefix hits {hits} (full {st['prefix_hits_full']}, "
          f"partial {st['prefix_hits_partial']}, misses {st['prefix_misses']}, evictions "
          f"{st['prefix_evictions']}, {released} index pages released at the end), chunk-program "
          f"calls {st['chunk_prefills']}, verify steps {st['spec_steps']}, wall {wall:.3f} s")
    print(f"kernel launches: multitoken {mt_launches} (= {cfg.n_layer} x {st['chunk_prefills']}), "
          f"decode {dec_launches_3b} (= {cfg.n_layer} x {spec_k + 1} x {st['spec_steps']})")
    print(f"prefix hit rate {st['prefix_hit_rate']:.4f}, mean accept length "
          f"{st['spec_accept_len_mean']:.4f} tokens per slot-step, decode tokens/s "
          f"{st['decode_tokens_per_s']:.1f}, tokens/s end to end {st['tokens_per_s']:.1f}, "
          f"(exact) TTFT p50 {st['ttft']['p50_s'] * 1e3:.2f} ms, TPOT p50 {st['tpot']['p50_s'] * 1e3:.3f} ms, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    st_3b = st
    bf16_pool_bytes = sum(t.numel() * t.element_size() for t in (srv.k_pool, srv.v_pool))
    del srv

    phase("3c", "serve gpt2-medium bf16 with int8 KV pages, speculation, the prefix cache and "
                "chunked prefill (3b's traffic)")
    srv = eng.serve(dict(FEATURES_SECTION, kv_cache_dtype="int8"))
    reqs = shared_prefix_requests(srv, cfg.vocab_size, seed=4321, n_shared=8, n_cold=8,
                                  system_len=256, tails=(8, 128), cold_lens=(64, 512),
                                  budgets=(16, 64))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES[K_PAGED] = LAUNCHES[K_PAGED8] = 0
    LAUNCHES[K_MT] = LAUNCHES[K_MT8] = 0
    t0 = time.perf_counter()
    done = srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dec8_launches, mt8_launches = LAUNCHES[K_PAGED8], LAUNCHES[K_MT8]
    fp_launches = LAUNCHES[K_PAGED] + LAUNCHES[K_MT]
    st = exact_stats(srv)
    check(len(done) == 16, f"{len(done)} of 16 requests completed")
    for req, budget in reqs:
        check(req.status == RequestStatus.FINISHED, f"request {req.id}: {req.status} {req.detail}")
        check(len(req.tokens) == budget, f"request {req.id}: {len(req.tokens)} of {budget} tokens")
        check(all(0 <= t < cfg.vocab_size for t in req.tokens), f"request {req.id}: token out of vocab")
    srv.check_no_leaks()
    hits = st["prefix_hits_partial"] + st["prefix_hits_full"]
    check(hits > 0, f"no prefix hits: {st}")
    check(st["chunk_prefills"] > 0 and st["spec_steps"] > 0, f"no chunks or verify steps: {st}")
    check(mt8_launches == cfg.n_layer * st["chunk_prefills"],
          f"int8 multitoken launches {mt8_launches} != n_layer {cfg.n_layer} x chunk-program "
          f"calls {st['chunk_prefills']}")
    check(dec8_launches == cfg.n_layer * (spec_k + 1) * st["spec_steps"],
          f"int8 decode launches {dec8_launches} != {cfg.n_layer} x {spec_k + 1} x verify steps "
          f"{st['spec_steps']}")
    check(fp_launches == 0, f"full-precision kernel modes launched {fp_launches} times in 3c")
    # the bytes, on the tensors: codes half of 3b's bf16 pools, scales
    # [L, P, KV, 2] f32
    code_bytes = sum(t.numel() * t.element_size() for t in (srv.k_pool, srv.v_pool))
    scale_bytes = srv.kv_scales.numel() * srv.kv_scales.element_size()
    want_scales = cfg.n_layer * FEATURES_SECTION["num_pages"] * cfg.n_head * 2 * 4
    check(srv.k_pool.dtype == torch.int8 and 2 * code_bytes == bf16_pool_bytes,
          f"int8 pools {code_bytes} bytes against the bf16 pools' {bf16_pool_bytes}")
    check(srv.kv_scales.dtype == torch.float32 and scale_bytes == want_scales,
          f"scales {scale_bytes} bytes, expected {want_scales}")
    check(st["kv_pool_bytes"] == code_bytes and st["kv_scales_bytes"] == scale_bytes,
          f"stats() bytes {st['kv_pool_bytes']}, {st['kv_scales_bytes']}")
    released = srv.release_prefix_cache()
    srv.allocator.check_no_leaks()
    print(f"requests {len(done)} finished, prefix hits {hits} (full {st['prefix_hits_full']}, "
          f"partial {st['prefix_hits_partial']}, misses {st['prefix_misses']}, {released} index "
          f"pages released at the end), chunk-program calls {st['chunk_prefills']}, verify steps "
          f"{st['spec_steps']}, wall {wall:.3f} s")
    print(f"int8 kernel launches: multitoken {mt8_launches} (= {cfg.n_layer} x "
          f"{st['chunk_prefills']}), decode {dec8_launches} (= {cfg.n_layer} x {spec_k + 1} x "
          f"{st['spec_steps']}); full-precision modes {fp_launches}")
    print(f"pool bytes on the tensors: int8 codes {code_bytes} = bf16 {bf16_pool_bytes} / 2, "
          f"scales {scale_bytes} (= {cfg.n_layer} x {FEATURES_SECTION['num_pages']} x "
          f"{cfg.n_head} x 2 x 4)")
    print(f"prefix hit rate {st['prefix_hit_rate']:.4f}, mean accept length "
          f"{st['spec_accept_len_mean']:.4f}, decode tokens/s {st['decode_tokens_per_s']:.1f} "
          f"(3b, bf16 pages: {st_3b['decode_tokens_per_s']:.1f}), tokens/s end to end "
          f"{st['tokens_per_s']:.1f} (3b: {st_3b['tokens_per_s']:.1f}), (exact) TTFT p50 "
          f"{st['ttft']['p50_s'] * 1e3:.2f} ms (3b: {st_3b['ttft']['p50_s'] * 1e3:.2f}), TPOT p50 "
          f"{st['tpot']['p50_s'] * 1e3:.3f} ms (3b: {st_3b['tpot']['p50_s'] * 1e3:.3f}), peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    st_3c = dict(st, wall_s=wall)
    del srv, eng

    phase(4, "fp32 streams: card against CPU, features on against off")
    cfg4 = gpt2.get_config("gpt2-medium", n_layer=4)
    tree = params_to_numpy(gpt2.init_params(
        cfg4, torch.Generator(device="cuda").manual_seed(7), "cuda", torch.float32))
    # 4 slots, so the second wave of the shared-prefix traffic finds the
    # first wave's prompt pages in the index
    feat_cfg = {"max_slots": 4, "max_prompt_len": 128, "prefill_chunk_tokens": 32,
                "prefix_cache": {"enabled": True}, "speculative": {"enabled": True, "k": 4}}
    runs = {  # name -> (serving section, the traffic)
        "default": (None, lambda s: mixed_requests(s, 8, cfg4.vocab_size, seed=99)),
        "features": (feat_cfg, lambda s: shared_prefix_requests(
            s, cfg4.vocab_size, seed=77, n_shared=4, n_cold=4, system_len=64,
            tails=(1, 64), cold_lens=(8, 128), budgets=(16, 64))),
    }
    # the features' traffic with the features off
    runs["features off"] = ({"max_slots": 4}, runs["features"][1])
    # the same three with int8 KV pages
    runs["int8 default"] = ({"kv_cache_dtype": "int8"}, runs["default"][1])
    runs["int8 features"] = (dict(feat_cfg, kv_cache_dtype="int8"), runs["features"][1])
    runs["int8 features off"] = ({"max_slots": 4, "kv_cache_dtype": "int8"},
                                 runs["features"][1])
    streams, captured4 = {}, {}
    for dev in ("cuda", "cpu"):
        e = dtt.init_inference(cfg4, params=params_from_numpy(tree, dev),
                               dtype=torch.float32, device=dev)
        for name, (section, traffic) in runs.items():
            if dev == "cpu" and name.endswith("features off"):
                continue
            s = e.serve(section, track_margins=True)
            rq = traffic(s)
            s.run()
            s.check_no_leaks()
            for req, budget in rq:
                check(req.status == RequestStatus.FINISHED and len(req.tokens) == budget,
                      f"{dev} {name} request {req.id}: {req.status}, "
                      f"{len(req.tokens)} of {budget}")
            if name.endswith("features"):
                st4 = s.stats()
                check(st4["prefix_hits_partial"] + st4["prefix_hits_full"] > 0
                      and st4["chunk_prefills"] > 0 and st4["spec_steps"] > 0,
                      f"{dev}: the features did not run: {st4}")
            if dev == "cuda":
                # the card's streams come from captured graphs (a program
                # called twice or more replays)
                check(all(p.graph is not None for p in s.executables if p.calls >= 2),
                      f"phase 4 {name}: a program ran uncaptured")
                captured4[name] = sum(p.replays for p in s.executables)
            streams[dev, name] = [r for r, _ in rq]
    print("the card's programs ran as captured CUDA graphs; replays by run: "
          + ", ".join(f"{k} {v}" for k, v in captured4.items()))
    compare_streams("default path, card vs CPU", streams["cuda", "default"],
                    streams["cpu", "default"])
    compare_streams("features on, card vs CPU", streams["cuda", "features"],
                    streams["cpu", "features"])
    compare_streams("card, features on vs off", streams["cuda", "features"],
                    streams["cuda", "features off"])
    compare_streams("int8 default path, card vs CPU", streams["cuda", "int8 default"],
                    streams["cpu", "int8 default"])
    compare_streams("int8 features on, card vs CPU", streams["cuda", "int8 features"],
                    streams["cpu", "int8 features"])
    compare_streams("int8 card, features on vs off", streams["cuda", "int8 features"],
                    streams["cuda", "int8 features off"])

    phase(5, "flash-attention kernels against their plain versions")
    flash_cases = [  # label, (B, S, H, KV, D, dtype), causal, window
        ("main bf16 B8 S1024 H16 D64 causal", (8, 1024, 16, 16, 64, torch.bfloat16), True, None),
        ("fp32 B2 S1024 H16 D64", (2, 1024, 16, 16, 64, torch.float32), True, None),
        ("fp16 B2 S1024 H16 D64", (2, 1024, 16, 16, 64, torch.float16), True, None),
        ("D128 bf16 B2 S1024 H8", (2, 1024, 8, 8, 128, torch.bfloat16), True, None),
        ("D256 bf16 B1 S1024 H4", (1, 1024, 4, 4, 256, torch.bfloat16), True, None),
        ("non-causal bf16 B2 S1024 H16", (2, 1024, 16, 16, 64, torch.bfloat16), False, None),
        ("GQA H16 KV4 bf16 B2 S1024", (2, 1024, 16, 4, 64, torch.bfloat16), True, None),
        ("window 256 bf16 B2 S1024 H16", (2, 1024, 16, 16, 64, torch.bfloat16), True, 256),
        ("ragged S1000 bf16 B2 H16", (2, 1000, 16, 16, 64, torch.bfloat16), True, None),
        ("long B1 H4 S8192 bf16", (1, 8192, 4, 4, 64, torch.bfloat16), True, None),
        ("D128 fp16 non-causal GQA H8 KV2 ragged S1088 B1", (1, 1088, 8, 2, 128, torch.float16),
         False, None),
        ("D128 bf16 window 200 B2 S1024 H8", (2, 1024, 8, 8, 128, torch.bfloat16), True, 200),
        ("fp32 D256 S4224 B1 H2", (1, 4224, 2, 2, 256, torch.float32), True, None),
        ("S128 bf16 B8 H16", (8, 128, 16, 16, 64, torch.bfloat16), True, None),
    ]
    flash_errs = {}
    for n, (label, shape, causal, window) in enumerate(flash_cases):
        dtype = shape[-1]
        errs5, scaled5 = flash_errors(*flash_case(*shape, seed=10 + n), causal=causal,
                                      window=window)
        flash_errs[label] = errs5
        tol, rel_tol = FLASH_TOL[dtype], FLASH_REL_TOL[dtype]
        print(f"flash {label}: max abs err " + ", ".join(f"{k} {e:.3e}" for k, e in errs5.items())
              + f" (tolerance {tol:g}); max abs err / max |ref| "
              + ", ".join(f"{k} {e:.3e}" for k, e in scaled5.items())
              + f" (tolerance {rel_tol:g}, lse {LSE_REL_TOL:g})")
        check(max(errs5.values()) <= tol, f"flash {label}: {errs5} above {tol}")
        check(scaled5["lse"] <= LSE_REL_TOL, f"flash {label}: lse scaled err {scaled5['lse']}")
        check(all(e <= rel_tol for k, e in scaled5.items() if k != "lse"),
              f"flash {label}: scaled errors {scaled5} above {rel_tol}")
        torch.cuda.empty_cache()
    main_label = flash_cases[0][0]
    fwd_err = max(flash_errs[main_label]["o"], flash_errs[main_label]["lse"])
    bwd_err = max(flash_errs[main_label][k] for k in ("dq", "dk", "dv"))

    q, k, v, do = flash_case(8, 1024, 16, 16, 64, torch.bfloat16, seed=10)
    o, lse = fa.flash_attention_fwd(q, k, v)
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    lib_o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True).transpose(1, 2)
    lib_err5 = float((lib_o.float() - fa.flash_attention_fwd_ref(q, k, v)[0].float()).abs().max())
    check(lib_err5 <= FLASH_TOL[torch.bfloat16], f"flash library yardstick disagrees: {lib_err5}")
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

    def lib_fwd_bwd(_):
        out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in leaves), is_causal=True)
        return torch.autograd.grad(out, leaves, dot)

    fwd_ms, fwd_call_ms = time_ms(lambda i: fa.flash_attention_fwd(q, k, v), 60)
    bwd_ms, bwd_call_ms = time_ms(lambda i: fa.flash_attention_bwd(q, k, v, o, lse, do), 30)
    fwd_plain_ms, _ = time_ms(lambda i: fa.flash_attention_fwd_ref(q, k, v), 6, warmup=2)
    bwd_plain_ms, _ = time_ms(lambda i: fa.flash_attention_bwd_ref(q, k, v, o, lse, do), 6,
                              warmup=2)
    lib_fwd_ms, _ = time_ms(lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 60)
    lib_fb_ms, _ = time_ms(lib_fwd_bwd, 30)
    lib_bwd_ms = lib_fb_ms - lib_fwd_ms
    fwd_bound, fwd_by = flash_bound(q, k, True, None, backward=False)
    bwd_bound, bwd_by = flash_bound(q, k, True, None, backward=True)
    print(f"flash_attention_fwd main shape, device ms per call: kernel {fwd_ms:.4f}, plain "
          f"{fwd_plain_ms:.4f}, library (SDPA forward) {lib_fwd_ms:.4f}, bound {fwd_bound:.5f} "
          f"({fwd_by}), kernel at {fwd_bound / fwd_ms:.3f} of bound; per call with the host's "
          f"launch path {fwd_call_ms:.4f}")
    print(f"flash_attention_bwd main shape, device ms per call: kernel {bwd_ms:.4f}, plain "
          f"{bwd_plain_ms:.4f}, library (SDPA forward+backward {lib_fb_ms:.4f} minus forward) "
          f"{lib_bwd_ms:.4f}, bound {bwd_bound:.5f} ({bwd_by}), kernel at "
          f"{bwd_bound / bwd_ms:.3f} of bound; per call with the host's launch path "
          f"{bwd_call_ms:.4f}")
    bwd_again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    bwd_first = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(bwd_first, bwd_again)),
          "flash backward: two calls differ")
    print("flash_attention_bwd main shape: two calls equal bit for bit")
    del q, k, v, do, o, lse, qt, kt, vt, dot, leaves, lib_o, bwd_first, bwd_again
    torch.cuda.empty_cache()
    # the backward at D128, BERT's S128 (causal and not) and one long
    # sequence, each beside SDPA's backward (its forward+backward minus its
    # forward) and the bound
    for label, shape, causal in (("B2 S1024 H8 D128 causal", (2, 1024, 8, 8, 128), True),
                                 ("S128 B8 H16 D64 causal", (8, 128, 16, 16, 64), True),
                                 ("S128 B8 H16 D64 non-causal", (8, 128, 16, 16, 64), False),
                                 ("long B1 H4 S8192 D64 causal", (1, 8192, 4, 4, 64), True)):
        q, k, v, do = flash_case(*shape, torch.bfloat16, seed=31)
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        leaves = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v)]
        dot = do.transpose(1, 2)

        def lib_fb(_):
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            return torch.autograd.grad(out, leaves, dot)

        x_ms, _ = time_ms(lambda i: fa.flash_attention_bwd(q, k, v, o, lse, do, causal), 30)
        x_lib = time_ms(lib_fb, 30)[0] - time_ms(
            lambda i: F.scaled_dot_product_attention(*leaves, is_causal=causal), 30)[0]
        x_bound, x_by = flash_bound(q, k, causal, None, backward=True)
        print(f"flash_attention_bwd {label} bf16, device ms per call: kernel {x_ms:.4f}, "
              f"library (SDPA backward) {x_lib:.4f}, bound {x_bound:.5f} ({x_by}), kernel at "
              f"{x_bound / x_ms:.3f} of bound")
        del q, k, v, do, o, lse, leaves, dot
    torch.cuda.empty_cache()
    # the forward at generate's prefill bucket and at one long sequence, each
    # beside SDPA
    for label, shape in (("S128 B8 H16 D64", (8, 128, 16, 16, 64)),
                         ("long B1 H4 S8192 D64", (1, 8192, 4, 4, 64))):
        q, k, v, _ = flash_case(*shape, torch.bfloat16, seed=30)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        x_ms, _ = time_ms(lambda i: fa.flash_attention_fwd(q, k, v), 60)
        x_lib_ms, _ = time_ms(
            lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True), 60)
        x_bound, x_by = flash_bound(q, k, True, None, backward=False)
        print(f"flash_attention_fwd {label} bf16 causal, device ms per call: kernel {x_ms:.4f}, "
              f"library (SDPA forward) {x_lib_ms:.4f}, bound {x_bound:.5f} ({x_by}), kernel at "
              f"{x_bound / x_ms:.3f} of bound")
        del q, k, v, qt, kt, vt
    print(f"flash_attention_fwd: 1 device launch a call; bf16/fp16 at D64/128 a persistent grid "
          f"of min(B x H x ceil(S / 128), {sms}) blocks of 3 warpgroups (TMA + wgmma)")
    print("flash_attention_bwd: 3 device launches a call (delta, dk/dv, dq); bf16/fp16 at "
          f"D64/128 dk/dv and dq persistent grids of min(items, {sms}) blocks of 3 warpgroups "
          "(TMA + wgmma)")
    torch.cuda.empty_cache()

    phase(6, "train gpt2-medium bf16 through initialize(...) (the slice's path)")
    cfg6 = gpt2.get_config("gpt2-medium")
    conf6 = train_config(micro=8, gas=2)
    eng6, _, _, _ = dtt.initialize(model=gpt2.make_module(cfg6), config=conf6, seed=0)
    S6 = cfg6.n_positions
    batch6 = {"input_ids": np.random.RandomState(5).randint(
        0, cfg6.vocab_size, (eng6.train_batch_size, S6)).astype(np.int32)}
    tokens6 = eng6.train_batch_size * S6
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash_launches()
    reset_optimizer_launches()
    losses6, step_s6, gnorms6 = [], [], []
    for _ in range(12):
        t0 = time.perf_counter()
        m6 = eng6.train_batch(batch6)
        losses6.append(float(m6["loss"]))
        gnorms6.append(float(m6["grad_norm"]))
        torch.cuda.synchronize()
        step_s6.append(time.perf_counter() - t0)
    fwd_launches = LAUNCHES["flash_attention_fwd"]
    bwd_launches = LAUNCHES["flash_attention_bwd"]
    adamw_launches = check_optimizer_launches("phase 6", 12)
    peak6 = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses6)) and all(np.isfinite(gnorms6)), f"non-finite: {losses6}")
    check(losses6[-1] < losses6[0], f"loss did not fall: {losses6}")
    want = cfg6.n_layer * eng6.gradient_accumulation_steps * 12
    check(fwd_launches == want and bwd_launches == want,
          f"flash launches fwd {fwd_launches} bwd {bwd_launches}, expected {want} each "
          f"(= {cfg6.n_layer} x {eng6.gradient_accumulation_steps} x 12)")
    step_ms6 = statistics.median(step_s6[2:]) * 1e3
    tps6 = tokens6 / (step_ms6 / 1e3)
    mfu6 = analytic_train_flops_per_token(cfg6.n_layer, cfg6.n_embd, cfg6.vocab_size, S6) \
        * tps6 / PEAK_OPS_PER_S[torch.bfloat16]
    print("losses " + " ".join(f"{x:.4f}" for x in losses6))
    print(f"flash launches: forward {fwd_launches}, backward {bwd_launches} "
          f"(= {cfg6.n_layer} x {eng6.gradient_accumulation_steps} x 12 each); fused AdamW "
          f"launches {adamw_launches} (= 12)")
    print(f"step ms (median of steps 3-12, each closed by a sync) {step_ms6:.2f}, steps "
          + " ".join(f"{x * 1e3:.1f}" for x in step_s6)
          + f"; tokens/s {tps6:.1f} ({tokens6} tokens a step); MFU {mfu6:.4f} of "
          f"{PEAK_OPS_PER_S[torch.bfloat16] / 1e12:.0f} TFLOP/s (analytic flops); peak memory "
          f"{peak6 / 2**30:.2f} GiB")
    p6 = profile_steps(eng6, batch6, 2)
    print_profile(p6)
    del eng6, m6
    gc.collect()
    torch.cuda.empty_cache()

    phase("6b", "gpt2-medium bf16 with remat: full, attn and dots policies")
    for policy in ("full", "attn", "dots"):
        cfg6b = gpt2.get_config("gpt2-medium", remat=True, remat_policy=policy)
        eng6b, _, _, _ = dtt.initialize(model=gpt2.make_module(cfg6b), config=conf6, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_flash_launches()
        reset_optimizer_launches()
        step_s6b, losses6b = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            losses6b.append(float(eng6b.train_batch(batch6)["loss"]))
            torch.cuda.synchronize()
            step_s6b.append(time.perf_counter() - t0)
        f6b, b6b = LAUNCHES["flash_attention_fwd"], LAUNCHES["flash_attention_bwd"]
        check_optimizer_launches(f"remat {policy}", 2)
        check(all(np.isfinite(losses6b)), f"remat {policy} losses {losses6b}")
        # full: the backward re-runs each block's forward; attn and dots keep
        # the attention output and its lse, so the forward runs once
        ratio = 2 if policy == "full" else 1
        check(b6b == cfg6b.n_layer * eng6b.gradient_accumulation_steps * 2
              and f6b == ratio * b6b,
              f"remat {policy} launches: forward {f6b}, backward {b6b}, expected forward = "
              f"{ratio} x backward")
        check(abs(losses6b[0] - losses6[0]) <= 1e-2 * abs(losses6[0]),
              f"remat {policy} step-1 loss {losses6b[0]} against {losses6[0]}")
        print(f"remat {policy}: launches forward {f6b} = {ratio} x backward {b6b}; losses "
              + " ".join(f"{x:.4f}" for x in losses6b)
              + f"; step ms {' '.join(f'{x * 1e3:.1f}' for x in step_s6b)}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        del eng6b
        gc.collect()
        torch.cuda.empty_cache()

    phase(7, "fp32 training at gpt2-medium width, 4 layers: card against CPU")
    cfg7 = gpt2.get_config("gpt2-medium", n_layer=4)
    tree7 = params_to_numpy(gpt2.init_params(
        cfg7, torch.Generator(device="cuda").manual_seed(11), "cuda", torch.float32))
    batch7 = {"input_ids": np.random.RandomState(7).randint(
        0, cfg7.vocab_size, (4, 256)).astype(np.int32)}
    for opt7, kernel7 in (("AdamW", "fused_adamw"), ("Lamb", "fused_lamb")):
        conf7 = train_config(micro=2, gas=2, optimizer=opt7)
        conf7.pop("bf16")
        losses7, params7 = {}, {}
        for dev in ("cuda plain update", "cuda", "cpu"):
            reset_flash_launches()
            reset_optimizer_launches()
            with plain_update() if dev == "cuda plain update" else contextlib.nullcontext():
                eng7, _, _, _ = dtt.initialize(
                    model=gpt2.make_module(cfg7), config=conf7,
                    model_parameters=params_from_numpy(tree7, dev.split()[0]),
                    device=dev.split()[0])
                losses7[dev] = [float(eng7.train_batch(batch7)["loss"]) for _ in range(3)]
            params7[dev] = params_to_numpy(eng7.params)
            if dev == "cuda":
                check(LAUNCHES["flash_attention_fwd"] == 4 * 2 * 3
                      and LAUNCHES["flash_attention_bwd"] == 4 * 2 * 3,
                      f"fp32 card run: flash launches {counts(fa.KERNELS)}")
                check_optimizer_launches(f"fp32 {opt7} card run", 3, kernel7)
            else:
                check_optimizer_launches(f"fp32 {opt7} {dev} run", 0)
            del eng7
        rel7 = [abs(a - b) / abs(b) for a, b in zip(losses7["cuda"], losses7["cpu"])]
        pdiff7 = max(float(np.abs(a - b).max())
                     for a, b in zip(tree_leaves(params7["cuda"]), tree_leaves(params7["cpu"])))
        print(f"{opt7}: losses card " + " ".join(f"{x:.7f}" for x in losses7["cuda"])
              + ", CPU " + " ".join(f"{x:.7f}" for x in losses7["cpu"])
              + ", relative differences " + " ".join(f"{x:.3e}" for x in rel7)
              + f"; max parameter difference after step 3 {pdiff7:.3e}")
        check(rel7[0] <= 1e-5, f"fp32 {opt7} step-1 loss card vs CPU: relative {rel7[0]} > 1e-5")
        check(max(rel7[1:]) <= 1e-4,
              f"fp32 {opt7} later losses card vs CPU: relative {rel7} > 1e-4")
        relk = [abs(a - b) / abs(b)
                for a, b in zip(losses7["cuda"], losses7["cuda plain update"])]
        pdiffk = max(float(np.abs(a - b).max()) for a, b in
                     zip(tree_leaves(params7["cuda"]), tree_leaves(params7["cuda plain update"])))
        print(f"{opt7}: the card's kernel update against its plain version on the card: loss "
              "relative differences " + " ".join(f"{x:.3e}" for x in relk)
              + f"; max parameter difference after step 3 {pdiffk:.3e}")
        check(max(relk) <= 1e-6, f"fp32 {opt7} kernel vs plain update on the card: {relk}")

    phase(9, "offline generate: gpt2-medium bf16 through init_inference(...).generate")
    eng9 = dtt.init_inference("gpt2-medium", seed=0)
    cfg9 = eng9.model_config
    B9, S9, new9 = 8, 128, 128
    ids9 = np.random.RandomState(9).randint(0, cfg9.vocab_size, (B9, S9)).astype(np.int32)
    check(eng9._prompt_bucket(S9, new9) == S9, "the 128-token prompt is its own bucket")
    out9 = eng9.generate(ids9, max_new_tokens=new9)  # warm-up
    check(out9.shape == (B9, S9 + new9) and np.array_equal(out9[:, :S9], ids9)
          and ((out9[:, S9:] >= 0) & (out9[:, S9:] < cfg9.vocab_size)).all(),
          f"generate output {out9.shape}")
    walls9 = []
    for i in range(3):
        if i == 0:
            LAUNCHES[K_DECODE] = 0
            LAUNCHES[K_PAGED] = LAUNCHES[K_PAGED8] = 0
        t0 = time.perf_counter()
        o9 = eng9.generate(ids9, max_new_tokens=new9)  # reads the tokens: a sync
        walls9.append(time.perf_counter() - t0)
        if i == 0:
            gen_launches, gen_paged = LAUNCHES[K_DECODE], LAUNCHES[K_PAGED] + LAUNCHES[K_PAGED8]
            repeat9 = np.array_equal(o9, out9)
    check(gen_launches == cfg9.n_layer * (new9 - 1) and gen_paged == 0,
          f"decode kernel launches {gen_launches} != {cfg9.n_layer} x {new9 - 1} "
          f"(paged kernels {gen_paged})")
    wall9 = statistics.median(walls9)
    print(f"generate B{B9} prompt {S9} + {new9} new tokens: decode kernel launches "
          f"{gen_launches} (= {cfg9.n_layer} x {new9 - 1}); wall per call "
          + " ".join(f"{w * 1e3:.1f}" for w in walls9)
          + f" ms; {wall9 * 1e3 / new9:.3f} ms per generated token (median call / {new9}), "
          f"{B9 * new9 / wall9:.1f} tokens/s; repeat call identical to the warm-up: {repeat9}")
    # a 100-token prompt: bucketed to 128 against the unbucketed engine
    ids100 = ids9[:, :100]
    eng_nb = dtt.init_inference(cfg9, params=eng9.params, config={"prompt_bucket_sizes": []})
    check(eng9._prompt_bucket(100, 64) == 128 and eng_nb._prompt_bucket(100, 64) is None,
          "bucket sizes")
    compare_generated("bf16 bucketed (100 -> 128) vs unbucketed", eng9,
                      eng9.generate(ids100, max_new_tokens=64),
                      eng_nb.generate(ids100, max_new_tokens=64), 100, BF16_TIE_MARGIN)
    del eng9, eng_nb
    # fp32 at gpt2-medium width, 4 layers (phase 4's weights): card vs CPU
    ids4 = np.random.RandomState(10).randint(0, cfg4.vocab_size, (4, 100)).astype(np.int32)
    gen4 = {}
    for dev in ("cuda", "cpu"):
        e = dtt.init_inference(cfg4, params=params_from_numpy(tree, dev), dtype=torch.float32,
                               device=dev)
        gen4[dev] = e.generate(ids4, max_new_tokens=32)
    compare_generated("fp32 generate, card vs CPU", e, gen4["cuda"], gen4["cpu"], 100,
                      TIE_MARGIN)
    del e
    gc.collect()
    torch.cuda.empty_cache()

    phase(10, "block-sparse kernels against their plain versions")
    bs_cases = [  # label, (B, S, H, D, dtype), block, layout, causal
        ("GPT-2 main bf16 B2 S4096 H16 D64 fixed-uni blk64",
         (2, 4096, 16, 64, torch.bfloat16), 64, "gpt2", True),
        ("BERT main bf16 B16 S512 H16 D64 fixed-bi blk16",
         (16, 512, 16, 64, torch.bfloat16), 16, "bert", False),
        ("fp32 B1 S1024 H4 D64 fixed-uni blk64", (1, 1024, 4, 64, torch.float32), 64, "gpt2", True),
        ("fp32 B2 S512 H4 D128 bigbird blk16", (2, 512, 4, 128, torch.float32), 16, "bigbird",
         False),
        ("fp32 B1 S1024 H2 D64 variable-uni blk32", (1, 1024, 2, 64, torch.float32), 32,
         "variable", True),
        ("fp32 B1 S2048 H2 D128 bslongformer-uni blk128", (1, 2048, 2, 128, torch.float32), 128,
         "bslongformer", True),
        ("fp16 B2 S1024 H8 D64 bigbird blk32", (2, 1024, 8, 64, torch.float16), 32, "bigbird",
         False),
        ("fp16 B1 S2048 H4 D128 fixed-bi blk128", (1, 2048, 4, 128, torch.float16), 128, "fixed",
         False),
        ("fp16 B2 S1024 H4 D64 fixed-uni blk16", (2, 1024, 4, 64, torch.float16), 16, "fixed",
         True),
        ("bf16 B1 S2048 H4 D128 bslongformer-uni blk128", (1, 2048, 4, 128, torch.bfloat16), 128,
         "bslongformer", True),
        ("bf16 B2 S1024 H4 D64 variable-bi blk32", (2, 1024, 4, 64, torch.bfloat16), 32,
         "variable", False),
        ("bf16 B4 S128 H4 D128 bigbird-uni blk16", (4, 128, 4, 128, torch.bfloat16), 16,
         "bigbird", True),
        ("bf16 B2 S1024 H4 D64 dense-uni blk64 (= flash)", (2, 1024, 4, 64, torch.bfloat16), 64,
         "dense", True),
        ("fp32 B1 S1024 H4 D128 dense-bi blk32 (= flash)", (1, 1024, 4, 128, torch.float32), 32,
         "dense", False),
        ("bf16 B1 S256 H2 D64 custom fully masked first row blk16",
         (1, 256, 2, 64, torch.bfloat16), 16, "custom", True),
        ("fp32 B1 S256 H2 D128 custom fully masked first row blk16",
         (1, 256, 2, 128, torch.float32), 16, "custom", True),
        ("bf16 B1 S512 H2 D64 custom fully masked first row blk64",
         (1, 512, 2, 64, torch.bfloat16), 64, "custom", True),
        ("fp16 B2 S1024 H4 D64 bigbird-uni blk64", (2, 1024, 4, 64, torch.float16), 64, "bigbird",
         True),
    ]
    bs_errs = {}
    for n, (label, (B, S, H, D, dtype), blk, kind, causal) in enumerate(bs_cases):
        q, k, v, do = bs_case(B, S, H, D, dtype, seed=40 + n)
        lists = bs_lists(kind, S, H, blk, causal)
        errs10, scaled10, o10, poisoned = bs_errors(q, k, v, do, lists, causal)
        bs_errs[label] = errs10
        rel_tol = FLASH_REL_TOL[dtype]
        extra = ""
        if kind == "dense":
            o_flash, _ = fa.flash_attention_fwd(q, k, v, causal)
            e = scaled_error(o10, o_flash)
            check(e <= rel_tol, f"block-sparse {label}: against the flash kernel {e}")
            extra = f"; o against the flash kernel {e:.3e}"
        if kind == "custom":
            zero = float(o10[:, :blk].float().abs().max())
            check(poisoned == B * H * blk and zero == 0.0,
                  f"block-sparse {label}: {poisoned} poisoned rows, max |o| there {zero}")
            extra = f"; {poisoned} poisoned rows with o exactly 0"
        print(f"block-sparse {label}: density {sac.layout_density(lists.layout):.4f}; max abs "
              "err " + ", ".join(f"{k} {e:.3e}" for k, e in errs10.items())
              + "; max abs err / max |ref| " + ", ".join(f"{k} {e:.3e}" for k, e in scaled10.items())
              + f" (tolerance {rel_tol:g}, lse {LSE_REL_TOL:g}); o/lse and dq/dk/dv repeat bit "
              f"for bit; routes " + ", ".join(
                  f"{w} {bs_route(q, blk)}" for w in ("fwd", "dq", "dkv")) + extra)
        check(scaled10["lse"] <= LSE_REL_TOL, f"block-sparse {label}: lse {scaled10['lse']}")
        check(all(e <= rel_tol for k, e in scaled10.items() if k != "lse"),
              f"block-sparse {label}: scaled errors {scaled10} above {rel_tol}")
        del q, k, v, do, o10
        torch.cuda.empty_cache()

    # the two main shapes: each kernel timed beside its plain version, SDPA
    # with the layout's dense boolean mask (backward: its forward+backward
    # for that kernel's grads minus its forward), the bound, and the port's
    # dense flash kernels at the same shape
    bs_times = {}
    for n, (label, (B, S, H, D, dtype), blk, kind, causal) in enumerate(bs_cases[:2]):
        q, k, v, do = bs_case(B, S, H, D, dtype, seed=40 + n)
        lists = bs_lists(kind, S, H, blk, causal)
        o, lse = bsa.block_sparse_attention_fwd(q, k, v, lists, causal)
        delta = bsa.block_sparse_delta(o, do)
        keep = lists.dense_mask("cuda")
        if causal:
            keep = keep & torch.ones(S, S, dtype=torch.bool, device="cuda").tril()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib_o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep[None]).transpose(1, 2)
        lib_err = scaled_error(lib_o, bsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal)[0])
        check(lib_err <= FLASH_REL_TOL[dtype], f"block-sparse library yardstick disagrees: {lib_err}")
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

        def lib_fwd(_):
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep[None])

        def lib_grad(which):
            def fn(_):
                out = F.scaled_dot_product_attention(*(x.transpose(1, 2) for x in leaves),
                                                     attn_mask=keep[None])
                return torch.autograd.grad(out, which, do.transpose(1, 2))
            return fn

        t = {}
        t["fwd"] = time_ms(lambda i: bsa.block_sparse_attention_fwd(q, k, v, lists, causal), 40)
        t["dq"] = time_ms(lambda i: bsa.block_sparse_attention_dq(q, k, v, do, lse, delta, lists,
                                                                  causal), 40)
        t["dkv"] = time_ms(lambda i: bsa.block_sparse_attention_dkv(q, k, v, do, lse, delta, lists,
                                                                    causal), 40)
        plain = {
            "fwd": time_ms(lambda i: bsa.block_sparse_attention_fwd_ref(q, k, v, lists, causal), 3,
                           warmup=1)[0],
            "dq": time_ms(lambda i: bsa.block_sparse_attention_dq_ref(q, k, v, do, lse, delta,
                                                                      lists, causal), 3,
                          warmup=1)[0],
            "dkv": time_ms(lambda i: bsa.block_sparse_attention_dkv_ref(q, k, v, do, lse, delta,
                                                                        lists, causal), 3,
                           warmup=1)[0],
        }
        bs_lib_fwd_ms = time_ms(lib_fwd, 20)[0]
        lib = {"fwd": bs_lib_fwd_ms,
               "dq": time_ms(lib_grad(leaves[:1]), 10)[0] - bs_lib_fwd_ms,
               "dkv": time_ms(lib_grad(leaves[1:]), 10)[0] - bs_lib_fwd_ms}
        flash_fwd_ms = time_ms(lambda i: fa.flash_attention_fwd(q, k, v, causal), 40)[0]
        fo, flse = fa.flash_attention_fwd(q, k, v, causal)
        flash_bwd_ms = time_ms(lambda i: fa.flash_attention_bwd(q, k, v, fo, flse, do, causal),
                               20)[0]
        for which in ("fwd", "dq", "dkv"):
            b_ms, b_by = bs_bound(q, lists, causal, which)
            bs_times[label, which] = dict(ms=t[which][0], call_ms=t[which][1], plain_ms=plain[which],
                                          library_ms=lib[which], bound_ms=b_ms, bound_by=b_by)
            print(f"block_sparse_attention_{which} {label}, device ms per call: kernel "
                  f"{t[which][0]:.4f}, plain {plain[which]:.4f}, library (SDPA with the dense "
                  f"mask{'' if which == 'fwd' else ', its backward for these grads'}) "
                  f"{lib[which]:.4f}, bound {b_ms:.5f} ({b_by}), kernel at {b_ms / t[which][0]:.3f} "
                  f"of bound; per call with the host's launch path {t[which][1]:.4f}")
        print(f"the port's dense flash kernels at this shape ({'causal' if causal else 'full'}), "
              f"device ms per call: forward {flash_fwd_ms:.4f}, backward (delta, dk/dv, dq) "
              f"{flash_bwd_ms:.4f}; block-sparse forward / dense {t['fwd'][0] / flash_fwd_ms:.3f}, "
              f"backward (dq + dk/dv) / dense {(t['dq'][0] + t['dkv'][0]) / flash_bwd_ms:.3f}, "
              f"layout density {sac.layout_density(lists.layout):.4f}")
        del q, k, v, do, o, lse, delta, keep, qt, kt, vt, lib_o, leaves, fo, flse
        gc.collect()
        torch.cuda.empty_cache()

    phase(11, "train gpt2-medium bf16 at S4096 with the block-sparse section (the slice's path)")
    cfg11, module11, conf11, batch11 = workload("gpt2-medium", sparse=True)
    check(cfg11.attn_impl == "sparse" and cfg11.n_positions == 4096, f"phase 11 config {cfg11}")
    eng11, counts11 = train_phase("phase 11", module11, conf11, batch11, 10, cfg11.n_layer,
                                  BLOCK_SPARSE_KERNELS + OPTIMIZER_KERNELS)
    del eng11, batch11
    gc.collect()
    torch.cuda.empty_cache()

    phase(12, "pre-train bert-large bf16 (MLM + NSP) with the default block-sparse section")
    cfg12, module12, conf12, batch12 = workload("bert-large", sparse=True)
    check(cfg12.attn_impl == "sparse" and cfg12.sparsity_config.block == 16,
          f"phase 12 config {cfg12}")
    eng12, counts12 = train_phase("phase 12", module12, conf12, batch12, 10, cfg12.n_layer,
                                  BLOCK_SPARSE_KERNELS + OPTIMIZER_KERNELS)
    del eng12, batch12
    gc.collect()
    torch.cuda.empty_cache()

    phase(13, "fp32 block-sparse training at full width, 4 layers: card against CPU")
    for label, model, kw in (("GPT-2 sparse S1024 blk64", "gpt2-medium",
                              dict(n_layer=4, seq=1024, micro=1, gas=2)),
                             ("BERT sparse S256 blk16", "bert-large",
                              dict(n_layer=4, seq=256, micro=2, gas=2))):
        cfg13, module13, conf13, batch13 = workload(model, sparse=True, seed=13, **kw)
        conf13.pop("bf16")
        init = bert.init_params if model.startswith("bert") else gpt2.init_params
        tree13 = params_to_numpy(init(cfg13, torch.Generator(device="cuda").manual_seed(13),
                                      "cuda", torch.float32))
        cpu_card_losses(label, module13, conf13, tree13, batch13, cfg13.n_layer)
        del tree13
        gc.collect()
        torch.cuda.empty_cache()

    phase(14, "fused AdamW / LAMB kernels against their plain versions")
    errs14, times14 = optimizer_kernels_phase()
    gc.collect()
    torch.cuda.empty_cache()

    phase(15, "pre-train bert-large bf16 (MLM + NSP), dense, with LAMB (the slice's path)")
    cfg15, module15, conf15, batch15 = workload("bert-large", optimizer="Lamb")
    check(cfg15.attn_impl != "sparse" and conf15["optimizer"]["type"] == "Lamb"
          and batch15["input_ids"].shape == (64, 128), f"phase 15 workload {cfg15}, {conf15}")
    eng15, counts15 = train_phase("phase 15", module15, conf15, batch15, 10, cfg15.n_layer,
                                  FLASH_KERNELS + OPTIMIZER_KERNELS, sparse=False,
                                  opt_kernel="fused_lamb")
    print(f"phase 12 (bert-large sparse S512, micro 16, Adam) step ms {counts12['step_ms']:.2f} "
          f"beside phase 15 (bert-large dense S128, micro 64, LAMB) {counts15['step_ms']:.2f}, "
          "this call")
    del eng15, batch15
    gc.collect()
    torch.cuda.empty_cache()

    phase(16, "the threefry kernel (dropout, uniform_rows) against its plain versions")
    times16 = threefry_kernels_phase()
    gc.collect()
    torch.cuda.empty_cache()

    phase(17, "train gpt2-medium bf16 at dropout 0.1 through initialize(...) (the slice's path)")
    drop_launches = dropout_training_phase(step_ms6)
    gc.collect()
    torch.cuda.empty_cache()

    phase(18, "fp32 training at gpt2-medium width, 4 layers, dropout 0.1: card against CPU")
    dropout_card_cpu_phase()
    gc.collect()
    torch.cuda.empty_cache()

    phase(19, "serve gpt2-medium through init_inference(dtype='int8') (weight-only int8)")
    int8_weights_phase(st_3, st_3c)
    gc.collect()
    torch.cuda.empty_cache()

    phase(20, "sampled streams (temperature 0.8, top-k 50, top-p 0.95)")
    uni_launches = sampled_phase(st_3)
    gc.collect()
    torch.cuda.empty_cache()

    phase(21, "captured programs: generate's LRU-bounded graphs and the serving program set, "
              "against eager")
    captured_programs_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()

    telemetry_phase(smi)

    phase(23, "the training step as one captured program, against eager: phases 6, 12 and "
              "17's configurations, fp16 with overflows, fp32 bit for bit, forward()")
    captured_training_phase(smi)

    phase(24, "train gpt2-medium bf16 with the training telemetry plane on (trace, "
              "Prometheus, watchdog)")
    training_telemetry_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()

    phase(25, "serve gpt2-medium bf16 with the prefix cache and the host KV tier (the slice's "
              "path), bf16 and int8 pages")
    host_tier_phase(smi, st_3b)
    gc.collect()
    torch.cuda.empty_cache()

    phase(26, "resilience: resume from an async resilient save, crash mid-save, walk-back, "
              "rollback, SIGTERM, serving retries (the slice's path)")
    resilience_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()

    phase(27, "the serving fleet (2 replicas, live session migration over the crc manifest) "
              "under the seeded trace-replay harness (the slice's path), bf16 and int8 pages")
    fleet_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()

    phase(28, "comm/ on NCCL and ZeRO stages 1-3 at world 1 (the slice's path)")
    zero_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()

    phase(29, "tensor-parallel and disaggregated serving placements (the slice's path)")
    placement_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()

    phase("29c", "the fleet over placements: 2 replicas x placement {tp: 2} of gpt2 fp32 in 4 "
                 "processes sharing the card over gloo, r0's live sessions migrated to r1 "
                 "(the slice's path)")
    fleet_placement_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()

    phase(30, "the decoder at Mistral-7B v0.1's width: a forward at S8192 with the sliding "
              "window and greedy generate, GQA 32/8 (the slice's path)")
    flash30, dec30 = decoder_phase(smi)
    gc.collect()
    torch.cuda.empty_cache()

    phase(8, "summary")
    print(f"chip_smoke.py total {time.perf_counter() - t_script:.1f} s (builds included; {smi})")
    # launches: each kernel's (and mode's) count on the path of the slice
    # that ported it (the decode kernel: phase 3's default path; the
    # multi-token kernel: phase 3b's feature path; their int8 modes: phase
    # 3c; the flash kernels: phase 6's training run; the contiguous decode
    # kernel: phase 9's first timed generate; fused AdamW: phase 6's training
    # run; fused LAMB: phase 15's)
    print(json.dumps({"kernels": [{
        "name": "paged_decode_attention",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:185",
        "launches": launches,
        "max_abs_err": errs["main bf16 B8 H16 D64 page16"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }, {
        "name": "paged_decode_attention (int8 pool mode)",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:162",
        "launches": dec8_launches,
        "max_abs_err": i8_errs[i8_main][0],
        "ms": i8_ms,
        "plain_ms": i8_plain_ms,
        "bound_ms": i8_bound_ms,
        "bound_by": i8_bound_by,
        "library_ms": i8_lib_ms,
    }, {
        "name": "paged_multitoken_attention",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_multitoken_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:317",
        "launches": mt_launches,
        "max_abs_err": mt_main_err,
        "ms": mt_ms,
        "plain_ms": mt_plain_ms,
        "bound_ms": mt_bound_ms,
        "bound_by": mt_bound_by,
        "library_ms": mt_lib_ms,
    }, {
        "name": "paged_multitoken_attention (int8 pool mode)",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/paged_multitoken_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:294",
        "launches": mt8_launches,
        "max_abs_err": i8mt_main_err,
        "ms": i8mt_ms,
        "plain_ms": i8mt_plain_ms,
        "bound_ms": i8mt_bound_ms,
        "bound_by": i8mt_bound_by,
        "library_ms": i8mt_lib_ms,
    }, {
        "name": "decode_attention",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_attention.cu",
        "replaces": "deepspeed_tpu/ops/pallas/decode_attention.py:97",
        "launches": gen_launches,
        "max_abs_err": d_main_err,
        "ms": d_ms,
        "plain_ms": d_plain_ms,
        "bound_ms": d_bound_ms,
        "bound_by": d_bound_by,
        "library_ms": d_lib_ms,
    }, {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:262",
        "launches": fwd_launches,
        "max_abs_err": fwd_err,
        "ms": fwd_ms,
        "plain_ms": fwd_plain_ms,
        "bound_ms": fwd_bound,
        "bound_by": fwd_by,
        "library_ms": lib_fwd_ms,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:428",
        "launches": bwd_launches,
        "max_abs_err": bwd_err,
        "ms": bwd_ms,
        "plain_ms": bwd_plain_ms,
        "bound_ms": bwd_bound,
        "bound_by": bwd_by,
        "library_ms": lib_bwd_ms,
    }] + [{
        # the decoder's shapes (phase 30): row 1 with GQA 32/8 and the
        # 4096 window at S8192, row 6 at H32 KV8 D128, with phase 30's launches
        "name": name,
        "route": "cuda",
        "source": f"deepspeed_tpu_torch/csrc/{src}.cu",
        "replaces": replaces,
        **{f: r[f] for f in ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                             "library_ms")},
    } for name, src, replaces, r in (
        ("flash_attention_fwd (decoder GQA 32/8 D128, window 4096)", "flash_attention_fwd",
         "deepspeed_tpu/ops/pallas/flash_attention.py:262", flash30),
        ("decode_attention (decoder GQA 32/8 D128)", "decode_attention",
         "deepspeed_tpu/ops/pallas/decode_attention.py:97", dec30))] + [{
        "name": f"block_sparse_attention_{which}",
        "route": "cuda",
        "source": f"deepspeed_tpu_torch/csrc/block_sparse_attention_{src}.cu",
        "replaces": f"deepspeed_tpu/ops/pallas/block_sparse_attention.py:{line}",
        "launches": counts11[f"block_sparse_attention_{which}"],
        "max_abs_err": max(bs_errs[bs_cases[0][0]][key] for key in outputs),
        "ms": bs_times[bs_cases[0][0], which]["ms"],
        "plain_ms": bs_times[bs_cases[0][0], which]["plain_ms"],
        "bound_ms": bs_times[bs_cases[0][0], which]["bound_ms"],
        "bound_by": bs_times[bs_cases[0][0], which]["bound_by"],
        "library_ms": bs_times[bs_cases[0][0], which]["library_ms"],
    } for which, src, line, outputs in BS_KERNELS] + [{
        # the grouped units at blocks of 16 and 32, at BERT's shape and with
        # phase 12's launches
        "name": f"block_sparse_attention_{which} (blocks 16/32)",
        "route": "cuda",
        "source": f"deepspeed_tpu_torch/csrc/block_sparse_attention_{src}.cu",
        "replaces": f"deepspeed_tpu/ops/pallas/block_sparse_attention.py:{line}",
        "launches": counts12[f"block_sparse_attention_{which}"],
        "max_abs_err": max(bs_errs[bs_cases[1][0]][key] for key in outputs),
        **{f: bs_times[bs_cases[1][0], which][f]
           for f in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
    } for which, src, line, outputs in BS_KERNELS] + [{
        "name": name,
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/fused_adam.cu",
        "replaces": f"deepspeed_tpu/ops/fused_adam.py:{line}",
        "launches": launches14,
        "max_abs_err": errs14[case14][0],
        **times14[kind],
    } for name, line, launches14, case14, kind in (
        ("fused_adamw", 96, adamw_launches, "gpt2-medium tree decoupled", "adam"),
        ("fused_lamb", 187, counts15["fused_lamb"], "lamb bert-large tree", "lamb"))] + [{
        # no pallas_call: the XLA-fused jax.random draws these replace
        "name": "threefry_dropout",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/threefry.cu",
        "replaces": "deepspeed_tpu/models/gpt2.py:251",
        "launches": drop_launches,
        **times16["dropout"],
    }, {
        "name": "threefry_uniform_rows",
        "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/threefry.cu",
        "replaces": "deepspeed_tpu/ops/sampling.py:70",
        "launches": uni_launches,
        **times16["uniform_rows"],
    }]}))
    # the run uses one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
    }}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--phase29-rank":
        # one of phase 29b's two ranks, started by placement_phase
        phase29_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        sys.exit(0)
    if len(sys.argv) > 1 and sys.argv[1] == "--phase29c-rank":
        # one of phase 29c's four ranks, started by fleet_placement_phase
        phase29c_rank(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
        sys.exit(0)
    sys.exit(main())
