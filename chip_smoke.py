#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DOPPLER on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases (any failure exits non-zero, and no result line is printed):

1. device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build: compiles every kernel in ``src/repro_torch/csrc`` with nvcc for
   sm_90a, all sources in parallel; prints each kernel's registers and
   spills (``-Xptxas=-v``).
3. kernels vs their plain versions on the card, each timed with CUDA
   events beside its plain version and, where one PyTorch call computes
   the same function, that call:
   ``gnn_mp`` (max relative error <= 1e-5), the single-direction kernel
   and the pair kernel (both directions of a GNN layer in one launch), at
   the placement path's shapes and on a 2^20-edge random graph, each timed
   with its byte bound (yardstick ``index_add_``, also in device time under
   the profiler, beside an empty kernel's launch);
   ``wc_oracle``'s per-trip kernel ``wc_step`` bit-exact on run_out and e1
   (rho where alive) at the placement shape B=257, R=72, K=8 and random
   shapes with drained, all-dropped and tied rows;
   ``flash_attention`` (2e-5 in fp32, 2e-2 in bf16 and fp16) at zamba2's
   serving shape B=4, S=2048, H=32, d=64 in bf16 and fp32, at gemma-2b's
   B=4, S=2048, H=8, one KV head, d=256 in bf16, and on random GQA, MQA,
   ragged and non-causal shapes with d up to 256 in all three types
   (yardstick ``scaled_dot_product_attention``): bf16 at d 64 and 128 runs
   ``flash_fwd_wgmma``, every other case ``flash_fwd_mma``; the first is
   timed at zamba2's bf16 shape (and ``flash_fwd_mma`` on the same
   inputs), the second in fp32 at zamba2's shape and in bf16 at gemma's;
   ``mamba2_scan`` (y and final state within 1e-4 of max(|ref|, 1)) at
   the serving shape B*H=64, S=2048, N=64, P=256, chunk 256 (with and
   without an initial state) and on P and chunk 100, N 50, S 1, q and k
   shared over heads or per head, and random ragged shapes; one call runs
   four kernels (``ssd_qk_scores``, ``ssd_chunk_state``,
   ``ssd_state_pass``, ``ssd_chunk_y``), each timed in device time under
   the profiler, beside the fp32 bound and the tensor-core bound of the
   work the design issues (xLSTM's shape, N 1024, is path 13's).
4. placement path: three placement requests through ``DopplerTrainer(...,
   device="cuda")`` at the policy's published width (d_hidden 64, d_z 32,
   d_y 32, 2 GNN layers, random weights from a seed): one ``gnn_mp`` pair
   launch per GNN layer (2 per request) and none of the single-direction
   kernel; greedy plus 256
   samples at eps 0.2, scored in one oracle batch: exactly one launch of
   ``wc_oracle``'s ``wc_trips`` (every trip of every episode) and none of
   ``wc_step`` per request.  The population's makespans with the kernel
   equal the plain oracle's on the card; on the small request they also
   equal the CPU oracle's and the card's encodings agree with the CPU's.
   Then ``wc_trips`` bit-equal (ms, n_done) to its plain version, the trip
   loop, on the three requests' candidate batches, random assignments on
   every workload x fleet preset, a fan-out of 70, one device, a batch of
   one and a deadlocked batch, in both placements of its state (shared
   memory, global scratch; llama_layer x tpu_v5e_16x16 takes the scratch
   by itself), timed at llama_layer's batch against the plain loop.  Then
   one more ``llama_layer`` request under ``torch.profiler``.
5. serving path: zamba2-1.2B at full width (38 layers, d_model 2048, vocab
   32,000; random seed-0 weights in bf16) through
   ``repro_torch.launch.serve``'s functions: batch 4 x prompt 2048, then 32
   greedy tokens.  One prefill must launch ``flash_attention`` 6 times, all
   of them ``flash_fwd_wgmma`` and none ``flash_fwd_mma`` (launch
   counters and profiler), and
   ``mamba2_scan`` 32 times: each of its four kernels 32 times under the
   profiler, the old ``ssd_chunk_scan`` never.  The kernel path's logits
   (prefill and 32 teacher-forced decode steps) agree with the plain
   path's on the card, in bf16 over 38 layers and in fp32 over one
   full-width 6-layer unit; beside the fp32 38-layer gate, both paths'
   error against the plain path run in float64 is printed, and the gate's
   reading with only one of the two kernels on the kernel path.
   Prints prefill s, decode ms per step, tokens per second and peak
   memory; then one more prefill and one decode step under
   ``torch.profiler``.
6. serving path: gemma-2b at full width and depth (18 layers, d_model
   2048, 8 heads, one KV head, head_dim 256, vocab 256,000; random seed-0
   weights in bf16, ~2.5e9 parameters) through the same functions: batch 4
   x prompt 2048, then 32 greedy tokens.  One prefill must launch
   ``flash_attention`` 18 times, all of them ``flash_fwd_mma`` (launch
   counters and profiler).  The kernel path's logits agree with the plain
   path's on the card: in bf16 over 18 layers, on each of GEMMA_BF16_SEEDS
   no further than the plain path's own bf16-vs-fp32 gap; in fp32 over 18
   layers at batch 1 x prompt 2048 within LOGITS_TOL, both paths' error
   against the plain path in float64 printed beside it.  Prints prefill s,
   decode ms per step, tokens per second and peak memory; then one more
   prefill under ``torch.profiler``.
7. training path: ``DopplerTrainer(...)`` on the card at the policy's
   published width on llama_layer x v100x8 (n 252, m 364, nd 8; random
   seed-0 weights): ``stage1_imitation`` (4 episodes of the CRITICAL-PATH
   teacher, run as 1 + 3), ``train_rl`` over the trainer's default engine
   (3 REINFORCE updates of 16 episodes, run as 1 + 2; every reward batch
   one ``wc_trips`` launch) and one ``stage2_sim_batched`` update on the
   numpy ``WCSimulator``.  Each episode and update encodes with the
   ``gnn_mp`` pair (one launch a GNN layer) and replays its actions under
   autograd (the pair's backward is the gather, as in the reference).  A
   hard gate holds the first episode and the first update against a twin
   trainer on the plain backends, on the card, started from the same
   params and generator state: the same actions, rewards bit-identical,
   losses within 1e-5 relative, each gradient leaf within 5e-6 of
   max(1, max|g|), params after the AdamW step within 5e-3.  Prints the
   seconds per episode and per update by phase, the launches per episode
   and update, the losses, the makespans per update and peak memory; then
   one more update under ``torch.profiler`` (device launches, busy share).
8. fused training path: the same request through ``stage1_imitation_fused``
   and ``stage2_fused`` (``core/train_fused.py``), each update one CUDA
   graph replay: Stage I 64 episodes (the first gated against an eager
   twin on the plain backends, from one state), Stage II 64 updates at K
   16, 8 a dispatch (the first on injected draws, gated against the plain
   eager fused twin and against path 7's non-fused ``train_rl`` on the
   same draws from the same state: actions identical, rewards
   bit-identical, advantages within 1e-6 of the rewards, gradients 5e-6
   of max(1, max|g|), and the fused loss within 1e-4 relative of the
   forced replay's on the same advantages);
   one chunked dispatch (chunks of 8, gradient chunks of 4) against the
   monolithic update from the same state (makespans bit-identical,
   gradients 1e-6, params 5e-3); a ``SimGraph`` doctored to ``n_trips=1``
   must raise from a captured dispatch.  The kernel launches a capture
   records (one update's: 2 ``gnn_mp`` pair a Stage I update; 4 pair and
   1 ``wc_trips`` a Stage II update; 10 and 2 chunked) are checked, and
   one profiled dispatch shows the launches replayed.  Prints seconds per
   update beside path 7's, warm-up and capture seconds, the training
   record (batch-mean makespans of the first and last 8 updates, best,
   CP) and peak memory.
9. Stage III path (the paper's full pipeline on the card), on the same
   request: the work-conserving executor (``core/executor.py``) at
   ``flops_scale = bytes_scale = 1`` with 8 logical devices, each its own
   CUDA stream on the one card.  Gates: an untimed debug replay under the
   CRITICAL-PATH and a round-robin assignment has every edge p -> v in
   dependency order on the card's clock (``end_p.elapsed_time(start_v)
   >= 0``), its steps on the executor's 8 streams, and every output
   constant and within 1e-4 relative of its closed form (float64, by
   walking the plan); two independent chains of 16 fp32 products at side
   1,024 take at most 0.9 of their one-stream device span on two
   streams, each stream first held 10 ms by a sleep kernel while the
   host enqueues (the spans without the head start printed beside it).
   Then ``calibrate_fleet(v100x8, executor_measure(8, repeats=3))`` (the
   fitted overheads, rates, link bandwidths, residuals and seconds), and
   on the calibrated fleet ``stage1_imitation_fused`` (16 episodes),
   ``stage2_fused`` (16 updates at K 16, 8 a dispatch: a new capture),
   ``stage3_system_batched`` (4 updates at K 8, 3 repeats, over
   ``ExecutorRewardEngine``) and one serial ``stage3_system`` episode.
   The first Stage III update is gated against a plain-backend twin from
   the same state and draws whose reward engine replays the measured
   times: actions identical, losses 1e-5 relative, gradients 5e-6 of
   max(1, max|g|) over the whole gradient, params 5e-3.  Prints seconds
   an update by phase, the executor-measured record (median of 5 runs
   each of CP, greedy and the best Stage III assignment: wall ms, host
   dispatch ms and the calibrated twin's ms), peak memory, and one
   profiled ``execute_batch`` (device launches, streams, busy share).
   The ``gnn_mp`` pair and ``wc_trips`` must launch on this path.
10. checkpoints and the paper's baselines, on the same request.  Resume
   on the fused path with the capture kept: trainer A runs RESUME_UPDATES
   ``stage2_fused`` updates at K 16, ``save_policy``, then RESUME_UPDATES
   more; trainer B (another seed) first runs one fused update, so its
   CUDA graph exists, then ``load_policy`` and the same updates: B's
   makespans bit-identical to A's, params and both moments bit-equal, the
   greedy assignment and the generator state equal, and B's next
   dispatches replays of its one graph.  The same for one non-fused
   ``train_rl`` update.  A CPU trainer's checkpoint restores onto the
   card with params bit-equal, and ``load_policy`` raises ``ValueError``
   for its generator (expected, caught by type).  Then GDP_EPISODES
   ``GDPTrainer`` and PLACETO_EPISODES ``PlacetoTrainer`` episodes on the
   ``gnn_mp`` pair, the first of each gated against a plain-backend twin
   from the same params and generator state at path 7's bars, with the
   pair's launches exact (one a GNN layer a forward: GDP 2 a rollout,
   Placeto 2·n, the replay as many again); ``enumerative_assignment`` on
   the host; then CRITICAL-PATH, EnumOpt, the GDP and Placeto bests and
   DOPPLER's greedy assignment scored in one ``wc_trips`` launch,
   bit-equal to the plain trip loop.  Prints the checkpoint's bytes and
   save / load seconds, seconds an episode by phase, peak memory, the
   host seconds of EnumOpt and the five makespans (random weights: no
   quality claim).
11. hierarchical placement and re-placement (``DopplerTrainer(...,
   hierarchy=HIER_CFG)``, the reference's fig-6 setting: 64 segments, 3
   refinement rounds, top-k 24) on ``v100x8`` at the policy's published
   width.  ``wc_trips`` bit-equal to the plain trip loop on a
   ``synthetic_layered(32, 16)`` refine batch in both placements.  On
   ``synthetic_layered(256, 16)`` (n 4,113, two levels): fused Stage I
   (HIER_S1 episodes) and Stage II (HIER_S2 updates at K 16, one a
   dispatch, each update's segment-level batch re-scored bit-equal by the
   plain trip loop), one ``train_rl`` update over flat rewards
   (``ExpandingEngine`` on the flat oracle), ``place(refine=True)``,
   ``replace`` for a device loss, a straggler and a link degradation
   without commit (budget 5 s) and the loss committed, after which
   HIER_AFTER fused updates are bit-identical (makespans, params,
   moments) to a fresh 7-device trainer's from the same state.  On
   ``synthetic_layered(4096, 16)`` (n 65,553, three levels, random
   weights): coarsen and ``place(refine=True)``.  Each ``place()``: one
   ``wc_trips`` launch an engine call, its makespan bit-equal to a
   one-row re-scoring, at most every expanded segment-CP candidate's,
   refinement monotone; after the loss no vertex on a device >= 7 and
   makespan <= CP.  Prints coarsen seconds and segment sizes, seconds of
   each stage and phase, refinement rounds, moves and rows, ``replace``
   latency, source and budget, a refine batch's ``wc_trips`` per-call
   and device ms, bound and scratch at both sizes, the largest gap to
   the float64 numpy ``WCSimulator`` at 4,113 (no bar), peak memory.
12. pretraining, zero-shot serving, ``FleetTrainer`` and the training
   CLI at the policy's published width.  12a: ``pretrain`` over the
   synthetic half of the zoo (``zoo_pretrain_tasks(holdout=ARCH_IDS,
   n_synthetic=4)``) and PRETRAIN_EXTRA (7 tasks), PRETRAIN_S1 imitation
   passes and PRETRAIN_ROUNDS rounds at K PRETRAIN_K (2 ``gnn_mp`` pair
   launches a pass, 4 an update, nothing else); its first Stage II
   update re-run from the same state on a kernel-backend and a
   plain-backend trainer at path 7's gate; every task's best time
   finite; ``save_pretrained`` -> ``load_pretrained`` bit-equal.  12b: a
   ``PlacementServer`` over those params on SERVE_CELLS (``llama_layer``,
   which pretraining never saw, on four fleets): a miss (2 pair
   launches, no oracle launch), a hit (no launch) and SERVE_HITS hits
   (p50, p99); served <= min(CP seeds 0, 1) and re-scored exactly by
   ``WCSimulator.run``; the card's ``greedy_place`` equal to the CPU's;
   ``from_checkpoint`` serving the same assignment; one fine-tuned miss
   (SERVE_FT_BUDGET_S) on a fresh server at most the zero-shot makespan.
   12c: ``FleetTrainer`` on FLEET_BLOCKS (episodes and stages checked).
   12d: ``doppler_train.main`` in this process for each of CLI_RUNS
   (executor + calibration + fused engine + trace, a resume on the
   oracle, Stage II under the supervisor with a device loss, a
   hierarchical run): a checkpoint after every stage that ran, the
   resume at run 1's final episode, the trace one event a compute
   vertex, one recovery and a 3-device fleet with no vertex on the lost
   device.  Prints seconds an imitation pass and an update by phase,
   the miss split (greedy, CP, scoring), hit percentiles, the CLI's own
   lines, each run's trainer seconds and the executor's wall and host
   dispatch ms.  The pair must launch in 12a, 12b and 12d and
   ``wc_trips`` in 12d; no single-direction ``gnn_mp`` or ``wc_step``.
   While each part runs, ``_KernelLog`` keeps the first pair launch at
   each (n, m, d), every ``wc_trips`` launch's inputs and outputs, and
   each replayed fused Stage II update's batch; after it, every entry is
   held against the plain version (the pair at GNN_REL_TOL, ``wc_trips``
   bit for bit in every placement), and every ``wc_trips`` launch the
   part counted must be logged or a capture whose replays were.
   On each path the launch counts are reset just before it is driven and
   read just after (checks against plain versions and timings excluded);
   every Pallas kernel must have a port that launched on its path.
13. serving path, run right after item 14: xlstm-1.3b at full width
   over XLSTM_SERVE_LAYERS = 24 of its 48 layers (21 mLSTM and 3 sLSTM
   blocks, d_model 2048, vocab 50,304; random seed-0 weights in bf16).  First
   ``mamba2_scan`` against its plain version at xLSTM's mLSTM prefill
   shape (B 4, S 2048, H 4, N = P = 1024 a head, 1025 columns of v with
   the normalizer channel, chunk 256, q and k per head) with and without
   an initial state and on ragged shapes past one tile of N (N 100-1024, P
   33-1025), timed by pass beside the fp32 and tensor-core bounds.  Then
   batch 4 x prompt 2048, 32 greedy tokens through
   ``repro_torch.launch.serve``'s functions: one prefill must launch
   ``mamba2_scan`` 21 times and ``flash_attention`` never, by the
   wrappers' counts, in the served prefill and in the profiled one, whose
   profile must hold each of the scan's four kernels.  Logits gates at
   zamba2's bars: bf16 over the 24 layers on each of XLSTM_BF16_SEEDS no
   further from the plain path than its own bf16-vs-fp32 gap; fp32 over
   one full-width unit (XLSTM_UNIT_LAYERS, 7 mLSTM + 1 sLSTM) within
   LOGITS_TOL, both paths' error against the plain path in float64
   printed beside it.  Prints prefill s, decode ms a step, tokens per
   second, peak memory, the sLSTM loop inside served prefills (its 3
   blocks' calls timed between syncs; the first block's launches under
   the profiler), and one prefill and one decode step under
   ``torch.profiler``.
14. serving path, run right after item 6, before item 13 (whose
   profiled prefill leaves later profiler sessions without kernel
   records): granite-moe-3b-a800m (32
   layers, 40 experts top-8), qwen3-moe-235b-a22b (full width, 128
   experts top-8, 2 of its 94 layers), musicgen-large (48 layers, frame
   embeddings in, fresh frames each decode step) and paligemma-3b (18
   layers, 256 patch embeddings in front of the prompt: 2,304 positions)
   at full width with random seed-0 weights in bf16, each batch 4 x
   prompt 2048, 32 greedy tokens through ``repro_torch.launch.serve``'s
   functions.  First ``flash_attention`` against its plain version at each
   config's prefill shape (bf16 at batch 4, fp32 at batch 1) and timed
   there in bf16 (``flash_fwd_wgmma`` at d 128 for qwen3-moe, at d 64 with
   8 KV heads for granite, ``flash_fwd_mma`` over 2,304 positions for
   paligemma).  One prefill must launch ``flash_attention`` once a layer,
   all ``flash_fwd_wgmma`` (granite 32, qwen3-moe 2, musicgen 48) or all
   ``flash_fwd_mma`` (paligemma 18), and ``mamba2_scan`` never, by the
   wrappers' counts.  Logits gates: bf16 over the full depth no further
   from the plain path than its own bf16-vs-fp32 gap (seed 0); fp32 at
   batch 1 over the full depth within LOGITS_TOL, the fp64 reading beside
   it (not for qwen3-moe), the MoE configs' plain runs forced onto the
   kernel run's expert choices (printed: how many choices the plain run
   would have made otherwise, and their smallest probability gap).
   Prints prefill s, decode ms a step, tokens per second, peak memory,
   and for the MoE configs the share of assignments dropped past an
   expert's capacity in a prefill and a decode step; then one profiled
   prefill and decode step of granite and paligemma (device ms by
   kernel and by kind: flash, gemm, sort, gather / scatter, ...).
15. LM training, run right after item 14, before item 13, through
   ``models/steps.py``'s ``make_train_step`` (``lm_loss`` ->
   ``model_apply(mode="train")`` -> clip 1.0 -> AdamW): on CUDA the flash
   and scan kernels run forward inside their ``autograd.Function``s and
   the plain versions' gradients backward.  15a: zamba2-1.2B at full
   width and depth (38 layers, f32 params, bf16 compute, remat: each
   repetition of the unit under activation checkpointing), batch 4 x seq
   2048 of ``SyntheticTokenStream`` (seed 0), 8 steps at
   ``cosine_schedule(3e-4, 3e-5, 8, warmup=1)``.  Gates: (i) step 0's
   gradients on the kernel backends against the plain backends, each
   leaf's gap over its max within the plain path's own bf16-vs-fp32 gap
   (its largest over the leaves; the largest share of the same leaf's
   own gap printed beside it); (ii) the same in fp32 over one 6-layer
   unit, within 1e-4 of each leaf's max; (iii) the loss on step 0's
   batch after the 8 steps below step 0's; (iv) every loss and gradient
   finite.  The
   wrappers' counts: 12 ``flash_fwd_wgmma`` and 62 ``mamba2_scan``
   launches a step (the unit's 30 Mamba2 blocks and 6 shared attentions
   twice under remat, the 2 remainder blocks once).  Prints each step's
   loss, grad norm and seconds, tokens per second and peak memory, a
   profiled step's device split, the kernels' forwards' share of it and
   the plain backward recompute's (each Function's backward in device
   time under the profiler).  15b: one step each of gemma-2b (1 layer,
   ``flash_fwd_mma`` at d 256), xlstm-1.3b (one 8-layer unit: the scan at
   N 1024 and the sLSTM loop under autograd), granite-moe (2 layers),
   musicgen (2) and paligemma (2, the 256 patches) at full width, batch
   1 x seq 512, gate (i) and the fp32 gate (1e-4 of each leaf's max) on
   each, launches checked; xlstm's gradients are ill-conditioned at
   random init (PATH15B_CALIBRATED), so its fp32 gate's bar is what the
   plain path's gradient moves under scan outputs perturbed within
   SSD_TOL, and its gate (i) is printed.
16. serving and the LM training driver, run right after item 15, before
   item 13: 16a serves olmo-1b (16 layers, non-parametric LayerNorm, tied
   head, H = KV 16), phi4-mini-3.8b (32 layers, GQA 24/8, a tied
   vocabulary of 200,064) and qwen1.5-110b (full width, QKV bias, rope
   theta 1e6, untied head; 4 of its 80 layers) with path 14's request and
   gates (the fp64 reading not for qwen1.5), ``flash_attention`` first
   held against its plain version and timed at each prefill shape; one
   prefill launches ``flash_fwd_wgmma`` (d 128) once a layer: 16, 32 and
   4; phi4's prefill profiled.  16b: ``repro_torch.launch.train.main``
   in-process, olmo-1b at full width and depth (f32 params, bf16 compute,
   remat), batch 4 x seq 2048, 8 steps: every loss and grad norm finite,
   32 ``flash_fwd_wgmma`` launches a step (16 forwards, 16 remat reruns);
   the driver's resume at full width over one layer (batch 1 x seq 512,
   4 steps, a checkpoint every 2 in a temporary directory): step 3 set
   aside, the run again resumes from step 2, and the two step-3
   ``arrays.msgpack`` are the same bytes; one step through
   ``make_int8_grad_transform`` (one layer, fp32) on the card against the
   same step on the CPU copy of its inputs at the LM training tests' step
   bars (tests/test_torch_lm_train.py; a code may differ only where the
   CPU's clipped gradient lies within the gradient gap of a rounding
   boundary).
17. the model-zoo graph importer, run right after item 16, before item
   13: 17a imports every registry config's ``model:<arch>`` layer (seq
   256) on the host from fake tensors: n, m, flops by kind and seconds
   printed, a second import identical, the dense configs' matmul flops
   equal to their closed form; 17b places ``model:olmo_1b`` and
   ``model:zamba2_1p2b`` on ``v100x8`` (``DopplerTrainer.place``, 64
   sampled episodes): 2 pair launches and 1 ``wc_trips`` launch a
   request, the makespans bit-equal to the CPU oracle's, the encodings
   within 1e-4 of the CPU's, greedy / best / CP printed; 17c places
   ``model:olmo_1b:full`` (seq 256, 2 microbatches) through the
   hierarchy (path 11's gates), then one refine batch at its placement
   bit-equal to the plain trip loop; 17d runs ``place_server.main`` with
   its defaults, the first pair launch at each shape held against the
   plain version.
18. the sizing dry-run (``launch/dryrun.py``), run right after item 17,
   before item 13: 18a sizes six (arch x shape x mesh) cells at full
   width and depth on a fake process group of 256 or 512 ranks, each
   through the CLI in a process of its own, all started together before
   item 17 at the lowest priority (olmo-1b train_4k, qwen1.5-110b train_4k, qwen3-moe train_4k on two
   pods, granite-moe prefill_32k, gemma-2b decode_32k, zamba2-1.2B
   long_500k): per-device argument and temp-peak GB, flops, bytes,
   collective bytes by kind, the three roofline terms at the H100's
   data-sheet peaks, the dominant one, the roofline fraction and the
   trace seconds; a cell that ends past PATH18A_BUDGET_S is recorded.
   18b sizes the one-card mesh at the shapes 15a, 16a and 16b ran (batch
   4 x 2,048: zamba2 train, olmo-1b prefill and train) in another such
   process (the prefill again in this one: fake tensors launch no
   kernel, checked, and it sizes alike) and prints the predicted
   argument bytes, peak and roofline bound beside the measured peak,
   seconds and model-flops utilisation; the train steps' predicted
   params + AdamW + batch bytes are held within 1% of what the card
   allocates for them.
19. the data-parallel fused Stage II and remat "dots", run last: 19a
   starts a one-rank NCCL process and two gloo ranks (processes of
   their own on the one card: NCCL takes one rank a GPU) on
   ``llama_layer`` x ``v100x8`` at K 16 and the policy's published
   width: the ranks run 4 eager data-parallel updates on numpy draw
   tables, each timed, the all-reduce's share read from its wrapped
   wall time, 4 ``gnn_mp`` pair launches and 1 ``wc_trips`` a rank an
   update; every rank's result bit-equal; the single-device engine from
   each update's state on the same tables gives the same actions and
   makespans (update 0 also on the plain backends); each update's loss
   and reduced gradient against the forced replay of its actions on its
   advantages (path 5's bars) and its AdamW step within lr / 100.  The
   NCCL process captures the engine over its one-rank group (the
   collectives inside the CUDA graph), bit-equal to the captured
   single-device engine, both timed.  19b, beside 19a's set-up: olmo-1b
   at full width and depth, batch 4 x 2,048: step 0's gradients under
   remat "dots" on the kernels against the plain backends at 15a's bar,
   against "full" within 1e-5 (loss) and that bar; then 2 steps under
   "dots" and 1 under "full" from the same state (``flash_fwd_wgmma`` 32
   a step under both), seconds and peak GB each.
   Path 18a's olmo-1b train_4k x pod cell is held to the CPU's sizing:
   temp within 1%, memory-bound, no operator run replicated.
20. sharded LM training, run last (``path20``): 20a calls
   ``flash_attention`` and ``ssd_scan`` on CUDA DTensors split over the
   heads of a (1, m) mesh, each rank in turn on a fake group: olmo's
   attention shape (16 heads = KV, m 4) and qwen3-moe's (64 over 4 KV
   heads, m 16: the KV heads replicated, each rank taking the KV head
   its query heads map to) on ``flash_fwd_wgmma``, gemma's (one KV head)
   on ``flash_fwd_mma``, zamba2's scan shape on ``mamba2_scan``: every
   rank's output bit-equal to the heads it owns of the one-device call.
   20b: olmo-1b at full width and depth (f32 params, bf16 compute,
   remat), batch 4 x 2,048, 2 steps of ``launch/train.py::train_loop``
   unsharded and over a one-rank NCCL group's (1, 1) mesh from the same
   params: losses and params bit-equal (else within 1e-6), 32
   ``flash_fwd_wgmma`` a step under both, no operator run whole.  20c:
   granite-moe at full width over 2 layers, batch 1 x 512, loss, aux and
   gradients under ``dispatch="shard_map"`` on that mesh against the
   gspmd plan unsharded: bit-equal, else within path 15b's bar.
21. prints the ``kernels`` JSON line and, last, the result line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import filecmp
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.registry import (ARCH_IDS, ShapeCell,  # noqa: E402
                                          get_config)
from repro_torch.core.assign import build_graph_data, encode  # noqa: E402
from repro_torch.core.calibrate import (calibrate_fleet,  # noqa: E402
                                        executor_measure)
from repro_torch.core.device import sync  # noqa: E402
from repro_torch.core.devices import (PRESETS,  # noqa: E402
                                      FleetEvent, get_device_model,
                                      uniform_box)
from repro_torch.core.graph import DataflowGraph  # noqa: E402
from repro_torch.core.engine import (CallableEngine,  # noqa: E402
                                     ExecutorRewardEngine, RewardEngine)
from repro_torch.core.enumopt import enumerative_assignment  # noqa: E402
from repro_torch.core.executor import WCExecutor  # noqa: E402
from repro_torch.core.gdp import GDPTrainer  # noqa: E402
from repro_torch.core.heuristics import (  # noqa: E402
    critical_path_assignment, round_robin_assignment)
from repro_torch.core.hierarchy import (ExpandingEngine,  # noqa: E402
                                        HierarchyConfig, propose_moves)
from repro_torch.core.nn import (tree_leaves, tree_map,  # noqa: E402
                                 value_and_grad)
from repro_torch.core.placeto import PlacetoTrainer  # noqa: E402
from repro_torch.core.policy_io import (load_policy,  # noqa: E402
                                        load_pretrained, save_policy,
                                        save_pretrained)
from repro_torch.core.sim_torch import (SimGraph,  # noqa: E402
                                        TorchWCEngine, makespan_fifo_batch,
                                        trip_inputs)
from repro_torch.core.simulator import WCSimulator  # noqa: E402
from repro_torch.core import sim_torch  # noqa: E402
from repro_torch.core.train_fused import FusedStage2  # noqa: E402
from repro_torch.core.training import (DopplerTrainer,  # noqa: E402
                                       FleetTrainer, PretrainTask,
                                       _pg_loss_and_grad_batch, pretrain,
                                       zoo_pretrain_tasks)
from repro_torch.core.zero_shot import (greedy_place,  # noqa: E402
                                        to_numpy_params)
from repro_torch.graphs import model_zoo  # noqa: E402
from repro_torch.graphs.workloads import (WORKLOADS,  # noqa: E402
                                          get_workload, synthetic_layered)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_ref  # noqa: E402
from repro_torch.kernels.gnn_mp import ops as gnn_ops  # noqa: E402
from repro_torch.kernels.gnn_mp.ref import (build_csr,  # noqa: E402
                                            segment_sum_pair_ref,
                                            segment_sum_ref)
from repro_torch.kernels.mamba2_scan import ops as ssd_ops  # noqa: E402
from repro_torch.kernels.mamba2_scan.ref import ssd_scan_ref  # noqa: E402
from repro_torch.kernels.wc_oracle import ops as wc_ops  # noqa: E402
from repro_torch.kernels.wc_oracle.ref import (wc_step_ref,  # noqa: E402
                                               wc_trips_ref)
from repro_torch.launch import doppler_train  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import place_server  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.launch.mesh import (destroy_sizing_mesh,  # noqa: E402
                                     make_sizing_mesh)
from repro_torch.launch.place_server import PlacementServer  # noqa: E402
from repro_torch.launch.serve import (generate, load_model,  # noqa: E402
                                      prompt_inputs, prompt_positions,
                                      prompt_tokens)
from repro_torch.models import mlp as moe_mlp  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.steps import (make_decode_step,  # noqa: E402
                                      make_eval_step, make_prefill_step,
                                      make_train_step)
from repro_torch.models.transformer import init_decode_state  # noqa: E402
from repro_torch.train.checkpoint import (latest_step,  # noqa: E402
                                          restore_checkpoint)
from repro_torch.train.compression import (  # noqa: E402
    int8_quantize, make_int8_grad_transform)
from repro_torch.train.data import (DataConfig,  # noqa: E402
                                   SyntheticTokenStream)
from repro_torch.train.optim import (AdamState, adamw_init,  # noqa: E402
                                     cosine_schedule)

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12            # outside the tensor cores
BF16_FLOP_PER_S = 989e12           # tensor cores, dense
TF32_FLOP_PER_S = 495e12           # tensor cores, dense
K_POP = 256
EPS = 0.2
REQUESTS = [("llama_layer", "v100x8"), ("llama_block", "mixed_gen4"),
            ("ffnn", "p100x4")]
GNN_REL_TOL = 1e-5
# the serving requests: zamba2-1.2B and gemma-2b at full width, random
# seed-0 weights
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "zamba2_1p2b", 4, 2048, 32
GEMMA_ARCH = "gemma_2b"
# path 13: xlstm-1.3b at full width and depth, the same request; its fp32
# gate and fp64 reading over one full-width unit (7 mLSTM + 1 sLSTM):
# fp32 and fp64 copies of all 48 layers would take 13.7 and 27 GB
XLSTM_ARCH, XLSTM_UNIT_LAYERS = "xlstm_1p3b", 8
# path 13 serves xlstm-1.3b over its first 24 of 48 layers (3 of its 6
# 8-layer units: 21 mLSTM + 3 sLSTM), a depth cut that keeps
# every gate (the full 48 layers took 123-187 s of the script)
XLSTM_SERVE_LAYERS = 24
# kernel vs plain: tests/test_kernels.py's bars (flash: atol = rtol =
# 2e-5 in fp32, 2e-2 in bf16 and fp16; mamba2_scan: 1e-4 of max(|ref|, 1))
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
SSD_TOL = 1e-4
# kernel path vs plain path, logits scaled by max(|plain|, 1).  fp32: the
# kernels agree to summation order, within LOGITS_TOL.  bf16 over 38 random
# layers: a one-ulp flip anywhere grows, so the bar of each seed in
# BF16_SEEDS is the plain path's own gap between its bf16 and its fp32
# logits on the same weights: the kernels may move the logits no more
# than bf16 itself does (PERF.md)
LOGITS_TOL = 1e-4
BF16_SEEDS = (0, 1, 2, 3)
GEMMA_BF16_SEEDS = (0, 1)
# xlstm-1.3b's 48-layer bf16 gate loads a 13.7 GB fp32 copy and serves
# again for each seed: two, as gemma's (the 8-layer fp32 gate and the
# kernel phase hold the kernel at 1e-4)
XLSTM_BF16_SEEDS = (0, 1)
# path 14: the MoE and stub-frontend configs at full width, the same
# request; per config the layers served and the flash kernel its bf16
# prefill runs, one launch a layer.  qwen3-moe at full width over 2 of its
# 94 layers: 94 hold ~470 GB of bf16 weights, one card 80.  The fp32 gates
# at batch 1 over the full depth, the fp64 reading beside them but for
# qwen3-moe (its fp64 copy would take 50 GB); the MoE configs' plain runs
# forced onto the kernel run's expert choices (an fp32 near-tie flips a
# top-k choice, and a flip moves a token by O(1)).  PATH14_PROFILED get a
# profiled prefill
PATH14 = {"granite_moe_3b_a800m": (32, "flash_fwd_wgmma"),
          "qwen3_moe_235b_a22b": (2, "flash_fwd_wgmma"),
          "musicgen_large": (48, "flash_fwd_wgmma"),
          "paligemma_3b": (18, "flash_fwd_mma")}
PATH14_NO_FP64 = ("qwen3_moe_235b_a22b",)
PATH14_PROFILED = ("granite_moe_3b_a800m", "paligemma_3b")
# path 15: LM training through make_train_step.  15a: zamba2-1.2B at full
# width and depth (f32 params, bf16 compute, remat), TRAIN15_STEPS steps
# on SyntheticTokenStream's batches (seed 0) at cosine_schedule(
# *TRAIN15_LR); step 0's gradients gated against the plain backends in
# bf16 (each leaf within the plain path's own bf16-vs-fp32 gap, its
# largest over the leaves: one rounding flip of an attention output
# moves a leaf as far as bf16 itself does, so a leaf's own gap is no
# bar) and in fp32 over one 6-layer unit (LOGITS_TOL of each leaf's
# max).  15b: one step a family at full width over PATH15B's layers,
# batch PATH15B_BATCH x PATH15B_SEQ, both gates.  qwen3-moe trains on
# the CPU only: 2 of its 94 layers hold 6.2e9 params, ~100 GB with
# gradients and AdamW moments in f32
TRAIN15_ARCH, TRAIN15_BATCH, TRAIN15_SEQ, TRAIN15_STEPS = \
    "zamba2_1p2b", 4, 2048, 8
TRAIN15_LR = (3e-4, 3e-5, TRAIN15_STEPS, 1)
PATH15B = {"gemma_2b": 1, "xlstm_1p3b": 8, "granite_moe_3b_a800m": 2,
           "musicgen_large": 2, "paligemma_3b": 2}
PATH15B_BATCH, PATH15B_SEQ = 1, 512
# xlstm-1.3b's 8-layer unit has ill-conditioned gradients at random init:
# forward differences of ~1e-6 moved its fp32 gradients by 4.3e-4 of a
# leaf's max on the card, and bf16 moves them by more than the leaf's max
# (median over leaves 1.08; PERF.md), so neither fixed bar tells a right
# kernel from a wrong one there.  Its fp32 gate is calibrated instead:
# within what the plain path's gradient moves when its scans' outputs are
# perturbed within the kernel's own forward bar (SSD_TOL of max(|y|, 1));
# gate (i) is printed beside it
PATH15B_CALIBRATED = ("xlstm_1p3b",)
# path 16a: the three dense configs no other path serves, path 14's
# request and gates; per config the layers served and the flash kernel
# its bf16 prefill runs (d 128 in all three).  qwen1.5-110b at full width
# over 4 of its 80 layers: a layer holds 1.36e9 params (2.7 GB of bf16),
# 80 do not fit one card; 4 hold 7.9e9 with the two vocabulary matrices
# (16 GB of bf16, 32 GB for the fp32 gate's copy: no fp64 reading)
PATH16 = {"olmo_1b": (16, "flash_fwd_wgmma"),
          "phi4_mini_3p8b": (32, "flash_fwd_wgmma"),
          "qwen1p5_110b": (4, "flash_fwd_wgmma")}
PATH16_NO_FP64 = ("qwen1p5_110b",)
PATH16_PROFILED = ("phi4_mini_3p8b",)
# path 16b: the LM training driver (launch/train.py) in-process, olmo-1b
# at full width and depth (f32 params, bf16 compute, remat), no
# checkpoint; then its resume at full width over one layer (a ~2 GB
# checkpoint in a temporary directory), unbroken against resumed bit for
# bit; then one step through the int8 gradient transform on the card
# against the same step on the CPU copy of its inputs (fp32, one layer),
# at the LM training tests' step bars (tests/test_torch_lm_train.py), the
# gradient gap widened by one int8 code where the CPU's clipped gradient
# lies within the gap of a rounding boundary
TRAIN16_ARCH = "olmo_1b"
TRAIN16_ARGV = ["--arch", TRAIN16_ARCH, "--batch", "4", "--seq", "2048",
                "--steps", "8", "--log-every", "1"]
RESUME16_ARGV = ["--arch", TRAIN16_ARCH, "--batch", "1", "--seq", "512",
                 "--steps", "4", "--ckpt-every", "2", "--log-every", "1"]
INT8_BATCH, INT8_SEQ = 1, 512
# path 18: the sizing dry-run (launch/dryrun.py) on the card's host.
# 18a: six (arch x shape x mesh) cells at full width and depth on the
# fake process group, each in a process of its own (the CLI), started
# together before path 17 at the lowest priority, so the host's idle
# cores run them beside it (PATH18A_BUDGET_S for the six from their
# start: a cell past it is recorded, to drop from the end of the list);
# 18b: the one-card mesh at the shapes
# paths 15a, 16a and 16b measure (batch 4 x 2,048), its predictions
# printed beside their measurements, the argument bytes (params + AdamW
# + batch) of the train steps held within ARGS18_TOL of what the card
# allocates for them
PATH18A_CELLS = (("olmo_1b", "train_4k", "pod"),
                 ("qwen1p5_110b", "train_4k", "pod"),
                 ("qwen3_moe_235b_a22b", "train_4k", "multipod"),
                 ("granite_moe_3b_a800m", "prefill_32k", "pod"),
                 ("gemma_2b", "decode_32k", "pod"),
                 ("zamba2_1p2b", "long_500k", "pod"))
PATH18A_BUDGET_S = 60.0
# a cell's temp GB a device and dominant term as the CPU sizes it
# (``python -m repro_torch.launch.dryrun --arch olmo_1b --shape train_4k
# --mesh pod``, torch 2.13): the card (another torch) must read the same,
# within PATH18A_CPU_TOL, with no operator run replicated
PATH18A_CPU = {("olmo_1b", "train_4k", "pod"): (3.906800, "memory")}
PATH18A_CPU_TOL = 0.01
PATH18A_TIMEOUT_S = 240
PATH18B = (("zamba2_1p2b", "train"), ("olmo_1b", "prefill"),
           ("olmo_1b", "train"))
PATH18B_BATCH, PATH18B_SEQ = 4, 2048
ARGS18_TOL = 0.01
# path 17: the model-zoo graph importer (graphs/model_zoo.py).  17a
# imports every registry config's model:<arch> layer (DEFAULT_SEQ 256) on
# the card's host, twice; 17b places ZOO17_PLACE's layers on ZOO17_FLEET
# (ZOO17_K sampled episodes a request); 17c places ZOO17_FULL (seq 256, 2
# microbatches) through the hierarchy (HIER_CFG); 17d runs the placement
# server's CLI with its defaults (model:olmo_1b x mixed_gen4 after a quick
# pretrain on the gemma_2b and phi4_mini_3p8b layers)
ZOO17_PLACE = ("olmo_1b", "zamba2_1p2b")
ZOO17_FLEET = "v100x8"
ZOO17_K = 64
ZOO17_FULL = "model:olmo_1b:full"
ZOO17_DENSE = ("gemma_2b", "phi4_mini_3p8b", "olmo_1b", "qwen1p5_110b",
               "musicgen_large", "paligemma_3b")
# the training path: Stage I and Stage II at the policy's published width
# on the placement slice's main shape; the gate (kernel backends vs plain
# on the card, from one state) at the reference's bars: losses relative,
# gradients of max(1, max|g|) per leaf
# (tests/test_train_fused.py:84), params after one AdamW step (:300)
TRAIN_REQUEST = ("llama_layer", "v100x8")
TRAIN_STAGE1, TRAIN_UPDATES, TRAIN_K = 4, 3, 16
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL, TRAIN_PARAM_TOL = 1e-5, 5e-6, 5e-3
# the fused path: 64 Stage I episodes and 64 Stage II updates at K 16, 8
# a dispatch; the fused loss against the forced replay on the same
# advantages at the reference's bars (tests/test_train_fused.py:68), the
# chunked gradient against the monolithic one at its parity bar (:112)
FUSED_RECORD, FUSED_DISPATCH, FUSED_PROFILED = 64, 8, 2
REPLAY_LOSS_TOL, CHUNK_GRAD_TOL = 1e-4, 1e-6
# the Stage III path on TRAIN_REQUEST: the executor at flops_scale =
# bytes_scale = 1 (one CUDA stream a logical device), its outputs within
# EXEC_VALUE_TOL of their closed form; two independent chains of
# OVERLAP_CHAIN fp32 matmuls at side OVERLAP_SIDE (64 output tiles of a
# 128 x 128 tiling against 132 SMs) must take at most OVERLAP_BAR of
# their device span on one stream when they run on two.  The spans are
# read with each stream first held OVERLAP_HOLD_S by a sleep kernel
# while the host enqueues the run: the executor's host dispatch (~35-60
# us a step) is as long as a step's device time, so without the head
# start the span is the host's (printed beside it, not gated; PERF.md).
# Then calibration, Stage I and II (fused) on the calibrated fleet and
# Stage III against measured wall-clock, the first update gated at path
# 7's bars with the gradient scaled by the whole gradient's max (as
# tests/test_torch_train.py's assert_grads_close): a scalar logit bias
# the softmax ignores carries ~1e-5 of rounding when every advantage is
# ~-28
STAGE3_S1, STAGE3_S2, STAGE3_K, STAGE3_UPDATES, STAGE3_REPEATS = \
    16, 16, 8, 4, 3
EXEC_VALUE_TOL = 1e-4
OVERLAP_SIDE, OVERLAP_CHAIN, OVERLAP_BAR = 1024, 16, 0.9
OVERLAP_REPS, OVERLAP_HOLD_S = 5, 10e-3
RECORD_RUNS = 5
# path 10 on TRAIN_REQUEST: resume after RESUME_UPDATES fused updates at
# K TRAIN_K (one dispatch), then the baselines' episodes (each a forward
# of the policy, a reward from the numpy WCSimulator, a replay under
# autograd and AdamW); the gates are path 7's
RESUME_UPDATES, GDP_EPISODES, PLACETO_EPISODES = 4, 4, 2
CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# path 11: the hierarchy at the reference's own setting
# (benchmarks/fig6_scalability.py:50) on HIER_FLEET: HIER_TRAIN trains
# (fused Stage I HIER_S1 episodes, Stage II HIER_S2 updates at K HIER_K,
# one flat-reward update), places and re-places (HIER_EVENTS without
# commit, then the loss committed and HIER_AFTER fused updates);
# HIER_BIG only coarsens and places (random weights); HIER_CHECK's refine
# batch is small enough for the plain trip loop
HIER_FLEET = "v100x8"
HIER_CFG = HierarchyConfig(n_segments=64, refine_rounds=3, refine_top_k=24)
HIER_TRAIN, HIER_BIG, HIER_CHECK = (256, 16), (4096, 16), (32, 16)
HIER_S1, HIER_S2, HIER_K, HIER_AFTER = 16, 16, 16, 2
HIER_EVENTS = (FleetEvent.device_loss(3), FleetEvent.straggler_onset(0, 0.5),
               FleetEvent.link_degradation(1, factor=0.25))
HIER_BUDGET_S = 5.0
# path 12 at the policy's published width: pretraining over the synthetic
# half of the zoo (zoo_pretrain_tasks(holdout=ARCH_IDS, n_synthetic=4))
# plus PRETRAIN_EXTRA, PRETRAIN_ROUNDS rounds (the reference's default is
# 4: the depth cut) at K PRETRAIN_K after PRETRAIN_S1 imitation passes;
# the zero-shot server on SERVE_CELLS (llama_layer, which pretraining
# never saw), SERVE_HITS hits a cell and one fine-tuned miss;
# FleetTrainer on FLEET_BLOCKS; the training CLI's CLI_RUNS
PRETRAIN_EXTRA = (("chainmm", "mixed_gen4"), ("ffnn", "two_pod_2x2"),
                  ("llama_block", "straggler8"))
PRETRAIN_ROUNDS, PRETRAIN_K, PRETRAIN_S1 = 2, 8, 2
PRETRAIN_DIR = ROOT / "build" / "chip_smoke_pretrained"
SERVE_CELLS = tuple(("llama_layer", f) for f in ("mixed_gen4", "two_pod_2x2",
                                                 "straggler8", "v100x8"))
SERVE_HITS, SERVE_FT_BUDGET_S = 200, 3.0
FLEET_BLOCKS, FLEET_FLEET, FLEET_REPLICAS = ("llama_block", "ffnn"), \
    "v100x8", 8
FLEET_EPISODES, FLEET_K = 16, 8
CLI_DIR = ROOT / "build" / "chip_smoke_cli"
CLI_RUNS = (
    ["--graph", "llama_layer", "--devices", "v100x8", "--stage1", "8",
     "--stage2", "8", "--stage2-batch", "16", "--engine", "fused",
     "--stage3", "2", "--stage3-batch", "8", "--system", "executor",
     "--calibrate", "--flops-scale", "1", "--bytes-scale", "1",
     "--ckpt-dir", str(CLI_DIR), "--trace", str(CLI_DIR / "trace.json")],
    ["--graph", "llama_layer", "--devices", "v100x8", "--stage2-batch", "16",
     "--ckpt-dir", str(CLI_DIR), "--resume", "--stage1", "0", "--stage2",
     "4", "--engine", "oracle", "--stage3", "0"],
    ["--graph", "llama_block", "--devices", "mixed_gen4", "--stage1", "4",
     "--stage2", "8", "--stage2-batch", "8", "--engine", "batched",
     "--stage3", "0", "--events", "3:loss:1"],
    ["--graph", "llama_layer", "--devices", "v100x8", "--hierarchy", "16",
     "--stage1", "4", "--stage2", "4", "--engine", "fused", "--stage3",
     "0"])
# the card's name and power limit, as nvidia-smi gives them (set by main)
CARD = ""


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(nbytes: float, ops: float,
             flop_rate: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max()) / max(
        float(ref.abs().max()), 1.0)


def scaled_err64(got: torch.Tensor, ref: torch.Tensor) -> float:
    """``scaled_err`` against a float64 reference, computed in fp64."""
    ref = ref.double()
    return float((got.double() - ref).abs().max()) / max(
        float(ref.abs().max()), 1.0)


# ------------------------------------------------------------- gnn_mp
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_kernel():
    """An empty kernel, built like the port's kernels, as a yardstick of
    one launch's device time; -> its launcher (stream -> cudaError)."""
    import ctypes
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "empty_kernel.cu"
    so = _build.BUILD_DIR / "empty_kernel.so"
    cu.write_text(EMPTY_CU)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(so)).launch_empty
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return fn


def gnn_bytes(m, n, d, directions=1) -> int:
    """Bytes one aggregation must move: msg read, out written, the CSR's
    perm and row_ptr read once, per direction."""
    return directions * 4 * (m * d + m + (n + 1) + n * d)


def check_gnn_mp(dev) -> list:
    """Kernels vs plain at the main path's aggregations (llama_layer's two
    edge directions, d = 64) and on a random 2^20-edge graph: the single
    direction kernel (``segment_sum``) and the pair (``segment_sum_pair``,
    both directions in one launch, the encoder's call).  Each is timed at
    the path's shape and the pair also at 2^20 edges, beside its byte
    bound."""
    g = get_workload("llama_layer")
    edges = torch.as_tensor(g.edge_array(), dtype=torch.long, device=dev)
    gen = torch.Generator(dev).manual_seed(0)
    n, d = g.n, 64
    big_n, big_m = 2**17, 2**20
    big = torch.randint(0, big_n, (big_m, 2), generator=gen, device=dev)
    graphs = [(edges, n), (big, big_n)]
    errs = {"single": [0.0, 0.0], "pair": [0.0, 0.0]}

    def record(kind, got, ref, what):
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        print(f"gnn_mp {kind} {what}: max_abs_err={err} max_rel_err={rel}")
        check(rel <= GNN_REL_TOL, f"gnn_mp {kind} {what}: relative error "
                                  f"{rel} > {GNN_REL_TOL}")
        errs[kind] = [max(errs[kind][0], err), max(errs[kind][1], rel)]

    for e, segs in graphs:
        m = e.shape[0]
        src, dst = e[:, 0], e[:, 1]
        csr = (build_csr(dst, segs), build_csr(src, segs))
        msg_in, msg_out = (torch.randn(m, d, generator=gen, device=dev)
                           for _ in range(2))
        refs = (segment_sum_ref(msg_in, dst, segs, csr[0]),
                segment_sum_ref(msg_out, src, segs, csr[1]))
        for idx, msg, c, ref, name in ((dst, msg_in, csr[0], refs[0], "dst"),
                                       (src, msg_out, csr[1], refs[1],
                                        "src")):
            got = gnn_ops.segment_sum(msg, idx, segs, backend="cuda", csr=c)
            record("single", got, ref, f"m={m} n={segs} d={d} by {name}")
        got = gnn_ops.segment_sum_pair(msg_in, dst, msg_out, src, segs,
                                       backend="cuda", csr=csr)
        for i, name in enumerate(("dst", "src")):
            record("pair", got[i], refs[i], f"m={m} n={segs} d={d} by {name}")

    # timing at the main path's shape (single: the incoming direction)
    calls = 20
    empty = empty_kernel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, empty_rows = _profiled(lambda: [_build.check("empty", empty(stream))
                                       for _ in range(calls)])
    empty_device_ms = sum(r[0] for r in empty_rows) * 1e-3 / calls
    entries = []
    for e, segs in graphs:
        m = e.shape[0]
        src, dst = e[:, 0], e[:, 1]
        csr = (build_csr(dst, segs), build_csr(src, segs))
        msg_in, msg_out = (torch.randn(m, d, generator=gen, device=dev)
                           for _ in range(2))
        single = lambda: gnn_ops.segment_sum(msg_in, dst, segs,
                                             backend="cuda", csr=csr[0])
        pair = lambda: gnn_ops.segment_sum_pair(msg_in, dst, msg_out, src,
                                                segs, backend="cuda", csr=csr)
        lib1 = lambda: torch.zeros(segs, d, device=dev).index_add_(0, dst,
                                                                 msg_in)

        def lib2():
            out = torch.zeros(2, segs, d, device=dev)
            out[0].index_add_(0, dst, msg_in)
            out[1].index_add_(0, src, msg_out)
            return out
        it = 200 if segs == n else 20
        row = {}
        for kind, kern, lib, tag, nd in (
                ("single", single, lib1, "segment_sum_csr", 1),
                ("pair", pair, lib2, "segment_sum_pair", 2)):
            if kind == "single" and segs != n:
                continue
            ms = time_ms(kern, iters=it)
            library_ms = time_ms(lib, iters=it)
            plain = ((lambda: segment_sum_ref(msg_in, dst, segs, csr[0]))
                     if kind == "single" else
                     (lambda: segment_sum_pair_ref(msg_in, dst, msg_out, src,
                                                   segs, csr)))
            plain_ms = time_ms(plain, iters=max(it // 10, 2))
            _, lib_rows = _profiled(lambda: [lib() for _ in range(calls)])
            _, k_rows = _profiled(lambda: [kern() for _ in range(calls)],
                                  (tag,))
            lib_dev = sum(r[0] for r in lib_rows) * 1e-3 / calls
            dev_ms = per_launch_ms(k_rows, (("k", tag),))["k"]
            b_ms, b_by = bound_ms(gnn_bytes(m, segs, d, nd), nd * m * d)
            print(f"gnn_mp {kind} m={m} n={segs} d={d} ({CARD}): {ms:.6f} ms "
                  f"per call, {dev_ms:.6f} ms device ({b_ms / dev_ms:.4f} of "
                  f"the {b_by} bound {b_ms:.6f} ms); plain {plain_ms:.6f} "
                  f"ms; library {library_ms:.6f} ms per call, {lib_dev:.6f} "
                  f"ms device (" + ", ".join(
                      f"{c // calls} x {key[:40]}" for _, c, key in lib_rows)
                  + f"); an empty kernel {empty_device_ms:.6f} ms device")
            row[kind] = {"ms": ms, "timed_device_ms": dev_ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": library_ms,
                         "library_device_ms": lib_dev,
                         "bound_share": b_ms / dev_ms}
        entries.append(row)
    path, big_row = entries
    single = {"name": "gnn_mp", "route": "cuda",
              "source": "src/repro_torch/csrc/gnn_mp.cu",
              "replaces": "src/repro/kernels/gnn_mp/kernel.py:31",
              "kernel": "segment_sum_csr", "launches": 0,
              "max_abs_err": errs["single"][0],
              "max_rel_err": errs["single"][1], **path["single"],
              "empty_kernel_device_ms": empty_device_ms,
              "shape": {"m": edges.shape[0], "n": n, "d": d}}
    pair = {"name": "gnn_mp_pair", "route": "cuda",
            "source": "src/repro_torch/csrc/gnn_mp.cu",
            "replaces": "src/repro/kernels/gnn_mp/kernel.py:31",
            "kernel": "segment_sum_pair", "launches": 0,
            "max_abs_err": errs["pair"][0], "max_rel_err": errs["pair"][1],
            **path["pair"], "empty_kernel_device_ms": empty_device_ms,
            "big": {**big_row["pair"], "m": big_m, "n": big_n, "d": d},
            "library": "zeros + index_add_ per direction",
            "shape": {"m": edges.shape[0], "n": n, "d": d,
                      "directions": 2}}
    return [single, pair]


# ---------------------------------------------------------- wc_oracle
def _wc_state(rng, B, R, K, dev):
    """Random tables honoring the kernel contract (exact-integer keys,
    identical rows on duplicate targets), with idle slots, dropped rows,
    a drained all-dropped episode and a fully tied episode."""
    run = rng.integers(0, 50, size=(B, R, 6)).astype(np.float32)
    run[..., 0] = np.where(rng.random((B, R)) < 0.4, np.inf,
                           run[..., 0] + 1.0)
    tgt = rng.integers(0, R, size=(B, K))
    base = rng.integers(0, 50, size=(B, R, 6)).astype(np.float32)
    rows = np.take_along_axis(base, tgt[:, :, None], axis=1)
    ridx = np.where(rng.random((B, K)) < 0.3, -1, tgt).astype(np.int32)
    run[0, :, 0] = np.inf                         # drained ...
    ridx[0] = -1                                  # ... and all dropped
    if B > 1:
        run[1, :, :4] = 3.0                       # every row tied
        ridx[1] = -1
    return [torch.from_numpy(x).to(dev) for x in (run, rows, ridx)]


def check_wc_oracle(dev) -> dict:
    rng = np.random.default_rng(0)
    shapes = [(257, 72, 8), (3, 20, 5), (2, 2, 1), (16, 257, 129),
              (1000, 300, 40)]
    shapes += [(int(rng.integers(1, 600)), int(rng.integers(1, 400)),
                int(rng.integers(1, 150))) for _ in range(6)]
    for B, R, K in shapes:
        run, rows, ridx = _wc_state(rng, B, R, K, dev)
        out_k, rho_k, e1_k = wc_ops.wc_step(run, rows, ridx, backend="cuda")
        out_r, rho_r, e1_r = wc_step_ref(run, rows, ridx)
        torch.cuda.synchronize()
        alive = torch.isfinite(e1_r)
        check(torch.equal(out_k, out_r), f"wc_oracle run_out {B, R, K}")
        check(torch.equal(e1_k, e1_r), f"wc_oracle e1 {B, R, K}")
        check(torch.equal(rho_k[alive], rho_r[alive]),
              f"wc_oracle rho {B, R, K}")
    print(f"wc_oracle bit-exact on {len(shapes)} shapes "
          f"(B, R, K) = {shapes}")

    B, R, K = 257, 72, 8
    run, rows, ridx = _wc_state(rng, B, R, K, dev)
    ms = time_ms(lambda: wc_ops.wc_step(run, rows, ridx, backend="cuda"))
    plain_ms = time_ms(lambda: wc_step_ref(run, rows, ridx))
    _, rows_p = _profiled(lambda: [wc_ops.wc_step(run, rows, ridx)
                                   for _ in range(20)], ("wc_step(",))
    device_ms = per_launch_ms(rows_p, (("k", "wc_step("),))["k"]
    # each input read once, each output written once; compares/selects:
    # K target tests per row, then ~14 per row for the four chained mins
    nbytes = 4 * B * (2 * R * 6 + K * 6 + K + 2)
    b_ms, b_by = bound_ms(nbytes, B * R * (K + 14))
    return {"name": "wc_oracle", "route": "cuda",
            "source": "src/repro_torch/csrc/wc_oracle.cu",
            "replaces": "src/repro/kernels/wc_oracle/kernel.py:41",
            "kernel": "wc_step", "launches": 0, "max_abs_err": 0.0, "ms": ms,
            "timed_device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"B": B, "R": R, "K": K}}


# ---------------------------------------------------- wc_oracle trips
def fanout_graph(width: int = 70) -> DataflowGraph:
    """A hub feeding ``width`` consumers that all feed one join: C = width,
    so ``wc_trips``'s readiness and candidate lists span several 32-lane
    chunks (tests/test_torch_wc_trips.py holds the same graph on the CPU)."""
    g = DataflowGraph(f"fanout{width}")
    x = g.add_vertex("input", out_bytes=4e6)
    hub = g.add_vertex("matmul", flops=2e9, out_bytes=8e6)
    join = g.add_vertex("sum_reduction", flops=1e6, out_bytes=1e6)
    g.add_edge(x, hub)
    for i in range(width):
        v = g.add_vertex("matmul", flops=1e8 * (1 + i % 7),
                         out_bytes=1e5 * (1 + i % 3))
        g.add_edge(hub, v)
        g.add_edge(v, join)
    return g.freeze()


def trips_placements(sg) -> tuple:
    nbytes = wc_ops.episode_bytes(sg.n, sg.esrc.shape[0], sg.R, sg.K)
    auto = wc_ops.placement(nbytes, sg.esrc.device)
    return (auto,) if auto == "global" else ("shared", "global")


def check_trips(sg, A, what: str) -> tuple:
    """wc_trips == wc_trips_ref, bit for bit on ms and n_done (so on ok),
    in every placement the state allows; -> (ok (B,), placements)."""
    args = trip_inputs(sg, torch.as_tensor(A, device=sg.esrc.device))
    _, nd_r, places = check_trip_args(sg, args, what)
    return nd_r == sg.n_compute, places


def check_trip_args(sg, args, what: str) -> tuple:
    """``check_trips`` on a batch's trip inputs; -> (the plain loop's ms
    and n_done, the placements run)."""
    ms_r, nd_r = wc_trips_ref(sg, *args)
    places = trips_placements(sg)
    for where in places:
        ms_k, nd_k = wc_ops.wc_trips(sg, *args, where=where)
        torch.cuda.synchronize()
        check(torch.equal(ms_k, ms_r) and torch.equal(nd_k, nd_r),
              f"wc_trips == plain on {what} ({where}): ms max abs diff "
              f"{float((ms_k - ms_r).abs().max())}, n_done differs in "
              f"{int((nd_k != nd_r).sum())} episodes")
    return ms_r, nd_r, places


def trips_bound(sg, args) -> tuple:
    """The trips of a ``wc_trips`` batch and its bound: -> (trips of the
    longest episode, mean trips, bound ms, what bounds it).  One trip a
    completion: every compute task and canonical transfer; each input
    read once (indices as the int32 the kernel takes), each output
    written once; the floor is the dependent chain of trips."""
    B, N = args[0].shape
    mm = N - sg.n
    trips = sg.n_compute + args[3].sum(1)
    words = (B * (2 * N + 2 * mm + 3 * (N + 1) + 2 * (sg.R + 1) + 6 * sg.R
                  + sg.n + 1 + sg.K) + 2 * mm + sg.n * sg.C + 2 * B)
    b_ms, b_by = bound_ms(4.0 * words, float(trips.sum()))
    return int(trips.max()), float(trips.float().mean()), b_ms, b_by


def check_wc_trips(dev, trainers, answers) -> dict:
    """``wc_trips`` against its plain version (the trip loop) on the three
    requests' candidate batches, random assignments on every suite x
    fleet pair, a fan-out of 70, a deadlocked batch and a batch of one;
    states that fit shared memory also run in the global-scratch
    placement, and llama_layer x tpu_v5e_16x16 (R = 65,792) takes it by
    itself.  Times the kernel and the plain loop at llama_layer's batch."""
    rng = np.random.default_rng(5)
    seen = {"shared": 0, "global": 0}
    n_batches = n_episodes = 0

    def run(sg, A, what, expect_ok=True):
        nonlocal n_batches, n_episodes
        ok, places = check_trips(sg, A, what)
        check(bool(ok.all()) if expect_ok else not bool(ok.any()),
              f"wc_trips ok flags on {what}")
        for where in places:
            seen[where] += 1
        n_batches += 1
        n_episodes += len(A)
        return sg

    batches = []
    for (gname, fleet), tr, pl in zip(REQUESTS, trainers, answers):
        cands = np.concatenate([pl.greedy[None], pl.population])
        batches.append(run(SimGraph.build(tr.g, tr.dev, dev), cands,
                           f"the {gname} request's {len(cands)} candidates"))
    for gname in sorted(WORKLOADS):           # the four Appendix-D graphs
        g = get_workload(gname)
        for fleet in sorted(PRESETS):
            fm = get_device_model(fleet)
            B = 4 if fm.n > 16 else 32
            run(SimGraph.build(g, fm, dev), rng.integers(0, fm.n, (B, g.n)),
                f"{gname} x {fleet}, {B} random")
    big = SimGraph.build(get_workload("llama_layer"),
                         get_device_model("tpu_v5e_16x16"), dev)
    check(trips_placements(big) == ("global",),
          "llama_layer x tpu_v5e_16x16 takes the global placement")
    g = fanout_graph()
    run(SimGraph.build(g, get_device_model("v100x8"), dev),
        rng.integers(0, 8, (64, g.n)), "fanout70 x v100x8, 64 random")
    g = get_workload("ffnn")
    run(SimGraph.build(g, uniform_box(1), dev), np.zeros((3, g.n), np.int64),
        "ffnn on one device (R = 2)")
    run(batches[0], np.asarray(answers[0].greedy)[None],
        "llama_layer, a batch of one")
    # a corrupted indegree: the heap drains early, every episode not ok
    g = get_workload("llama_block")
    sg = SimGraph.build(g, get_device_model("mixed_gen4"), dev)
    need0 = sg.need0.clone()
    need0[int(torch.nonzero(need0 > 0)[0])] = 99
    run(dataclasses.replace(sg, need0=need0), rng.integers(0, 4, (16, g.n)),
        "a deadlocked llama_block batch", expect_ok=False)
    print(f"wc_trips bit-equal to the plain trip loop (ms, n_done) on "
          f"{n_batches} batches, {n_episodes} episodes; placements run "
          f"{seen}")

    # timing at llama_layer's batch (the main path's first request)
    sg = batches[0]
    pl = answers[0]
    A = torch.as_tensor(np.concatenate([pl.greedy[None], pl.population]),
                        device=dev)
    args = trip_inputs(sg, A)
    B, N = args[0].shape
    mm = N - sg.n
    kern = lambda: wc_ops.wc_trips(sg, *args)
    ms = time_ms(kern, iters=20, warmup=2)
    plain_ms = time_ms(lambda: wc_trips_ref(sg, *args), iters=2, warmup=1)
    _, rows = _profiled(lambda: [kern() for _ in range(5)], ("wc_trips<",))
    dev_ms = per_launch_ms(rows, (("k", "wc_trips<"),))["k"]
    t_max, t_mean, b_ms, b_by = trips_bound(sg, args)
    nbytes = wc_ops.episode_bytes(sg.n, mm, sg.R, sg.K)
    print(f"wc_trips at llama_layer's batch (B={B}, n={sg.n}, R={sg.R}, "
          f"C={sg.C}, K={sg.K}, {nbytes} bytes of state per episode, "
          f"{trips_placements(sg)[0]}): {ms:.6f} ms per call, {dev_ms:.6f} "
          f"ms device, trips per episode max {t_max} mean {t_mean:.1f}, "
          f"{dev_ms * 1e3 / t_max:.4f} us per trip of the longest episode; "
          f"bound {b_ms:.6f} ms ({b_by}); plain trip loop {plain_ms:.3f} ms")
    return {"name": "wc_oracle_trips", "route": "cuda",
            "source": "src/repro_torch/csrc/wc_oracle.cu",
            "replaces": "src/repro/kernels/wc_oracle/kernel.py:41",
            "loop_replaced": "src/repro/core/sim_jax.py:443 (_run_trips)",
            "kernel": "wc_trips", "launches": 0, "max_abs_err": 0.0,
            "ms": ms, "timed_device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "us_per_trip": dev_ms * 1e3 / t_max, "trips_max": t_max,
            "trips_mean": t_mean, "batches_checked": n_batches,
            "episodes_checked": n_episodes, "placements_run": seen,
            "shape": {"B": B, "n": sg.n, "mm": mm, "R": sg.R, "C": sg.C,
                      "K": sg.K, "episode_bytes": nbytes}}


# ---------------------------------------------------- flash_attention
def _qkv(gen, B, S, H, Hkv, d, dtype, dev):
    return [torch.randn(B, S, h, d, generator=gen, device=dev).to(dtype)
            for h in (H, Hkv, Hkv)]


def _sdpa_inputs(q, k, v):
    """(B, H, S, d) copies for ``scaled_dot_product_attention``, KV heads
    repeated over their group (made outside the timed calls)."""
    G = q.shape[2] // k.shape[2]
    return [x.repeat_interleave(r, 2).transpose(1, 2).contiguous()
            for x, r in ((q, 1), (k, G), (v, G))]


def time_flash(dev, gen, shape, dt, rate) -> dict:
    """One kernel at one causal shape: per call and device time, the
    bound, the plain version and ``scaled_dot_product_attention``."""
    B, S, H, Hkv, d = shape
    q, k, v = _qkv(gen, B, S, H, Hkv, d, dt, dev)
    name = "flash_fwd_wgmma" if fa_ops.uses_wgmma(dt, d) else "flash_fwd_mma"
    kern = lambda: fa_ops.flash_attention(q, k, v, backend="cuda")
    ms = time_ms(kern, iters=30, warmup=3)
    _, rows = _profiled(lambda: [kern() for _ in range(5)], (name + "<",))
    dev_ms = per_launch_ms(rows, (("k", name + "<"),))["k"]
    plain_ms = time_ms(lambda: attention_ref(q, k, v), iters=5, warmup=1)
    qt, kt, vt = _sdpa_inputs(q, k, v)
    library_ms = time_ms(lambda: torch.nn.functional.
                         scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True),
                         iters=30, warmup=3)
    # the causal half: S(S+1)/2 (query, key) pairs, 2d flops each for
    # q kᵀ and for p v; q, k, v read and o written once
    flops = 4.0 * B * H * d * S * (S + 1) / 2
    elems = 2 * B * S * H * d + 2 * B * S * Hkv * d
    b_ms, b_by = bound_ms(q.element_size() * elems, flops, rate)
    # a profiler session can come back without the kernel's records
    # (PERF.md): then the share is of the per-call time
    dev = (f"{dev_ms:.5f} ms device" if dev_ms is not None else
           "device ms not measured (no kernel record in the profile)")
    print(f"flash_attention {str(dt).split('.')[-1]} B={B} S={S} H={H} "
          f"Hkv={Hkv} d={d} ({name}, {CARD}): {ms:.5f} ms per call, "
          f"{dev}, {flops / ms * 1e-9:.1f} TFLOP/s; bound "
          f"{b_ms:.5f} ms ({b_by}, {b_ms / (dev_ms or ms):.4f} of it); "
          f"plain "
          f"{plain_ms:.5f} ms; scaled_dot_product_attention "
          f"{library_ms:.5f} ms")
    return {"ms": ms, "timed_device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "tflops": flops / ms * 1e-9,
            "shape": {"B": B, "S": S, "H": H, "Hkv": Hkv, "d": d,
                      "dtype": str(dt).split(".")[-1], "causal": True}}


def check_flash(dev, cfg, gemma) -> list:
    """Kernels vs plain at zamba2's serving shape (bf16 and fp32), at
    gemma-2b's (bf16, d 256, one KV head) and on random shapes with GQA,
    MQA, ragged S, S = 1, non-causal masks and d up to 256 in fp32, bf16
    and fp16.  bf16 at d 64 and 128 runs ``flash_fwd_wgmma``, the rest
    ``flash_fwd_mma``.  Times ``flash_fwd_wgmma`` at zamba2's bf16 shape
    (and ``flash_fwd_mma`` on the same inputs through its C entry point),
    ``flash_fwd_mma`` in fp32 at zamba2's shape and in bf16 at gemma's,
    each against its bound, its plain version and
    ``scaled_dot_product_attention``."""
    gen = torch.Generator(dev).manual_seed(1)
    rng = np.random.default_rng(1)
    B, S, H, d = SERVE_BATCH, SERVE_PROMPT, cfg.n_heads, cfg.head_dim
    Hkv = cfg.n_kv_heads
    gshape = (SERVE_BATCH, SERVE_PROMPT, gemma.n_heads, gemma.n_kv_heads,
              gemma.head_dim)
    cases = [(B, S, H, Hkv, d, dt, True) for dt in (torch.bfloat16,
                                                    torch.float32)]
    cases += [(*gshape, torch.bfloat16, True),
              (1, S, gemma.n_heads, 1, gemma.head_dim, torch.float32, True),
              (1, 1, 4, 2, 64, torch.bfloat16, True),
              (1, 1, 8, 1, 256, torch.float16, True),
              (2, 333, 8, 2, 128, torch.float32, False),
              (2, 333, 8, 1, 256, torch.float16, False)]
    types = [torch.bfloat16, torch.float32, torch.float16]
    for _ in range(8):
        hkv = int(rng.integers(1, 5))
        cases.append((int(rng.integers(1, 4)), int(rng.integers(1, 700)),
                      hkv * int(rng.integers(1, 4)), hkv,
                      int(rng.choice([16, 32, 64, 96, 128, 200, 256])),
                      types[int(rng.integers(3))], bool(rng.integers(2))))
    # the tensor-core kernel at d = 128, ragged and non-causal
    cases += [(1, S, 16, 4, 128, torch.bfloat16, True),
              (2, 777, 8, 2, 64, torch.bfloat16, False),
              (3, 193, 6, 2, 128, torch.bfloat16, False)]
    errs = {}
    for b, s, h, hkv, dd, dt, causal in cases:
        q, k, v = _qkv(gen, b, s, h, hkv, dd, dt, dev)
        got = fa_ops.flash_attention(q, k, v, causal=causal, backend="cuda")
        ref = attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dt]
        diff = (got.float() - ref.float()).abs()
        check(got.dtype == dt and bool(torch.isfinite(got).all()),
              f"flash_attention output {b, s, h, hkv, dd, dt}")
        check(bool((diff <= tol + tol * ref.float().abs()).all()),
              f"flash_attention {b, s, h, hkv, dd, dt, causal}: max abs "
              f"err {float(diff.max())} > {tol} (+ rel)")
        key = ("flash_fwd_wgmma" if fa_ops.uses_wgmma(dt, dd) else
               f"flash_fwd_mma {str(dt).split('.')[-1]}")
        errs[key] = max(errs.get(key, 0.0), float(diff.max()))
    print(f"flash_attention vs plain on {len(cases)} shapes (zamba2 B={B} "
          f"S={S} H={H} d={d} bf16 and fp32, gemma-2b B={gshape[0]} "
          f"S={gshape[1]} H={gshape[2]} Hkv={gshape[3]} d={gshape[4]} bf16 "
          f"and fp32, GQA, MQA, ragged, S=1, d up to 256, fp16, "
          f"non-causal): max abs err by kernel {errs}")

    # a reading, not a gate: fp32 at zamba2's shape against the plain
    # version run in float64, beside the plain version's own distance
    q, k, v = _qkv(gen, B, S, H, Hkv, d, torch.float32, dev)
    ref64 = attention_ref(q.double(), k.double(), v.double())
    fp64 = {}
    for name, out in (("flash_fwd_mma", fa_ops.flash_attention(q, k, v)),
                      ("plain", attention_ref(q, k, v))):
        e = (out.double() - ref64).abs()
        fp64[name] = {"max": float(e.max()), "mean": float(e.mean())}
    del q, k, v, ref64
    print(f"flash_attention float32 at zamba2's shape vs the plain version "
          f"in float64 (abs err): {fp64}")
    wg = time_flash(dev, gen, (B, S, H, Hkv, d), torch.bfloat16,
                    BF16_FLOP_PER_S)
    mma32 = time_flash(dev, gen, (B, S, H, Hkv, d), torch.float32,
                       FP32_FLOP_PER_S)
    mma16 = time_flash(dev, gen, gshape, torch.bfloat16, BF16_FLOP_PER_S)
    # flash_fwd_mma on zamba2's bf16 inputs, through its C entry point
    # (the wrapper sends bf16 at d = 64 to flash_fwd_wgmma)
    q, k, v = _qkv(gen, B, S, H, Hkv, d, torch.bfloat16, dev)
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    stream = torch.cuda.current_stream(dev).cuda_stream
    mma_ms = time_ms(lambda: lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, H,
        Hkv, d, 1, fa_ops.DTYPE_CODES[torch.bfloat16], stream),
        iters=30, warmup=3)
    check(float((out.float() - fa_ops.flash_attention(q, k, v).float())
                .abs().max()) <= 2 * FLASH_TOL[torch.bfloat16],
          "flash_fwd_mma and flash_fwd_wgmma agree on bf16")
    wg_ms = time_ms(lambda: fa_ops.flash_attention(q, k, v), iters=30,
                    warmup=3)
    print(f"flash_attention bf16 at zamba2's shape, same inputs, one after "
          f"the other: flash_fwd_mma {mma_ms:.5f} ms, flash_fwd_wgmma "
          f"{wg_ms:.5f} ms ({mma_ms / wg_ms:.2f}x)")
    shape_wg = wg.pop("shape")
    shape16 = mma16.pop("shape")
    return [{"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention_sm90.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
             "kernel": "flash_fwd_wgmma", "launches": 0,
             "max_abs_err": errs["flash_fwd_wgmma"], **wg,
             "flash_fwd_mma_bf16_ms": mma_ms, "shape": shape_wg},
            {"name": "flash_attention_mma", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
             "kernel": "flash_fwd_mma", "launches": 0,
             "max_abs_err": max(v_ for k_, v_ in errs.items()
                                if k_.startswith("flash_fwd_mma")),
             "max_abs_err_by_type": {k_.split()[-1]: v_ for k_, v_
                                     in errs.items()
                                     if k_.startswith("flash_fwd_mma")},
             **mma16, "shape": shape16,
             "fp32": mma32, "fp32_vs_fp64": fp64}]


# ------------------------------------------------------- mamba2_scan
def _ssd_inputs(gen, B, S, H, N, P, dev, state=False, shared=True):
    """mamba2_forward's layout by default: one (B, S, N) q and k broadcast
    over the heads (head stride 0); ``shared=False``: per-head q and k.
    Log decay -softplus(.) <= 0."""
    rn = lambda *s: torch.randn(*s, generator=gen, device=dev)
    if shared:
        q = rn(B, S, 1, N).expand(B, S, H, N)
        k = rn(B, S, 1, N).expand(B, S, H, N)
    else:
        q, k = rn(B, S, H, N), rn(B, S, H, N)
    v = rn(B, S, H, P)
    log_a = -torch.nn.functional.softplus(rn(B, S, H))
    return q, k, v, log_a, (rn(B, H, P, N) if state else None)


def ssd_work(B, S, H, N, P, L, shared=True) -> tuple[float, float]:
    """Flops and bytes of one ``ssd_scan`` call as its kernels tile it
    (csrc/mamba2_scan.cu): 64 x 64 score tiles (the lower ones of each
    chunk, once per batch row when q and k are shared) over N / 64 depth
    tiles, per-chunk states over 128 columns of P and 64 of N, and 64 x
    128 output tiles over N / 64 depth tiles of q stateᵀ and the key tiles
    up to the diagonal, each product over a depth of 64; tiles past S are
    skipped, the part-empty last tiles of P and N counted whole.  Bytes:
    inputs read and outputs written once, the scores scratch written and
    read, the chunk-states scratch written, read and written, read.  ->
    (flops before the 3xTF32 split, bytes)."""
    T, PT = ssd_ops.TILE, 2 * ssd_ops.TILE
    nt, nc, nn = -(-L // T), -(-S // L), -(-N // T)
    p_tiles, n_g = -(-P // PT), B if shared else B * H
    scores = state = out = 0
    for c in range(nc):
        live = [ti for ti in range(nt) if c * L + ti * T < S]
        scores += sum(ti + 1 for ti in live) * nn
        state += len(live) * nn
        out += sum(ti + 1 + nn for ti in live)   # q stateᵀ tiles and keys
    tile = 2.0 * T * T * T
    flops = (n_g * scores * tile + B * H * p_tiles * 2 * (state + out)
             * tile)
    qk = 2 * (B * S * N if shared else B * S * H * N)
    io = qk + 2 * B * S * H * P + B * H * nc * L + 2 * B * H * P * N
    scratch = (2 * n_g * nc * nt * (nt + 1) // 2 * T * T
               + 4 * B * H * nc * P * N)
    return flops, 4.0 * (io + scratch)


def ssd_bound(B, S, H, N, P, L, shared=True) -> tuple[float, str, float]:
    """The fp32 bound of one ``ssd_scan`` call at the serving shapes (S a
    multiple of L) -> (ms, what bounds it, useful flops).  Per (b,
    chunk), or per (b*h, chunk) when q and k are per head: the causal
    pairs' q.k (2N).  Per (b*h, chunk): decay (1) and p v (2P); q stateᵀ
    (2LNP) and its scale (LP); the update (2LNP + LP + 2PN).  Bytes: q
    and k as the tensors they are, v, log_a, the state in; y and the
    state out."""
    pairs = L * (L + 1) / 2
    per_head = pairs * (2 * P + 1) + 4 * L * N * P + 2 * L * P + 2 * P * N
    flops = (B * (S // L) * (pairs * 2 * N + H * per_head) if shared
             else B * H * (S // L) * (pairs * 2 * N + per_head))
    qk = 2 * B * S * N * (1 if shared else H)
    nbytes = 4.0 * (qk + B * S * H * P + B * S * H + 2 * B * H * P * N
                    + B * S * H * P)
    return (*bound_ms(nbytes, flops), flops)


def time_scan(q, k, v, log_a, L, st0, iters: int) -> dict:
    """One ``ssd_scan`` call timed with CUDA events (``iters`` calls), each
    of its kernels in device time under the profiler (10 calls), and the
    plain version."""
    kern = lambda: ssd_ops.ssd_scan(q, k, v, log_a, L, st0, backend="cuda")
    ms = time_ms(kern, iters=iters, warmup=3)
    calls = 10
    _, rows = _profiled(lambda: [kern() for _ in range(calls)],
                        ssd_ops.KERNELS)
    by_kernel = per_launch_ms(rows, [(n, n) for n in ssd_ops.KERNELS])
    plain_ms = time_ms(lambda: ssd_scan_ref(q, k, v, log_a, L, st0),
                       iters=5, warmup=1)
    return {"ms": ms, "device_ms": sum(by_kernel.values()),
            "by_kernel": by_kernel, "plain_ms": plain_ms}


def check_scan_cases(dev, gen, cases) -> float:
    """Kernel vs plain, y and the final state within SSD_TOL of max(|ref|,
    1), on each (B, S, H, N, P, chunk, initial state, shared q and k);
    -> the largest absolute error."""
    max_err = 0.0
    for b, s, h, n, p, L_, st, sh in cases:
        q, k, v, log_a, st0 = _ssd_inputs(gen, b, s, h, n, p, dev, st, sh)
        y, fin = ssd_ops.ssd_scan(q, k, v, log_a, L_, st0, backend="cuda")
        y_r, fin_r = ssd_scan_ref(q, k, v, log_a, L_, st0)
        torch.cuda.synchronize()
        for what, got, ref in (("y", y, y_r), ("state", fin, fin_r)):
            err = scaled_err(got, ref)
            check(err <= SSD_TOL, f"mamba2_scan {what} "
                                  f"{b, s, h, n, p, L_, st, sh}: scaled err "
                                  f"{err} > {SSD_TOL}")
            max_err = max(max_err, float((got - ref).abs().max()))
        del q, k, v, log_a, st0, y, fin, y_r, fin_r
    return max_err


def check_mamba2(dev, cfg) -> dict:
    """Kernel vs plain (y and the final state) at the serving shape and on
    shapes with P and chunk not multiples of 8, N 50, S = 1, per-head and
    shared q and k, ragged S and a nonzero initial state.  Times the call,
    and each of its kernels in device time under the profiler."""
    gen = torch.Generator(dev).manual_seed(2)
    rng = np.random.default_rng(2)
    ssm = cfg.ssm
    B, S, H, N = SERVE_BATCH, SERVE_PROMPT, ssm.n_heads, ssm.state_dim
    P, L = ssm.expand * cfg.d_model // H, ssm.chunk
    cases = [(B, S, H, N, P, L, False, True), (B, S, H, N, P, L, True, True),
             (1, 1, 2, 64, 256, 256, True, True),
             (2, 777, 3, 64, 256, 256, True, True),
             (2, 300, 2, 50, 100, 100, True, False),
             (1, 1, 3, 50, 100, 100, False, False),
             (2, 1000, 4, 64, 256, 256, True, False)]
    for _ in range(6):
        cases.append((int(rng.integers(1, 4)), int(rng.integers(1, 700)),
                      int(rng.integers(1, 5)),
                      int(rng.choice([8, 16, 50, 64])),
                      int(rng.choice([16, 64, 100, 256])),
                      int(rng.choice([8, 64, 100, 256])),
                      bool(rng.integers(2)), bool(rng.integers(2))))
    max_err = check_scan_cases(dev, gen, cases)
    print(f"mamba2_scan vs plain on {len(cases)} shapes (serving B={B} "
          f"S={S} H={H} N={N} P={P} L={L} with and without an initial "
          f"state, P and chunk 100, N 50, S=1, shared and per-head q and k, "
          f"ragged): y and state within {SSD_TOL} of max(|ref|, 1); max abs "
          f"err {max_err}")

    # a reading, not a gate: y at the serving shape against the plain
    # version run in float64, beside the plain version's own distance
    q, k, v, log_a, st0 = _ssd_inputs(gen, B, S, H, N, P, dev, True)
    y64, _ = ssd_scan_ref(*(x.double() for x in (q, k, v, log_a)), L,
                          st0.double())
    fp64 = {}
    for name, (y, _) in (("kernel", ssd_ops.ssd_scan(q, k, v, log_a, L,
                                                    st0, backend="cuda")),
                         ("plain", ssd_scan_ref(q, k, v, log_a, L, st0))):
        e = (y.double() - y64).abs()
        fp64[name] = {"max": float(e.max()), "mean": float(e.mean())}
    del y64
    print(f"mamba2_scan y at the serving shape vs the plain version in "
          f"float64 (abs err): {fp64}")

    q, k, v, log_a, st0 = _ssd_inputs(gen, B, S, H, N, P, dev)
    st0 = torch.zeros(B, H, P, N, device=dev)       # prefill's initial state
    t = time_scan(q, k, v, log_a, L, st0, iters=30)
    ms, dev_ms, by_kernel, plain_ms = (t["ms"], t["device_ms"],
                                       t["by_kernel"], t["plain_ms"])
    b_ms, b_by, flops = ssd_bound(B, S, H, N, P, L)
    # the tensor-core bound of the work the kernels issue: 3xTF32 triples
    # their tiles' flops; the scratch counts in the bytes
    tc_flops, tc_bytes = ssd_work(B, S, H, N, P, L)
    tc_ms, tc_by = bound_ms(tc_bytes, 3 * tc_flops, TF32_FLOP_PER_S)
    print(f"mamba2_scan at the serving shape: {ms:.5f} ms per call, "
          f"{dev_ms:.5f} ms device per call ("
          + ", ".join(f"{n} {t:.5f}" for n, t in by_kernel.items())
          + f"), {flops / ms * 1e-9:.1f} TFLOP/s useful; fp32 bound "
          f"{b_ms:.5f} ms ({b_by}); tensor-core bound of the "
          f"{3 * tc_flops:.4g} flops and {tc_bytes / 1e6:.1f} MB issued "
          f"{tc_ms:.5f} ms ({tc_by}); plain {plain_ms:.5f} ms")
    return {"name": "mamba2_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/mamba2_scan.cu",
            "replaces": "src/repro/kernels/mamba2_scan/kernel.py:26",
            "kernels": list(ssd_ops.KERNELS),
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "timed_device_ms": dev_ms, "timed_device_ms_by_kernel": by_kernel,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "tc_bound_ms": tc_ms, "tc_bound_by": tc_by,
            "tc_flops_issued": 3 * tc_flops, "library_ms": None,
            "y_vs_fp64": fp64,
            "shape": {"B": B, "S": S, "H": H, "N": N, "P": P, "chunk": L}}


def check_mamba2_xlstm(dev, cfg) -> dict:
    """``mamba2_scan`` at xLSTM's mLSTM prefill shape (B 4, S 2048, H 4,
    N = P = 1024 a head, 1025 columns of v with the normalizer channel,
    chunk 256, q and k per head), with and without an initial state, and
    past one tile of N on ragged shapes (N 100, 200, 1000; P 1025, 100,
    33; S not a multiple of the chunk; shared and per-head q and k; S 1).
    Timed like zamba2's shape, beside the fp32 bound and the tensor-core
    bound of the work the kernels issue (``ssd_work``)."""
    gen = torch.Generator(dev).manual_seed(3)
    H = cfg.ssm.n_heads
    N = cfg.ssm.expand * cfg.d_model // H
    B, S, P, L = SERVE_BATCH, SERVE_PROMPT, N + 1, cfg.ssm.chunk
    cases = [(B, S, H, N, P, L, False, False), (B, S, H, N, P, L, True, False),
             (1, 300, 2, 100, 1025, 256, True, False),
             (2, 129, 2, 1000, 100, 64, False, False),
             (2, 300, 2, 1000, 1025, 100, True, True),
             (1, 77, 3, 200, 33, 32, False, True),
             (1, 1, 2, 1024, 1025, 256, True, False)]
    max_err = check_scan_cases(dev, gen, cases)
    print(f"mamba2_scan vs plain at xLSTM's shape B={B} S={S} H={H} N={N} "
          f"P={P} L={L} (per-head q and k, with and without an initial "
          f"state) and on {len(cases) - 2} ragged shapes with N 100-1024: "
          f"y and state within {SSD_TOL} of max(|ref|, 1); max abs err "
          f"{max_err}")
    q, k, v, log_a, _ = _ssd_inputs(gen, B, S, H, N, P, dev, shared=False)
    st0 = torch.zeros(B, H, P, N, device=dev)       # prefill's initial state
    t = time_scan(q, k, v, log_a, L, st0, iters=10)
    del q, k, v, log_a, st0
    b_ms, b_by, flops = ssd_bound(B, S, H, N, P, L, shared=False)
    tc_flops, tc_bytes = ssd_work(B, S, H, N, P, L, shared=False)
    tc_ms, tc_by = bound_ms(tc_bytes, 3 * tc_flops, TF32_FLOP_PER_S)
    print(f"mamba2_scan at xLSTM's shape ({CARD}): {t['ms']:.5f} ms per "
          f"call, {t['device_ms']:.5f} ms device per call ("
          + ", ".join(f"{n} {x:.5f}" for n, x in t["by_kernel"].items())
          + f"), {flops / t['ms'] * 1e-9:.1f} TFLOP/s useful; fp32 bound "
          f"{b_ms:.5f} ms ({b_by}, {flops:.4g} flops); tensor-core bound of "
          f"the {3 * tc_flops:.4g} flops and {tc_bytes / 1e6:.1f} MB issued "
          f"{tc_ms:.5f} ms ({tc_by}); plain {t['plain_ms']:.5f} ms")
    return {"max_abs_err": max_err, "ms": t["ms"],
            "timed_device_ms": t["device_ms"],
            "timed_device_ms_by_kernel": t["by_kernel"],
            "plain_ms": t["plain_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "tc_bound_ms": tc_ms, "tc_bound_by": tc_by,
            "tc_flops_issued": 3 * tc_flops, "library_ms": None,
            "shape": {"B": B, "S": S, "H": H, "N": N, "P": P, "chunk": L,
                      "qk": "per head"}}


# ------------------------------------------------------------ main path
def main_path(dev):
    trainers = []
    for gname, fleet in REQUESTS:
        trainers.append(DopplerTrainer(get_workload(gname),
                                       get_device_model(fleet), seed=0,
                                       device=dev))
    for tr in trainers:       # first-use set-up (cuBLAS, kernel loads, ...)
        encode(tr.params, tr.gd, tr.encoder_backend)
        tr.default_engine().run_batch(np.zeros((1, tr.g.n), np.int64))
    sync(dev)
    gnn_ops.launches = gnn_ops.pair_launches = 0
    wc_ops.launches = wc_ops.trip_launches = 0
    count = lambda: (gnn_ops.pair_launches, gnn_ops.launches,  # noqa: E731
                     wc_ops.launches, wc_ops.trip_launches)
    answers, per_request = [], []
    for tr in trainers:
        c0 = count()
        answers.append(tr.place(n_samples=K_POP, eps=EPS))
        per_request.append(tuple(b - a for a, b in zip(c0, count())))
    launches = dict(zip(("gnn_mp_pair", "gnn_mp", "wc_oracle",
                         "wc_oracle_trips"), count()))
    return trainers, answers, per_request, launches


def check_main_path(trainers, answers, per_request, dev) -> None:
    for (gname, fleet), tr, pl, (lp, lg, lw, lt) in zip(
            REQUESTS, trainers, answers, per_request):
        g = tr.g
        check(tr.encoder_backend == tr.oracle_backend == "cuda",
              "backends default to cuda on the card")
        check((lp, lg) == (len(tr.params["gnn"]["layers"]), 0) == (2, 0),
              f"{gname}: the encoder is one gnn_mp pair launch a GNN layer "
              f"and no single-direction launch: {lp}, {lg}")
        check((lw, lt) == (0, 1), f"{gname}: the oracle is one wc_trips "
                                  f"launch and no wc_step launch: {lt}, {lw}")
        check(pl.population.shape == (K_POP, g.n), "population shape")
        cands = np.concatenate([pl.greedy[None], pl.population])
        check(bool(((cands >= 0) & (cands < tr.dev.n)).all()),
              "assignments in range")
        check(bool(np.isfinite(pl.makespans).all())
              and pl.makespans.shape == (K_POP + 1,), "finite makespans")
        check(pl.makespan == pl.makespans.min()
              and np.array_equal(pl.assignment,
                                 cands[int(pl.makespans.argmin())]),
              "place returns the scored best")
        plain = TorchWCEngine(g, tr.dev, backend="torch", device=dev)
        check(np.array_equal(plain.run_batch(cands), pl.makespans),
              f"{gname}: kernel oracle == plain oracle on the card")
        cp = critical_path_assignment(g, tr.dev, seed=0)
        cp_ms = tr.default_engine().exec_time(cp)
        sec = pl.seconds
        print(f"request {gname} x {fleet}: n={g.n} m={g.m} nd={tr.dev.n} "
              f"K_pop={K_POP} greedy_ms={pl.makespans[0] * 1e3:.6f} "
              f"best_sampled_ms={pl.makespans[1:].min() * 1e3:.6f} "
              f"cp_ms={cp_ms * 1e3:.6f} encode_s={sec['encode']:.6f} "
              f"rollout_s={sec['rollout']:.6f} "
              f"oracle_s={sec['oracle']:.6f} "
              f"launches gnn_mp_pair={lp} gnn_mp={lg} wc_trips={lt} "
              f"wc_step={lw}")

    # small input against the CPU reference: same params, same inputs
    tr, pl = trainers[-1], answers[-1]
    cands = np.concatenate([pl.greedy[None], pl.population])
    cpu_ms = TorchWCEngine(tr.g, tr.dev, backend="torch",
                           device="cpu").run_batch(cands)
    check(np.array_equal(cpu_ms, pl.makespans),
          "ffnn: card oracle == CPU oracle")
    gd_cpu = build_graph_data(tr.g, tr.dev, tr.comm_factor, "cpu")
    params_cpu = tree_map(lambda x: x.cpu(), tr.params)
    for a, b in zip(encode(tr.params, tr.gd, "cuda"),
                    encode(params_cpu, gd_cpu, "torch")):
        err = float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                     1.0)
        check(err <= 1e-4, f"ffnn: card encodings vs CPU, rel err {err}")
    print("ffnn x p100x4: card oracle == CPU oracle on all "
          f"{len(cands)} candidates; encodings agree with the CPU")


def profile_request(tr, untraced_s: float) -> dict:
    """One more ``llama_layer`` request under ``torch.profiler``: device
    time per kernel name and the device's busy share of the request.
    Tracing slows the host side only, so the share is also given against
    the untraced request's wall time from the main path."""
    traced_s, _, rows = _trace(lambda: tr.place(n_samples=K_POP, eps=EPS),
                               ("segment_sum_pair", "wc_trips<"))
    busy_s = sum(r[0] for r in rows) * 1e-6
    print(f"profile llama_layer request: traced_s={traced_s:.6f} "
          f"untraced_s={untraced_s:.6f} device_busy_s={busy_s:.6f} "
          f"busy_share_traced={busy_s / traced_s:.6f} "
          f"busy_share_untraced={busy_s / untraced_s:.6f} "
          f"device_launches={sum(r[1] for r in rows)}")
    for us, count, key in rows[:8]:
        print(f"  {us * 1e-3:10.3f} ms  {count:6d} x  {key[:90]}")
    return per_launch_ms(rows, (("gnn_mp", "segment_sum_csr"),
                                ("gnn_mp_pair", "segment_sum_pair"),
                                ("wc_oracle", "wc_step("),
                                ("wc_oracle_trips", "wc_trips<")))


def device_rows(prof) -> list:
    """(device us, launches, name) per kernel name, largest first."""
    rows = []
    for avg in prof.key_averages():
        if str(avg.device_type).endswith("CUDA"):
            us = getattr(avg, "self_device_time_total", None)
            if us is None:
                us = avg.self_cuda_time_total
            rows.append((us, avg.count, avg.key))
    return sorted(rows, reverse=True)


# kernel-name tags of each kind of device work, matched in this order
KERNEL_KINDS = (("flash", ("flash_fwd",)), ("mamba2_scan", ("ssd_",)),
                ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
                ("sort", ("sort", "Sort", "Radix", "searchsorted")),
                ("gather_scatter", ("index", "Index", "gather", "Gather",
                                    "scatter", "Scatter")),
                ("reduce_softmax", ("reduce", "Reduce", "softmax",
                                    "Softmax")),
                ("elementwise", ("elementwise", "vectorized", "unrolled")))


def device_split(rows) -> dict:
    """(device ms, launches) by kind of kernel (KERNEL_KINDS, else
    "other"), largest first."""
    out = {}
    for us, count, key in rows:
        kind = next((k for k, tags in KERNEL_KINDS
                     if any(t in key for t in tags)), "other")
        ms, n = out.get(kind, (0.0, 0))
        out[kind] = (ms + us * 1e-3, n + count)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def per_launch_ms(rows, tags) -> dict:
    """Device ms per launch of each named kernel (None if not traced)."""
    out = {}
    for name, tag in tags:
        hit = [(us, c) for us, c, key in rows if tag in key]
        out[name] = (sum(h[0] for h in hit) * 1e-3
                     / max(sum(h[1] for h in hit), 1)) if hit else None
    return out


# ------------------------------------------------------ serving path
def _as_batch(x) -> dict:
    """Token ids (B, S) as a batch dict; a batch dict as it is."""
    return x if isinstance(x, dict) else {"tokens": x}


def _rows(batch: dict, n: int) -> dict:
    return {k: v[:n] for k, v in batch.items()}


def _n_steps(tokens) -> int:
    return next(iter(_as_batch(tokens).values())).shape[1]


def teacher_forced(params, cfg, prompt, tokens, backend, state_dtype,
                   ssm_backend=None):
    """Prefill ``prompt`` (token ids (B, S) or a batch dict from
    ``prompt_inputs``), then one decode step per column of ``tokens``
    ((B, T) ids, or a dict of step inputs such as the audio stub's frames;
    fed, not sampled); -> the logits of prefill's last position and of
    every step.  ``backend`` serves attention and, unless ``ssm_backend``
    is given, the Mamba2 scan."""
    prompt, tokens = _as_batch(prompt), _as_batch(tokens)
    first = next(iter(prompt.values()))
    B, S, T = first.shape[0], prompt_positions(prompt), _n_steps(tokens)
    state = init_decode_state(cfg, B, S + T, dtype=state_dtype,
                              device=first.device)
    ssm_backend = ssm_backend or backend
    prefill = make_prefill_step(cfg, S + T, backend, ssm_backend)
    decode = make_decode_step(cfg, backend, ssm_backend)
    with torch.inference_mode():
        logits, state = prefill(params, prompt, state)
        out = [logits]
        for i in range(T):
            logits, state = decode(
                params, {k: v[:, i:i + 1] for k, v in tokens.items()},
                state, S + i)
            out.append(logits)
    return out


def compare_paths(params, cfg, prompt, tokens, state_dtype, what,
                  plain=None, fp32=None, fp64=None,
                  kern=None) -> tuple[float, float]:
    """Kernel path vs plain path (both backends "torch") on the card: the
    logits of prefill and of each teacher-forced decode step; -> (max
    scaled gap, its bar).  ``plain`` / ``kern``: the plain / kernel path's
    logits, if already computed.  The bar is LOGITS_TOL, or, given
    ``fp32`` (the plain path's logits at compute_dtype float32 on the same
    weights), the plain path's own largest gap from them.  ``fp64``: the
    plain path's logits in float64 (parameters cast to fp64), a reading
    printed beside the bar."""
    if kern is None:
        kern = teacher_forced(params, cfg, prompt, tokens, "cuda",
                              state_dtype)
    if plain is None:
        plain = teacher_forced(params, cfg, prompt, tokens, "torch",
                               state_dtype)
    check(all(bool(torch.isfinite(x).all()) for x in kern + plain),
          f"{what}: finite logits")
    errs = [scaled_err(a, b) for a, b in zip(kern, plain)]
    tol, vs_fp32 = LOGITS_TOL, ""
    if fp32 is not None:
        tol = max(scaled_err(a, b) for a, b in zip(plain, fp32))
        vs_fp32 = (f"; vs the plain path's fp32 logits: plain "
                   f"{tol} (the bar), kernel "
                   f"{max(scaled_err(a, b) for a, b in zip(kern, fp32))}; "
                   f"argmax agreement of plain with fp32 "
                   f"{argmax_agreement(plain, fp32)}")
    if fp64 is not None:
        vs_fp32 += (f"; vs the plain path in fp64: plain "
                    f"{max(scaled_err64(a, b) for a, b in zip(plain, fp64))},"
                    f" kernel "
                    f"{max(scaled_err64(a, b) for a, b in zip(kern, fp64))}")
    print(f"{what}: kernel vs plain path, logits of prefill + "
          f"{_n_steps(tokens)} decode steps: max scaled err {max(errs)} "
          f"(prefill {errs[0]}, tol {tol}), argmax agreement "
          f"{argmax_agreement(kern, plain)}{vs_fp32}")
    return max(errs), tol


def argmax_agreement(a: list, b: list) -> float:
    """Share of (step, sequence) pairs whose greedy token is the same."""
    same = [(x.argmax(-1) == y.argmax(-1)).float().mean()
            for x, y in zip(a, b)]
    return float(torch.stack(same).mean())


def serve_request(dev, cfg):
    """A serving request through repro_torch.launch.serve's functions:
    ``cfg`` with random seed-0 weights, batch 4 x prompt 2048 (+ patches),
    32 greedy tokens (the audio stub fed fresh frames each step).  Launch
    counts are reset just before and read just after; -> (params, the
    prompt's batch dict, the decode steps' inputs or None, the result,
    launches, peak GB)."""
    params = load_model(cfg, seed=0, device=dev)
    prompt, steps = prompt_inputs(cfg, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN,
                                  seed=0, device=dev)
    small, small_steps = prompt_inputs(cfg, SERVE_BATCH, 64, 2, 0, dev)
    generate(params, cfg, small, 2, step_inputs=small_steps)  # set-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa_ops.launches = ssd_ops.launches = 0
    fa_ops.kernel_launches.update(flash_fwd_wgmma=0, flash_fwd_mma=0)
    res = generate(params, cfg, prompt, SERVE_GEN, step_inputs=steps)
    launches = {"flash_attention": fa_ops.launches,
                "mamba2_scan": ssd_ops.launches, **fa_ops.kernel_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    return params, prompt, steps, res, launches, peak_gb


def serve_path(dev, arch, layers=None):
    """``serve_request`` for a token-fed config at full width (over its
    first ``layers`` layers, if given); the prompt as token ids."""
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params, prompt, _, res, launches, peak_gb = serve_request(dev, cfg)
    return cfg, params, prompt["tokens"], res, launches, peak_gb


def print_serve(cfg, res, launches, peak_gb) -> None:
    steps = SERVE_GEN - 1
    print(f"serve {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"random seed-0 weights, {cfg.compute_dtype}, {CARD}): batch "
          f"{SERVE_BATCH} prompt {SERVE_PROMPT} gen {SERVE_GEN}: "
          f"prefill_s={res.prefill_s:.6f} prefill_tokens_per_s="
          f"{SERVE_BATCH * SERVE_PROMPT / res.prefill_s:.1f} "
          f"decode_ms_per_step={res.decode_ms_per_step:.6f} "
          f"decode_tokens_per_s={SERVE_BATCH * steps / res.decode_s:.1f} "
          f"peak_memory_gb={peak_gb:.3f} launches {launches}")


def check_outputs(cfg, res) -> None:
    check(res.tokens.shape == (SERVE_BATCH, SERVE_GEN)
          and bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()),
          f"{cfg.name}: generated tokens")
    check(all(lg.shape == (SERVE_BATCH, cfg.vocab)
              and bool(torch.isfinite(lg).all()) for lg in res.logits),
          f"{cfg.name}: finite logits of the expected shape")


def check_serve_path(cfg, params, prompt, res, launches, peak_gb, dev):
    n_attn = cfg.pattern_for_depth().count("attn_shared")
    n_mamba = cfg.pattern_for_depth().count("mamba")
    check((cfg.n_layers, cfg.d_model, cfg.vocab) == (38, 2048, 32000),
          "zamba2-1.2B at its published width")
    check(launches == {"flash_attention": n_attn, "mamba2_scan": n_mamba,
                       "flash_fwd_wgmma": n_attn, "flash_fwd_mma": 0}
          == {"flash_attention": 6, "mamba2_scan": 32, "flash_fwd_wgmma": 6,
              "flash_fwd_mma": 0},
          f"one prefill launches flash_attention 6x, all flash_fwd_wgmma, "
          f"and mamba2_scan 32x: {launches}")
    check_outputs(cfg, res)
    print_serve(cfg, res, launches, peak_gb)
    # fp32 on the same draws (init_params is fp32; the cast is a no-op).
    # bf16 on several seeds, each against its own plain fp32 logits; the
    # gaps of all seeds are printed before any is checked
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gaps = []
    for seed in BF16_SEEDS:
        p16, toks, pr = params, res.tokens, prompt
        if seed:
            p16 = load_model(cfg, seed=seed, device=dev)
            pr = prompt_tokens(cfg, SERVE_BATCH, SERVE_PROMPT, seed=seed,
                               device=dev)
            toks = generate(p16, cfg, pr, SERVE_GEN).tokens
        p32 = load_model(cfg32, seed=seed, device=dev)
        plain32 = teacher_forced(p32, cfg32, pr, toks, "torch",
                                 torch.float32)
        gaps.append(compare_paths(
            p16, cfg, pr, toks, torch.bfloat16,
            f"{cfg.name} bf16, {cfg.n_layers} layers, seed {seed}",
            fp32=plain32))
        if not seed:
            # a reading beside the fp32 gate, which stays as it is: both
            # paths against the plain path run in float64
            p64 = tree_map(lambda x: x.double() if x.is_floating_point()
                           else x, p32)
            plain64 = teacher_forced(p64, cfg32, pr, toks, "torch",
                                     torch.float64)
            del p64
            err, tol = compare_paths(
                p32, cfg32, pr, toks, torch.float32,
                f"{cfg.name} fp32, {cfg.n_layers} layers", plain=plain32,
                fp64=plain64)
            del plain64
            # readings beside the gate: each kernel alone on the kernel path
            for attn, ssm in (("cuda", "torch"), ("torch", "cuda")):
                one = teacher_forced(p32, cfg32, pr, toks, attn,
                                     torch.float32, ssm)
                print(f"{cfg.name} fp32, {cfg.n_layers} layers, attention "
                      f"{attn}, mamba2_scan {ssm}: vs the plain path "
                      f"{max(scaled_err(a, b) for a, b in zip(one, plain32))}")
                del one
            check(err <= tol, f"fp32 {cfg.n_layers} layers: kernel vs plain "
                              f"logits {err} > {tol}")
        del p16, p32, plain32
    for seed, (err, tol) in zip(BF16_SEEDS, gaps):
        check(err <= tol, f"bf16 seed {seed}: kernel vs plain logits {err} "
                          f"> the plain path's own bf16 gap {tol}")
    cfg6 = dataclasses.replace(cfg32, n_layers=6)
    err, tol = compare_paths(load_model(cfg6, seed=0, device=dev), cfg6,
                             prompt, res.tokens, torch.float32,
                             f"{cfg.name} fp32, one full-width unit "
                             f"(6 layers)")
    check(err <= tol, f"fp32 6 layers: kernel vs plain logits {err} > {tol}")


def check_gemma_path(cfg, params, prompt, res, launches, peak_gb, dev):
    """gemma-2b: launches, outputs, and its logits gates: bf16 over 18
    layers on each of GEMMA_BF16_SEEDS against the plain path's own bf16
    gap, fp32 over 18 layers at batch 1 within LOGITS_TOL (the fp64
    reading beside it)."""
    n_attn = cfg.pattern_for_depth().count("attn")
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.head_dim,
           cfg.n_kv_heads) == (18, 2048, 256000, 256, 1),
          "gemma-2b at its published width and depth")
    check(launches == {"flash_attention": n_attn, "mamba2_scan": 0,
                       "flash_fwd_wgmma": 0, "flash_fwd_mma": n_attn}
          and n_attn == 18,
          f"one gemma-2b prefill launches flash_attention 18x, all "
          f"flash_fwd_mma: {launches}")
    check_outputs(cfg, res)
    print_serve(cfg, res, launches, peak_gb)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gaps = []
    for seed in GEMMA_BF16_SEEDS:
        p16, toks, pr = params, res.tokens, prompt
        if seed:
            p16 = load_model(cfg, seed=seed, device=dev)
            pr = prompt_tokens(cfg, SERVE_BATCH, SERVE_PROMPT, seed=seed,
                               device=dev)
            toks = generate(p16, cfg, pr, SERVE_GEN).tokens
        p32 = load_model(cfg32, seed=seed, device=dev)
        plain32 = teacher_forced(p32, cfg32, pr, toks, "torch",
                                 torch.float32)
        del p32
        gaps.append(compare_paths(
            p16, cfg, pr, toks, torch.bfloat16,
            f"{cfg.name} bf16, {cfg.n_layers} layers, seed {seed}",
            fp32=plain32))
        del p16, plain32
        torch.cuda.empty_cache()
    for seed, (err, tol) in zip(GEMMA_BF16_SEEDS, gaps):
        check(err <= tol, f"{cfg.name} bf16 seed {seed}: kernel vs plain "
                          f"logits {err} > the plain path's own bf16 gap "
                          f"{tol}")
    # fp32 over the full depth at batch 1, the fp64 reading beside it
    p32 = load_model(cfg32, seed=0, device=dev)
    pr, toks = prompt[:1], res.tokens[:1]
    plain32 = teacher_forced(p32, cfg32, pr, toks, "torch", torch.float32)
    p64 = tree_map(lambda x: x.double() if x.is_floating_point() else x,
                   p32)
    plain64 = teacher_forced(p64, cfg32, pr, toks, "torch", torch.float64)
    del p64
    torch.cuda.empty_cache()
    err, tol = compare_paths(p32, cfg32, pr, toks, torch.float32,
                             f"{cfg.name} fp32, {cfg.n_layers} layers, "
                             f"batch 1", plain=plain32, fp64=plain64)
    del p32, plain32, plain64
    torch.cuda.empty_cache()
    check(err <= tol, f"{cfg.name} fp32 {cfg.n_layers} layers: kernel vs "
                      f"plain logits {err} > {tol}")


def check_xlstm_path(cfg, params, prompt, res, launches, peak_gb, dev):
    """xlstm-1.3b over XLSTM_SERVE_LAYERS of its 48 layers: launches,
    outputs, and its logits gates, at zamba2's bars: bf16 over those
    layers on each of XLSTM_BF16_SEEDS against the plain path's own bf16
    gap; fp32 over one full-width unit (XLSTM_UNIT_LAYERS: 7 mLSTM + 1
    sLSTM) within LOGITS_TOL, both paths' error against the plain path in
    float64 printed beside it."""
    pattern = cfg.pattern_for_depth()
    n_m, n_s = pattern.count("mlstm"), pattern.count("slstm")
    full = get_config(XLSTM_ARCH)
    check((full.n_layers, cfg.n_layers, cfg.d_model, cfg.vocab, n_m, n_s)
          == (48, XLSTM_SERVE_LAYERS, 2048, 50304,
              7 * XLSTM_SERVE_LAYERS // 8, XLSTM_SERVE_LAYERS // 8),
          f"xlstm-1.3b at its published width over {XLSTM_SERVE_LAYERS} of "
          f"its 48 layers")
    check(launches == {"flash_attention": 0, "mamba2_scan": n_m,
                       "flash_fwd_wgmma": 0, "flash_fwd_mma": 0},
          f"one xlstm-1.3b prefill launches mamba2_scan {n_m}x and "
          f"flash_attention never: {launches}")
    check_outputs(cfg, res)
    print_serve(cfg, res, launches, peak_gb)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gaps = []
    for seed in XLSTM_BF16_SEEDS:
        p16, toks, pr = params, res.tokens, prompt
        if seed:
            p16 = load_model(cfg, seed=seed, device=dev)
            pr = prompt_tokens(cfg, SERVE_BATCH, SERVE_PROMPT, seed=seed,
                               device=dev)
            toks = generate(p16, cfg, pr, SERVE_GEN).tokens
        p32 = load_model(cfg32, seed=seed, device=dev)
        plain32 = teacher_forced(p32, cfg32, pr, toks, "torch",
                                 torch.float32)
        del p32
        gaps.append(compare_paths(
            p16, cfg, pr, toks, torch.bfloat16,
            f"{cfg.name} bf16, {cfg.n_layers} layers, seed {seed}",
            fp32=plain32))
        del p16, plain32
        torch.cuda.empty_cache()
    for seed, (err, tol) in zip(XLSTM_BF16_SEEDS, gaps):
        check(err <= tol, f"{cfg.name} bf16 seed {seed}: kernel vs plain "
                          f"logits {err} > the plain path's own bf16 gap "
                          f"{tol}")
    cfg_u = dataclasses.replace(cfg32, n_layers=XLSTM_UNIT_LAYERS)
    p32 = load_model(cfg_u, seed=0, device=dev)
    plain32 = teacher_forced(p32, cfg_u, prompt, res.tokens, "torch",
                             torch.float32)
    p64 = tree_map(lambda x: x.double() if x.is_floating_point() else x,
                   p32)
    plain64 = teacher_forced(p64, cfg_u, prompt, res.tokens, "torch",
                             torch.float64)
    del p64
    err, tol = compare_paths(p32, cfg_u, prompt, res.tokens, torch.float32,
                             f"{cfg.name} fp32, one full-width unit "
                             f"({XLSTM_UNIT_LAYERS} layers)", plain=plain32,
                             fp64=plain64)
    del p32, plain32, plain64
    torch.cuda.empty_cache()
    check(err <= tol, f"{cfg.name} fp32 {XLSTM_UNIT_LAYERS} layers: kernel "
                      f"vs plain logits {err} > {tol}")


@contextlib.contextmanager
def _around_slstm(hook):
    """Inside the block each ``slstm_forward`` call of the model runs as
    ``hook(call)``, ``call`` the call itself."""
    f = lm.slstm_forward
    lm.slstm_forward = lambda *a, **kw: hook(lambda: f(*a, **kw))
    try:
        yield
    finally:
        lm.slstm_forward = f


def slstm_in_prefill(params, cfg, prompt) -> dict:
    """The sLSTM's loop over time (plain PyTorch, no kernel of its own)
    inside served prefills: in one, each sLSTM block's call timed on the
    host between device syncs, beside the prefill's own seconds; in a
    second, the first sLSTM block's call under a device-only profiler
    session, for its launches and device time (a session may lose a few
    records, so the launches are as recorded; all six would cost ~60 s of
    profiler post-processing)."""
    B, S = prompt.shape
    state = init_decode_state(cfg, B, S + SERVE_GEN, device=prompt.device)
    prefill = make_prefill_step(cfg, S + SERVE_GEN)
    calls_s, rows = [], []

    def timed(call):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        calls_s.append(time.perf_counter() - t0)
        return out

    def traced_first(call):
        if rows:
            return call()
        out = []
        rows.extend(_trace(lambda: out.append(call()), cpu=False)[2])
        return out[-1]

    with torch.inference_mode():
        with _around_slstm(timed):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, {"tokens": prompt}, state)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
        with _around_slstm(traced_first):
            prefill(params, {"tokens": prompt}, state)
    n_s = cfg.pattern_for_depth().count("slstm")
    check(len(calls_s) == n_s, f"one prefill runs {n_s} sLSTM blocks: "
                               f"{len(calls_s)}")
    slstm_s = sum(calls_s)
    launches = sum(r[1] for r in rows)
    busy_s = sum(r[0] for r in rows) * 1e-6
    print(f"sLSTM loop in a prefill ({CARD}; B {B} x S {S}, {n_s} blocks): "
          f"{slstm_s:.6f} s of a {prefill_s:.6f} s prefill (synced at each "
          f"block; blocks " + ", ".join(f"{t:.6f}" for t in calls_s)
          + f" s); in another prefill the first block {launches} device "
          f"launches recorded ({launches / S:.1f} a step), {busy_s:.6f} s "
          f"device busy")
    return {"blocks": n_s, "prefill_s": slstm_s, "block_s": calls_s,
            "synced_prefill_s": prefill_s, "first_block_launches": launches,
            "first_block_device_busy_s": busy_s}


def xlstm_path(dev) -> dict:
    """Path 13: the kernel at xLSTM's shape, then xlstm-1.3b served
    (launch counts reset just before the request and read just after),
    its gates, the sLSTM loop's reading and one profiled prefill and
    decode step; -> the ``xlstm`` record of the ``mamba2_scan`` entry."""
    t_path = time.perf_counter()
    parts = {}

    def part(name, t0):
        parts[name] = round(time.perf_counter() - t0, 3)
        return time.perf_counter()

    t0 = time.perf_counter()
    xlstm = check_mamba2_xlstm(dev, get_config(XLSTM_ARCH))
    t0 = part("kernel", t0)
    cfg, params, prompt, res, launches, peak_gb = serve_path(
        dev, XLSTM_ARCH, XLSTM_SERVE_LAYERS)
    t0 = part("serve", t0)
    check_xlstm_path(cfg, params, prompt, res, launches, peak_gb, dev)
    t0 = part("gates", t0)
    slstm = slstm_in_prefill(params, cfg, prompt)
    t0 = part("slstm", t0)
    # one ssd_scan call that returns has launched each of its kernels once
    serve_ms, by_kernel, _ = profile_serve(
        params, cfg, prompt, res,
        {"flash_fwd_wgmma<": 0, "flash_fwd_mma<": 0,
         **{name: launches["mamba2_scan"] for name in ssd_ops.KERNELS}},
        cpu=False,
        counted=lambda: {"flash_fwd_wgmma<":
                         fa_ops.kernel_launches["flash_fwd_wgmma"],
                         "flash_fwd_mma<":
                         fa_ops.kernel_launches["flash_fwd_mma"],
                         **dict.fromkeys(ssd_ops.KERNELS, ssd_ops.launches)})
    part("profile", t0)
    xlstm.update(
        launches=launches["mamba2_scan"],
        device_ms=serve_ms.get("mamba2_scan"), device_ms_by_kernel=by_kernel,
        serve={"prefill_s": res.prefill_s,
               "decode_ms_per_step": res.decode_ms_per_step,
               "decode_tokens_per_s": SERVE_BATCH * (SERVE_GEN - 1)
               / res.decode_s, "peak_memory_gb": peak_gb},
        slstm=slstm)
    del params, res
    torch.cuda.empty_cache()
    print(f"path 13 wall s: {time.perf_counter() - t_path:.3f} {parts}; "
          f"launches {launches}")
    return xlstm


# ------------------------------------------------------------- path 14
def path14_config(arch, table=None):
    """``arch`` at its published width, at the depth path 14 (or
    ``table``'s path) serves."""
    table = PATH14 if table is None else table
    return dataclasses.replace(get_config(arch), n_layers=table[arch][0])


@contextlib.contextmanager
def _around_moe_route(hook):
    """Inside the block each ``moe_route`` call of the model runs as
    ``hook(route, params, xf, cfg)``, ``route`` the function itself."""
    f = moe_mlp.moe_route
    moe_mlp.moe_route = lambda params, xf, cfg: hook(f, params, xf, cfg)
    try:
        yield
    finally:
        moe_mlp.moe_route = f


def recorded_routes(log: list):
    """Every ``moe_route`` call's expert choices appended to ``log``."""
    def hook(route, params, xf, cfg):
        r = route(params, xf, cfg)
        log.append(r.experts)
        return r
    return _around_moe_route(hook)


def forced_routes(log: list, stats: dict):
    """Each ``moe_route`` call forced onto the next of ``log``'s choices,
    its gate values this run's own probabilities there.  ``stats``: calls,
    (token, slot) choices, how many of them the call's own top-k would
    have made differently, and the smallest gap between the K-th and the
    (K+1)-th probability among the tokens that differ."""
    calls = iter(log)
    stats.update(calls=0, choices=0, differ=0, min_margin=None)

    def hook(route, params, xf, cfg):
        forced = next(calls)
        own = route(params, xf, cfg)
        K = cfg.top_k
        missing = (own.experts[:, :, None] != forced[:, None, :]).all(-1)
        n = int(missing.sum())
        stats["calls"] += 1
        stats["choices"] += missing.numel()
        stats["differ"] += n
        if n:
            top = own.probs.topk(K + 1, dim=-1).values
            gap = float((top[:, K - 1] - top[:, K])[missing.any(-1)].min())
            m = stats["min_margin"]
            stats["min_margin"] = gap if m is None else min(m, gap)
        return route(params, xf, cfg, experts=forced)
    return _around_moe_route(hook)


def moe_drop_shares(params, cfg, prompt, fed) -> tuple[float, float]:
    """The share of top-k assignments dropped (past an expert's capacity)
    over the layers of one kernel-path prefill of ``prompt`` and of the
    decode step after it, fed the first column of ``fed``."""
    drops = []

    def hook(route, p, xf, moe):
        r = route(p, xf, moe)
        cap = moe_mlp.moe_capacity(xf.shape[0], moe)
        keep = moe_mlp.moe_slots(r.experts, moe.n_experts, cap).keep
        drops.append(((~keep).sum(), keep.numel()))
        return r
    with _around_moe_route(hook):
        teacher_forced(params, cfg, prompt,
                       {k: v[:, :1] for k, v in fed.items()}, "cuda",
                       torch.bfloat16)
    L = cfg.n_layers
    check(len(drops) == 2 * L, f"{cfg.name}: one route a layer a pass")
    share = lambda d: sum(int(x) for x, _ in d) / sum(n for _, n in d)
    return share(drops[:L]), share(drops[L:])


def check_flash_path14(dev, cfgs, label="path 14") -> dict:
    """``flash_attention`` against its plain version at each config's
    prefill shape (bf16 at batch 4, fp32 at batch 1: the shapes of its
    serve and its gates), then timed in bf16 at each; -> the timings by
    arch."""
    gen = torch.Generator(dev).manual_seed(14)
    errs, timed = {}, {}
    for cfg in cfgs:
        S = SERVE_PROMPT + (cfg.n_patches if cfg.frontend == "vision_stub"
                            else 0)
        shape = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        for b, dt in ((SERVE_BATCH, torch.bfloat16), (1, torch.float32)):
            q, k, v = _qkv(gen, b, S, *shape, dt, dev)
            got = fa_ops.flash_attention(q, k, v, backend="cuda")
            ref = attention_ref(q, k, v)
            diff = (got.float() - ref.float()).abs()
            tol = FLASH_TOL[dt]
            check(got.dtype == dt and bool(torch.isfinite(got).all())
                  and bool((diff <= tol + tol * ref.float().abs()).all()),
                  f"flash_attention at {cfg.name}'s shape {b, S, *shape, dt}:"
                  f" max abs err {float(diff.max())}")
            errs[f"{cfg.name} {str(dt).split('.')[-1]}"] = float(diff.max())
            del q, k, v, got, ref, diff
        timed[cfg.name] = time_flash(dev, gen, (SERVE_BATCH, S, *shape),
                                     torch.bfloat16, BF16_FLOP_PER_S)
        torch.cuda.empty_cache()
    print(f"flash_attention vs plain at {label}'s prefill shapes (bf16 B "
          f"{SERVE_BATCH}, fp32 B 1): max abs err {errs}")
    return timed


def path14_gates(arch, cfg, params, prompt, fed, dev,
                 no_fp64=PATH14_NO_FP64) -> dict:
    """bf16 over the full depth: kernel path vs plain path within the plain
    path's own bf16-vs-fp32 gap; fp32 at batch 1 over the full depth
    within LOGITS_TOL, the fp64 reading beside it (not for ``no_fp64``),
    the MoE configs' plain runs forced onto the kernel
    run's expert choices.  The checks come after both are printed."""
    L = cfg.n_layers
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    p32 = load_model(cfg32, seed=0, device=dev)
    plain32 = teacher_forced(p32, cfg32, prompt, fed, "torch", torch.float32)
    err16, tol16 = compare_paths(params, cfg, prompt, fed, torch.bfloat16,
                                 f"{cfg.name} bf16, {L} layers, seed 0",
                                 fp32=plain32)
    del plain32
    torch.cuda.empty_cache()
    pr1, fed1 = _rows(prompt, 1), _rows(fed, 1)
    log, stats, stats64 = [], {}, {}
    with recorded_routes(log):
        kern = teacher_forced(p32, cfg32, pr1, fed1, "cuda", torch.float32)
    with forced_routes(log, stats):
        plain32 = teacher_forced(p32, cfg32, pr1, fed1, "torch",
                                 torch.float32)
    plain64 = None
    if arch not in no_fp64:
        p64 = tree_map(lambda x: x.double() if x.is_floating_point() else x,
                       p32)
        with forced_routes(log, stats64):
            plain64 = teacher_forced(p64, cfg32, pr1, fed1, "torch",
                                     torch.float64)
        del p64
        torch.cuda.empty_cache()
    err, tol = compare_paths(p32, cfg32, pr1, fed1, torch.float32,
                             f"{cfg.name} fp32, {L} layers, batch 1",
                             plain=plain32, fp64=plain64, kern=kern)
    n_calls = len(log)
    del p32, plain32, plain64, kern, log
    torch.cuda.empty_cache()
    if cfg.moe is not None:
        print(f"{cfg.name} fp32 gate, routing: the plain runs forced onto the "
              f"kernel run's experts in {stats['calls']} of {n_calls} "
              f"moe_route calls; the plain run's own top-{cfg.moe.top_k} "
              f"differs in {stats['differ']} of {stats['choices']} (token, "
              f"slot) choices (min gap K-th to (K+1)-th probability among "
              f"them {stats['min_margin']}), the fp64 run's in "
              f"{stats64.get('differ')} (min gap {stats64.get('min_margin')})")
        check(n_calls == L * (1 + _n_steps(fed1)) == stats["calls"]
              and stats64.get("calls", n_calls) == n_calls,
              f"{cfg.name}: one route a layer a pass, every one of the "
              f"plain runs forced")
    check(err16 <= tol16, f"{cfg.name} bf16: kernel vs plain logits {err16} "
                          f"> the plain path's own bf16 gap {tol16}")
    check(err <= tol, f"{cfg.name} fp32 {L} layers: kernel vs plain logits "
                      f"{err} > {tol}")
    return {"bf16": {"err": err16, "bar": tol16},
            "fp32": {"err": err, "bar": tol},
            "routing_fp32": stats if cfg.moe else None,
            "routing_fp64": stats64 if cfg.moe else None}


def serve_config14(dev, arch, table=PATH14, no_fp64=PATH14_NO_FP64,
                   profiled=PATH14_PROFILED, label="path 14") -> dict:
    """One config of path 14 (or of ``table``'s path): served, checked,
    gated, maybe profiled."""
    t0 = time.perf_counter()
    cfg = path14_config(arch, table)
    L, kernel = table[arch]
    pub = get_config(arch)
    check(dataclasses.replace(cfg, n_layers=pub.n_layers) == pub,
          f"{cfg.name} at its published width")
    params, prompt, steps, res, launches, peak_gb = serve_request(dev, cfg)
    other = ({"flash_fwd_wgmma", "flash_fwd_mma"} - {kernel}).pop()
    want = {"flash_attention": L, "mamba2_scan": 0, kernel: L, other: 0}
    check(launches == want, f"one {cfg.name} prefill launches "
                            f"flash_attention {L}x, all {kernel}, "
                            f"mamba2_scan never: {launches}")
    check_outputs(cfg, res)
    fed = steps if steps is not None else {"tokens": res.tokens}
    drops = None
    if cfg.moe is not None:
        drops = moe_drop_shares(params, cfg, prompt, fed)
    positions = prompt_positions(prompt)
    n_steps = SERVE_GEN - 1
    print(f"serve {cfg.name} ({L} layers, d_model {cfg.d_model}, random "
          f"seed-0 weights, {cfg.compute_dtype}, {CARD}): batch "
          f"{SERVE_BATCH} prompt {SERVE_PROMPT} ({positions} positions) "
          f"gen {SERVE_GEN}: prefill_s={res.prefill_s:.6f} "
          f"prefill_positions_per_s="
          f"{SERVE_BATCH * positions / res.prefill_s:.1f} "
          f"decode_ms_per_step={res.decode_ms_per_step:.6f} "
          f"decode_tokens_per_s={SERVE_BATCH * n_steps / res.decode_s:.1f} "
          f"peak_memory_gb={peak_gb:.3f} launches {launches}"
          + (f" dropped_share_prefill={drops[0]:.6f} "
             f"dropped_share_decode_step={drops[1]:.6f}" if drops else ""))
    t_serve = time.perf_counter()
    gates = path14_gates(arch, cfg, params, prompt, fed, dev, no_fp64)
    t_gates = time.perf_counter()
    split = None
    if arch in profiled:
        # launches by the wrappers' counts: a session may lose records
        _, _, split = profile_serve(
            params, cfg, prompt, res, {f"{kernel}<": L, f"{other}<": 0},
            counted=lambda: {f"{k}<": fa_ops.kernel_launches[k]
                             for k in (kernel, other)})
    serve = {"prefill_s": res.prefill_s,
             "decode_ms_per_step": res.decode_ms_per_step,
             "decode_tokens_per_s": SERVE_BATCH * n_steps / res.decode_s,
             "peak_memory_gb": peak_gb}
    del params, res
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    print(f"{label} {cfg.name} wall s: {t1 - t0:.3f} (serve "
          f"{t_serve - t0:.3f}, gates {t_gates - t_serve:.3f}, profile "
          f"{t1 - t_gates:.3f})")
    return {"kernel": kernel, "launches": launches[kernel], "layers": L,
            "serve": serve, "dropped_share": drops, "gates": gates,
            "device_split": split}


def path14(dev) -> tuple[dict, dict]:
    """Path 14: the flash kernel at each config's shapes, then each config
    served and gated; -> the records of ``flash_fwd_wgmma``'s configs and
    of ``flash_fwd_mma``'s."""
    t_path = time.perf_counter()
    timed = check_flash_path14(dev, [path14_config(a) for a in PATH14])
    by_kernel = {"flash_fwd_wgmma": {}, "flash_fwd_mma": {}}
    for arch in PATH14:
        rec = serve_config14(dev, arch)
        rec["kernel_timing"] = timed[path14_config(arch).name]
        by_kernel[rec["kernel"]][arch] = rec
    print(f"path 14 wall s: {time.perf_counter() - t_path:.3f}; flash "
          f"launches a prefill " + str({a: r["launches"] for k in by_kernel
                                        for a, r in by_kernel[k].items()}))
    return by_kernel["flash_fwd_wgmma"], by_kernel["flash_fwd_mma"]


# ------------------------------------------------------- LM training path
def _zero_lm_counts() -> None:
    fa_ops.launches = ssd_ops.launches = 0
    fa_ops.kernel_launches.update(flash_fwd_wgmma=0, flash_fwd_mma=0)


def _lm_counts() -> dict:
    return {"mamba2_scan": ssd_ops.launches, **fa_ops.kernel_launches}


def step_launches(cfg) -> dict:
    """The kernel launches one train step of ``cfg`` makes: one a block's
    forward, twice for the unit's blocks under remat (the recompute in
    the backward pass, under "full" and "dots" alike: "dots" keeps only
    the products without a batch dim; the remainder runs once, as the
    reference's ``jax.checkpoint`` wraps only its scan body); the plain
    backward launches none."""
    unit, reps, rem = lm.unit_and_reps(cfg)
    k = 2 if cfg.remat and cfg.remat_policy in ("full", "dots") else 1
    n = lambda kinds: (k * reps * sum(x in kinds for x in unit)
                       + sum(x in kinds for x in rem))
    attn = n(lm.ATTN_KINDS)
    wgmma = fa_ops.uses_wgmma(lm.dtype_of(cfg.compute_dtype), cfg.head_dim)
    return {"mamba2_scan": n(("mamba", "mlstm")),
            "flash_fwd_wgmma": attn if wgmma else 0,
            "flash_fwd_mma": 0 if wgmma else attn}


def lm_grads(params, cfg, batch, backend) -> tuple:
    """``lm_loss`` and its gradients at ``params``, attention and the
    scans on ``backend``; -> (ce, aux, grads)."""
    (_, (ce, aux)), grads = value_and_grad(
        lambda p: lm.lm_loss(p, cfg, batch, attn_backend=backend,
                             ssm_backend=backend), params, has_aux=True)
    return float(ce), float(aux), grads


def leaf_names(tree, prefix="") -> list:
    """Each leaf's path, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in
                leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree) for n in
                leaf_names(t, f"{prefix}{i}.")]
    return [] if tree is None else [prefix[:-1]]


def leaf_gaps(got, ref) -> list:
    """Per leaf: max |got - ref| over max |ref| (0 where both are 0)."""
    out = []
    for a, b in zip(tree_leaves(got), tree_leaves(ref)):
        gap, top = float((a - b).abs().max()), float(b.abs().max())
        out.append(gap / top if top else (0.0 if gap == 0 else float("inf")))
    return out


def hold_grads(what, kern, plain, plain32=None, tol=None,
               gated: bool = True) -> dict:
    """Gradients on the kernel backends against the plain backends, leaf
    by leaf, each gap over the leaf's max, within ``tol`` or, given
    ``plain32`` (the plain gradient at compute dtype fp32 from the same
    params and batch), within the plain path's own bf16 gap: its largest
    leaf gap to ``plain32``, as the serving gates take the largest gap
    over all logits.  Beside it, a reading: the largest share of the same
    leaf's own bf16 gap.  Every gradient finite.  Printed before it is
    checked."""
    names = leaf_names(kern)
    gaps = leaf_gaps(kern, plain)
    own = leaf_gaps(plain, plain32) if plain32 is not None else None
    bar = max(own) if own is not None else tol
    finite = all(bool(torch.isfinite(g).all()) for g in
                 tree_leaves(kern) + tree_leaves(plain))
    worst = int(np.argmax(gaps))
    line = (f"{what}: gradients, kernel vs plain backends, {len(gaps)} "
            f"leaves: max gap over the leaf's max {gaps[worst]} "
            f"({names[worst]}), bar {bar}")
    share = None
    if own is not None:
        shares = [g / b if b else (0.0 if g == 0 else float("inf"))
                  for g, b in zip(gaps, own)]
        k = int(np.argmax(shares))
        share = shares[k]
        line += (f" (the plain path's bf16-vs-fp32 gap, at "
                 f"{names[int(np.argmax(own))]}; median over leaves "
                 f"{float(np.median(own))}); reading: largest share of the "
                 f"same leaf's own gap {share} ({names[k]}: {gaps[k]} vs "
                 f"{own[k]})")
    print(line + f"; finite {finite}" + ("" if gated else "; not gated"))
    check(finite, f"{what}: finite gradients")
    check(gaps[worst] <= bar or not gated,
          f"{what}: gradient gap {gaps[worst]} at {names[worst]} > {bar}")
    return {"max_gap": gaps[worst], "bar": bar, "leaf": names[worst],
            "largest_share_of_own_leaf_gap": share}


def gate_grads(what, params, cfg, batch, gated: bool = True) -> dict:
    """Gate (i): the kernel backends' gradients against the plain
    backends', within the plain path's own bf16-vs-fp32 gap; -> its
    record, with the plain fp32 gradient (``plain32``) for 15b's fp32
    gate.  ``gated=False``: printed, not checked."""
    ce, aux, kern = lm_grads(params, cfg, batch, "cuda")
    ce_p, _, plain = lm_grads(params, cfg, batch, "torch")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ce32, _, plain32 = lm_grads(params, cfg32, batch, "torch")
    print(f"{what}: ce kernel {ce} plain {ce_p} plain fp32 {ce32}, aux {aux}")
    check(all(np.isfinite([ce, ce_p, ce32, aux])), f"{what}: finite losses")
    out = hold_grads(what, kern, plain, plain32, gated=gated)
    del kern, plain
    torch.cuda.empty_cache()
    return {**out, "ce": ce, "ce_plain": ce_p, "ce_plain_fp32": ce32,
            "plain32": plain32}


def backward_recompute_ms(cfg, batch_shape, dev) -> dict:
    """Device ms of one backward of each kernel's Function (the plain
    recompute and its gradient) at ``cfg``'s train shapes, random
    inputs: the profiler's kernel time over 3 backwards."""
    B, S = batch_shape
    gen = torch.Generator(dev).manual_seed(15)
    cdt = lm.dtype_of(cfg.compute_dtype)

    def device_ms(y, wrt):
        g = torch.randn_like(y)
        torch.autograd.grad(y, wrt, g, retain_graph=True)      # warm-up
        _, _, rows = _trace(lambda: [torch.autograd.grad(
            y, wrt, g, retain_graph=True) for _ in range(3)], cpu=False)
        return sum(r[0] for r in rows) * 1e-3 / 3
    out = {}
    if any(k in lm.ATTN_KINDS for k in cfg.block_pattern):
        q, k, v = (t.requires_grad_() for t in _qkv(
            gen, B, S, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cdt, dev))
        out["flash_attention"] = device_ms(
            fa_ops.flash_attention(q, k, v, backend="cuda"), (q, k, v))
        del q, k, v
    if "mamba" in cfg.block_pattern:
        H, N = cfg.ssm.n_heads, cfg.ssm.state_dim
        P = cfg.ssm.expand * cfg.d_model // H
        q, k, v, log_a, _ = _ssd_inputs(gen, B, S, H, N, P, dev)
        leaves = [t.detach().requires_grad_() for t in
                  (q[:, :, 0], k[:, :, 0], v, log_a)]
        qq, kk = (t[:, :, None].expand(B, S, H, N) for t in leaves[:2])
        y, _ = ssd_ops.ssd_scan(qq, kk, leaves[2], leaves[3], cfg.ssm.chunk,
                                backend="cuda")
        out["mamba2_scan"] = device_ms(y, leaves)
    torch.cuda.empty_cache()
    return out


def profile_train_step(step_fn, params, opt, batch, step) -> dict:
    """One more train step under ``torch.profiler`` (device only): device
    ms by kind (``device_split``) and the kernels' forwards' share."""
    traced_s, _, rows = _trace(lambda: step_fn(params, opt, batch, step),
                               ("flash_fwd", "ssd_"), cpu=False)
    busy_ms = sum(r[0] for r in rows) * 1e-3
    split = device_split(rows)
    print(f"profiled train step: traced_s={traced_s:.6f} device_busy_ms="
          f"{busy_ms:.3f} device_launches={sum(r[1] for r in rows)} by "
          f"kind " + ", ".join(f"{k} {ms:.3f} ms / {n}" for k, (ms, n)
                               in split.items()))
    for us, count, key in rows[:8]:
        print(f"  {us * 1e-3:10.3f} ms  {count:6d} x  {key[:90]}")
    return {"traced_s": traced_s, "device_busy_ms": busy_ms,
            "split": {k: ms for k, (ms, _) in split.items()}}


def path15a(dev) -> dict:
    """15a: zamba2-1.2B trained at full width and depth (38 layers, f32
    params, bf16 compute, remat) through ``make_train_step``: gates (i)
    and (ii) on step 0's gradients, TRAIN15_STEPS steps on the kernel
    backends with their launches counted, gates (iii) and (iv), a
    profiled step and the Functions' backward timed."""
    t0 = time.perf_counter()
    cfg = get_config(TRAIN15_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.param_dtype,
           cfg.compute_dtype, cfg.remat, cfg.remat_policy)
          == (38, 2048, 32000, "float32", "bfloat16", True, "full"),
          "zamba2-1.2B at its published width and depth, remat on")
    B, S = TRAIN15_BATCH, TRAIN15_SEQ
    params = lm.init_params(cfg, 0, device=dev)
    stream = SyntheticTokenStream(cfg, DataConfig(S, B, seed=0), device=dev)
    batches = [stream.next_batch() for _ in range(TRAIN15_STEPS)]
    gate_i = gate_grads(f"{cfg.name} {cfg.n_layers} layers, bf16, step 0",
                        params, cfg, batches[0])
    del gate_i["plain32"]
    cfg6 = dataclasses.replace(cfg, n_layers=6, compute_dtype="float32")
    p6 = lm.init_params(cfg6, 0, device=dev)
    _, _, kern = lm_grads(p6, cfg6, batches[0], "cuda")
    _, _, plain = lm_grads(p6, cfg6, batches[0], "torch")
    gate_ii = hold_grads(f"{cfg.name} fp32, one full-width unit (6 "
                         f"layers)", kern, plain, tol=LOGITS_TOL)
    del p6, kern, plain
    torch.cuda.empty_cache()
    t_gates = time.perf_counter()

    step_fn = make_train_step(cfg, cosine_schedule(*TRAIN15_LR))
    opt = adamw_init(params)
    per_step = step_launches(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    rows = []
    for i, batch in enumerate(batches):
        t = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, i)
        torch.cuda.synchronize()
        rows.append({"loss": float(m["loss"]), "grad_norm":
                     float(m["grad_norm"]), "lr": float(m["lr"]),
                     "s": time.perf_counter() - t})
    launches = _lm_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for i, r in enumerate(rows):
        print(f"train {cfg.name} step {i}: loss={r['loss']:.6f} grad_norm="
              f"{r['grad_norm']:.6f} lr={r['lr']:.6e} s={r['s']:.6f}")
    after = float(make_eval_step(cfg)(params, batches[0])["loss"])
    mean_s = float(np.mean([r["s"] for r in rows[1:]]))
    print(f"train {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, f32 params, {cfg.compute_dtype} compute, remat, "
          f"{CARD}): batch {B} x seq {S}, {TRAIN15_STEPS} steps: "
          f"s_per_step(steps 1-{TRAIN15_STEPS - 1})={mean_s:.6f} "
          f"tokens_per_s={B * S / mean_s:.1f} first_step_s="
          f"{rows[0]['s']:.6f} peak_memory_gb={peak_gb:.3f} launches "
          f"{launches} ({per_step} a step: the unit's blocks twice under "
          f"remat, the 2 remainder Mamba2 blocks once); loss on step 0's "
          f"batch after {TRAIN15_STEPS} steps {after} (step 0: "
          f"{rows[0]['loss']})")
    check(launches == {k: TRAIN15_STEPS * n for k, n in per_step.items()}
          and per_step == {"mamba2_scan": 62, "flash_fwd_wgmma": 12,
                           "flash_fwd_mma": 0},
          f"{TRAIN15_STEPS} remat'd zamba2 steps launch flash_fwd_wgmma 12x "
          f"and mamba2_scan 62x a step: {launches}")
    check(all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in rows)
          and np.isfinite(after), "finite losses and gradient norms")
    check(after < rows[0]["loss"], f"the loss after {TRAIN15_STEPS} steps "
                                   f"{after} < step 0's {rows[0]['loss']}")
    t_train = time.perf_counter()
    prof = profile_train_step(step_fn, params, opt, batches[0],
                              TRAIN15_STEPS)
    bwd = backward_recompute_ms(cfg, (B, S), dev)
    kern_fwd = sum(prof["split"].get(k, 0.0) for k in ("flash",
                                                       "mamba2_scan"))
    blocks = step_launches(dataclasses.replace(cfg, remat=False))
    bwd_ms = (bwd["flash_attention"] * blocks["flash_fwd_wgmma"]
              + bwd["mamba2_scan"] * blocks["mamba2_scan"])
    print(f"a step's device time: {prof['device_busy_ms']:.3f} ms; the "
          f"kernels' forwards {kern_fwd:.3f} ms "
          f"({kern_fwd / prof['device_busy_ms']:.4f}); their plain backward "
          f"recompute ~{bwd_ms:.3f} ms "
          f"({bwd_ms / prof['device_busy_ms']:.4f}: "
          f"{blocks['flash_fwd_wgmma']} flash and {blocks['mamba2_scan']} "
          f"scan backwards at {bwd} device ms each)")
    del params, opt
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    print(f"path 15a wall s: {t1 - t0:.3f} (gates {t_gates - t0:.3f}, "
          f"train {t_train - t_gates:.3f}, profile {t1 - t_train:.3f})")
    return {"per_step": per_step, "launches": launches, "steps": rows,
            "s_per_step": mean_s, "tokens_per_s": B * S / mean_s,
            "peak_memory_gb": peak_gb, "loss_after": after,
            "gate_i": gate_i, "gate_ii": gate_ii, "profile": prof,
            "backward_ms": bwd, "kernel_forward_ms": kern_fwd,
            "backward_recompute_ms": bwd_ms}


@contextlib.contextmanager
def _perturbed_scans(rel: float, dev):
    """Inside the block each ``ssd_scan`` call runs the plain version and
    adds fixed noise to y, uniform within ``rel`` of max(|y|, 1): a
    forward error as large as the kernel's bar allows."""
    f, gen = ssd_ops.ssd_scan, torch.Generator(dev).manual_seed(15)

    def noisy(q, k, v, log_a, chunk, state=None, backend="cuda"):
        y, st = f(q, k, v, log_a, chunk, state, backend="torch")
        amp = rel * max(float(y.detach().abs().max()), 1.0)
        noise = torch.rand(y.shape, generator=gen, device=y.device)
        return y + (2 * noise - 1) * amp, st
    ssd_ops.ssd_scan = noisy
    try:
        yield
    finally:
        ssd_ops.ssd_scan = f


def calibrated_bar(params, cfg32, batch, dev) -> float:
    """The largest leaf gap (over the leaf's max) between the plain fp32
    gradients with and without ``_perturbed_scans(SSD_TOL)``, remat off
    (the recompute would draw other noise)."""
    cfg = dataclasses.replace(cfg32, remat=False)
    _, _, plain = lm_grads(params, cfg, batch, "torch")
    with _perturbed_scans(SSD_TOL, dev):
        _, _, moved = lm_grads(params, cfg, batch, "torch")
    return max(leaf_gaps(moved, plain))


def path15b(dev) -> dict:
    """15b: one train step a family at full width and a cut depth
    (PATH15B), batch PATH15B_BATCH x PATH15B_SEQ: gate (i) and the fp32
    gate on its gradients (PATH15B_CALIBRATED: the calibrated fp32 gate,
    gate (i) printed), its launches counted."""
    out = {}
    for arch, L in PATH15B.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch), n_layers=L)
        params = lm.init_params(cfg, 0, device=dev)
        batch = SyntheticTokenStream(
            cfg, DataConfig(PATH15B_SEQ, PATH15B_BATCH, seed=0),
            device=dev).next_batch()
        calibrated = arch in PATH15B_CALIBRATED
        gate = gate_grads(f"{cfg.name} {L} layers, bf16", params, cfg, batch,
                          gated=not calibrated)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        tol = (calibrated_bar(params, cfg32, batch, dev) if calibrated
               else LOGITS_TOL)
        _, _, kern32 = lm_grads(params, cfg32, batch, "cuda")
        gate["fp32"] = hold_grads(
            f"{cfg.name} {L} layers, fp32" + (
                " (bar: the plain gradient's move under scans perturbed "
                f"within SSD_TOL {SSD_TOL})" if calibrated else ""),
            kern32, gate.pop("plain32"), tol=tol)
        del kern32
        step_fn = make_train_step(cfg, cosine_schedule(*TRAIN15_LR))
        opt = adamw_init(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_lm_counts()
        t = time.perf_counter()
        _, _, m = step_fn(params, opt, batch, 1)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t
        launches = _lm_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = step_launches(cfg)
        print(f"train {cfg.name} ({L} layers, full width, {CARD}): batch "
              f"{PATH15B_BATCH} x seq {PATH15B_SEQ}, one step: s="
              f"{step_s:.6f} loss={float(m['loss']):.6f} grad_norm="
              f"{float(m['grad_norm']):.6f} peak_memory_gb={peak_gb:.3f} "
              f"launches {launches} (want {want}); wall s "
              f"{time.perf_counter() - t0:.3f}")
        check(launches == want and sum(want.values()) > 0,
              f"{cfg.name}: one step's launches {launches} == {want}")
        check(bool(torch.isfinite(m["loss"])) and bool(
            torch.isfinite(m["grad_norm"])), f"{cfg.name}: finite step")
        out[arch] = {"layers": L, "launches": launches, "step_s": step_s,
                     "peak_memory_gb": peak_gb, "gate_i": gate}
        del params, opt, m
        torch.cuda.empty_cache()
    return out


def path15(dev) -> dict:
    """Path 15: LM training, 15a then 15b."""
    t0 = time.perf_counter()
    res = {"15a": path15a(dev), "15b": path15b(dev)}
    print(f"path 15 wall s: {time.perf_counter() - t0:.3f}")
    return res


# ------------------------------------------------------------- path 16
def path16a(dev) -> dict:
    """16a: olmo-1b, phi4-mini-3.8b and qwen1.5-110b (4 layers) served at
    full width through path 14's functions: ``flash_attention`` against
    its plain version and timed at each prefill shape, then each config
    served, its launches counted, gated and (PATH16_PROFILED) profiled;
    -> the records by arch."""
    t0 = time.perf_counter()
    cfgs = {a: path14_config(a, PATH16) for a in PATH16}
    feats = {a: (c.d_model, c.n_heads, c.n_kv_heads, c.head_dim, c.vocab,
                 c.norm, c.qkv_bias, c.rope_theta, c.tie_embeddings)
             for a, c in cfgs.items()}
    check(feats == {
        "olmo_1b": (2048, 16, 16, 128, 50304, "nonparametric", False,
                    1e4, True),
        "phi4_mini_3p8b": (3072, 24, 8, 128, 200064, "rms", False, 1e4,
                           True),
        "qwen1p5_110b": (8192, 64, 8, 128, 152064, "rms", True, 1e6,
                         False)}, f"path 16's configs: {feats}")
    check([get_config(a).n_layers for a in PATH16] == [16, 32, 80]
          and [L for L, _ in PATH16.values()] == [16, 32, 4],
          "olmo and phi4 at full depth, qwen1.5 at 4 of its 80 layers")
    print("path 16a params: " + ", ".join(
        f"{c.name} {c.n_layers} layers {c.n_params():.4g}"
        for c in cfgs.values()))
    timed = check_flash_path14(dev, cfgs.values(), "path 16a")
    out = {}
    for arch in PATH16:
        rec = serve_config14(dev, arch, PATH16, PATH16_NO_FP64,
                             PATH16_PROFILED, "path 16a")
        rec["kernel_timing"] = timed[cfgs[arch].name]
        out[arch] = rec
    print(f"path 16a wall s: {time.perf_counter() - t0:.3f}; flash "
          f"launches a prefill {({a: r['launches'] for a, r in out.items()})}")
    return out


@contextlib.contextmanager
def _driver_config(cfg):
    """Inside the block the training driver's ``get_config`` returns
    ``cfg`` (the depth cut of the resume check; the driver, as the
    reference's, has no depth flag)."""
    f = train_driver.get_config
    train_driver.get_config = lambda arch: cfg
    try:
        yield
    finally:
        train_driver.get_config = f


def driver_train(dev) -> dict:
    """olmo-1b at full width and depth through ``train_driver.main``,
    TRAIN16_ARGV, no checkpoint: every loss and grad norm finite, one
    ``flash_fwd_wgmma`` launch a layer a forward (32 a step under remat);
    seconds a step from the driver's per-step ends (each step synced by
    its log line)."""
    cfg = get_config(TRAIN16_ARCH)
    check((cfg.n_layers, cfg.d_model, cfg.vocab, cfg.param_dtype,
           cfg.compute_dtype, cfg.remat, cfg.remat_policy)
          == (16, 2048, 50304, "float32", "bfloat16", True, "full"),
          "olmo-1b at its published width and depth, remat on")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_lm_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = train_driver.main(TRAIN16_ARGV)
    launches = _lm_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(out.getvalue().rstrip())
    n = len(res.metrics)
    B, S = (int(TRAIN16_ARGV[TRAIN16_ARGV.index(f) + 1])
            for f in ("--batch", "--seq"))
    per_step = step_launches(cfg)
    loss = [float(m["loss"]) for m in res.metrics]
    gnorm = [float(m["grad_norm"]) for m in res.metrics]
    ends = res.step_end_s
    mean_s = (ends[-1] - ends[0]) / (n - 1)
    print(f"train driver {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_params():.4g} params, f32 params, bf16 "
          f"compute, remat, {CARD}): batch {B} x seq {S}, {n} steps: "
          f"s_per_step(steps 1-{n - 1})={mean_s:.6f} tokens_per_s="
          f"{B * S / mean_s:.1f} first_step_s={ends[0]:.6f} "
          f"peak_memory_gb={peak_gb:.3f} launches {launches} ({per_step} "
          f"a step); losses {loss}; grad norms {gnorm}")
    check(n == 8 and res.start == 0, f"the driver took 8 steps: {n}")
    check(per_step == {"mamba2_scan": 0, "flash_fwd_wgmma": 32,
                       "flash_fwd_mma": 0}
          and launches == {k: n * v for k, v in per_step.items()},
          f"8 remat'd olmo-1b steps launch flash_fwd_wgmma 32x a step: "
          f"{launches}")
    check(all(np.isfinite(loss + gnorm)), "finite losses and grad norms")
    del res
    torch.cuda.empty_cache()
    return {"per_step": per_step, "launches": launches, "loss": loss,
            "grad_norm": gnorm, "s_per_step": mean_s,
            "tokens_per_s": B * S / mean_s, "first_step_s": ends[0],
            "peak_memory_gb": peak_gb}


def driver_resume() -> dict:
    """The driver at full width over one layer (RESUME16_ARGV): the
    unbroken run saves steps 2 and 3; step 3 set aside, the run again
    resumes from 2 and saves 3; the two ``arrays.msgpack`` the same
    bytes."""
    cfg1 = dataclasses.replace(get_config(TRAIN16_ARCH), n_layers=1)
    with tempfile.TemporaryDirectory() as tmp, _driver_config(cfg1):
        tmp = Path(tmp)
        argv = [*RESUME16_ARGV, "--ckpt-dir", str(tmp / "ck")]
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            a = train_driver.main(argv)
            t_a = time.perf_counter()
            (tmp / "ck" / "step_000000003").rename(tmp / "unbroken_3")
            b = train_driver.main(argv)
        t_b = time.perf_counter()
        print(out.getvalue().rstrip())
        kept = tmp / "unbroken_3" / "arrays.msgpack"
        again = tmp / "ck" / "step_000000003" / "arrays.msgpack"
        nbytes = kept.stat().st_size
        same = filecmp.cmp(kept, again, shallow=False)
        del a
        print(f"train driver resume ({cfg1.name} 1 layer, full width, "
              f"{cfg1.n_params():.4g} params, {CARD}): batch 1 x seq 512, "
              f"4 steps, checkpoints at 2 and 3 ({nbytes} bytes each): "
              f"unbroken {t_a - t0:.3f} s, resumed from 2 "
              f"{t_b - t_a:.3f} s (start {b.start}); final checkpoints "
              f"bit-equal: {same}")
        check(b.start == 3, f"the second run resumed from step 2: {b.start}")
        del b
    torch.cuda.empty_cache()
    check(same, "the resumed run's final checkpoint is the unbroken run's, "
                "bit for bit")
    return {"bit_equal": same, "checkpoint_bytes": nbytes,
            "unbroken_s": t_a - t0, "resumed_s": t_b - t_a}


def int8_step_gate(dev) -> dict:
    """One ``make_train_step`` step through ``make_int8_grad_transform``
    on the card (kernel backends) and on the CPU copy of its inputs (plain
    backends): olmo-1b at full width over one layer in fp32, batch
    INT8_BATCH x INT8_SEQ, step 1 of ``cosine_schedule(*TRAIN15_LR)``.
    Loss and grad norm within TRAIN_LOSS_TOL relative; int8 codes that
    differ only where the CPU's clipped gradient lies within the gradient
    gap ((1e-4 + 1e-5) of the leaf's max, tests/test_torch_lm_train.py)
    of a rounding boundary; mu and the params within that file's step
    bars at that gap, widened by one code there."""
    cfg = dataclasses.replace(get_config(TRAIN16_ARCH), n_layers=1,
                              compute_dtype="float32")
    sched = cosine_schedule(*TRAIN15_LR)
    lr = float(sched(1))
    params = lm.init_params(cfg, 0, device=dev)
    batch = SyntheticTokenStream(cfg, DataConfig(INT8_SEQ, INT8_BATCH,
                                                 seed=0),
                                 device=dev).next_batch()
    seen, res = {}, {}
    t0 = time.perf_counter()
    for where in ("cuda", "cpu"):
        def recorded(grads, where=where):
            seen[where] = grads
            return make_int8_grad_transform()(grads)
        p = params if where == "cuda" else tree_map(lambda t: t.cpu(),
                                                    params)
        b = batch if where == "cuda" else {k: v.cpu()
                                           for k, v in batch.items()}
        _zero_lm_counts()
        res[where] = make_train_step(cfg, sched, grad_transform=recorded)(
            p, adamw_init(p), b, 1)
        if where == "cuda":
            torch.cuda.synchronize()
            launches = _lm_counts()
            t_card = time.perf_counter()
    t_cpu = time.perf_counter()
    (p_k, o_k, m_k), (p_c, o_c, m_c) = res["cuda"], res["cpu"]
    b1, b2, eps = 0.9, 0.999, 1e-8
    flips = near_n = 0
    worst = {"params": 0.0, "mu": 0.0}
    ok = True
    for gk, gc, pk, pc, mk, mc, nu in zip(
            tree_leaves(seen["cuda"]), tree_leaves(seen["cpu"]),
            tree_leaves(p_k), tree_leaves(p_c), tree_leaves(o_k.mu),
            tree_leaves(o_c.mu), tree_leaves(o_c.nu)):
        g_max = float(gc.abs().max())
        scale = float(np.float32(g_max) * np.float32(1 / 127))
        gap = (LOGITS_TOL + TRAIN_LOSS_TOL) * g_max
        near = (gc.abs() / scale % 1.0 - 0.5).abs() <= gap / scale
        flipped = int8_quantize(gk)[0].cpu() != int8_quantize(gc)[0]
        flips += int(flipped.sum())
        near_n += int(near.sum())
        ok &= not bool((flipped & ~near).any())
        gap_el = torch.where(near, gap + scale, gap)
        v_hat = nu / (1 - b2 ** 1)
        bar_p = lr / 100 + lr * torch.clamp(2 * gap_el / (v_hat.sqrt() + eps),
                                            max=2.0)
        bar_mu = (1 - b1) * gap_el * 1.01
        dp, dm = (pk.cpu() - pc).abs(), (mk.cpu() - mc).abs()
        worst["params"] = max(worst["params"], float((dp / bar_p).max()))
        worst["mu"] = max(worst["mu"], float((dm / bar_mu).max()))
    rel = {k: abs(float(m_k[k]) - float(m_c[k])) / abs(float(m_c[k]))
           for k in ("loss", "grad_norm")}
    print(f"int8 step ({cfg.name} 1 layer, fp32, batch {INT8_BATCH} x seq "
          f"{INT8_SEQ}, {CARD}): card vs CPU: loss {float(m_k['loss'])} "
          f"vs {float(m_c['loss'])}, grad norm {float(m_k['grad_norm'])} "
          f"vs {float(m_c['grad_norm'])} (relative gaps {rel}, bar "
          f"{TRAIN_LOSS_TOL}); int8 codes differing {flips}, all within "
          f"the gradient gap of a rounding boundary: {ok} ({near_n} codes "
          f"that close); largest share of the step bar: params "
          f"{worst['params']}, mu {worst['mu']}; launches {launches}; card "
          f"step {t_card - t0:.3f} s, CPU step {t_cpu - t_card:.3f} s")
    check(launches == step_launches(cfg), f"the int8 step's launches "
                                          f"{launches}")
    check(all(v <= TRAIN_LOSS_TOL for v in rel.values()),
          f"int8 step: loss and grad norm within {TRAIN_LOSS_TOL}: {rel}")
    check(float(m_k["lr"]) == float(m_c["lr"]) == np.float32(lr),
          "int8 step: the same lr")
    check(ok, "int8 step: a code differs only near a rounding boundary")
    check(worst["params"] <= 1 and worst["mu"] <= 1,
          f"int8 step: params and mu within the step bars: {worst}")
    del params, res, seen
    torch.cuda.empty_cache()
    return {"codes_differing": flips, "codes_near_boundary": near_n,
            "bar_share": worst, "relative_gaps": rel}


def path16b(dev) -> dict:
    """16b: the LM training driver: olmo-1b at full width and depth, the
    resume check, the int8 step."""
    t0 = time.perf_counter()
    out = {"train": driver_train(dev)}
    t1 = time.perf_counter()
    out["resume"] = driver_resume()
    t2 = time.perf_counter()
    out["int8"] = int8_step_gate(dev)
    t3 = time.perf_counter()
    print(f"path 16b wall s: {t3 - t0:.3f} (train {t1 - t0:.3f}, resume "
          f"{t2 - t1:.3f}, int8 {t3 - t2:.3f})")
    return out


def path16(dev) -> dict:
    """Path 16: 16a (serving the three dense configs), then 16b (the
    training driver)."""
    t0 = time.perf_counter()
    res = {"16a": path16a(dev), "16b": path16b(dev)}
    print(f"path 16 wall s: {time.perf_counter() - t0:.3f}")
    return res


# ------------------------------------------------------------- path 17
def dense_matmul_flops(cfg, seq: int) -> float:
    """Matmul flops of one dense layer at batch 1, closed form: the
    projections, the FFN, and causal attention's scores and values
    computed in full (what the reference's import counts)."""
    d, n_ffn = cfg.d_model, 3 if cfg.act in ("swiglu", "geglu") else 2
    proj = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    return (2.0 * seq * (proj + n_ffn * d * cfg.d_ff)
            + 4.0 * cfg.n_heads * seq * seq * cfg.head_dim)


def _same_graph(a, b) -> bool:
    return (a.n == b.n and a.outputs == b.outputs
            and [(v.kind, v.label, v.out_shape) for v in a.vertices]
            == [(v.kind, v.label, v.out_shape) for v in b.vertices]
            and np.array_equal(a.flops_array(), b.flops_array())
            and np.array_equal(a.out_bytes_array(), b.out_bytes_array())
            and np.array_equal(a.edge_array(), b.edge_array()))


def zoo_import_path() -> dict:
    """17a: every registry config's layer graph at DEFAULT_SEQ, traced on
    fake tensors on the host (no device memory): n, m, flops by kind and
    the import's seconds; a second trace identical; the dense configs'
    matmul flops equal to their closed form."""
    rows = {}
    model_zoo._import_model.cache_clear()
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        g = get_workload(f"model:{arch}")
        s = time.perf_counter() - t0
        again = model_zoo._import_model.__wrapped__(
            arch, model_zoo.DEFAULT_SEQ, 1, None, True, 1e4)
        check(_same_graph(g, again), f"model:{arch}: a second import is "
                                     f"identical")
        kinds = {}
        for v in g.vertices:
            n, f = kinds.get(v.kind, (0, 0.0))
            kinds[v.kind] = (n + 1, f + v.flops)
        mm = kinds.get("matmul", (0, 0.0))[1]
        if arch in ZOO17_DENSE:
            want = dense_matmul_flops(get_config(arch), model_zoo.DEFAULT_SEQ)
            check(mm == want, f"model:{arch}: matmul flops {mm} == the "
                              f"closed form {want}")
        rows[arch] = {"n": g.n, "m": g.m, "import_s": s, "matmul_flops": mm,
                      "flops": g.total_flops(), "kinds": kinds}
        print(f"zoo import model:{arch} ({CARD}, on the host): n={g.n} "
              f"m={g.m} flops={g.total_flops():.6e} (matmul {mm:.6e}"
              + (", the closed form" if arch in ZOO17_DENSE else "")
              + f") import {s:.6f} s; by kind "
              + ", ".join(f"{k} {n} {f:.4e}"
                          for k, (n, f) in sorted(kinds.items())))
    return rows


def zoo_place_path(dev) -> dict:
    """17b: ``DopplerTrainer.place`` on ZOO17_PLACE's layers x ZOO17_FLEET
    on the card: 2 pair launches and 1 ``wc_trips`` launch a request; the
    makespans bit-equal to the CPU oracle's on the same candidates and the
    encodings within 1e-4 of the CPU's; greedy / best / CP printed."""
    fm, res = get_device_model(ZOO17_FLEET), {}
    for arch in ZOO17_PLACE:
        g = get_workload(f"model:{arch}")
        tr = DopplerTrainer(g, fm, seed=0, device=dev)
        check(tr.encoder_backend == tr.oracle_backend == "cuda",
              f"model:{arch}: backends default to cuda on the card")
        _uncounted(lambda: (encode(tr.params, tr.gd, tr.encoder_backend),
                            tr.default_engine().run_batch(
                                np.zeros((1, g.n), np.int64))))
        sync(dev)
        pl, c = _counted(lambda: tr.place(n_samples=ZOO17_K, eps=EPS))
        check(c == {"gnn_mp_pair": 2, "gnn_mp": 0, "wc_oracle_trips": 1,
                    "wc_oracle": 0},
              f"model:{arch}: a request is 2 pair launches and 1 wc_trips "
              f"launch: {c}")
        cands = np.concatenate([pl.greedy[None], pl.population])
        cpu_ms = TorchWCEngine(g, fm, backend="torch",
                               device="cpu").run_batch(cands)
        check(np.array_equal(cpu_ms, pl.makespans),
              f"model:{arch}: card oracle == CPU oracle on "
              f"{len(cands)} candidates")
        gd_cpu = build_graph_data(g, fm, tr.comm_factor, "cpu")
        params_cpu = tree_map(lambda x: x.cpu(), tr.params)
        err = _uncounted(lambda: max(
            float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1.0)
            for a, b in zip(encode(tr.params, tr.gd, "cuda"),
                            encode(params_cpu, gd_cpu, "torch"))))
        check(err <= 1e-4, f"model:{arch}: card encodings vs CPU, rel err "
                           f"{err}")
        cp_ms = _uncounted(lambda: tr.default_engine().exec_time(
            critical_path_assignment(g, fm, seed=0)))
        res[arch] = {"n": g.n, "greedy": float(pl.makespans[0]),
                     "best": pl.makespan, "cp": cp_ms,
                     "seconds": dict(pl.seconds), "launches": c}
        sec = pl.seconds
        print(f"zoo place model:{arch} x {ZOO17_FLEET} ({CARD}): n={g.n} "
              f"m={g.m} K={ZOO17_K} greedy_ms={pl.makespans[0] * 1e3:.6f} "
              f"best_ms={pl.makespan * 1e3:.6f} cp_ms={cp_ms * 1e3:.6f} "
              f"encode_s={sec['encode']:.6f} rollout_s={sec['rollout']:.6f} "
              f"oracle_s={sec['oracle']:.6f}; launches {c}; card oracle == "
              f"CPU oracle, encodings rel err {err:.3e}")
    return res


def zoo_full_path(dev) -> dict:
    """17c: ZOO17_FULL through the hierarchy's ``place()`` on the card
    (``hier_place``'s gates), then one refine batch at its placement
    held bit-equal to the plain trip loop (``check_trips``)."""
    fm = get_device_model(ZOO17_FLEET)
    t0 = time.perf_counter()
    g = get_workload(ZOO17_FULL)
    import_s = time.perf_counter() - t0
    tr = DopplerTrainer(g, fm, seed=0, device=dev, hierarchy=HIER_CFG)
    setup_s = time.perf_counter() - t0 - import_s
    print(f"zoo full {ZOO17_FULL} ({CARD}): n={g.n} m={g.m} n_rep="
          f"{g.replication.n_rep} imported in {import_s:.6f} s on the host, "
          f"trainer set-up (coarsen, {tr.hier.n_levels} levels) "
          f"{setup_s:.6f} s")
    res = hier_place(tr, ZOO17_FULL)
    A = refine_batch(tr, res["placement"].assignment)
    # every row: the plain loop's time follows the longest episode's trips
    # (host-driven launches), not the rows (on an H100, 3 rows 27.9 s, 49
    # rows 25.9 s)
    t0 = time.perf_counter()
    ok, places = _uncounted(lambda: check_trips(
        tr.flat_engine().sim_graph, A, f"{ZOO17_FULL}'s refine batch"))
    check(bool(ok.all()), f"{ZOO17_FULL}: every refine episode done")
    print(f"zoo full {ZOO17_FULL} ({CARD}): a refine batch of {len(A)} rows "
          f"bit-equal to the plain trip loop in {places} "
          f"({time.perf_counter() - t0:.3f} s)")
    return {"n": g.n, "m": g.m, "import_s": import_s, "setup_s": setup_s,
            "makespan": res["placement"].makespan,
            "seconds": dict(res["placement"].seconds),
            "engine_calls": len(res["calls"]), "refine_rows": len(A)}


def zoo_server_path() -> dict:
    """17d: ``place_server.main`` with its defaults on the card: a quick
    pretrain on the zoo half, then model:olmo_1b x mixed_gen4 twice (a
    miss, then a hit)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        place_server.main(["--device", "cuda"])
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"place_server ({CARD}): {line}")
    check(len(lines) == 3
          and lines[0].startswith("[0] model:olmo_1b on mixed_gen4: ")
          and "cache_hit=False" in lines[0] and "cache_hit=True" in lines[1]
          and lines[2] == "server stats: {'hits': 1, 'misses': 1, "
                          "'cached': 1}",
          f"place_server's defaults serve model:olmo_1b: {lines}")
    return {"lines": lines}


def path17(dev, by_name) -> None:
    """Path 17: the importer's graphs imported, placed flat and
    hierarchically and served on the card; the launch counts are reset
    before each part and read after it.  17b's and 17c's launches are
    held by their own gates (the CPU oracle, a refine batch); 17d's pair
    launches by ``_KernelLog`` (the first at each shape)."""
    t_path, counts, res = time.perf_counter(), {}, {}

    def part(name, fn):
        gnn_ops.launches = gnn_ops.pair_launches = 0
        wc_ops.launches = wc_ops.trip_launches = 0
        t0 = time.perf_counter()
        res[name] = fn()
        counts[name] = _launch_counts()
        print(f"path {name} wall s ({CARD}): "
              f"{time.perf_counter() - t0:.3f}; launches {counts[name]}")

    def logged():
        with _KernelLog() as log:
            out = zoo_server_path()
        held = _uncounted(lambda: log.hold("path 17d"))
        check(held["trips_batches"] == 0 and held["pair_shapes"],
              f"path 17d: its pair launches held: {held}")
        return out

    part("17a", zoo_import_path)
    part("17b", lambda: zoo_place_path(dev))
    part("17c", lambda: zoo_full_path(dev))
    part("17d", logged)
    c = counts
    check(not any(c["17a"].values())
          and c["17b"]["gnn_mp_pair"] == 2 * len(ZOO17_PLACE)
          and c["17b"]["wc_oracle_trips"] == len(ZOO17_PLACE)
          and c["17c"]["gnn_mp_pair"] == 2 and c["17c"]["wc_oracle_trips"] > 0
          and c["17d"]["gnn_mp_pair"] > 0
          and all(p["gnn_mp"] == p["wc_oracle"] == 0 for p in c.values()),
          f"path 17 ran the gnn_mp pair and wc_trips on the card, no "
          f"single-direction gnn_mp and no wc_step: {c}")
    print(f"path 17 wall s ({CARD}): {time.perf_counter() - t_path:.3f}")
    by_name["gnn_mp_pair"]["zoo"] = {p: v["gnn_mp_pair"]
                                     for p, v in c.items()}
    by_name["wc_oracle_trips"]["zoo"] = {p: v["wc_oracle_trips"]
                                         for p, v in c.items()}
    by_name["wc_oracle_trips"]["zoo_place"] = res["17b"]
    by_name["wc_oracle_trips"]["zoo_full"] = res["17c"]


# ---------------------------------------------------------- training path
def _launch_counts() -> dict:
    return {"gnn_mp_pair": gnn_ops.pair_launches, "gnn_mp": gnn_ops.launches,
            "wc_oracle_trips": wc_ops.trip_launches,
            "wc_oracle": wc_ops.launches}


def _uncounted(fn):
    """Run ``fn`` (a check against a plain version, or a timing) without
    its launches counting toward the path's."""
    c0 = _launch_counts()
    out = fn()
    gnn_ops.pair_launches, gnn_ops.launches = c0["gnn_mp_pair"], c0["gnn_mp"]
    wc_ops.trip_launches, wc_ops.launches = (c0["wc_oracle_trips"],
                                             c0["wc_oracle"])
    return out


def _counted(fn) -> tuple:
    """Run ``fn``; -> (its result, the kernel launches it made, by wrapper
    counter)."""
    c0 = _launch_counts()
    out = fn()
    return out, {k: v - c0[k] for k, v in _launch_counts().items()}


def gate_update(what: str, kern, plain,
                loss_tol: float | None = TRAIN_LOSS_TOL,
                grad_tol: float = TRAIN_GRAD_TOL,
                param_tol: float | None = TRAIN_PARAM_TOL,
                tree_scale: bool = False) -> None:
    """The latest episode or update of two trainers that started from the
    same params and generator state, kernel backends against plain: the
    same actions (and rewards bit for bit), losses within ``loss_tol``
    relative, each gradient leaf within ``grad_tol`` of max(1, max|g|)
    (|g| of the leaf, or with ``tree_scale`` of the whole gradient; the
    other reading is printed), the params after the AdamW step within
    ``param_tol`` (a bar of None is printed, not checked)."""
    a, b = kern.last_update, plain.last_update
    check(np.array_equal(np.asarray(torch.as_tensor(a["actions"]).cpu()),
                         np.asarray(torch.as_tensor(b["actions"]).cpu())),
          f"{what}: the same actions on both backends")
    if "rewards" in a:
        check(np.array_equal(a["rewards"], b["rewards"]),
              f"{what}: rewards bit-identical on both backends")
    lk, lp = float(a["loss"]), float(b["loss"])
    loss_rel = abs(lk - lp) / abs(lp)
    check(loss_tol is None or loss_rel <= loss_tol,
          f"{what}: loss {lk} vs {lp}, relative {loss_rel}")
    pairs = list(zip(tree_leaves(a["grads"]), tree_leaves(b["grads"])))
    tree = max(1.0, max(float(gp.abs().max()) for _, gp in pairs))
    by_leaf = max(float((gk - gp).abs().max())
                  / max(1.0, float(gp.abs().max())) for gk, gp in pairs)
    by_tree = max(float((gk - gp).abs().max()) for gk, gp in pairs) / tree
    grad_err = by_tree if tree_scale else by_leaf
    if grad_err > grad_tol:                  # which leaf, and how large
        for i, (gk, gp) in enumerate(pairs):
            print(f"{what}: leaf {i} {tuple(gp.shape)} max|g| "
                  f"{float(gp.abs().max()):.6e} max diff "
                  f"{float((gk - gp).abs().max()):.6e} (tree max {tree:.6e})")
    check(grad_err <= grad_tol, f"{what}: gradient error {grad_err}")
    params = ""
    if param_tol is not None:
        param_err = max(float((pk - pp).abs().max()) for pk, pp in
                        zip(tree_leaves(kern.params),
                            tree_leaves(plain.params)))
        check(param_err <= param_tol, f"{what}: params after the step "
                                      f"differ by {param_err}")
        params = f"; params {param_err:.3e} <= {param_tol}"
    print(f"train gate {what}: loss {lk:.7f} vs {lp:.7f} ("
          f"{loss_rel:.3e} relative"
          + ("" if loss_tol is None else f" <= {loss_tol}") + "); "
          f"gradient {grad_err:.3e} of max(1, max|g|"
          + (" over the gradient" if tree_scale else " of the leaf")
          + f") <= {grad_tol} ("
          + (f"of the leaf {by_leaf:.3e}" if tree_scale
             else f"over the gradient {by_tree:.3e}")
          + f"){params}; actions identical"
          + ("; rewards bit-identical" if "rewards" in a else ""))


def _copy_state(src, dst) -> None:
    """``dst`` continues from ``src``'s params, optimizer, generator,
    counters and reward statistics (its own backends)."""
    dst.params = tree_map(torch.clone, src.params)
    dst.opt_state = AdamState(src.opt_state.step,
                              tree_map(torch.clone, src.opt_state.mu),
                              tree_map(torch.clone, src.opt_state.nu))
    dst.generator.set_state(src.generator.get_state())
    dst.episode = src.episode
    dst._r_sum, dst._r_sqsum, dst._r_count = \
        src._r_sum, src._r_sqsum, src._r_count


def train_path(dev) -> dict:
    """Stage I then Stage II of ``DopplerTrainer`` on the card at the
    policy's published width on TRAIN_REQUEST: ``stage1_imitation``
    (TRAIN_STAGE1 episodes, run as 1 + the rest), ``train_rl`` over the
    trainer's default engine (the oracle, one ``wc_trips`` launch per
    reward batch; TRAIN_UPDATES updates at K TRAIN_K, run as 1 + the
    rest), one ``stage2_sim_batched`` update on the numpy ``WCSimulator``.
    The first episode and the first update are gated against a twin on
    the plain backends started from the same state.  The launch counts
    cover the kernel trainer's calls (the twin's must be 0)."""
    gname, fleet = TRAIN_REQUEST
    g, fm = get_workload(gname), get_device_model(fleet)
    kern = DopplerTrainer(g, fm, seed=0, device=dev)
    plain = DopplerTrainer(g, fm, seed=0, device=dev,
                           encoder_backend="torch", oracle_backend="torch")
    check((kern.encoder_backend, kern.oracle_backend) == ("cuda", "cuda"),
          "the trainer's backends default to cuda on the card")
    engine, plain_engine = kern.default_engine(), plain.default_engine()
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    counts = dict.fromkeys(_launch_counts(), 0)

    def run(fn, twin=False):
        out, delta = _counted(fn)
        if twin:
            check(delta == dict.fromkeys(counts, 0),
                  f"the plain twin launches no kernel: {delta}")
        for k, v in delta.items():
            counts[k] += v
        return out, delta

    # Stage I
    _, first = run(lambda: kern.stage1_imitation(1))
    run(lambda: plain.stage1_imitation(1), twin=True)
    gate_update("stage I episode 1", kern, plain)
    _, rest = run(lambda: kern.stage1_imitation(TRAIN_STAGE1 - 1, seed=1))
    s1_seconds = dict(kern.seconds)
    per_episode = {k: v / TRAIN_STAGE1 for k, v in s1_seconds.items()}
    check(first == {"gnn_mp_pair": 2, "gnn_mp": 0, "wc_oracle_trips": 0,
                    "wc_oracle": 0}
          and rest["gnn_mp_pair"] == 2 * (TRAIN_STAGE1 - 1),
          f"stage I: one gnn_mp pair launch a GNN layer an episode "
          f"(forward; the backward is the gather): {first}, {rest}")

    # Stage II: the first update gated against the twin, from one state
    _copy_state(kern, plain)
    kern.seconds.clear()
    times, upd1 = run(lambda: kern.train_rl(engine, 1, batch_size=TRAIN_K))
    run(lambda: plain.train_rl(plain_engine, 1, batch_size=TRAIN_K),
        twin=True)
    gate_update("stage II update 1", kern, plain)
    del plain
    more_times, more = run(lambda: kern.train_rl(
        engine, TRAIN_UPDATES - 1, batch_size=TRAIN_K))
    s2_seconds = dict(kern.seconds)
    per_update = {k: v / TRAIN_UPDATES for k, v in s2_seconds.items()}
    check(upd1 == {"gnn_mp_pair": 4, "gnn_mp": 0, "wc_oracle_trips": 1,
                   "wc_oracle": 0}
          and more["gnn_mp_pair"] == 4 * (TRAIN_UPDATES - 1)
          and more["wc_oracle_trips"] == TRAIN_UPDATES - 1,
          f"stage II: 2 pair launches to sample, 2 to replay, one wc_trips "
          f"launch an update: {upd1}, {more}")
    # the numpy simulator as the reward engine (no oracle kernel)
    kern.seconds.clear()
    sim_times, sim_delta = run(lambda: kern.stage2_sim_batched(
        1, batch_size=TRAIN_K))
    sim_seconds = dict(kern.seconds)
    check(sim_delta["gnn_mp_pair"] == 4
          and sim_delta["wc_oracle_trips"] == 0,
          f"stage2_sim_batched: {sim_delta}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ts = np.asarray(times + more_times + sim_times).reshape(-1, TRAIN_K)
    return {"trainer": kern, "engine": engine, "counts": counts,
            "batch_best": ts.min(1), "stage1_s": per_episode,
            "stage2_s": per_update, "sim_s": sim_seconds,
            "launches": {"stage1_episode": first, "stage2_update": upd1,
                         "stage2_sim_update": sim_delta},
            "peak_gb": peak_gb}


def check_train_path(res) -> None:
    tr = res["trainer"]
    g = tr.g
    n_upd = TRAIN_STAGE1 + TRAIN_UPDATES + 1
    check(len(tr.losses) == n_upd and all(np.isfinite(tr.losses)),
          f"finite losses, one an episode or update: {tr.losses}")
    check(tr.episode == TRAIN_STAGE1 + (TRAIN_UPDATES + 1) * TRAIN_K,
          f"episode counter {tr.episode}")
    rows = tr.history
    check(len(rows) == TRAIN_UPDATES + 1
          and [h.stage for h in rows] == [res["engine"].name]
          * TRAIN_UPDATES + ["sim_batch"], "history rows")
    check(all(np.isfinite(h.exec_time) and h.exec_time > 0 for h in rows)
          and tr.best_time <= min(h.exec_time for h in rows),
          "finite makespans, best so far kept")
    a = tr.best_assignment
    check(a.shape == (g.n,) and bool(((a >= 0) & (a < tr.dev.n)).all()),
          "best assignment in range")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(tr.params)),
          "finite params")
    cp_ms = res["engine"].exec_time(critical_path_assignment(g, tr.dev,
                                                             seed=0))
    gname, fleet = TRAIN_REQUEST
    s1, s2, sim = res["stage1_s"], res["stage2_s"], res["sim_s"]
    print(f"train {gname} x {fleet} ({CARD}): n={g.n} m={g.m} "
          f"nd={tr.dev.n} d_hidden 64, d_z 32, d_y 32, 2 GNN layers, "
          f"random seed-0 weights; stage I {TRAIN_STAGE1} episodes, "
          f"stage II {TRAIN_UPDATES} updates at K={TRAIN_K} over "
          f"{res['engine'].name}, 1 stage2_sim_batched update at "
          f"K={TRAIN_K}; peak_memory_gb={res['peak_gb']:.3f}")
    print(f"train stage I s per episode: total "
          f"{sum(s1.values()):.6f} = " + " + ".join(
              f"{k} {v:.6f}" for k, v in s1.items()))
    print(f"train stage II s per update: total "
          f"{sum(s2.values()):.6f} = " + " + ".join(
              f"{k} {v:.6f}" for k, v in s2.items()))
    print(f"train stage2_sim_batched s (numpy WCSimulator, one update): "
          f"total {sum(sim.values()):.6f} = " + " + ".join(
              f"{k} {v:.6f}" for k, v in sim.items()))
    print(f"train launches: per stage I episode "
          f"{res['launches']['stage1_episode']}, per stage II update "
          f"{res['launches']['stage2_update']}, per stage2_sim_batched "
          f"update {res['launches']['stage2_sim_update']}; the path "
          f"{res['counts']}")
    print(f"train losses {[round(x, 6) for x in tr.losses]}")
    print("train makespan ms per update (mean / best of the batch): "
          + ", ".join(f"{h.stage} {h.exec_time * 1e3:.6f} / "
                      f"{b * 1e3:.6f}" for h, b in zip(
                          rows, res["batch_best"]))
          + f"; best so far {tr.best_time * 1e3:.6f}; CP {cp_ms * 1e3:.6f}")


# ---------------------------------------------------- fused training path
def _draw_tables(rng, n: int, K: int, nd: int) -> list:
    """One update's step-major draw tables (gumbel rows, uniforms) made
    with numpy from ``rng``."""
    def u(*shape):
        return rng.random(shape, dtype=np.float32).clip(1e-7, 1 - 1e-7)

    def gumbel(*shape):
        return (-np.log(-np.log(u(*shape)))).astype(np.float32)
    return [gumbel(n, K, n), gumbel(n, K, nd), u(n, K), u(n, K)]


def gate_replay(fused, nonfused, params0, draws) -> None:
    """The fused update against the non-fused path (path 7's ``train_rl``:
    a forced replay under autograd) from the same state on the same
    draws: the same actions and rewards bit for bit, advantages within
    1e-6 of the rewards' magnitude (each path rounds its own baseline: a
    shift ``d`` of the baseline moves the loss by ``d`` times the mean
    summed log-prob, ~700 here, so the two trainers' losses are not
    compared), gradients within TRAIN_GRAD_TOL; then the fused loss and
    gradients against the forced replay's on the fused update's own
    advantages from ``params0``, the state before it, at the reference's
    fused-vs-replay bars (REPLAY_LOSS_TOL relative, TRAIN_GRAD_TOL)."""
    nonfused.train_rl(nonfused.default_engine(), 1, batch_size=TRAIN_K,
                      draws=draws)
    gate_update("fused stage II update 1 vs non-fused train_rl", fused,
                nonfused, loss_tol=None, param_tol=None)
    a, b = fused.last_update, nonfused.last_update
    adv_gap = float(np.abs(a["advantages"] - b["advantages"]).max())
    scale = float(np.abs(a["rewards"]).max())
    check(adv_gap <= 1e-6 * scale, f"advantages differ by {adv_gap}")
    loss, grads = _pg_loss_and_grad_batch(
        params0, fused.gd, a["actions"], a["advantages"],
        fused.entropy_weight, encoder_backend=fused.encoder_backend)
    replay = SimpleNamespace(last_update=dict(
        actions=a["actions"], rewards=a["rewards"], loss=loss, grads=grads))
    gate_update("fused stage II update 1 vs the forced replay on its "
                "advantages", fused, replay, loss_tol=REPLAY_LOSS_TOL,
                param_tol=None)
    print(f"train gate advantages: fused vs non-fused {adv_gap:.3e} <= "
          f"1e-6 of max|reward| {scale:.6f}")


def _engine(tr, stage: str):
    """``tr``'s one cached fused engine of ``stage``."""
    (eng,) = [e for k, e in tr._fused_cache.items() if k[0] == stage]
    return eng


def fused_path(dev) -> dict:
    """Stage I and Stage II through the fused engine on TRAIN_REQUEST at
    the policy's published width, each update one CUDA graph replay:
    FUSED_RECORD Stage I episodes (the first gated against a plain eager
    twin), then FUSED_RECORD Stage II updates at K TRAIN_K, FUSED_DISPATCH
    a dispatch (the first on injected draws, gated against the plain
    eager fused twin and the non-fused ``train_rl``, all from one state);
    a chunked dispatch against that first update; the raise of a
    doctored oracle.  Launch counts: the wrappers count the warm-up's
    launches and a capture's recordings; a capture's count is what every
    replay launches."""
    gname, fleet = TRAIN_REQUEST
    g, fm = get_workload(gname), get_device_model(fleet)

    def trainer(plain=False):
        kw = dict(encoder_backend="torch", oracle_backend="torch") \
            if plain else {}
        return DopplerTrainer(g, fm, seed=0, device=dev, **kw)
    kern, plain = trainer(), trainer(plain=True)
    sync(dev)
    torch.cuda.reset_peak_memory_stats()
    c0 = _launch_counts()

    # Stage I: the first episode captured, against the plain eager twin
    _copy_state(kern, plain)
    before = _launch_counts()
    kern.stage1_imitation_fused(1)
    plain.stage1_imitation_fused(1, capture=False)
    check(_launch_counts() == {k: v + 4 * (k == "gnn_mp_pair")
                               for k, v in before.items()},
          "fused stage I: the warm-up launches the gnn_mp pair twice and "
          "the capture records it twice; the plain twin launches nothing")
    gate_update("fused stage I episode 1", kern, plain)
    s1_first = dict(kern.seconds)
    kern.seconds.clear()
    kern.stage1_imitation_fused(FUSED_RECORD - 1, seed=1)
    s1 = {k: v / (FUSED_RECORD - 1) for k, v in kern.seconds.items()}
    s1_captured = _engine(kern, "stage1").graphed.captured

    # Stage II from the state after Stage I: the first update on injected
    # draws, against the plain eager twin, the non-fused path and the
    # chunked engine, each started from that state
    rng = np.random.default_rng(0)
    draws = [_draw_tables(rng, g.n, TRAIN_K, fm.n)]
    nonfused, chunked = trainer(), trainer()
    for tr in (plain, nonfused, chunked):
        _copy_state(kern, tr)
    params0 = tree_map(torch.clone, kern.params)
    kern.seconds.clear()
    kern.stage2_fused(1, batch_size=TRAIN_K,
                      updates_per_dispatch=FUSED_DISPATCH, draws=draws)
    s2_first = dict(kern.seconds)
    before = _launch_counts()
    plain.stage2_fused(1, batch_size=TRAIN_K, draws=draws, capture=False)
    check(_launch_counts() == before, "the plain fused twin launches no "
                                      "kernel")
    gate_update("fused stage II update 1", kern, plain)
    del plain
    gate_replay(kern, nonfused, params0, draws)
    del nonfused
    chunked.stage2_fused(1, batch_size=TRAIN_K, chunk_size=8,
                         grad_chunk_size=4, draws=draws)
    gate_update("chunked (8 / 4) vs monolithic stage II update 1", chunked,
                kern, loss_tol=None, grad_tol=CHUNK_GRAD_TOL)
    chunk_captured = _engine(chunked, "stage2").graphed.captured
    del chunked

    # the rest of the record: fresh draws from the trainer's generator
    kern.seconds.clear()
    kern.stage2_fused(FUSED_RECORD - 1, batch_size=TRAIN_K,
                      updates_per_dispatch=FUSED_DISPATCH)
    s2 = {k: v / (FUSED_RECORD - 1) for k, v in kern.seconds.items()}
    s2_captured = _engine(kern, "stage2").graphed.captured

    # the validity flag, through a captured dispatch
    doctored = trainer()
    doctored._fused_cache["sim_graph"] = dataclasses.replace(
        SimGraph.build(g, fm, dev), n_trips=1)
    try:
        doctored.stage2_fused(1, batch_size=TRAIN_K,
                              updates_per_dispatch=FUSED_DISPATCH)
        raised = ""
    except RuntimeError as err:
        raised = str(err)
    check("converge" in raised and _engine(doctored, "stage2").graphed.graph
          is not None and doctored.episode == 0,
          f"a doctored oracle raises from a captured dispatch: {raised!r}")
    del doctored
    counts = {k: v - c0[k] for k, v in _launch_counts().items()}
    return {"trainer": kern, "counts": counts, "stage1_first": s1_first,
            "stage1_s": s1, "stage2_first": s2_first, "stage2_s": s2,
            "captured": {"stage1": s1_captured, "stage2": s2_captured,
                         "chunked": chunk_captured},
            "raised": raised,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def check_fused_path(res, nonfused_s1: dict, nonfused_s2: dict) -> None:
    tr, cap = res["trainer"], res["captured"]
    g = tr.g
    check(cap["stage1"] == {"gnn_mp_pair": 2, "wc_oracle_trips": 0}
          and cap["stage2"] == {"gnn_mp_pair": 4, "wc_oracle_trips": 1}
          and cap["chunked"] == {"gnn_mp_pair": 10, "wc_oracle_trips": 2},
          f"launches a captured update: {cap}")
    check(res["counts"]["gnn_mp_pair"] > 0
          and res["counts"]["wc_oracle_trips"] > 0
          and res["counts"]["gnn_mp"] == res["counts"]["wc_oracle"] == 0,
          f"the fused path ran the gnn_mp pair and wc_trips: "
          f"{res['counts']}")
    n_upd = 2 * FUSED_RECORD
    check(len(tr.losses) == n_upd and all(np.isfinite(tr.losses)),
          "finite losses, one an update")
    check(tr.episode == FUSED_RECORD * (1 + TRAIN_K)
          and tr.opt_state.step == n_upd, f"episode counter {tr.episode}")
    rows = tr.history
    check(len(rows) == FUSED_RECORD
          and all(h.stage == "sim_fused" for h in rows)
          and all(np.isfinite(h.exec_time) and h.exec_time > 0
                  for h in rows)
          and tr.best_time <= min(h.exec_time for h in rows),
          "history rows, finite makespans, best so far kept")
    a = tr.best_assignment
    check(a.shape == (g.n,) and bool(((a >= 0) & (a < tr.dev.n)).all()),
          "best assignment in range")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(tr.params)),
          "finite params")
    cp_ms = tr.default_engine().exec_time(critical_path_assignment(
        g, tr.dev, seed=0))
    s1, s2 = res["stage1_s"], res["stage2_s"]
    f1, f2 = res["stage1_first"], res["stage2_first"]
    gname, fleet = TRAIN_REQUEST
    print(f"fused {gname} x {fleet} ({CARD}): stage I {FUSED_RECORD} "
          f"episodes, stage II {FUSED_RECORD} updates at K={TRAIN_K}, "
          f"{FUSED_DISPATCH} a dispatch; launches a captured update "
          f"{cap}; the path's counters (warm-ups and captures) "
          f"{res['counts']}; peak_memory_gb={res['peak_gb']:.3f}")
    print(f"fused stage I s per episode (over {FUSED_RECORD - 1}): "
          + " + ".join(f"{k} {v:.6f}" for k, v in s1.items())
          + f"; first call warmup {f1.get('warmup', 0.0):.6f} capture "
          f"{f1.get('capture', 0.0):.6f}; non-fused (path 7) "
          f"{sum(nonfused_s1.values()):.6f}")
    print(f"fused stage II s per update (over {FUSED_RECORD - 1}): "
          f"updates {s2['updates']:.6f}; first call warmup "
          f"{f2.get('warmup', 0.0):.6f} capture {f2.get('capture', 0.0):.6f}"
          f" updates {f2['updates']:.6f}; non-fused (path 7) "
          f"{sum(nonfused_s2.values()):.6f}")
    means = [h.exec_time * 1e3 for h in rows]
    print("fused training record, batch-mean makespan ms: first 8 "
          + ", ".join(f"{m:.6f}" for m in means[:8]) + "; last 8 "
          + ", ".join(f"{m:.6f}" for m in means[-8:])
          + f"; best {tr.best_time * 1e3:.6f}; CP {cp_ms * 1e3:.6f}")
    print(f"fused stage I losses first / last: {tr.losses[0]:.6f} / "
          f"{tr.losses[FUSED_RECORD - 1]:.6f}; stage II losses first 4 "
          + str([round(x, 6) for x in tr.losses[FUSED_RECORD:][:4]]))
    print(f"fused validity flag: {res['raised'][:80]}")


def profile_fused(tr, untraced_s: float) -> dict:
    """One more dispatch of FUSED_PROFILED Stage II updates (graph
    replays) under ``torch.profiler``: device launches and busy share per
    update, device ms per kernel; the kernels inside the replayed graph
    must be the captured ones."""
    traced_s, _, rows = _trace(
        lambda: tr.stage2_fused(FUSED_PROFILED, batch_size=TRAIN_K,
                                updates_per_dispatch=FUSED_DISPATCH),
        ("segment_sum_pair", "wc_trips<"))
    busy_s = sum(r[0] for r in rows) * 1e-6
    launches = sum(r[1] for r in rows)
    per = FUSED_PROFILED
    print(f"profile fused stage II dispatch ({per} updates, K={TRAIN_K}): "
          f"traced_s={traced_s:.6f} untraced_s={untraced_s * per:.6f} "
          f"device_busy_s={busy_s:.6f} "
          f"busy_share_traced={busy_s / traced_s:.6f} "
          f"busy_share_untraced={busy_s / (untraced_s * per):.6f} "
          f"device_launches_per_update={launches / per:.1f}")
    for us, count, key in rows[:8]:
        print(f"  {us * 1e-3:10.3f} ms  {count:6d} x  {key[:90]}")
    seen = {name: sum(c for _, c, key in rows if tag in key)
            for name, tag in (("gnn_mp_pair", "segment_sum_pair"),
                              ("wc_oracle_trips", "wc_trips<"))}
    check(seen == {"gnn_mp_pair": 4 * per, "wc_oracle_trips": per},
          f"the profiled replays launch the captured kernels: {seen}")
    return {"device_launches_per_update": launches / per,
            "device_busy_s_per_update": busy_s / per,
            "device_ms_per_launch": per_launch_ms(
                rows, (("gnn_mp_pair", "segment_sum_pair"),
                       ("wc_oracle_trips", "wc_trips<")))}


def profile_update(tr, engine, untraced_s: float) -> dict:
    """One more Stage II update under ``torch.profiler``: device launches
    and the device's busy share (traced and against an untraced update)."""
    traced_s, _, rows = _trace(lambda: tr.train_rl(engine, 1,
                                                   batch_size=TRAIN_K),
                               ("segment_sum_pair", "wc_trips<"))
    busy_s = sum(r[0] for r in rows) * 1e-6
    launches = sum(r[1] for r in rows)
    print(f"profile stage II update (K={TRAIN_K}): traced_s={traced_s:.6f} "
          f"untraced_s={untraced_s:.6f} device_busy_s={busy_s:.6f} "
          f"busy_share_traced={busy_s / traced_s:.6f} "
          f"busy_share_untraced={busy_s / untraced_s:.6f} "
          f"device_launches={launches}")
    for us, count, key in rows[:8]:
        print(f"  {us * 1e-3:10.3f} ms  {count:6d} x  {key[:90]}")
    per = per_launch_ms(rows, (("gnn_mp_pair", "segment_sum_pair"),
                               ("wc_oracle_trips", "wc_trips<")))
    return {"device_launches": launches, "device_busy_s": busy_s,
            "traced_s": traced_s, "device_ms_per_launch": per}


TRACE_TRIES = 3     # profiler sessions before a trace without the rows stands


def _trace(fn, tags=(), cpu=True):
    """Run ``fn`` under ``torch.profiler``; -> (traced s, the profile, its
    device rows).  Now and then a session on the card comes back without
    the device's activity (no kernel rows, or not the kernel asked for): a
    session with no device rows, or none whose name holds each of
    ``tags``, runs ``fn`` again, up to ``TRACE_TRIES`` sessions.  A session
    can also lose some of its kernel records (one of an xlstm-1.3b
    prefill's 42 scans, PERF.md Findings), so launches are counted by the
    wrappers and a profile's per-kernel times average the launches it
    recorded.  ``cpu=False`` traces the device alone: on ~270,000 launches
    (an xlstm-1.3b prefill) the host's op events took path 13 from 196 to
    298 s."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    for _ in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - t0
        rows = device_rows(prof)
        keys = [key for _, _, key in rows]
        if keys and all(any(t in k for k in keys) for t in tags):
            break
    return traced_s, prof, rows


def _profiled(fn, tags=(), cpu=True):
    """``fn`` under ``torch.profiler`` (``_trace``) in inference mode;
    -> (traced s, device rows)."""
    def run():
        with torch.inference_mode():
            fn()
    traced_s, _, rows = _trace(run, tags, cpu)
    return traced_s, rows


def profile_serve(params, cfg, prompt, res, expect: dict, cpu=True,
                  counted=None) -> dict:
    """One more prefill, then one decode step, under ``torch.profiler``:
    device time per kernel name and by kind (``device_split``), and the
    device's busy share of each; -> (device ms a launch by kernel,
    ``mamba2_scan``'s by pass, the split of each phase).
    ``expect``: the prefill's launches by kernel-name tag, which the
    profile must hold; ``cpu``: as ``_trace``'s.  ``counted`` (-> the
    wrappers' launch counts by tag) is for a prefill of so many launches
    that its session may lose a few kernel records (xlstm-1.3b's
    ~270,000): then the wrappers' counts over the profiled prefill must
    equal ``expect``, and the profile must hold each expected kernel at
    least once and none more often than expected."""
    prompt = _as_batch(prompt)
    first = next(iter(prompt.values()))
    B, S = first.shape[0], prompt_positions(prompt)
    state = init_decode_state(cfg, B, S + SERVE_GEN, device=first.device)
    prefill = make_prefill_step(cfg, S + SERVE_GEN)
    decode = make_decode_step(cfg)
    out, wrapped = {}, []

    def run_prefill():
        c0 = counted() if counted else {}
        out.update(pre=prefill(params, prompt, state))
        if counted:
            wrapped.append({t: n - c0[t] for t, n in counted().items()})

    phases = (("prefill", run_prefill, res.prefill_s, 10,
               tuple(t for t, c in expect.items() if c)),
              ("decode step", lambda: decode(
                  params, {"tokens": res.tokens[:, :1]}, out["pre"][1], S),
               res.decode_ms_per_step * 1e-3, 6, ()))
    rows_by_phase, splits = {}, {}
    for name, fn, untraced_s, top, tags in phases:
        traced_s, rows = _profiled(fn, tags, cpu)
        busy_s = sum(r[0] for r in rows) * 1e-6
        print(f"profile {cfg.name} {name} (B={B}, S={S}): traced_s="
              f"{traced_s:.6f} untraced_s={untraced_s:.6f} device_busy_s="
              f"{busy_s:.6f} busy_share_traced={busy_s / traced_s:.6f} "
              f"busy_share_untraced={busy_s / untraced_s:.6f} "
              f"device_launches={sum(r[1] for r in rows)}")
        for us, count, key in rows[:top]:
            print(f"  {us * 1e-3:10.3f} ms  {count:6d} x  {key[:90]}")
        splits[name] = device_split(rows)
        busy = max(busy_s, 1e-12)
        print("  by kind (device ms, launches, share of device time): "
              + ", ".join(f"{g} {ms:.3f} {n} {ms * 1e-3 / busy:.4f}"
                          for g, (ms, n) in splits[name].items()))
        rows_by_phase[name] = rows
    pre = rows_by_phase["prefill"]
    counts = {tag: sum(c for _, c, key in pre if tag in key)
              for tag in expect}
    print(f"profile {cfg.name} prefill: kernel launches recorded {counts}"
          + (f", by the wrappers {wrapped[-1]}" if counted else ""))
    if counted:
        check(wrapped[-1] == expect, f"the profiled {cfg.name} prefill "
                                     f"launches {expect}: {wrapped[-1]}")
        check(all((c > 0) == (expect[t] > 0) and c <= expect[t]
                  for t, c in counts.items()),
              f"the profile of the {cfg.name} prefill holds each of "
              f"{expect}: {counts}")
    else:
        check(counts == expect, f"the profiled {cfg.name} prefill runs "
                                f"{expect}: {counts}")
    per = per_launch_ms(pre, (("flash_attention", "flash_fwd_wgmma<"),
                              ("flash_attention_mma", "flash_fwd_mma<"),
                              *((n, n) for n in ssd_ops.KERNELS)))
    by_kernel = {n: per.pop(n) for n in ssd_ops.KERNELS}
    if all(t is not None for t in by_kernel.values()):
        # one mamba2_scan call launches each of its kernels once
        per["mamba2_scan"] = sum(by_kernel.values())
        print(f"profile {cfg.name} prefill: mamba2_scan device ms per call "
              f"{per['mamba2_scan']:.5f} = "
              + " + ".join(f"{n} {t:.5f}" for n, t in by_kernel.items()))
    return ({k: t for k, t in per.items() if t is not None}, by_kernel,
            splits)

# ------------------------------------------------------- Stage III path
def closed_form(ex, plan) -> dict:
    """Every result of one run of ``plan``, in float64 on the host, by
    walking the plan: inputs 0, a transfer copies, a step's seed is the
    sum of its predecessors' values, and with base = 1/s the payload
    gives r[0, 0] = s * (1/s + seed * 1e-6)^2, times 1e-9."""
    vals = dict.fromkeys(ex._input_results, 0.0)
    for v, d, xfers, pred_keys, _, base in plan.steps:
        for p, src in xfers:
            vals[(p, d)] = vals[(p, src)]
        seed = sum(vals[pk] for pk in pred_keys)
        s = base.shape[0]
        vals[(v, d)] = s * (1.0 / s + seed * 1e-6) ** 2 * 1e-9
    return vals


def check_exec_run(ex, assignment, what: str) -> dict:
    """One untimed debug replay of ``assignment``: every edge p -> v with
    p computed has end_p <= start_v on the card's clock (timing events
    after the step's waits and after its output); every output constant
    along its length and within EXEC_VALUE_TOL relative of its closed
    form; -> the streams the steps ran on and the worst readings."""
    plan = ex.compile_plan(assignment)
    trace = ex.trace_run(assignment)
    at = {v: (sid, start, end) for v, _, sid, start, end in trace["steps"]}
    g = ex.g
    gaps = [at[p][2].elapsed_time(at[v][1]) for p, v in g.edges
            if p in at]
    check(min(gaps) >= 0.0, f"{what}: a step started before its producer "
                            f"ended ({min(gaps)} ms)")
    want = closed_form(ex, plan)
    keys = sorted(trace["results"])
    got = torch.stack([torch.stack([trace["results"][k].amin(),
                                    trace["results"][k].amax()])
                       for k in keys]).double().cpu().numpy()
    check(np.array_equal(got[:, 0], got[:, 1]),
          f"{what}: every output constant along its length")
    ref = np.array([want[k] for k in keys])
    nz = ref != 0
    check(np.array_equal(got[~nz, 0], ref[~nz]), f"{what}: inputs are 0")
    rel = float(np.max(np.abs(got[nz, 0] - ref[nz]) / np.abs(ref[nz])))
    check(rel <= EXEC_VALUE_TOL, f"{what}: outputs {rel} from their "
                                 f"closed form")
    streams = {sid for sid, _, _ in at.values()}
    return {"streams": streams, "min_gap_ms": min(gaps), "value_rel": rel,
            "results": len(keys), "transfers": plan.n_transfers,
            "edges": len(gaps)}


def chains_graph(side: int, length: int) -> DataflowGraph:
    """One input feeding two independent chains of ``length`` matmuls at
    side ``side`` (vertices 1..length, then length+1..2 length)."""
    g = DataflowGraph(f"two_chains_{side}")
    x = g.add_vertex("input", out_bytes=4.0)
    for _ in range(2):
        prev = x
        for i in range(length):
            v = g.add_vertex("matmul", flops=2.0 * side ** 3, out_bytes=4.0,
                             meta_op=i)
            g.add_edge(prev, v)
            prev = v
    return g.freeze()


def device_span_ms(trace) -> float:
    """First step start to last step end of a debug replay, device ms."""
    ref = trace["steps"][0][3]
    starts = [ref.elapsed_time(st) for *_, st, _ in trace["steps"]]
    ends = [ref.elapsed_time(en) for *_, en in trace["steps"]]
    return max(ends) - min(starts)


def held_trace(ex, assignment, n_streams: int) -> dict:
    """``ex.trace_run`` with its first ``n_streams`` streams each held
    OVERLAP_HOLD_S by a sleep kernel (0: no head start)."""
    ex.compile_plan(assignment)
    cycles = int(torch.cuda.get_device_properties(0).clock_rate * 1e3
                 * OVERLAP_HOLD_S)
    for s in ex.streams[:n_streams]:
        with torch.cuda.stream(s):
            torch.cuda._sleep(cycles)
    return ex.trace_run(assignment)


def check_overlap() -> dict:
    """The two chains on logical devices {0, 1} (two streams) against all
    on device 0, OVERLAP_REPS debug replays of each in turns, with and
    without the head start: the median device span with the head start
    on two streams must be at most OVERLAP_BAR of that on one."""
    two = np.array([0] + [0] * OVERLAP_CHAIN + [1] * OVERLAP_CHAIN)
    one = np.zeros(1 + 2 * OVERLAP_CHAIN, np.int64)
    ex = WCExecutor(chains_graph(OVERLAP_SIDE, OVERLAP_CHAIN), n_virtual=2)
    res = {}
    for held in (True, False):
        spans = {"two": [], "one": []}
        for r in range(OVERLAP_REPS):
            for name in (("two", "one") if r % 2 else ("one", "two")):
                a, n = (two, 2) if name == "two" else (one, 1)
                spans[name].append(device_span_ms(
                    held_trace(ex, a, n if held else 0)))
        med = {k: float(np.median(v)) for k, v in spans.items()}
        res["held" if held else "not_held"] = {
            "ratio": med["two"] / med["one"], **med}
    h, u = res["held"], res["not_held"]
    print(f"stage3 overlap: 2 x {OVERLAP_CHAIN} fp32 matmuls at side "
          f"{OVERLAP_SIDE}, device span ms median of {OVERLAP_REPS}, with "
          f"a {OVERLAP_HOLD_S * 1e3:g} ms head start: two streams "
          f"{h['two']:.6f}, one {h['one']:.6f}, ratio {h['ratio']:.6f} <= "
          f"{OVERLAP_BAR}; without (not gated): two {u['two']:.6f}, one "
          f"{u['one']:.6f}, ratio {u['ratio']:.6f}")
    check(h["ratio"] <= OVERLAP_BAR,
          f"two streams overlap: span ratio {h['ratio']}")
    return res


def profile_exec(ex, assignment) -> dict:
    """One ``execute_batch`` of one run under ``torch.profiler``: device
    launches (kernels and copies), the streams they ran on, and the
    device's busy share (the union of their intervals over the traced
    wall time) beside their summed time over it (> 1 where streams
    overlap)."""
    ex.compile_plan(assignment)
    traced_s, prof, _ = _trace(lambda: ex.execute_batch(assignment[None],
                                                        repeats=1))
    evs = sorted((e.time_range.start, e.time_range.end,
                  e.device_resource_id) for e in prof.events()
                 if str(e.device_type).endswith("CUDA"))
    union, end = 0.0, -np.inf
    for a, b, _ in evs:
        if b > end:
            union += b - max(a, end)
            end = b
    total = sum(b - a for a, b, _ in evs)
    out = {"launches": len(evs), "streams": len({e[2] for e in evs}),
           "busy_share": union * 1e-6 / traced_s,
           "summed_share": total * 1e-6 / traced_s, "traced_s": traced_s}
    print(f"profile stage3 execute (CP, one run): traced_s={traced_s:.6f} "
          f"device_launches={out['launches']} streams={out['streams']} "
          f"busy_share={out['busy_share']:.6f} "
          f"summed_kernel_share={out['summed_share']:.6f}")
    return out


def stage3_path(dev) -> dict:
    """Stage III on the card on TRAIN_REQUEST: the executor's gates, the
    two-stream overlap, the calibration of the fleet on the executor,
    Stage I and II (fused) on the calibrated twin, then Stage III
    against the executor's measured wall-clock, the first update gated
    against a plain-backend twin that replays its measurements."""
    gname, fleet = TRAIN_REQUEST
    g, fm = get_workload(gname), get_device_model(fleet)
    torch.cuda.reset_peak_memory_stats()
    t_path = time.perf_counter()
    ex = WCExecutor(g, n_virtual=fm.n)      # flops_scale = bytes_scale = 1
    cp = critical_path_assignment(g, fm, seed=0)
    default_id = torch.cuda.default_stream().stream_id
    own = {s.stream_id for s in ex.streams}
    check(len(own) == fm.n and default_id not in own,
          f"one non-default stream a logical device: {own}")
    runs = {}
    for what, a in (("CP", cp), ("round-robin",
                                 round_robin_assignment(g, fm.n))):
        runs[what] = r = check_exec_run(ex, a, what)
        print(f"stage3 executor {what}: {r['edges']} edges in dependency "
              f"order (min end->start {r['min_gap_ms']:.6f} ms), "
              f"{r['results']} results within {r['value_rel']:.3e} <= "
              f"{EXEC_VALUE_TOL} of their closed form, {r['transfers']} "
              f"transfers, steps on {len(r['streams'])} streams")
    check(runs["round-robin"]["streams"] == own,
          "the round-robin run's steps land on the executor's "
          f"{fm.n} streams")
    check_overlap()

    t0 = time.perf_counter()
    cal = calibrate_fleet(fm, executor_measure(fm.n,
                                               repeats=STAGE3_REPEATS))
    cal_s = time.perf_counter() - t0
    off = ~np.eye(fm.n, dtype=bool)
    print(f"stage3 calibration of {fleet} on the executor ({CARD}): "
          f"{cal_s:.3f} s, {cal.n_measurements} probe measurements; "
          f"overhead us {np.round(cal.exec_overhead * 1e6, 3).tolist()}; "
          f"rate TFLOP/s {np.round(cal.flops_per_sec / 1e12, 3).tolist()}"
          f"; link GB/s {cal.link_bw[off].min() / 1e9:.3f} - "
          f"{cal.link_bw[off].max() / 1e9:.3f}; residuals "
          + ", ".join(f"{k} {v:.6f}" for k, v in cal.residuals.items()))
    check(np.isfinite(cal.exec_overhead).all()
          and (cal.exec_overhead >= 0).all()
          and np.isfinite(cal.flops_per_sec).all()
          and {"device", "link", "overall"} <= set(cal.residuals),
          "a finite calibrated fleet")

    gnn_ops.launches = gnn_ops.pair_launches = 0
    wc_ops.launches = wc_ops.trip_launches = 0
    kern = DopplerTrainer(g, cal.fleet, seed=0, device=dev)
    kern.stage1_imitation_fused(STAGE3_S1)
    kern.stage2_fused(STAGE3_S2, batch_size=TRAIN_K,
                      updates_per_dispatch=FUSED_DISPATCH)
    twin_s = dict(kern.seconds)
    engine = ExecutorRewardEngine(ex)
    plain = DopplerTrainer(g, cal.fleet, seed=0, device=dev,
                           encoder_backend="torch", oracle_backend="torch")
    _copy_state(kern, plain)
    draws = [_draw_tables(np.random.default_rng(1), g.n, STAGE3_K, fm.n)]
    # Stage III's best is by measured wall-clock, which the twin's
    # makespans from Stage II do not compare with
    kern.best_time, kern.best_assignment = np.inf, None
    kern.seconds.clear()
    kern.stage3_system_batched(1, engine, batch_size=STAGE3_K,
                               repeats=STAGE3_REPEATS, draws=draws)
    measured = -np.asarray(kern.last_update["rewards"])
    before = _launch_counts()
    plain.stage3_system_batched(
        1, CallableEngine(lambda A: measured, batched=True),
        batch_size=STAGE3_K, draws=draws)
    check(_launch_counts() == before, "the plain twin launches no kernel")
    gate_update("stage III update 1 (twin replays the measured times)",
                kern, plain, tree_scale=True)
    del plain
    kern.stage3_system_batched(STAGE3_UPDATES - 1, engine,
                               batch_size=STAGE3_K, repeats=STAGE3_REPEATS)
    s3 = {k: v / STAGE3_UPDATES for k, v in kern.seconds.items()}
    kern.seconds.clear()
    kern.stage3_system(1, ex.execute)
    serial_s = dict(kern.seconds)

    # the record: CP, greedy and the best Stage III assignment, measured
    # RECORD_RUNS times each in turns
    cands = {"CP": cp, "greedy": kern.greedy_assignment(),
             "best stage III": kern.best_assignment}
    wall = {k: [] for k in cands}
    host = {k: [] for k in cands}
    for _ in range(RECORD_RUNS):
        for k, a in cands.items():
            wall[k].append(ex.execute(a))
            host[k].append(ex.last_dispatch_s)
    twin = TorchWCEngine(g, cal.fleet, device=dev)
    record = {k: (float(np.median(wall[k])), float(np.median(host[k])),
                  float(twin.exec_time(a))) for k, a in cands.items()}
    profile_exec(ex, cp)
    return {"trainer": kern, "counts": _launch_counts(), "twin_s": twin_s,
            "stage3_s": s3, "serial_s": serial_s, "record": record,
            "calibration_s": cal_s,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "path_s": time.perf_counter() - t_path}


def check_stage3_path(res) -> None:
    tr = res["trainer"]
    g = tr.g
    check(res["counts"]["gnn_mp_pair"] > 0
          and res["counts"]["wc_oracle_trips"] > 0,
          f"the Stage III path ran the gnn_mp pair and wc_trips: "
          f"{res['counts']}")
    n_upd = STAGE3_S1 + STAGE3_S2 + STAGE3_UPDATES + 1
    check(len(tr.losses) == n_upd and all(np.isfinite(tr.losses)),
          f"finite losses, one an update: {len(tr.losses)}")
    rows = tr.history
    check([h.stage for h in rows] == ["sim_fused"] * STAGE3_S2
          + ["sys_batch"] * STAGE3_UPDATES + ["sys"],
          f"history rows {[h.stage for h in rows]}")
    check(all(np.isfinite(h.exec_time) and h.exec_time > 0 for h in rows)
          and tr.best_time == min(h.best_so_far for h in rows[STAGE3_S2:]),
          "finite positive makespans and measurements, Stage III's best "
          "kept")
    a = tr.best_assignment
    check(a.shape == (g.n,) and bool(((a >= 0) & (a < tr.dev.n)).all()),
          "best assignment in range")
    check(all(bool(torch.isfinite(x).all()) for x in tree_leaves(tr.params)),
          "finite params")
    gname, fleet = TRAIN_REQUEST
    s3, serial, twin = res["stage3_s"], res["serial_s"], res["twin_s"]
    print(f"stage3 {gname} x {fleet} ({CARD}): executor n_virtual "
          f"{tr.dev.n} on one card, flops_scale = bytes_scale = 1; fused "
          f"stage I {STAGE3_S1} episodes + stage II {STAGE3_S2} updates at "
          f"K={TRAIN_K} on the calibrated fleet "
          + " + ".join(f"{k} {v:.6f}" for k, v in twin.items())
          + f" s; launches on the path {res['counts']}; "
          f"peak_memory_gb={res['peak_gb']:.3f}")
    print(f"stage3 s per stage3_system_batched update (K={STAGE3_K}, "
          f"repeats {STAGE3_REPEATS}, {STAGE3_UPDATES} updates): total "
          f"{sum(s3.values()):.6f} = " + " + ".join(
              f"{k} {v:.6f}" for k, v in s3.items())
          + "; serial stage3_system episode: total "
          f"{sum(serial.values()):.6f} = " + " + ".join(
              f"{k} {v:.6f}" for k, v in serial.items()))
    print("stage3 batch-mean measured ms per update: "
          + ", ".join(f"{h.stage} {h.exec_time * 1e3:.6f}" for h in rows
                      if h.stage.startswith("sys")))
    print(f"stage3 record, median of {RECORD_RUNS} runs (wall ms / host "
          f"dispatch ms / calibrated twin ms): " + "; ".join(
              f"{k} {w * 1e3:.6f} / {h * 1e3:.6f} / {t * 1e3:.6f}"
              for k, (w, h, t) in res["record"].items()))
    print(f"stage3 path wall s: {res['path_s']:.3f} (calibration "
          f"{res['calibration_s']:.3f})")


# ------------------------------------------ checkpoints and the baselines
def check_resumed(a, b, what: str) -> None:
    """``b``, resumed from a checkpoint of ``a``, in ``a``'s state: params
    and both AdamW moments bit-equal, counters, reward statistics and
    generator state equal, the same greedy assignment."""
    pairs = zip(tree_leaves((a.params, a.opt_state.mu, a.opt_state.nu)),
                tree_leaves((b.params, b.opt_state.mu, b.opt_state.nu)))
    check(all(torch.equal(x, y) for x, y in pairs),
          f"{what}: params and moments bit-equal")
    check((a.opt_state.step, a.episode, a._r_sum, a._r_sqsum, a._r_count)
          == (b.opt_state.step, b.episode, b._r_sum, b._r_sqsum,
              b._r_count), f"{what}: counters and reward statistics")
    check(torch.equal(a.generator.get_state(), b.generator.get_state()),
          f"{what}: generator state")
    check(np.array_equal(a.greedy_assignment(), b.greedy_assignment()),
          f"{what}: greedy assignment")


def resume_path(dev) -> dict:
    """Save and resume on TRAIN_REQUEST: the fused Stage II with trainer
    B's capture built before the load, one non-fused ``train_rl`` update,
    and a CPU trainer's checkpoint on the card."""
    gname, fleet = TRAIN_REQUEST
    g, fm = get_workload(gname), get_device_model(fleet)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    kw = dict(batch_size=TRAIN_K, updates_per_dispatch=RESUME_UPDATES)
    a = DopplerTrainer(g, fm, seed=0, device=dev)
    a.stage2_fused(RESUME_UPDATES, **kw)
    t0 = time.perf_counter()
    path = save_policy(CKPT_DIR / "fused", a)
    save_s = time.perf_counter() - t0
    nbytes = (path / "arrays.msgpack").stat().st_size
    want = a.stage2_fused(RESUME_UPDATES, **kw)
    b = DopplerTrainer(g, fm, seed=1, device=dev)
    b.stage2_fused(1, **kw)
    eng = _engine(b, "stage2")
    check(eng.graphed.graph is not None, "B's fused engine is captured "
                                         "before the load")
    t0 = time.perf_counter()
    load_policy(CKPT_DIR / "fused", b)
    sync(dev)
    load_s = time.perf_counter() - t0
    got = b.stage2_fused(RESUME_UPDATES, **kw)
    check(got == want, "the resumed fused updates' makespans bit-identical "
                       "to the uninterrupted run's")
    check(_engine(b, "stage2") is eng
          and eng.graphed.replays == 1 + RESUME_UPDATES,
          f"B replays its one graph: {eng.graphed.replays} replays")
    check_resumed(a, b, "fused resume")

    # one non-fused update, resumed
    save_policy(CKPT_DIR / "train_rl", a)
    want_rl = a.train_rl(a.default_engine(), 1, batch_size=TRAIN_K)
    load_policy(CKPT_DIR / "train_rl", b)
    got_rl = b.train_rl(b.default_engine(), 1, batch_size=TRAIN_K)
    check(got_rl == want_rl, "the resumed train_rl update's makespans "
                             "bit-identical")
    check_resumed(a, b, "train_rl resume")

    # a CPU trainer's checkpoint on the card
    cpu = DopplerTrainer(g, fm, seed=3, device="cpu")
    save_policy(CKPT_DIR / "cpu", cpu)
    like = (b.params, AdamState(torch.zeros((), dtype=torch.int32),
                                b.opt_state.mu, b.opt_state.nu))
    (params, _), _ = restore_checkpoint(CKPT_DIR / "cpu",
                                        latest_step(CKPT_DIR / "cpu"), like)
    check(all(x.device.type == "cuda" and torch.equal(x.cpu(), y)
              for x, y in zip(tree_leaves(params), tree_leaves(cpu.params))),
          "a CPU checkpoint's params restore onto the card bit-equal")
    episode = b.episode
    try:
        load_policy(CKPT_DIR / "cpu", b)
        refused = ""
    except ValueError as err:
        refused = str(err)
    check("cpu generator" in refused and "cuda generator" in refused
          and b.episode == episode,
          f"the CPU generator state is refused on the card: {refused!r}")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return {"trainer": a, "bytes": nbytes, "save_s": save_s,
            "load_s": load_s, "makespans": np.asarray(want),
            "refused": refused}


def baselines_path(dev, doppler) -> dict:
    """GDP and Placeto on the ``gnn_mp`` pair (the first episode of each
    gated against a plain-backend twin), EnumOpt on the host, and the
    five assignments scored in one ``wc_trips`` launch."""
    gname, fleet = TRAIN_REQUEST
    g, fm = get_workload(gname), get_device_model(fleet)
    sim = WCSimulator(g, fm, noise_sigma=0.05)
    torch.cuda.reset_peak_memory_stats()
    res = {}
    for T, n_ep in ((GDPTrainer, GDP_EPISODES),
                    (PlacetoTrainer, PLACETO_EPISODES)):
        kern = T(g, fm, seed=0, device=dev)
        plain = T(g, fm, seed=0, device=dev, encoder_backend="torch")
        check(kern.encoder_backend == "cuda", f"{T.name} on the pair")
        layers = len(kern.params["gnn"]["layers"])
        forward = layers * (1 if T is GDPTrainer else g.n)
        _, first = _counted(lambda: kern.train(1, sim))
        _, twin = _counted(lambda: plain.train(1, sim))
        check(twin == dict.fromkeys(twin, 0),
              f"the plain {T.name} twin launches no kernel: {twin}")
        gate_update(f"{T.name} episode 1", kern, plain)
        del plain
        _, rest = _counted(lambda: kern.train(n_ep - 1, sim))
        check(first == {"gnn_mp_pair": 2 * forward, "gnn_mp": 0,
                        "wc_oracle_trips": 0, "wc_oracle": 0}
              and rest["gnn_mp_pair"] == 2 * forward * (n_ep - 1),
              f"{T.name}: {forward} pair launches a rollout and as many "
              f"in the replay: {first}, {rest}")
        check(len(kern.history) == n_ep
              and all(np.isfinite(kern.history)), f"{T.name} history")
        res[T.name] = {"trainer": kern, "per_episode": first,
                       "seconds": {k: v / n_ep
                                   for k, v in kern.seconds.items()}}
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    enum = enumerative_assignment(g, fm)
    res["enumopt_s"] = time.perf_counter() - t0
    cands = {"CP": critical_path_assignment(g, fm, seed=0),
             "EnumOpt": enum,
             "GDP best": res["gdp"]["trainer"].best_assignment,
             "Placeto best": res["placeto"]["trainer"].best_assignment,
             "DOPPLER greedy": doppler.greedy_assignment()}
    A = np.stack([np.asarray(a, dtype=np.int64) for a in cands.values()])
    check(bool(((A >= 0) & (A < fm.n)).all()), "assignments in range")
    ms, scored = _counted(
        lambda: TorchWCEngine(g, fm, device=dev).exec_times(A))
    check(scored["wc_oracle_trips"] == 1,
          f"the five assignments in one wc_trips launch: {scored}")
    plain_ms = TorchWCEngine(g, fm, backend="torch", device=dev).exec_times(A)
    check(np.array_equal(np.asarray(ms), np.asarray(plain_ms)),
          "the scoring batch bit-equal to the plain trip loop")
    res["makespans"] = dict(zip(cands, np.asarray(ms).tolist()))
    return res


def print_path10(resume, base) -> None:
    gname, fleet = TRAIN_REQUEST
    print(f"resume {gname} x {fleet} ({CARD}): arrays.msgpack "
          f"{resume['bytes']} bytes, save_policy {resume['save_s']:.6f} s, "
          f"load_policy {resume['load_s']:.6f} s; {RESUME_UPDATES} fused "
          f"updates at K={TRAIN_K} after the load bit-identical (batch "
          f"means ms "
          + ", ".join(f"{m * 1e3:.6f}" for m in
                      resume["makespans"].reshape(RESUME_UPDATES, -1)
                      .mean(1))
          + "), one train_rl update bit-identical; refused as expected: "
          f"{resume['refused'][:60]}")
    for name in ("gdp", "placeto"):
        r = base[name]
        tr = r["trainer"]
        print(f"{name} s per episode ({len(tr.history)} episodes): total "
              f"{sum(r['seconds'].values()):.6f} = " + " + ".join(
                  f"{k} {v:.6f}" for k, v in r["seconds"].items())
              + f"; launches an episode {r['per_episode']}; makespans ms "
              + ", ".join(f"{t * 1e3:.6f}" for t in tr.history))
    print(f"baselines peak_memory_gb={base['peak_gb']:.3f}; enumopt host "
          f"s {base['enumopt_s']:.6f}; one wc_trips batch, makespan ms: "
          + ", ".join(f"{k} {v * 1e3:.6f}"
                      for k, v in base["makespans"].items()))


# ------------------------------------------------------------- path 11
class LoggedEngine(RewardEngine):
    """A flat oracle that logs each call: its rows, makespans, seconds and
    the ``wc_trips`` launches it made (one a call on the card)."""

    batched = True
    deterministic = True

    def __init__(self, inner):
        self.inner, self.name = inner, f"logged[{inner.name}]"
        self.calls: list[dict] = []

    def exec_times(self, assignments, episode: int = 0) -> np.ndarray:
        A = np.asarray(assignments)
        A = A[None] if A.ndim == 1 else A
        t0, l0 = time.perf_counter(), wc_ops.trip_launches
        ts = self.inner.exec_times(A, episode)
        self.calls.append({"rows": len(A), "ms": np.asarray(ts),
                           "s": time.perf_counter() - t0,
                           "launches": wc_ops.trip_launches - l0})
        return ts


def assignment_of(actions) -> np.ndarray:
    """(K, n, 2) (vertex, device) steps -> (K, n) assignments."""
    acts = np.asarray(torch.as_tensor(actions).cpu())
    A = np.empty(acts.shape[:2], np.int64)
    np.put_along_axis(A, acts[..., 0], acts[..., 1], axis=1)
    return A


def fused_updates_checked(tr, n: int, what: str) -> tuple:
    """``n`` captured Stage II updates at K HIER_K, one a dispatch; every
    update's segment-level ``wc_trips`` batch is then re-scored by the
    plain trip loop on the card, all in one batch (episodes are
    independent): makespans bit-equal, every episode done.  -> (the
    makespans of every update, seconds an update)."""
    times, batches, s0 = [], [], tr.seconds.get("updates", 0.0)
    for _ in range(n):
        times += tr.stage2_fused(1, batch_size=HIER_K,
                                 updates_per_dispatch=1)
        batches.append(assignment_of(tr.last_update["actions"]))
    per_update = (tr.seconds.get("updates", 0.0) - s0) / n
    sg = tr._fused_cache["sim_graph"]
    ms, ok = makespan_fifo_batch(sg, torch.as_tensor(
        np.concatenate(batches), device=sg.esrc.device), backend="torch")
    check(bool(ok.all()) and ms.cpu().tolist() == times,
          f"{what}: each update's wc_trips batch bit-equal to the plain "
          f"trip loop ({n} batches of {HIER_K})")
    return times, per_update


def hier_place(tr, what: str) -> dict:
    """``place(refine=True)`` of a hierarchical trainer on its flat oracle
    (logged): one ``wc_trips`` launch an engine call, the greedy rollout
    2 ``gnn_mp`` pair launches; the makespan bit-equal to a one-row
    re-scoring, at most every expanded segment-CP candidate's, and the
    refinement monotone from the pool's and the V-cycle's best."""
    eng = LoggedEngine(tr.flat_engine())
    pl, counts = _counted(lambda: tr.place(engine=eng, refine=True))
    calls = eng.calls
    check(all(c["launches"] == 1 for c in calls)
          and counts["wc_oracle_trips"] == len(calls)
          and counts["gnn_mp_pair"] == 2 and counts["gnn_mp"] == 0,
          f"{what}: one wc_trips launch an engine call ({len(calls)}), 2 "
          f"pair launches: {counts}")
    again = float(_uncounted(
        lambda: tr.flat_engine().exec_times(pl.assignment[None]))[0])
    check(pl.makespan == again, f"{what}: place()'s makespan {pl.makespan} "
          f"bit-equal to a one-row re-scoring {again}")
    n_pool = len(pl.makespans)
    cp_rows = pl.makespans[n_pool - 3:]                  # the 3 CP seeds
    check(pl.makespan <= cp_rows.min(),
          f"{what}: {pl.makespan} <= expanded segment CP {cp_rows.min()}")
    vc = tr.hier.n_levels > 1
    best_in = min(float(calls[0]["ms"].min()),
                  float(calls[1]["ms"][0]) if vc else np.inf)
    t_in = float(calls[1 + vc]["ms"][0])
    check(t_in == best_in and pl.makespan <= t_in
          and pl.refine_state.exec_time == pl.makespan,
          f"{what}: refinement from {t_in} (best of pool and V-cycle "
          f"{best_in}) to {pl.makespan} never raises it")
    rows = [c["rows"] for c in calls[2 + vc:]]
    print(f"hier place {what} ({CARD}): n={tr.flat_graph.n} levels "
          f"{[p.seg_graph.n for p in tr.hier.partition.levels]}; makespan "
          f"ms pool best {calls[0]['ms'].min() * 1e3:.6f}"
          + (f", V-cycle {float(calls[1]['ms'][0]) * 1e3:.6f}" if vc else "")
          + f", refined {pl.makespan * 1e3:.6f}, segment CP best "
          f"{cp_rows.min() * 1e3:.6f}; seconds pool "
          f"{pl.seconds['pool']:.6f} vcycle {pl.seconds['vcycle']:.6f} "
          f"refine {pl.seconds['refine']:.6f}; refine rounds "
          f"{pl.refine_state.rounds_done} moves "
          f"{pl.refine_state.moves_applied}, rows a call after the first "
          f"{rows}; vcycle stats "
          + str([{k: (round(v, 6) if isinstance(v, float) else v)
                  for k, v in st.items()} for st in tr.hier.vcycle_stats])
          + f"; engine calls {len(calls)}, oracle s "
          f"{sum(c['s'] for c in calls):.6f}")
    return {"placement": pl, "calls": calls, "counts": counts}


def refine_batch(tr, a) -> np.ndarray:
    """The candidates a refinement round proposes at flat assignment
    ``a`` (``propose_moves`` with the trainer's top_k)."""
    cands, _ = propose_moves(tr.flat_graph, a, tr.hierarchy.refine_top_k,
                             tr.hier.exec_cost, tr.dev.n)
    return cands


def time_refine_batch(tr, A, what: str, iters: int) -> dict:
    """One refine batch through ``wc_trips`` (the global scratch at these
    sizes): per-call ms (CUDA events), device ms a launch (profiler), its
    bound and scratch bytes."""
    sg = tr.flat_engine().sim_graph
    args = trip_inputs(sg, torch.as_tensor(A, device=sg.esrc.device))
    B, N = args[0].shape
    nbytes = wc_ops.episode_bytes(sg.n, N - sg.n, sg.R, sg.K)
    where = trips_placements(sg)[0]
    kern = lambda: wc_ops.wc_trips(sg, *args)          # noqa: E731
    ms = time_ms(kern, iters=iters, warmup=1)
    _, rows = _profiled(lambda: [kern() for _ in range(iters)],
                        ("wc_trips<",))
    dev_ms = per_launch_ms(rows, (("k", "wc_trips<"),))["k"]
    t_max, t_mean, b_ms, b_by = trips_bound(sg, args)
    out = {"n": sg.n, "B": B, "R": sg.R, "C": sg.C, "placement": where,
           "episode_bytes": nbytes, "scratch_bytes": B * nbytes * (
               where == "global"), "ms": ms, "device_ms": dev_ms,
           "bound_ms": b_ms, "bound_by": b_by, "trips_max": t_max,
           "trips_mean": t_mean, "us_per_trip": ms * 1e3 / t_max}
    dev = "not measured" if dev_ms is None else f"{dev_ms:.6f} ms"
    print(f"wc_trips {what} refine batch ({CARD}): B={B} n={sg.n} "
          f"mm={N - sg.n} C={sg.C} {where}, {nbytes} bytes of state an "
          f"episode, scratch {out['scratch_bytes']} bytes: {ms:.6f} ms per "
          f"call, device (profiler) {dev} a launch, trips max {t_max} mean "
          f"{t_mean:.1f}, {out['us_per_trip']:.4f} us a trip; bound "
          f"{b_ms:.6f} ms ({b_by})")
    return out


def hier_train_path(dev) -> dict:
    """HIER_TRAIN on HIER_FLEET: fused Stage I and II on the segment graph
    (every Stage II batch held against the plain trip loop), one
    ``train_rl`` update over flat rewards, ``place(refine=True)``, three
    re-placements without commit and a committed device loss followed by
    fused updates gated against a fresh trainer on the new fleet."""
    fm = get_device_model(HIER_FLEET)
    g = synthetic_layered(*HIER_TRAIN)
    res = {}
    t0 = time.perf_counter()
    tr = DopplerTrainer(g, fm, seed=0, device=dev, hierarchy=HIER_CFG)
    res["setup_s"] = time.perf_counter() - t0
    check(tr.hier.n_levels == 2 and tr.g.n < g.n,
          f"{g.n} vertices coarsen in 2 levels: "
          f"{[p.seg_graph.n for p in tr.hier.partition.levels]}")
    print(f"hier coarsen n={g.n} ({CARD}): trainer set-up "
          f"{res['setup_s']:.6f} s; levels " + ", ".join(
              f"{st['n_in']} -> {st['n_out']} in {st['seconds']:.6f} s"
              for st in tr.hier.partition.level_stats))

    t0 = time.perf_counter()
    tr.stage1_imitation_fused(HIER_S1)
    sync(dev)
    res["stage1_s"] = (time.perf_counter() - t0) / HIER_S1
    check(_engine(tr, "stage1").graphed.captured
          == {"gnn_mp_pair": 2, "wc_oracle_trips": 0},
          f"hier stage I captured: {_engine(tr, 'stage1').graphed.captured}")
    t0 = time.perf_counter()
    times, per_update = fused_updates_checked(tr, HIER_S2, "hier stage II")
    res["stage2_s"] = (time.perf_counter() - t0) / HIER_S2
    res["stage2_update_s"] = per_update
    check(_engine(tr, "stage2").graphed.captured
          == {"gnn_mp_pair": 4, "wc_oracle_trips": 1},
          f"hier stage II captured: {_engine(tr, 'stage2').graphed.captured}")
    ms = np.asarray(times).reshape(HIER_S2, HIER_K)
    check(bool(np.isfinite(ms).all()), "finite Stage II makespans")

    flat = LoggedEngine(tr.flat_engine())
    t0 = time.perf_counter()
    _, c = _counted(lambda: tr.train_rl(ExpandingEngine(tr.hier, flat), 1,
                                        batch_size=HIER_K))
    res["flat_update_s"] = time.perf_counter() - t0
    check(c == {"gnn_mp_pair": 4, "gnn_mp": 0, "wc_oracle_trips": 1,
                "wc_oracle": 0} and flat.calls[0]["rows"] == HIER_K,
          f"the flat-reward update: one wc_trips batch of {HIER_K} flat "
          f"rows, 4 pair launches: {c}")
    print(f"hier training ({CARD}): stage I fused {res['stage1_s']:.6f} s "
          f"an episode ({HIER_S1}); stage II fused {res['stage2_s']:.6f} s "
          f"an update with its plain-loop check, {per_update:.6f} s of "
          f"dispatch ({HIER_S2} at K={HIER_K}, batch means ms "
          f"{ms[0].mean() * 1e3:.6f} -> {ms[-1].mean() * 1e3:.6f}); "
          f"flat-reward train_rl update {res['flat_update_s']:.6f} s "
          f"(oracle {flat.calls[0]['s']:.6f} s, flat mean ms "
          f"{flat.calls[0]['ms'].mean() * 1e3:.6f})")

    res["place"] = hier_place(tr, f"n={g.n}")
    pl = res["place"]["placement"]
    A = refine_batch(tr, pl.assignment)
    res["trips"] = _uncounted(
        lambda: time_refine_batch(tr, A, f"n={g.n}", iters=5))
    t0 = time.perf_counter()
    numpy_ms = WCSimulator(g, fm, noise_sigma=0.0).run_batch(A)[:, 0]
    numpy_s = time.perf_counter() - t0
    card_ms = _uncounted(lambda: tr.flat_engine().exec_times(A))
    gap = float(np.abs(card_ms - numpy_ms).max() / numpy_ms.min())
    res["numpy_gap"] = gap
    print(f"wc_trips vs the float64 numpy WCSimulator on the n={g.n} refine "
          f"batch ({len(A)} rows): largest gap {gap:.6e} of the smallest "
          f"makespan (no bar: ROADMAP C3); numpy {numpy_s:.6f} s")

    res["replace"] = []
    dev0, params0 = tr.dev, tr.params
    for ev in HIER_EVENTS:
        new_dev, _ = ev.apply(tr.dev)
        eng = LoggedEngine(tr.flat_engine(new_dev))
        r, c = _counted(lambda: tr.replace(ev, budget_s=HIER_BUDGET_S,
                                           engine=eng, commit=False))
        check(tr.dev is dev0 and tr.params is params0,
              f"replace({ev.kind}, commit=False) leaves the trainer")
        check(all(x["launches"] == 1 for x in eng.calls)
              and c["wc_oracle_trips"] == len(eng.calls)
              and c["gnn_mp_pair"] == 2,
              f"replace({ev.kind}): one wc_trips launch an engine call, "
              f"one greedy rollout: {c}")
        check(r.makespan <= r.cp_makespan and r.makespan <= r.makespan_before
              and r.assignment.max() < new_dev.n
              and r.assignment.shape == (g.n,),
              f"replace({ev.kind}): {r.makespan} <= CP {r.cp_makespan}, "
              f"<= before {r.makespan_before}, devices < {new_dev.n}")
        res["replace"].append(r)
        print(f"replace {ev.kind}({ev.device}) ({CARD}): latency "
              f"{r.latency_s:.6f} s (budget {r.budget_s}, within "
              f"{r.within_budget}), source {r.source}, makespan ms before "
              f"{r.makespan_before * 1e3:.6f} -> {r.makespan * 1e3:.6f}, "
              f"CP {r.cp_makespan * 1e3:.6f}, refine rounds "
              f"{r.refine_rounds} moves {r.refine_moves}, candidates "
              f"{r.n_candidates}, engine rows {[x['rows'] for x in eng.calls]}")
    loss = HIER_EVENTS[0]
    check(loss.kind == "device_loss" and res["replace"][0].assignment.max()
          < fm.n - 1, "after a device loss no vertex sits on a device >= 7")

    eng = LoggedEngine(tr.flat_engine(loss.apply(tr.dev)[0]))
    r, c = _counted(lambda: tr.replace(loss, budget_s=HIER_BUDGET_S,
                                       engine=eng, commit=True))
    check(all(x["launches"] == 1 for x in eng.calls)
          and c["wc_oracle_trips"] == len(eng.calls)
          and c["gnn_mp_pair"] == 2,
          f"replace(device_loss, commit=True): one wc_trips launch an "
          f"engine call, one greedy rollout: {c}")
    check(tr.dev.n == fm.n - 1 and tr._fused_cache == {}
          and tr.hier.n_devices == fm.n - 1 and tr.gd.nd == fm.n - 1
          and len(tr.best_assignment) == tr.g.n,
          "the committed loss: 7 devices, fused engines dropped")
    fresh = DopplerTrainer(g, tr.dev, seed=1, device=dev, hierarchy=HIER_CFG)
    _copy_state(tr, fresh)
    fresh.best_assignment = tr.best_assignment.copy()
    fresh.best_time = tr.best_time
    got, _ = fused_updates_checked(tr, HIER_AFTER, "after the commit")
    want, _ = fused_updates_checked(fresh, HIER_AFTER, "the fresh trainer")
    for who, t in (("committed", tr), ("fresh", fresh)):
        cap = _engine(t, "stage2").graphed.captured
        check(cap == {"gnn_mp_pair": 4, "wc_oracle_trips": 1},
              f"the {who} 7-device stage II captured: {cap}")
    gap = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves((tr.params, tr.opt_state.mu, tr.opt_state.nu)),
        tree_leaves((fresh.params, fresh.opt_state.mu, fresh.opt_state.nu))))
    check(got == want and gap == 0.0,
          f"after the committed loss the fused updates are bit-identical "
          f"to a fresh trainer's on the new fleet from the same state: "
          f"makespans equal {got == want}, params and moments {gap}")
    print(f"replace device_loss(3) committed ({CARD}): latency "
          f"{r.latency_s:.6f} s, makespan ms {r.makespan * 1e3:.6f}; "
          f"{HIER_AFTER} fused updates after it bit-identical to a fresh "
          f"7-device trainer's (batch means ms "
          + ", ".join(f"{m * 1e3:.6f}" for m in
                      np.asarray(got).reshape(HIER_AFTER, -1).mean(1)) + ")")
    res["trainer"] = tr
    return res


def hier_big_path(dev) -> dict:
    """HIER_BIG on HIER_FLEET with random weights: coarsen (3 levels) and
    ``place(refine=True)`` on the flat oracle, as the reference's
    ``measure_big`` (no training); then one refine batch timed."""
    fm = get_device_model(HIER_FLEET)
    g = synthetic_layered(*HIER_BIG)
    t0 = time.perf_counter()
    tr = DopplerTrainer(g, fm, seed=0, device=dev, hierarchy=HIER_CFG)
    setup_s = time.perf_counter() - t0
    check(tr.hier.n_levels == 3,
          f"{g.n} vertices coarsen in 3 levels: "
          f"{[p.seg_graph.n for p in tr.hier.partition.levels]}")
    print(f"hier coarsen n={g.n} ({CARD}): trainer set-up {setup_s:.6f} s; "
          f"levels " + ", ".join(
              f"{st['n_in']} -> {st['n_out']} in {st['seconds']:.6f} s"
              for st in tr.hier.partition.level_stats))
    res = {"setup_s": setup_s, "place": hier_place(tr, f"n={g.n}")}
    pl = res["place"]["placement"]
    A = refine_batch(tr, pl.assignment)
    res["trips"] = _uncounted(
        lambda: time_refine_batch(tr, A, f"n={g.n}", iters=2))
    return res


def hier_path(dev) -> dict:
    """Path 11: the hierarchy and re-placement at n 4,113 (trained) and
    65,553 (random weights), on a ``synthetic_layered(32, 16)`` refine
    batch ``wc_trips`` against the plain trip loop in both placements."""
    fm = get_device_model(HIER_FLEET)
    g = synthetic_layered(*HIER_CHECK)
    sg = SimGraph.build(g, fm, dev)
    cost = (fm.exec_overhead_vec[None, :] + g.flops_array()[:, None]
            / fm.flops_per_sec[None, :])
    cost[g.input_mask()] = 0.0
    cands, _ = propose_moves(g, critical_path_assignment(g, fm), 24, cost,
                             fm.n)
    ok, places = _uncounted(
        lambda: check_trips(sg, cands, f"the n={g.n} refine batch"))
    check(bool(ok.all()) and places == ("shared", "global"),
          f"the n={g.n} refine batch runs both placements: {places}")
    print(f"wc_trips bit-equal to the plain trip loop on the n={g.n} refine "
          f"batch ({len(cands)} rows) in {places}")
    torch.cuda.reset_peak_memory_stats()
    train = hier_train_path(dev)
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    del train["trainer"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    big = hier_big_path(dev)
    big_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"hier peak_memory_gb n={train['trips']['n']} {train_peak:.3f}, "
          f"n={big['trips']['n']} {big_peak:.3f}")
    return {"train": train, "big": big, "check_rows": len(cands),
            "peak_gb": (train_peak, big_peak)}


# ------------------------------------------------------------- path 12
class _Recording:
    """Within the block, every ``stage1_imitation`` pass and
    ``_batched_rl_update`` of any ``DopplerTrainer`` is recorded: its
    trainer, wall seconds, phase seconds and kernel launches (the
    pretraining loop builds its trainers itself); the first Stage II
    update also keeps the state it started from (params, AdamW state,
    generator, counters) and its reward engine."""

    def __init__(self):
        self.stage1, self.stage2, self.first = [], [], None

    def __enter__(self):
        self._orig = (DopplerTrainer.stage1_imitation,
                      DopplerTrainer._batched_rl_update)
        s1, s2 = self._orig
        rec = self

        def timed(log, fn, tr, *a, **k):
            c0, p0 = _launch_counts(), dict(tr.seconds)
            t0 = time.perf_counter()
            out = fn(tr, *a, **k)
            sync(tr.device)
            log.append({"trainer": tr, "s": time.perf_counter() - t0,
                        "phases": {p: v - p0.get(p, 0.0)
                                   for p, v in tr.seconds.items()
                                   if v != p0.get(p)},
                        "launches": {n: v - c0[n]
                                     for n, v in _launch_counts().items()}})
            return out

        def stage1(tr, *a, **k):
            return timed(rec.stage1, s1, tr, *a, **k)

        def stage2(tr, reward, *a, **k):
            first = rec.first is None
            if first:
                rec.first = SimpleNamespace(
                    params=tree_map(torch.clone, tr.params),
                    opt_state=AdamState(
                        tr.opt_state.step,
                        tree_map(torch.clone, tr.opt_state.mu),
                        tree_map(torch.clone, tr.opt_state.nu)),
                    generator=torch.Generator(tr.device),
                    episode=tr.episode, _r_sum=tr._r_sum,
                    _r_sqsum=tr._r_sqsum, _r_count=tr._r_count,
                    reward=reward, trainer=tr)
                rec.first.generator.set_state(tr.generator.get_state())
            out = timed(rec.stage2, s2, tr, reward, *a, **k)
            if first:
                rec.first.update = dict(tr.last_update)
            return out

        DopplerTrainer.stage1_imitation = stage1
        DopplerTrainer._batched_rl_update = stage2
        return self

    def __exit__(self, *exc):
        DopplerTrainer.stage1_imitation, DopplerTrainer._batched_rl_update = \
            self._orig
        return False


def _phase_means(log) -> dict:
    keys = sorted({p for r in log for p in r["phases"]})
    return {p: sum(r["phases"].get(p, 0.0) for r in log) / len(log)
            for p in keys}


def pretrain_path(dev) -> dict:
    """12a: ``pretrain`` at the policy's published width over
    PRETRAIN_TASKS, its first Stage II update re-run on a kernel-backend
    and a plain-backend twin from the same state (path 4's gate), every
    task's best time finite, and the result saved and loaded bit-equal."""
    tasks = zoo_pretrain_tasks(holdout=ARCH_IDS, n_synthetic=4, seed=0)
    tasks += [PretrainTask(f"{g}|{f}", get_workload(g), get_device_model(f))
              for g, f in PRETRAIN_EXTRA]
    t0 = time.perf_counter()
    with _Recording() as rec:
        pre = pretrain(tasks, rounds=PRETRAIN_ROUNDS, batch_size=PRETRAIN_K,
                       imitation_episodes=PRETRAIN_S1, device=dev)
    wall = time.perf_counter() - t0
    check(len(rec.stage1) == PRETRAIN_S1 * len(tasks)
          and len(rec.stage2) == PRETRAIN_ROUNDS * len(tasks),
          f"pretrain ran {len(rec.stage1)} imitation passes and "
          f"{len(rec.stage2)} updates")
    best = {k: v["best_time"] for k, v in pre["per_task"].items()}
    check(all(np.isfinite(t) for t in best.values()),
          f"every task's best time is finite: {best}")
    check(all(r["launches"]["gnn_mp_pair"] == 2 for r in rec.stage1)
          and all(r["launches"]["gnn_mp_pair"] == 4 for r in rec.stage2)
          and all(r["launches"][k] == 0 for r in rec.stage1 + rec.stage2
                  for k in ("gnn_mp", "wc_oracle", "wc_oracle_trips")),
          "the gnn_mp pair twice an imitation pass (the replay) and 4 times "
          "an update (sample + replay), nothing else")

    # the first Stage II update again, kernel against plain backends
    first = rec.first
    src = first.trainer

    def twin(backend):
        tr = DopplerTrainer(src.g, src.dev, seed=0, d_hidden=64,
                            lr0=3e-3, lr1=1e-5,
                            total_episodes=src.total_episodes, device=dev,
                            encoder_backend=backend)
        _copy_state(first, tr)
        tr._batched_rl_update(first.reward, PRETRAIN_K, "pretrain")
        return tr

    kern, plain = _uncounted(lambda: (twin("cuda"), twin("torch")))
    check(np.array_equal(kern.last_update["rewards"],
                         first.update["rewards"])
          and torch.equal(kern.last_update["actions"],
                          first.update["actions"]),
          "the re-run first update is pretrain's (actions, rewards)")
    gate_update(f"pretrain first update ({pre['meta']['tasks'][0]})",
                kern, plain)

    # save_pretrained -> load_pretrained on the card, bit-equal
    shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    save_pretrained(PRETRAIN_DIR, pre)
    t1 = time.perf_counter()
    back = load_pretrained(PRETRAIN_DIR, device=dev)
    t2 = time.perf_counter()
    check(back["meta"] == pre["meta"] and all(
        a.device == b.device and torch.equal(a, b) for a, b in zip(
            tree_leaves(back["params"]), tree_leaves(pre["params"]))),
          "save_pretrained -> load_pretrained on the card is bit-equal")

    s1, s2 = _phase_means(rec.stage1), _phase_means(rec.stage2)
    print(f"pretrain ({CARD}): {len(tasks)} tasks "
          f"{[(t.name, t.graph.n) for t in tasks]}, {PRETRAIN_S1} imitation "
          f"passes + {PRETRAIN_ROUNDS} rounds at K {PRETRAIN_K}: wall "
          f"{wall:.6f} s; s an imitation pass "
          f"{np.mean([r['s'] for r in rec.stage1]):.6f} by phase "
          + json.dumps({k: round(v, 6) for k, v in s1.items()})
          + f"; s an update {np.mean([r['s'] for r in rec.stage2]):.6f} by "
          f"phase " + json.dumps({k: round(v, 6) for k, v in s2.items()})
          + f"; pair launches an update 4, an imitation pass 2; best ms "
          + json.dumps({k: round(v * 1e3, 6) for k, v in best.items()})
          + f"; save {t1 - t0:.6f} s, load {t2 - t1:.6f} s")
    return {"pre": pre, "tasks": tasks, "wall_s": wall}


def serve_zero_shot_path(dev, pre) -> dict:
    """12b: a ``PlacementServer`` over 12a's params on SERVE_CELLS (a graph
    pretraining never saw): a miss (2 pair launches, no oracle launch),
    a hit (no launch), SERVE_HITS hits for p50 / p99; served <= CP and
    re-scored exactly; the card's greedy equal to the CPU's; a server
    from the checkpoint; one fine-tuned miss on a fresh server."""
    server = PlacementServer(pre["params"], meta=pre["meta"], device=dev)
    cpu_params = to_numpy_params(pre["params"])
    res, served = {"cells": []}, []
    for gname, fleet in SERVE_CELLS:
        g, fm = get_workload(gname), get_device_model(fleet)
        miss, c_miss = _counted(lambda: server.place(g, fm))
        check(not miss.cache_hit and c_miss["gnn_mp_pair"] == 2
              and c_miss["wc_oracle_trips"] == c_miss["gnn_mp"]
              == c_miss["wc_oracle"] == 0,
              f"{gname} x {fleet}: a miss is 2 pair launches: {c_miss}")
        hit, c_hit = _counted(lambda: server.place(g, fm))
        check(hit.cache_hit and not any(c_hit.values())
              and np.array_equal(hit.assignment, miss.assignment),
              f"{gname} x {fleet}: a hit launches nothing: {c_hit}")
        lat = [server.place(g, fm).latency_s for _ in range(SERVE_HITS)]
        sim = WCSimulator(g, fm, choose="fifo", noise_sigma=0.0)
        cp = min(sim.run(critical_path_assignment(g, fm, seed=s)).makespan
                 for s in range(2))
        again = sim.run(miss.assignment).makespan
        check(miss.makespan <= cp * (1 + 1e-9) and again == miss.makespan,
              f"{gname} x {fleet}: served {miss.makespan} <= CP {cp}, "
              f"re-scored {again}")
        cpu_greedy = _uncounted(lambda: greedy_place(cpu_params, g, fm,
                                                     device="cpu"))
        card_greedy = _uncounted(lambda: greedy_place(pre["params"], g, fm,
                                                      device=dev))
        check(np.array_equal(cpu_greedy, card_greedy),
              f"{gname} x {fleet}: the card's greedy equals the CPU's")
        served.append(miss.assignment)
        cell = {"cell": f"{gname}|{fleet}", "makespan": miss.makespan,
                "cp": cp, "source": miss.source, "seconds": miss.seconds,
                "latency_s": miss.latency_s,
                "hit_p50_s": float(np.percentile(lat, 50)),
                "hit_p99_s": float(np.percentile(lat, 99))}
        res["cells"].append(cell)
        print(f"serve zero-shot {gname} x {fleet} ({CARD}): miss "
              f"{miss.latency_s:.6f} s = greedy "
              f"{miss.seconds['greedy']:.6f} + CP {miss.seconds['cp']:.6f} "
              f"+ scoring {miss.seconds['scoring']:.6f}; hit p50 "
              f"{cell['hit_p50_s'] * 1e6:.3f} us p99 "
              f"{cell['hit_p99_s'] * 1e6:.3f} us ({SERVE_HITS} hits); "
              f"served {miss.makespan * 1e3:.6f} ms ({miss.source}), CP "
              f"{cp * 1e3:.6f} ms; greedy equal to the CPU's")
    gname, fleet = SERVE_CELLS[0]
    g, fm = get_workload(gname), get_device_model(fleet)
    from_ckpt = PlacementServer.from_checkpoint(PRETRAIN_DIR, device=dev)
    check(np.array_equal(from_ckpt.place(g, fm).assignment, served[0]),
          "from_checkpoint serves the same assignment")
    fresh = PlacementServer(pre["params"], meta=pre["meta"], device=dev)
    ft = fresh.place(g, fm, fine_tune_budget_s=SERVE_FT_BUDGET_S)
    check(ft.makespan <= res["cells"][0]["makespan"]
          and ft.fine_tune_updates >= 1,
          f"the fine-tuned miss serves {ft.makespan} <= the zero-shot "
          f"{res['cells'][0]['makespan']}")
    print(f"serve fine-tune {gname} x {fleet} ({CARD}): budget "
          f"{SERVE_FT_BUDGET_S} s, {ft.fine_tune_updates} updates at K 8, "
          f"miss {ft.latency_s:.6f} s (fine-tune "
          f"{ft.seconds['fine_tune']:.6f}), served {ft.makespan * 1e3:.6f} "
          f"ms from {ft.source}; from_checkpoint served the same "
          f"assignment")
    res["fine_tune"] = {"updates": ft.fine_tune_updates,
                        "makespan": ft.makespan, "source": ft.source}
    return res


def fleet_path(dev) -> dict:
    """12c: ``FleetTrainer`` (App. I) on FLEET_BLOCKS x FLEET_FLEET, every
    block's reward the mean of FLEET_REPLICAS replicas."""
    fm = get_device_model(FLEET_FLEET)
    t0 = time.perf_counter()
    ft = FleetTrainer({b: get_workload(b) for b in FLEET_BLOCKS}, fm,
                      n_replicas=FLEET_REPLICAS, device=dev)
    ft.train(FLEET_EPISODES, batch_size=FLEET_K)
    wall = time.perf_counter() - t0
    for name, tr in ft.trainers.items():
        check(tr.episode == FLEET_EPISODES
              and [h.stage for h in tr.history] == ["fleet"] * (
                  FLEET_EPISODES // FLEET_K),
              f"FleetTrainer {name}: episode {tr.episode}, stages "
              f"{[h.stage for h in tr.history]}")
    best = {n: a is not None for n, a in ft.assignments().items()}
    check(all(best.values()), f"every block has an assignment: {best}")
    print(f"fleet trainer ({CARD}): {list(FLEET_BLOCKS)} on {FLEET_FLEET}, "
          f"{FLEET_REPLICAS} replicas, {FLEET_EPISODES} episodes at K "
          f"{FLEET_K}: {wall:.6f} s; best ms "
          + json.dumps({n: round(t.best_time * 1e3, 6)
                        for n, t in ft.trainers.items()}))
    return {"wall_s": wall}


def _cli(argv) -> tuple[dict, list, float]:
    """``doppler_train.main(argv)`` in this process; its output is printed
    as it comes and kept.  -> (its result, its lines, wall seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = doppler_train.main(argv)
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f"  | {line}")
    return out, lines, wall


def cli_path(dev) -> dict:
    """12d: the training CLI in this process, four runs (CLI_RUNS): the
    pipeline with the executor and calibration, a resume on the oracle,
    Stage II under the supervisor with a device loss, a hierarchical
    run."""
    shutil.rmtree(CLI_DIR, ignore_errors=True)
    res = {}
    for i, argv in enumerate(CLI_RUNS, 1):
        argv = argv + ["--device", str(dev)]
        print(f"cli run {i}: python -m repro_torch.launch.doppler_train "
              + " ".join(argv))
        out, lines, wall = _cli(argv)
        tr = out["trainer"]
        res[i] = {"out": out, "lines": lines, "wall_s": wall,
                  "seconds": dict(tr.seconds), "episode": tr.episode}
        check(any(l.startswith("DOPPLER best: ") for l in lines)
              and np.isfinite(out["best"][0]),
              f"cli run {i} evaluated its best assignment")
        print(f"cli run {i} ({CARD}): wall {wall:.6f} s; trainer seconds "
              + json.dumps({k: round(v, 6) for k, v in tr.seconds.items()})
              + f"; episode {tr.episode}")

    def saved(lines):
        return [l.split("]")[0][1:] for l in lines
                if "] checkpoint saved: " in l]

    check(saved(res[1]["lines"]) == ["stage1", "stage2", "stage3"]
          and saved(res[2]["lines"]) == ["stage2"],
          f"a checkpoint after every stage that ran: "
          f"{saved(res[1]['lines'])}, {saved(res[2]['lines'])}")
    resumed = [l for l in res[2]["lines"] if l.startswith("resumed at ")]
    check(resumed == [f"resumed at episode {res[1]['episode']}"],
          f"run 2 {resumed} at run 1's final episode {res[1]['episode']}")
    g = get_workload("llama_layer")
    events = json.loads((CLI_DIR / "trace.json").read_text())["traceEvents"]
    n_exec = sum(e["ph"] == "X" and e["pid"] == 0 for e in events)
    check(n_exec == g.n - int(g.input_mask().sum()),
          f"the trace parses with one event a compute vertex: {n_exec}")
    ex = res[1]["out"]["executor"]
    mean, std = res[1]["out"]["best"]
    print(f"cli run 1 executor ({CARD}): evaluated best wall "
          f"{mean * 1e3:.6f} +- {std * 1e3:.6f} ms (10 runs), last run's "
          f"host dispatch {ex.last_dispatch_s * 1e3:.6f} ms")
    tr3 = res[3]["out"]["trainer"]
    sup = [l for l in res[3]["lines"] if l.startswith("stage II : ")]
    check(len(sup) == 1 and " 1 recoveries, " in sup[0]
          and tr3.dev.n == 3 and int(tr3.best_assignment.max()) < 3,
          f"run 3: one recovery, the fleet at 3 devices, no vertex on the "
          f"lost one: {sup}, {tr3.dev.n}")
    return res


def _by_graph(rows) -> list:
    """(sg, *fields) rows -> [(sg, [each field's list])], one a SimGraph
    (its batches are held together: episodes are independent)."""
    groups: dict = {}
    for sg, *fields in rows:
        cols = groups.setdefault(id(sg), (sg, [[] for _ in fields]))[1]
        for col, x in zip(cols, fields):
            col.append(x)
    return list(groups.values())


class _KernelLog:
    """While on, logs what path 12's kernels were given and what they gave
    back: the first ``gnn_mp`` pair launch at each (n, m, d), every
    ``wc_trips`` launch outside a CUDA graph capture (its trip inputs and
    outputs), and each replayed fused Stage II update's batch (its
    sampled assignments, makespans and ok flags).  Launches that a
    capture records are counted apart: each replay of them is logged as
    an update.  ``hold()`` then holds every entry against the plain
    version on the same inputs."""

    def __init__(self):
        self.pairs: dict = {}
        self.trips: list = []
        self.updates: list = []
        self.captured = {"pair": 0, "trips": 0}

    def __enter__(self):
        self._orig = (gnn_ops._launch_pair, sim_torch.wc_trips)
        pair0, trips0 = self._orig
        run0 = FusedStage2._run
        log = self

        def pair(msg_a, csr_a, msg_b, csr_b, n):
            out = pair0(msg_a, csr_a, msg_b, csr_b, n)
            key = (n, *msg_a.shape)
            if torch.cuda.is_current_stream_capturing():
                log.captured["pair"] += 1
            elif key not in log.pairs:
                log.pairs[key] = (msg_a.clone(), csr_a, msg_b.clone(), csr_b,
                                  out.clone())
            return out

        def trips(sg, *args, **kw):
            out = trips0(sg, *args, **kw)
            if kw.get("backend", "cuda") == "torch" or not out[0].is_cuda:
                return out
            if torch.cuda.is_current_stream_capturing():
                log.captured["trips"] += 1
            else:
                log.trips.append((sg, [a.clone() for a in args],
                                  *(t.clone() for t in out)))
            return out

        def run(eng, load, fill, u, keep):
            def kept():
                o = eng.out
                log.updates.append((eng.sg, o["actions"].clone(),
                                    o["makespans"].clone(),
                                    o["oracle_ok"].clone()))
                return keep()
            return run0(eng, load, fill, u, kept)

        gnn_ops._launch_pair, sim_torch.wc_trips = pair, trips
        FusedStage2._run = run
        return self

    def __exit__(self, *exc):
        gnn_ops._launch_pair, sim_torch.wc_trips = self._orig
        del FusedStage2._run
        return False

    def hold(self, what: str) -> dict:
        """Every logged launch against its plain version: the pair at
        GNN_REL_TOL, ``wc_trips`` bit for bit (ms, n_done) in every
        placement."""
        worst = [0.0, 0.0]
        for (n, m, d), (ma, ca, mb, cb, out) in self.pairs.items():
            for i, (msg, csr) in enumerate(((ma, ca), (mb, cb))):
                ref = segment_sum_ref(msg, None, n, csr)
                err = float((out[i] - ref).abs().max())
                rel = err / max(float(ref.abs().max()), 1e-30)
                check(rel <= GNN_REL_TOL,
                      f"{what}: gnn_mp pair at n={n} m={m} d={d} direction "
                      f"{i}: relative error {rel} > {GNN_REL_TOL}")
                worst = [max(worst[0], err), max(worst[1], rel)]
        seen = {"shared": 0, "global": 0}
        for sg, (args, ms, nd) in _by_graph(self.trips):
            cat = [torch.cat(a) for a in zip(*args)]
            ms_r, nd_r, places = check_trip_args(
                sg, cat, f"{what}'s {len(ms)} logged batches at n={sg.n}")
            check(torch.equal(torch.cat(ms), ms_r)
                  and torch.equal(torch.cat(nd), nd_r),
                  f"{what}: the path's wc_trips results at n={sg.n} "
                  f"bit-equal to the plain trip loop on their inputs")
            for w in places:
                seen[w] += 1
        for sg, (acts, ms, ok) in _by_graph(self.updates):
            A = np.concatenate([assignment_of(a) for a in acts])
            args = trip_inputs(sg, torch.as_tensor(A, device=sg.esrc.device))
            ms_r, nd_r, places = check_trip_args(
                sg, args, f"{what}'s {len(A)} replayed episodes at n={sg.n}")
            check(torch.equal(torch.cat(ms), ms_r)
                  and torch.equal(torch.cat(ok), nd_r == sg.n_compute),
                  f"{what}: every replayed update's makespans and ok flags "
                  f"at n={sg.n} bit-equal to the plain trip loop")
            for w in places:
                seen[w] += 1
        check(not self.captured["trips"] or self.updates,
              f"{what}: captured wc_trips launches are held through their "
              f"replays")
        out = {"pair_shapes": sorted(self.pairs), "pair_max_abs_err": worst[0],
               "pair_max_rel_err": worst[1],
               "trips_batches": len(self.trips),
               "trips_episodes": sum(len(t[2]) for t in self.trips),
               "updates": len(self.updates),
               "update_episodes": sum(len(u[2]) for u in self.updates),
               "placements": seen, "captured": dict(self.captured)}
        print(f"{what} held against the plain versions: gnn_mp pair at "
              f"(n, m, d) {out['pair_shapes']}, max abs err {worst[0]}, "
              f"max rel err {worst[1]}; wc_trips bit-equal on "
              f"{out['trips_batches']} launched batches "
              f"({out['trips_episodes']} episodes) and {out['updates']} "
              f"replayed updates ({out['update_episodes']} episodes), "
              f"placements run {seen}; captures {self.captured}")
        return out


def path12(dev, by_name) -> None:
    """Path 12: pretraining, zero-shot serving, FleetTrainer and the
    training CLI on the card; the launch counts are reset before each
    part and read after it."""
    t_path, counts, held = time.perf_counter(), {}, {}

    def part(name, fn):
        gnn_ops.launches = gnn_ops.pair_launches = 0
        wc_ops.launches = wc_ops.trip_launches = 0
        t0 = time.perf_counter()
        with _KernelLog() as log:
            out = fn()
        counts[name] = _launch_counts()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        held[name] = _uncounted(lambda: log.hold(f"path {name}"))
        c = counts[name]
        check(held[name]["trips_batches"] + held[name]["captured"]["trips"]
              == c["wc_oracle_trips"],
              f"path {name}: every wc_trips launch logged or captured: "
              f"{held[name]}, {c}")
        print(f"path {name} wall s: {wall:.3f}; launches {c}; the hold "
              f"{time.perf_counter() - t0:.3f} s")
        return out

    pre = part("12a", lambda: pretrain_path(dev))
    part("12b", lambda: serve_zero_shot_path(dev, pre["pre"]))
    part("12c", lambda: fleet_path(dev))
    part("12d", lambda: cli_path(dev))
    check(all(counts[p]["gnn_mp_pair"] > 0 for p in ("12a", "12b", "12d"))
          and counts["12d"]["wc_oracle_trips"] > 0
          and all(c["gnn_mp"] == c["wc_oracle"] == 0
                  for c in counts.values()),
          f"path 12 ran the gnn_mp pair (12a, 12b, 12d) and wc_trips (12d), "
          f"no single-direction gnn_mp and no wc_step: {counts}")
    print(f"path 12 wall s: {time.perf_counter() - t_path:.3f}")
    by_name["gnn_mp_pair"]["pretrain_serve_cli"] = {
        p: c["gnn_mp_pair"] for p, c in counts.items()}
    by_name["wc_oracle_trips"]["pretrain_serve_cli"] = {
        p: c["wc_oracle_trips"] for p, c in counts.items()}
    pair = by_name["gnn_mp_pair"]
    pair["max_abs_err"] = max([pair["max_abs_err"]] + [
        h["pair_max_abs_err"] for h in held.values()])
    pair["max_rel_err"] = max([pair["max_rel_err"]] + [
        h["pair_max_rel_err"] for h in held.values()])
    pair["pretrain_serve_cli_held"] = {
        p: [list(k) for k in h["pair_shapes"]] for p, h in held.items()}
    by_name["wc_oracle_trips"]["pretrain_serve_cli_held"] = {
        p: {k: h[k] for k in ("trips_batches", "trips_episodes", "updates",
                              "update_episodes", "placements")}
        for p, h in held.items()}


# ------------------------------------------------------------- path 18
# 18b's one-card sizing, in a process of its own: argv[1] the JSON list of
# (arch, kind), argv[2] and argv[3] the batch and the sequence; prints the
# results as one JSON line
PATH18B_CODE = """
import json, sys
from repro_torch.configs.registry import ShapeCell
from repro_torch.launch import dryrun
B, S = int(sys.argv[2]), int(sys.argv[3])
out = {}
for arch, kind in json.loads(sys.argv[1]):
    cell = ShapeCell(f"{kind}_{B}x{S}", S, B, kind)
    out[f"{arch} {kind}"] = dryrun.size_cell(arch, cell, {"data": 1,
                                                         "model": 1})
print(json.dumps(out))
"""


def path18_start() -> dict:
    """Start path 18's host work: 18a's cells, each through the dry-run's
    CLI in a process of its own (the fake group is process-wide), and
    18b's one-card sizing in another, all at once and at the lowest
    priority, so that they run on the host's idle cores while the card
    runs path 17; the end of each is timed.  Processes still running
    when the script exits are killed."""
    import atexit
    import threading
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    logs = Path(tempfile.mkdtemp(prefix="path18_"))
    t0 = time.perf_counter()

    def launch(name, argv):
        rec = {"out": logs / f"{name}.out", "err": logs / f"{name}.err",
               "end": None}
        with open(rec["out"], "w") as out, open(rec["err"], "w") as err:
            rec["proc"] = subprocess.Popen(
                [sys.executable, *argv], cwd=str(ROOT), env=env, stdout=out,
                stderr=err, preexec_fn=lambda: os.nice(19))

        def wait():
            rec["proc"].wait()
            rec["end"] = time.perf_counter()
        threading.Thread(target=wait, daemon=True).start()
        return rec

    cells = [launch(f"{a}__{sh}__{m}",
                    ["-m", "repro_torch.launch.dryrun", "--arch", a,
                     "--shape", sh, "--mesh", m, "--force"])
             for a, sh, m in PATH18A_CELLS]
    sizing = launch("18b", ["-c", PATH18B_CODE, json.dumps(PATH18B),
                            str(PATH18B_BATCH), str(PATH18B_SEQ)])
    procs = [r["proc"] for r in cells] + [sizing["proc"]]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return {"t0": t0, "cells": cells, "sizing": sizing, "logs": logs}


def _finished(rec, t0: float) -> tuple:
    """Wait for one of path 18's processes (to PATH18A_TIMEOUT_S after
    the start) -> (return code, stdout, stderr, seconds from the start to
    its end)."""
    p = rec["proc"]
    try:
        p.wait(timeout=max(1.0, PATH18A_TIMEOUT_S
                           - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
    while rec["end"] is None:
        time.sleep(0.01)
    return (p.returncode, rec["out"].read_text(), rec["err"].read_text(),
            rec["end"] - t0)


def path18a_print(res: dict, wall_s: float) -> None:
    rf, mem = res["roofline"], res["memory_analysis"]
    coll = {k: v for k, v in res["collective_breakdown"].items() if v}
    print(f"path 18a {res['arch']} x {res['shape']} x {res['mesh']} "
          f"({res['n_chips']} devices, fake group, at "
          f"{dryrun.HW_H100['name']}, {dryrun.HW_H100['power_limit_w']:.2f} "
          f"W peaks): per-device argument_gb="
          f"{mem['argument_size_in_bytes'] / 1e9:.6f} temp_peak_gb="
          f"{mem['temp_size_in_bytes'] / 1e9:.6f} fits_80gb="
          f"{mem['fits_hbm']} flops={res['hlo_flops_per_device']:.6e} "
          f"bytes={res['hlo_bytes_per_device']:.6e} collective_bytes="
          f"{res['collective_bytes_per_device']:.6e} by kind "
          f"{ {k: f'{v:.4e}' for k, v in coll.items()} } counts "
          f"{ {k: v for k, v in res['collective_counts'].items() if v} } "
          f"t_compute={rf['t_compute']:.6f} t_memory={rf['t_memory']:.6f} "
          f"t_collective={rf['t_collective']:.6f} dominant={rf['dominant']} "
          f"roofline_fraction={res['roofline_fraction']:.6f} "
          f"dtensor_fallbacks={res['dtensor_fallbacks']} trace_s="
          f"{res['trace_seconds']:.3f} process_wall_s={wall_s:.3f}")


def path18b_args(dev, arch) -> float:
    """Bytes the card allocates for ``arch``'s float32 params, their AdamW
    moments and one batch of PATH18B_BATCH x PATH18B_SEQ ids (the
    training paths' own: the data stream's batch)."""
    cfg = get_config(arch)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = lm.init_params(cfg, 0, device=dev)
    opt = adamw_init(params)
    batch = SyntheticTokenStream(
        cfg, DataConfig(PATH18B_SEQ, PATH18B_BATCH, seed=0),
        device=dev).next_batch()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    del params, opt, batch
    torch.cuda.empty_cache()
    return float(held)


def path18(dev, measured: dict, started: dict) -> dict:
    """Path 18: the dry-run.  ``started``: ``path18_start``'s processes
    (18a's six cells through the CLI, 18b's one-card sizing).  Here: one
    18b cell sized again in this process (fake tensors on the host: no
    kernel may launch, and the same result as the process's), the
    processes' results, then 18b's argument-bytes gate on the card and
    the predictions beside ``measured`` ({(arch, kind): (seconds a step
    or a prefill, peak GB)} of paths 15a, 16a and 16b)."""
    t0, t_start = time.perf_counter(), started["t0"]
    gnn_ops.launches = gnn_ops.pair_launches = 0
    wc_ops.launches = wc_ops.trip_launches = 0
    _zero_lm_counts()
    arch, kind = PATH18B[1]
    here = dryrun.size_cell(arch, ShapeCell(
        f"{kind}_{PATH18B_BATCH}x{PATH18B_SEQ}", PATH18B_SEQ, PATH18B_BATCH,
        kind), {"data": 1, "model": 1})
    launched = {**_launch_counts(), **_lm_counts()}
    check(all(v == 0 for v in launched.values()),
          f"the dry-run's fake traces launch no kernel: {launched}")
    rc, out, err, wall_b = _finished(started["sizing"], t_start)
    check(rc == 0, f"path 18b's sizing process ran (rc {rc}): {err[-1500:]}")
    sized = {tuple(k.split()): v
             for k, v in json.loads(out.strip().splitlines()[-1]).items()}
    check(here["hlo_flops_per_device"]
          == sized[(arch, kind)]["hlo_flops_per_device"]
          and here["memory_analysis"] == sized[(arch, kind)][
              "memory_analysis"],
          f"path 18b {arch} {kind}: sized alike here and in its process")

    cells, dropped = [], []
    for (arch, shape, mesh), rec in zip(PATH18A_CELLS, started["cells"]):
        rc, out, err, wall = _finished(rec, t_start)
        check(rc == 0 and f"OK   {arch} {shape} {mesh}" in out,
              f"path 18a {arch} x {shape} x {mesh}: the CLI ran the cell "
              f"(rc {rc}): {err[-1500:]}")
        res = json.loads((dryrun.RESULTS_DIR / f"{arch}__{shape}__{mesh}"
                          f".json").read_text())
        path18a_print(res, wall)
        if wall > PATH18A_BUDGET_S:
            dropped.append((arch, shape, mesh, round(wall, 3)))
        rf = res["roofline"]
        check(not res["skipped"] and res["hlo_flops_per_device"] > 0
              and res["memory_analysis"]["argument_size_in_bytes"] > 0
              and np.isfinite([rf["t_compute"], rf["t_memory"],
                               rf["t_collective"]]).all()
              and rf["dominant"] in ("compute", "memory", "collective")
              and (res["n_chips"] == 512) == (mesh == "multipod"),
              f"path 18a {arch} x {shape} x {mesh}: per-device bytes, "
              f"flops and a dominant term")
        want = PATH18A_CPU.get((arch, shape, mesh))
        if want is not None:
            temp = res["memory_analysis"]["temp_size_in_bytes"] / 1e9
            check(abs(temp / want[0] - 1) <= PATH18A_CPU_TOL
                  and rf["dominant"] == want[1]
                  and res["dtensor_fallbacks"] == {},
                  f"path 18a {arch} x {shape} x {mesh}: temp {temp} GB, "
                  f"{rf['dominant']}, fallbacks {res['dtensor_fallbacks']} "
                  f"as the CPU sizes it: {want}")
        cells.append(res)
    t_a = time.perf_counter()
    ends = [_finished(rec, t_start)[3] for rec in started["cells"]]
    print(f"path 18a: {len(cells)} cells in {max(ends):.3f} s of wall from "
          f"their start (all started together before path 17, at the "
          f"lowest priority; 18b's sizing process {wall_b:.3f} s); past the "
          f"{PATH18A_BUDGET_S:.0f} s budget (to drop from the end of the "
          f"list next time): {dropped}")

    rows = {}
    for (arch, kind), res in sized.items():
        s_meas, peak_meas = measured[(arch, kind)]
        mem, rf = res["memory_analysis"], res["roofline"]
        args = mem["argument_size_in_bytes"]
        peak_pred = args + mem["temp_size_in_bytes"]
        mfu = res["model_flops_global"] / (s_meas * BF16_FLOP_PER_S)
        row = {"predicted_argument_gb": args / 1e9,
               "predicted_peak_gb": peak_pred / 1e9,
               "measured_peak_gb": peak_meas,
               "peak_ratio": peak_pred / 1e9 / peak_meas,
               "predicted_bound_s": rf["bound_s"], "dominant":
               rf["dominant"], "measured_s": s_meas, "mfu": mfu,
               "bound_share": rf["bound_s"] / s_meas,
               "trace_s": res["trace_seconds"]}
        if kind == "train":
            held = path18b_args(dev, arch)
            row["card_argument_gb"] = held / 1e9
            row["argument_ratio"] = args / held
        rows[(arch, kind)] = row
        print(f"path 18b {arch} {kind} at batch {PATH18B_BATCH} x "
              f"{PATH18B_SEQ} on the one-card mesh ({CARD}): predicted "
              f"argument_gb={row['predicted_argument_gb']:.6f} (f32 "
              f"params" + (" + AdamW + batch" if kind == "train" else
                           " + bf16 KV cache + batch; the server holds "
                           "bf16 matrices") + ")"
              + (f" card_argument_gb={row['card_argument_gb']:.6f} "
                 f"ratio={row['argument_ratio']:.6f}"
                 if kind == "train" else "")
              + f" predicted_peak_gb={row['predicted_peak_gb']:.6f} "
              f"measured_peak_gb={peak_meas:.6f} peak_ratio="
              f"{row['peak_ratio']:.6f} predicted_bound_s="
              f"{rf['bound_s']:.6f} ({rf['dominant']}; t_compute "
              f"{rf['t_compute']:.6f}, t_memory {rf['t_memory']:.6f}) "
              f"measured_s={s_meas:.6f} bound/measured="
              f"{row['bound_share']:.6f} model_flops="
              f"{res['model_flops_global']:.6e} mfu={mfu:.6f} trace_s="
              f"{res['trace_seconds']:.3f}")
        if kind == "train":
            check(abs(row["argument_ratio"] - 1.0) <= ARGS18_TOL,
                  f"path 18b {arch}: predicted argument bytes {args} within "
                  f"{ARGS18_TOL} of the card's {held}")
        check(np.isfinite([row["predicted_peak_gb"], rf["bound_s"], mfu]
                          ).all() and rf["bound_s"] > 0,
              f"path 18b {arch} {kind}: finite predictions")
    t1 = time.perf_counter()
    print(f"path 18 wall s: {t1 - t0:.3f} after path 17 (waiting for its "
          f"processes {t_a - t0:.3f}, 18b's gates {t1 - t_a:.3f})")
    shutil.rmtree(started["logs"], ignore_errors=True)
    return {"18a": cells, "18a_dropped": dropped, "18b": rows,
            "wall_s": t1 - t0, "processes_s": max(ends + [wall_b])}


# ------------------------------------------------------------- path 19
# 19a: the data-parallel fused Stage II (core/train_fused.py, n_devices)
# on TRAIN_REQUEST at K TRAIN_K: DP19_RANKS gloo ranks, one process each
# on the one card, eager (NCCL takes one rank a GPU; gloo stages the
# CUDA tensors through the host and its collectives cannot be captured),
# DP19_UPDATES updates of one a dispatch on numpy draw tables (seed
# DP19_SEED), against the single-device engine on the same tables; and a
# one-rank NCCL group with capture, bit-equal to the captured
# single-device engine.  The processes start before path 12 and wait for
# path 19; from there they have DP19_TIMEOUT_S.
DP19_RANKS, DP19_UPDATES, DP19_SEED, DP19_TIMEOUT_S = 2, 4, 19, 300
# 19b: olmo-1b at full width and depth, batch 4 x 2,048, remat "dots"
# (the reference's dots_with_no_batch_dims_saveable) for DOTS19_STEPS
# steps and "full" for one, from the same state
DOTS19_ARCH, DOTS19_STEPS, DOTS19_BATCH, DOTS19_SEQ = "olmo_1b", 2, 4, 2048


def _dp19_setup(dev, world: int, backend: str, store: str):
    """A rank's process group, TRAIN_REQUEST's graph and fleet, and the
    draw tables every rank makes alike."""
    import torch.distributed as dist
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=int(os.environ["DP19_RANK"]),
                            world_size=world)
    gname, fleet = TRAIN_REQUEST
    g, fm = get_workload(gname), get_device_model(fleet)
    rng = np.random.default_rng(DP19_SEED)
    draws = [_draw_tables(rng, g.n, TRAIN_K, fm.n)
             for _ in range(DP19_UPDATES)]
    return dist, g, fm, draws


def _wait_for(path: Path, timeout: float) -> None:
    t0 = time.perf_counter()
    while not path.exists():
        check(time.perf_counter() - t0 < timeout, f"waited for {path}")
        time.sleep(0.05)


def _timed_collectives(dist, dev, log: dict):
    """Wrap ``dist.all_reduce`` / ``all_gather``: each call's wall time,
    the card synced before and after, summed by name into ``log``."""
    def wrap(name, fn):
        def timed(*a, **k):
            sync(dev)
            t = time.perf_counter()
            out = fn(*a, **k)
            sync(dev)
            log[name] = log.get(name, 0.0) + time.perf_counter() - t
            return out
        return timed
    for name in ("all_reduce", "all_gather"):
        setattr(dist, name, wrap(name, getattr(dist, name)))


def _update_record(tr) -> dict:
    lu = tr.last_update
    return {"params": tree_map(torch.clone, tr.params),
            "mu": tree_map(torch.clone, tr.opt_state.mu),
            "nu": tree_map(torch.clone, tr.opt_state.nu),
            "grads": tree_map(torch.clone, lu["grads"]),
            "loss": lu["loss"], "actions": lu["actions"].cpu(),
            "rewards": lu["rewards"], "advantages": lu["advantages"],
            "episode": tr.episode,
            "r_stats": (tr._r_sum, tr._r_sqsum, tr._r_count)}


def path19a_rank(world: int, store: str, out: str,
                 device: str = "cuda") -> None:
    """One gloo rank of 19a (a process; ``DP19_RANK`` in its environment):
    DP19_UPDATES eager data-parallel updates, each timed (the first warms
    up; the rest wait for the NCCL process's captures, ``out``.captured,
    and for the main process, ``out``.go, so that nothing else runs on
    the card beside them), the collectives' wall time wrapped, launches
    counted.  After the NCCL process's timed replays
    (``out``.nccl_timed), the gates, split over the
    ranks: every rank's result bit-equal to rank 0's; on rank 0 the
    single-device engine from each update's state on the same tables
    (actions and makespans bit-equal); on the last rank update 0 on the
    plain backends (the same actions and makespans: ``wc_trips`` and
    the ``gnn_mp`` pair held against their plain versions); on rank
    ``u % world`` update u's loss and reduced gradient against the forced
    replay of its actions on its advantages (path 5's bars, the gradient
    over the whole tree as the CPU tests hold it) and its AdamW step
    within lr / 100.  Prints one JSON line.  ``device`` "cpu" rehearses
    it (the plain versions stand in for the kernels)."""
    import pickle
    from repro_torch.train.optim import adamw_update
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    rank = int(os.environ["DP19_RANK"])
    dist, g, fm, draws = _dp19_setup(dev, world, "gloo", store)
    tr = DopplerTrainer(g, fm, seed=0, device=dev)
    state0 = SimpleNamespace(params=tree_map(torch.clone, tr.params),
                             opt_state=tr.opt_state, generator=tr.generator,
                             episode=0, _r_sum=0.0, _r_sqsum=0.0, _r_count=0)
    coll: dict = {}
    _timed_collectives(dist, dev, coll)
    dist.barrier()
    recs, seconds, launches, ms = [], [], [], []
    for u in range(DP19_UPDATES):
        if u == 1:          # the main process comes to path 19 (minutes)
            for flag in (".captured", ".go"):
                _wait_for(Path(out + flag), 1200)
            dist.barrier()
            coll.clear()
        before = {"params": tree_map(torch.clone, tr.params),
                  "state": AdamState(tr.opt_state.step,
                                     tree_map(torch.clone, tr.opt_state.mu),
                                     tree_map(torch.clone, tr.opt_state.nu)),
                  "episode": tr.episode}
        c0 = _launch_counts()
        t = time.perf_counter()
        ms.append(tr.stage2_fused(1, batch_size=TRAIN_K,
                                  updates_per_dispatch=1, n_devices=world,
                                  draws=draws[u:u + 1], capture=False))
        sync(dev)
        seconds.append(time.perf_counter() - t)
        launches.append({k: v - c0[k] for k, v in _launch_counts().items()})
        recs.append({**_update_record(tr), "before": before})
    dist.barrier()
    if rank == 0:
        Path(out + ".timed").touch()
    _wait_for(Path(out + ".nccl_timed"), DP19_TIMEOUT_S)
    t_gates = time.perf_counter()
    mine = {"makespans": ms, "params": [tree_map(lambda x: x.cpu(),
                                                 r["params"]) for r in recs],
            "losses": [r["loss"] for r in recs]}
    if rank:
        with open(f"{out}.rank{rank}", "wb") as f:
            pickle.dump(mine, f)
    dist.barrier()
    res = {"rank": rank, "seconds": seconds, "launches": launches,
           "collective_s": coll, "makespans": ms}
    if rank == 0:
        for r in range(1, world):
            with open(f"{out}.rank{r}", "rb") as f:
                theirs = pickle.load(f)
            check(theirs["makespans"] == ms and theirs["losses"]
                  == mine["losses"] and all(
                      torch.equal(a, b) for pa, pb in zip(
                          theirs["params"], mine["params"])
                      for a, b in zip(tree_leaves(pa), tree_leaves(pb))),
                  f"19a: rank {r}'s makespans, losses and params bit-equal "
                  f"to rank 0's")
    twins = []
    if rank == 0:         # the single-device engine from each update's state
        one = DopplerTrainer(g, fm, seed=0, device=dev)
        twins = [(u, one) for u in range(DP19_UPDATES)]
    if rank == world - 1:        # update 0 on the plain backends
        plain = DopplerTrainer(g, fm, seed=0, device=dev,
                               encoder_backend="torch",
                               oracle_backend="torch")
        twins.insert(0, (0, plain))
    single = []
    for u, twin in twins:
        rec, b = recs[u], recs[u]["before"]
        _copy_state(SimpleNamespace(
            params=b["params"], opt_state=b["state"],
            generator=twin.generator, episode=b["episode"],
            _r_sum=recs[u - 1]["r_stats"][0] if u else 0.0,
            _r_sqsum=recs[u - 1]["r_stats"][1] if u else 0.0,
            _r_count=recs[u - 1]["r_stats"][2] if u else 0), twin)
        got = twin.stage2_fused(1, batch_size=TRAIN_K, draws=draws[u:u + 1],
                                capture=False)
        lo = twin.last_update
        check(got == ms[u] and np.array_equal(
            rec["actions"].numpy(), lo["actions"].cpu().numpy()),
              f"19a update {u}: actions and makespans bit-equal to the "
              f"single-device engine's ({twin.encoder_backend} / "
              f"{twin.oracle_backend} backends)")
        single.append((u, twin.encoder_backend,
                       abs(rec["loss"] - lo["loss"]) / abs(lo["loss"]),
                       max(float((x - y).abs().max()) for x, y in zip(
                           tree_leaves(rec["grads"]),
                           tree_leaves(lo["grads"])))))
    step_bars = []
    for u in range(rank, DP19_UPDATES, world):
        rec, b = recs[u], recs[u]["before"]
        # the reduced gradient: the whole batch's loss on its advantages,
        # by the forced replay (path 5's gate)
        loss, grads = _pg_loss_and_grad_batch(
            b["params"], tr.gd, rec["actions"].to(dev), rec["advantages"],
            tr.entropy_weight, encoder_backend=tr.encoder_backend)
        gate_update(f"19a update {u}: {world} gloo ranks vs the forced "
                    f"replay on their advantages",
                    SimpleNamespace(last_update={
                        k: rec[k] for k in ("actions", "rewards", "loss",
                                            "grads")}),
                    SimpleNamespace(last_update={
                        "actions": rec["actions"], "rewards": rec["rewards"],
                        "loss": loss, "grads": grads}),
                    loss_tol=REPLAY_LOSS_TOL, param_tol=None,
                    tree_scale=True)
        lr = float(tr.lr_sched(torch.tensor(b["episode"], dtype=torch.int32,
                                            device=dev)))
        want, _ = adamw_update(rec["grads"], b["state"], b["params"], lr)
        err = max(float((x - y).abs().max()) for x, y in zip(
            tree_leaves(rec["params"]), tree_leaves(want)))
        check(err <= lr / 100, f"19a update {u}: the AdamW step on the "
                               f"reduced gradient {err} <= lr/100")
        step_bars.append((u, err))
    print(f"19a rank {rank}: against one device from the same state (update, "
          f"encoder backend, loss relative, max gradient gap): {single} (the "
          f"batch std is sqrt(E[r^2] - E[r]^2) over ranks, the population "
          f"std on one device); gates {time.perf_counter() - t_gates:.3f} s")
    res.update(single_device_gaps=single, adamw_step_err=step_bars)
    dist.barrier()
    dist.destroy_process_group()
    print(json.dumps(res))


def path19a_nccl(store: str, out: str, device: str = "cuda",
                 backend: str = "nccl") -> None:
    """19a's one-rank NCCL group: DP19_UPDATES updates of the
    data-parallel engine (``n_devices=1`` over the group) captured as
    CUDA graphs, the collectives inside them (the communicator made in
    the warm-up), against the captured single-device engine from the
    same state on the same tables: makespans, losses, params, AdamW
    moments and reward statistics bit-equal; then DP19_UPDATES more
    replays of each on fresh draws, timed after the gloo ranks' timed
    updates (``out``.timed); touches ``out``.captured after the captures.
    Prints one JSON line.  ``device`` "cpu" and ``backend`` "gloo"
    rehearse it (eagerly)."""
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)
    dist, g, fm, draws = _dp19_setup(dev, 1, backend, store)
    try:
        dp, one = (DopplerTrainer(g, fm, seed=0, device=dev)
                   for _ in range(2))
        c0 = _launch_counts()
        got = dp.stage2_fused(DP19_UPDATES, batch_size=TRAIN_K,
                              updates_per_dispatch=DP19_UPDATES,
                              n_devices=1, draws=draws)
        c1 = _launch_counts()
        want = one.stage2_fused(DP19_UPDATES, batch_size=TRAIN_K,
                                updates_per_dispatch=DP19_UPDATES,
                                draws=draws)
        eng = _engine(dp, "stage2")
        check(eng.group is not None and eng.graphed.graph is not None,
              "19a: the one-rank engine runs over the NCCL group, captured")
        same = (got == want and dp.losses == one.losses
                and (dp._r_sum, dp._r_sqsum, dp._r_count)
                == (one._r_sum, one._r_sqsum, one._r_count)
                and all(torch.equal(a, b) for a, b in zip(
                    tree_leaves((dp.params, dp.opt_state.mu,
                                 dp.opt_state.nu)),
                    tree_leaves((one.params, one.opt_state.mu,
                                 one.opt_state.nu)))))
        check(same, "19a: the captured one-rank NCCL update is bit-equal "
                    "to the captured single-device update")
        Path(out + ".captured").touch()
        _wait_for(Path(out + ".timed"), 1200)    # after path 12 (minutes)
        timed = {}
        for name, tr, kw in (("nccl_1rank", dp, {"n_devices": 1}),
                             ("single_device", one, {})):
            tr.seconds.clear()
            tr.stage2_fused(DP19_UPDATES, batch_size=TRAIN_K,
                            updates_per_dispatch=DP19_UPDATES, **kw)
            timed[name] = tr.seconds["updates"] / DP19_UPDATES
        Path(out + ".nccl_timed").touch()
        print(json.dumps({"captured": eng.graphed.captured,
                          "launches_first_dispatch": {
                              k: v - c0[k] for k, v in c1.items()},
                          "s_per_update": timed, "bit_equal": same}))
    finally:
        for flag in (".captured", ".nccl_timed"):
            Path(out + flag).touch()
        dist.destroy_process_group()


PATH19A_CODE = """
import chip_smoke
chip_smoke.CARD = {card!r}
chip_smoke.{fn}
"""


def path19a_start() -> dict:
    """Start 19a: the one-rank NCCL process and DP19_RANKS gloo ranks,
    together (each imports the port and loads the kernels the main
    process built).  Their set-up, captures and warm-up update run beside
    what the main process does next; the ranks' timed updates wait for
    ``out``.go,
    which the main process touches after them, the NCCL process's timed
    replays for the ranks', the ranks' gates for those.  Processes still
    running when the script exits are killed."""
    import atexit
    tmp = Path(tempfile.mkdtemp(prefix="path19a_"))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}

    def launch(rank, fn):
        return subprocess.Popen(
            [sys.executable, "-c", PATH19A_CODE.format(card=CARD, fn=fn)],
            cwd=str(ROOT), env={**env, "DP19_RANK": str(rank)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = str(tmp / "dp")
    procs = [launch(0, f"path19a_nccl({str(tmp / 'nccl')!r}, {out!r})")]
    procs += [launch(r, f"path19a_rank({DP19_RANKS}, "
                        f"{str(tmp / 'gloo')!r}, {out!r})")
              for r in range(DP19_RANKS)]
    atexit.register(lambda: [p.kill() for p in procs if p.poll() is None])
    return {"tmp": tmp, "out": out, "procs": procs}


def path19a(started: dict) -> dict:
    """19a's results: the processes' gates passed, their launches, times
    and the NCCL process's bit-equality."""
    t0, procs = time.perf_counter(), started["procs"]
    Path(started["out"] + ".go").touch()
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(
                1.0, DP19_TIMEOUT_S - (time.perf_counter() - t0))))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(started["tmp"], ignore_errors=True)
    for name, p, (so, se) in zip(["nccl"] + [f"gloo rank {r}" for r in
                                             range(DP19_RANKS)], procs, outs):
        for line in so.strip().splitlines()[:-1]:
            print(f"  19a {name}: {line}")
        check(p.returncode == 0, f"19a's {name} process (rc {p.returncode}):"
                                 f" {se[-2500:]}")
    nccl, *ranks = (json.loads(o.strip().splitlines()[-1])
                    for o, _ in outs)
    per = {"gnn_mp_pair": 4, "gnn_mp": 0, "wc_oracle_trips": 1,
           "wc_oracle": 0}
    for r in ranks:
        check(all(c == per for c in r["launches"]),
              f"19a rank {r['rank']}: the gnn_mp pair 4x and wc_trips once "
              f"an update: {r['launches']}")
    check(nccl["captured"] == {"gnn_mp_pair": 4, "wc_oracle_trips": 1},
          f"19a: a captured one-rank update records the pair 4x and "
          f"wc_trips once: {nccl['captured']}")
    r0 = ranks[0]
    timed = r0["seconds"][1:]
    s_upd = float(np.mean(timed))
    coll = {k: v / (DP19_UPDATES - 1) for k, v in
            r0["collective_s"].items()}
    share = coll.get("all_reduce", 0.0) / s_upd
    print(f"path 19a ({CARD}): data-parallel fused Stage II on "
          f"{'x'.join(TRAIN_REQUEST)} at K {TRAIN_K}: {DP19_RANKS} gloo "
          f"ranks eager, s_per_update(updates 1-{DP19_UPDATES - 1})="
          f"{s_upd:.6f} (all {r0['seconds']}), all_reduce_s_per_update="
          f"{coll.get('all_reduce', 0.0):.6f} (share {share:.6f}), "
          f"all_gather_s_per_dispatch={coll.get('all_gather', 0.0):.6f}; "
          f"launches per rank per update {per}; makespans bit-equal to "
          f"the single-device engine over {DP19_UPDATES} updates, the "
          f"AdamW step within lr/100 ({[r['adamw_step_err'] for r in ranks]}); one-rank "
          f"NCCL captured: s_per_update {nccl['s_per_update']} (the "
          f"collectives' share "
          f"{1 - nccl['s_per_update']['single_device'] / nccl['s_per_update']['nccl_1rank']:.6f}), "
          f"bit-equal {nccl['bit_equal']}, captured launches "
          f"{nccl['captured']}; path wall s {time.perf_counter() - t0:.3f}")
    return {"s_per_update_gloo2": s_upd, "seconds_gloo2": r0["seconds"],
            "all_reduce_s": coll.get("all_reduce", 0.0),
            "all_gather_s": coll.get("all_gather", 0.0),
            "all_reduce_share": share, "launches_per_rank_update": per,
            "nccl": nccl, "wall_s": time.perf_counter() - t0}


def path19b_grads(dev) -> dict:
    """19b's gates: olmo-1b at full width and depth (f32 params, bf16
    compute), batch DOTS19_BATCH x DOTS19_SEQ.  Step 0's loss and
    gradients under "dots" and under "full" on the kernels, and under
    "dots" on the plain backends in bf16 and fp32: dots on the kernels
    against plain within the plain path's own bf16-vs-fp32 gap (15a's
    bar), dots against full within TRAIN_LOSS_TOL relative and that bar;
    the peak GB of each kernel pass (forward and backward, no
    optimizer)."""
    t0 = time.perf_counter()
    full = get_config(DOTS19_ARCH)
    dots = dataclasses.replace(full, remat_policy="dots")
    check((full.n_layers, full.d_model, full.remat, full.remat_policy)
          == (16, 2048, True, "full"), "olmo-1b at full depth, remat on")
    params = lm.init_params(full, 0, device=dev)
    stream = SyntheticTokenStream(full, DataConfig(DOTS19_SEQ, DOTS19_BATCH,
                                                   seed=0), device=dev)
    batches = [stream.next_batch() for _ in range(DOTS19_STEPS)]
    ce, peak, grads = {}, {}, {}
    for name, cfg in (("dots", dots), ("full", full)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ce[name], _, grads[name] = lm_grads(params, cfg, batches[0], "cuda")
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
    ce["plain"], _, plain = lm_grads(params, dots, batches[0], "torch")
    ce["plain32"], _, plain32 = lm_grads(
        params, dataclasses.replace(dots, compute_dtype="float32"),
        batches[0], "torch")
    gate = hold_grads(f"19b {full.name} remat dots, bf16, step 0",
                      grads["dots"], plain, plain32)
    rel = abs(ce["dots"] - ce["full"]) / abs(ce["full"])
    check(rel <= TRAIN_LOSS_TOL and np.isfinite(list(ce.values())).all(),
          f"19b: step 0's loss under dots vs full: {ce}, relative {rel}")
    held = hold_grads("19b step 0, dots vs full (kernels)", grads["dots"],
                      grads["full"], tol=gate["bar"])
    del grads, plain, plain32
    torch.cuda.empty_cache()
    return {"cfgs": (dots, full), "params": params, "batches": batches,
            "ce": ce, "loss_rel": rel, "grad_pass_peak_gb": peak,
            "gate_plain": {k: gate[k] for k in ("max_gap", "bar")},
            "grads_dots_vs_full": held["max_gap"], "bar": held["bar"],
            "wall_s": time.perf_counter() - t0}


def path19b(dev, gates: dict) -> dict:
    """19b's steps from ``path19b_grads``' state: DOTS19_STEPS under
    "dots" and one under "full", each timed (a sync after it) with its
    peak GB; launches (``flash_fwd_wgmma`` 32 a step under both: the
    Function runs again in the recompute)."""
    t0 = time.perf_counter()
    (dots, full), params, batches = (gates[k] for k in ("cfgs", "params",
                                                        "batches"))
    rows = {}
    for policy, cfg, n in (("dots", dots, DOTS19_STEPS), ("full", full, 1)):
        step_fn = make_train_step(cfg, cosine_schedule(*TRAIN15_LR))
        p, opt = params, adamw_init(params)
        out = []
        _zero_lm_counts()
        for i in range(n):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            p, opt, m = step_fn(p, opt, batches[i], i)
            torch.cuda.synchronize()
            out.append({"s": time.perf_counter() - t,
                        "loss": float(m["loss"]),
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        rows[policy] = {"steps": out, "launches": _lm_counts()}
        del p, opt
        torch.cuda.empty_cache()
    per = step_launches(dots)
    check(per == step_launches(full) == {"mamba2_scan": 0,
                                         "flash_fwd_wgmma": 32,
                                         "flash_fwd_mma": 0}
          and rows["dots"]["launches"] == {k: DOTS19_STEPS * v for k, v
                                           in per.items()}
          and rows["full"]["launches"] == per,
          f"19b: flash_fwd_wgmma 32x a step under dots and full: "
          f"{rows['dots']['launches']}, {rows['full']['launches']}")
    ce = gates["ce"]
    check(rows["dots"]["steps"][0]["loss"] == ce["dots"]
          and rows["full"]["steps"][0]["loss"] == ce["full"]
          and np.isfinite(rows["dots"]["steps"][-1]["loss"]),
          "19b: the steps' losses are the gates' step 0, and finite")
    s = {"dots": rows["dots"]["steps"][-1]["s"],
         "full": rows["full"]["steps"][0]["s"]}
    peak = {k: r["steps"][0]["peak_gb"] for k, r in rows.items()}
    print(f"path 19b {full.name} ({full.n_layers} layers, f32 params, bf16 "
          f"compute, {CARD}): batch {DOTS19_BATCH} x {DOTS19_SEQ}: step s "
          f"dots {[r['s'] for r in rows['dots']['steps']]} full "
          f"{[r['s'] for r in rows['full']['steps']]}; peak GB a step dots "
          f"{[r['peak_gb'] for r in rows['dots']['steps']]} full "
          f"{[r['peak_gb'] for r in rows['full']['steps']]}; peak GB of "
          f"step 0's forward and backward alone "
          f"{gates['grad_pass_peak_gb']}; step 0 loss {ce} (dots vs full "
          f"relative {gates['loss_rel']}); gradients dots vs full "
          f"{gates['grads_dots_vs_full']} <= {gates['bar']}; launches "
          f"dots {rows['dots']['launches']} full "
          f"{rows['full']['launches']}; gates wall s "
          f"{gates['wall_s']:.3f}, steps {time.perf_counter() - t0:.3f}")
    return {"s_per_step": s, "peak_gb": peak,
            "launches": {k: r["launches"] for k, r in rows.items()},
            **{k: gates[k] for k in ("loss_rel", "grad_pass_peak_gb",
                                     "gate_plain", "grads_dots_vs_full",
                                     "bar")}}


def path19(dev, started: dict) -> dict:
    """Path 19: 19a's processes (``path19a_start``, started before path
    12, which their set-up runs beside), 19b's gradient gates, 19a's
    timed updates and gates, then 19b's timed steps."""
    t0 = time.perf_counter()
    try:
        gates = path19b_grads(dev)
    finally:
        Path(started["out"] + ".go").touch()
    res = {"19a": path19a(started)}
    res["19b"] = path19b(dev, gates)
    del gates
    torch.cuda.empty_cache()
    print(f"path 19 wall s: {time.perf_counter() - t0:.3f}")
    return res


# ------------------------------------------------------------- path 20
# 20a: the kernels' local-shard mapping, (arch, m) of a (1, m) mesh on a
# fake group (one process; each rank r in turn); the attention shapes of
# olmo (16 = KV heads), qwen3-moe (64 over 4 KV heads: KV replicated over
# 16) and gemma (one KV head), the scan at zamba2's
PATH20A_FLASH = (("olmo_1b", 4), ("qwen3_moe_235b_a22b", 16),
                 ("gemma_2b", 4))
PATH20A_SCAN = ("zamba2_1p2b", 4)
PATH20A_BATCH, PATH20A_SEQ = 1, 2048
# 20b: olmo-1b through the sharded loop on a one-rank NCCL group, mesh (1,
# 1), against the unsharded loop from the same params
TRAIN20_ARCH, TRAIN20_STEPS, TRAIN20_BATCH, TRAIN20_SEQ = \
    "olmo_1b", 2, 4, 2048
TRAIN20_TOL = 1e-6
# 20c: granite-moe under dispatch="shard_map" on that mesh against the
# gspmd plan unsharded, 2 layers at full width, batch 1 x 512
PATH20C_ARCH, PATH20C_LAYERS, PATH20C_BATCH, PATH20C_SEQ = \
    "granite_moe_3b_a800m", 2, 1, 512


def _head_shard(t, mesh, r: int, m: int, dim: int = 2):
    """Rank r's block of ``t``'s dim ``dim`` as its local shard of a
    DTensor split there over 'model'."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n = t.shape[dim] // m
    return DTensor.from_local(t.narrow(dim, r * n, n), mesh,
                              [Replicate(), Shard(dim)], run_check=False)


def path20a(dev) -> dict:
    """20a: ``flash_attention`` and ``ssd_scan`` on CUDA DTensors, each
    rank of a (1, m) mesh in turn: every rank's output must be, bit for
    bit, the heads it owns of the one-device kernel call, with the
    DTensor's placements; a rank whose KV heads are replicated takes the
    KV heads its query heads map to.  -> launches by kernel, of the
    ranks' calls."""
    from torch.distributed.tensor import DTensor, Replicate
    gen = torch.Generator(dev).manual_seed(20)
    counts = {"flash_fwd_wgmma": 0, "flash_fwd_mma": 0, "mamba2_scan": 0}
    try:
        for arch, m in PATH20A_FLASH:
            cfg = get_config(arch)
            B, S = PATH20A_BATCH, PATH20A_SEQ
            H, Hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            q, k, v = _qkv(gen, B, S, H, Hkv, d, torch.bfloat16, dev)
            full = fa_ops.flash_attention(q, k, v)
            name = ("flash_fwd_wgmma" if fa_ops.uses_wgmma(torch.bfloat16, d)
                    else "flash_fwd_mma")
            Hl, same = H // m, True
            for r in range(m):
                mesh = make_sizing_mesh({"data": 1, "model": m}, rank=r,
                                        device_type="cuda")
                dq = _head_shard(q, mesh, r, m)
                dk, dv = ((_head_shard(t, mesh, r, m) if Hkv % m == 0 else
                           DTensor.from_local(t, mesh, [Replicate()] * 2,
                                              run_check=False))
                          for t in (k, v))
                before = fa_ops.kernel_launches[name]
                out = fa_ops.flash_attention(dq, dk, dv)
                counts[name] += fa_ops.kernel_launches[name] - before
                same &= (tuple(out.placements) == tuple(dq.placements)
                         and torch.equal(out.to_local(),
                                         full[:, :, r * Hl:(r + 1) * Hl]))
            print(f"path 20a {name} at {cfg.name}'s shape (H {H}, KV {Hkv}, "
                  f"d {d}, B {B} x S {S}, bf16) over (1, {m}): every rank's "
                  f"heads bit-equal to the one-device call: {same}")
            check(same, f"20a {name} at {cfg.name}'s shape: each rank's "
                        f"heads bit-equal")
        arch, m = PATH20A_SCAN
        ssm = get_config(arch).ssm
        H, N = ssm.n_heads, ssm.state_dim
        P = ssm.expand * get_config(arch).d_model // H
        q, k, v, log_a, _ = _ssd_inputs(gen, PATH20A_BATCH, PATH20A_SEQ, H,
                                        N, P, dev)
        y, st = ssd_ops.ssd_scan(q, k, v, log_a, ssm.chunk)
        Hl, same = H // m, True
        for r in range(m):
            mesh = make_sizing_mesh({"data": 1, "model": m}, rank=r,
                                        device_type="cuda")
            parts = [_head_shard(t, mesh, r, m) for t in (q, k, v, log_a)]
            before = ssd_ops.launches
            dy, dst = ssd_ops.ssd_scan(*parts, ssm.chunk)
            counts["mamba2_scan"] += ssd_ops.launches - before
            same &= (tuple(dy.placements) == tuple(parts[2].placements)
                     and torch.equal(dy.to_local(),
                                     y[:, :, r * Hl:(r + 1) * Hl])
                     and torch.equal(dst.to_local(),
                                     st[:, r * Hl:(r + 1) * Hl]))
        print(f"path 20a mamba2_scan at {arch}'s shape (H {H}, N {N}, P {P}, "
              f"chunk {ssm.chunk}, q and k shared) over (1, {m}): every "
              f"rank's heads and state bit-equal: {same}")
        check(same, "20a mamba2_scan: each rank's heads bit-equal")
    finally:
        destroy_sizing_mesh()
    check(all(n > 0 for n in counts.values()),
          f"20a launched every kernel on local shards: {counts}")
    return counts


def _one_rank_nccl(dev):
    """A one-rank NCCL group on this card and its (1, 1) mesh."""
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(dev.index if dev.index is not None
                          else torch.cuda.current_device())
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    return make_host_mesh(1, 1)


def path20b(dev, mesh) -> dict:
    """20b: olmo-1b at full width and depth (f32 params, bf16 compute,
    remat) through ``train_loop`` for TRAIN20_STEPS steps, unsharded and
    then over ``mesh``, from the same params: losses and params after the
    last step bit-equal (else within TRAIN20_TOL), 32 ``flash_fwd_wgmma``
    launches a step under both, no operator run whole.  A check of the
    driver's wiring over a real group, not of sharding: on the (1, 1)
    mesh every placement is ``Replicate``, so nothing is split and no
    operator can run whole; 20a holds the kernels on split shards."""
    cfg = get_config(TRAIN20_ARCH)
    p0 = lm.init_params(cfg, 0, device=dev)
    runs, launches, wall = {}, {}, {}
    for kind, on in (("unsharded", None), ("sharded", mesh)):
        torch.cuda.synchronize()
        _zero_lm_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            res = train_driver.train_loop(
                cfg, steps=TRAIN20_STEPS, batch=TRAIN20_BATCH,
                seq=TRAIN20_SEQ, device=dev, mesh=on, init=p0, log_every=1)
        torch.cuda.synchronize()
        wall[kind] = time.perf_counter() - t0
        launches[kind] = _lm_counts()
        params = [t.full_tensor() if hasattr(t, "full_tensor") else t
                  for t in tree_leaves(res.params)]
        runs[kind] = {"loss": [float(m["loss"]) for m in res.metrics],
                      "ends": res.step_end_s, "params": params,
                      "replicated": res.replicated}
        del res
        torch.cuda.empty_cache()
    a, b = runs["unsharded"], runs["sharded"]
    bit = a["loss"] == b["loss"] and all(
        torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
    gap = max(float((x - y).abs().max())
              for x, y in zip(a["params"], b["params"]))
    loss_gap = max(abs(x - y) for x, y in zip(a["loss"], b["loss"]))
    per_step = step_launches(cfg)
    print(f"path 20b {cfg.name} ({cfg.n_layers} layers, f32 params, bf16 "
          f"compute, remat, {CARD}): batch {TRAIN20_BATCH} x "
          f"{TRAIN20_SEQ}, {TRAIN20_STEPS} steps unsharded and over a "
          f"one-rank NCCL mesh (1, 1): losses {a['loss']} / {b['loss']}; "
          f"bit-equal {bit}, params max gap {gap}, loss gap {loss_gap}; "
          f"launches {launches} ({per_step} a step); step ends s "
          f"{a['ends']} / {b['ends']}; wall s {wall}; replicated "
          f"{b['replicated']}")
    check(bit or (gap <= TRAIN20_TOL and loss_gap <= TRAIN20_TOL),
          f"20b: the sharded loop equals the unsharded one ({gap}, "
          f"{loss_gap})")
    want = {k: TRAIN20_STEPS * v for k, v in per_step.items()}
    check(per_step["flash_fwd_wgmma"] == 32 and all(
        n == want for n in launches.values()),
          f"20b: flash_fwd_wgmma 32x a step under both: {launches}")
    check(b["replicated"] == {}, f"20b: no operator run whole: "
                                 f"{b['replicated']}")
    del p0, runs
    torch.cuda.empty_cache()
    return {"launches": launches, "per_step": per_step, "bit_equal": bit,
            "param_gap": gap, "wall_s": wall}


def path20c(dev, mesh) -> dict:
    """20c: granite-moe at full width over PATH20C_LAYERS layers, one
    batch: the loss, aux and gradients under ``dispatch="shard_map"`` on
    ``mesh`` against the gspmd plan unsharded (one shard: the same
    capacity and drops); bit-equal, else within path 15b's bar."""
    from repro_torch.core.nn import value_and_grad
    from repro_torch.parallel.annotate import use_mesh
    from repro_torch.parallel.sharding import (data_specs, param_specs,
                                               shard_tree)
    cfg = dataclasses.replace(get_config(PATH20C_ARCH),
                              n_layers=PATH20C_LAYERS)
    sm = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="shard_map"))
    params = lm.init_params(cfg, 0, device=dev)
    batch = SyntheticTokenStream(
        cfg, DataConfig(PATH20C_SEQ, PATH20C_BATCH, seed=0),
        device=dev).next_batch()
    _zero_lm_counts()
    (_, (ce1, aux1)), g1 = value_and_grad(
        lambda p: lm.lm_loss(p, cfg, batch), params, has_aux=True)
    plain_launches = _lm_counts()
    sp = shard_tree(params, param_specs(params, mesh, sm), mesh)
    sb = shard_tree(batch, data_specs(batch, mesh), mesh)
    _zero_lm_counts()
    with use_mesh(mesh):
        (_, (ce2, aux2)), g2 = value_and_grad(
            lambda p: lm.lm_loss(p, sm, sb), sp, has_aux=True)
    sharded_launches = _lm_counts()
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    g1, g2 = tree_leaves(g1), [full(t) for t in tree_leaves(g2)]
    same = [torch.equal(a, b) for a, b in zip(g1, g2)]
    err = max(scaled_err(b, a) for a, b in zip(g1, g2))
    ce2, aux2 = float(full(ce2)), float(full(aux2))
    print(f"path 20c {cfg.name} ({PATH20C_LAYERS} layers, full width, "
          f"bf16, {CARD}): batch {PATH20C_BATCH} x {PATH20C_SEQ}: ce "
          f"{float(ce1)} / {ce2}, aux {float(aux1)} / {aux2} (gspmd / "
          f"shard_map); {sum(same)} of {len(same)} gradient leaves "
          f"bit-equal, max scaled gap {err}; launches {plain_launches} / "
          f"{sharded_launches}")
    check(float(ce1) == ce2 and float(aux1) == aux2,
          "20c: the loss and aux bit-equal")
    check(all(same) or err <= LOGITS_TOL,
          f"20c: shard_map's gradients within the bar: {err}")
    check(plain_launches == sharded_launches == step_launches(cfg)
          and plain_launches["flash_fwd_wgmma"] > 0,
          f"20c: the same launches: {plain_launches}, {sharded_launches}")
    del params, sp, g1, g2
    torch.cuda.empty_cache()
    return {"launches": sharded_launches, "bit_equal_leaves": sum(same),
            "leaves": len(same), "max_scaled_gap": err}


def path20(dev) -> dict:
    """Path 20: 20a on fake groups, then 20b and 20c on a one-rank NCCL
    group (destroyed after)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    res = {"20a": path20a(dev)}
    t_a = time.perf_counter() - t0
    mesh = _one_rank_nccl(dev)
    try:
        res["20b"] = path20b(dev, mesh)
        t_b = time.perf_counter() - t0 - t_a
        res["20c"] = path20c(dev, mesh)
    finally:
        dist.destroy_process_group()
    print(f"path 20 wall s: {time.perf_counter() - t0:.3f} (20a {t_a:.3f}, "
          f"20b {t_b:.3f})")
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    print(CARD)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} in {time.perf_counter() - t0:.3f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            entry = re.search(r"entry function '\w*?_cu_[0-9a-f]{8}(\w+)'",
                              line)
            if entry:                        # the mangled kernel name
                print(f"  {name}: {entry.group(1)[:60]}")
            elif "registers" in line or "spill" in line or "wgmma" in line:
                print(f"  {name}:   {line.strip()}")

    serve_cfg, gemma_cfg = get_config(SERVE_ARCH), get_config(GEMMA_ARCH)
    kernels = [*check_gnn_mp(dev), check_wc_oracle(dev),
               *check_flash(dev, serve_cfg, gemma_cfg),
               check_mamba2(dev, serve_cfg)]

    # path 1: placement requests (gnn_mp's pair, wc_oracle's wc_trips)
    trainers, answers, per_request, launches = main_path(dev)
    check_main_path(trainers, answers, per_request, dev)
    kernels.insert(3, check_wc_trips(dev, trainers, answers))
    by_name = {k["name"]: k for k in kernels}
    device_ms = profile_request(trainers[0], sum(answers[0].seconds.values()))
    del trainers, answers

    # path 2: serving zamba2-1.2B (flash_fwd_wgmma, mamba2_scan)
    cfg, params, prompt, res, serve_launches, peak_gb = serve_path(
        dev, SERVE_ARCH)
    check_serve_path(cfg, params, prompt, res, serve_launches, peak_gb, dev)
    serve_ms, ssd_by_kernel, _ = profile_serve(
        params, cfg, prompt, res,
        {"flash_fwd_wgmma<": 6, "flash_fwd_mma<": 0, "ssd_chunk_scan": 0,
         **{name: 32 for name in ssd_ops.KERNELS}})
    device_ms.update(serve_ms)
    by_name["mamba2_scan"]["device_ms_by_kernel"] = ssd_by_kernel
    launches["flash_attention"] = serve_launches["flash_fwd_wgmma"]
    launches["mamba2_scan"] = serve_launches["mamba2_scan"]
    by_name["flash_attention_mma"]["launches_zamba2_prefill"] = \
        serve_launches["flash_fwd_mma"]
    del params, res
    torch.cuda.empty_cache()

    # path 3: serving gemma-2b (flash_fwd_mma at head_dim 256)
    cfg, params, prompt, res, gemma_launches, peak_gb = serve_path(
        dev, GEMMA_ARCH)
    check_gemma_path(cfg, params, prompt, res, gemma_launches, peak_gb, dev)
    gemma_ms, _, _ = profile_serve(params, cfg, prompt, res,
                                {"flash_fwd_mma<": 18, "flash_fwd_wgmma<": 0})
    device_ms["flash_attention_mma"] = gemma_ms["flash_attention_mma"]
    launches["flash_attention_mma"] = gemma_launches["flash_fwd_mma"]
    del params, res
    torch.cuda.empty_cache()

    # path 14: serving granite-moe-3b-a800m, qwen3-moe-235b-a22b (2 of 94
    # layers), musicgen-large and paligemma-3b (flash_fwd_wgmma at d 64
    # and 128, flash_fwd_mma at d 256 over patches + prompt; the MoE's
    # dispatch and experts in plain PyTorch, as the reference's einsums).
    # It runs before path 13: after path 13's profiled prefill (~272,000
    # launches) the next profiler sessions came back without kernel
    # records (PERF.md, Findings)
    by_name["flash_attention"]["path14"], \
        by_name["flash_attention_mma"]["path14"] = path14(dev)

    # path 15: LM training through make_train_step (zamba2-1.2B at full
    # width and depth, then one step a family at a cut depth): the flash
    # and scan kernels forward under autograd, the plain versions'
    # gradients backward.  Before path 13, whose profiled prefill leaves
    # later profiler sessions without kernel records
    p15 = path15(dev)
    a15, b15 = p15["15a"], p15["15b"]
    by_name["flash_attention"]["path15"] = {
        "zamba2_per_step": a15["per_step"]["flash_fwd_wgmma"],
        "zamba2_steps": a15["launches"]["flash_fwd_wgmma"],
        **{a: r["launches"]["flash_fwd_wgmma"] for a, r in b15.items()
           if r["launches"]["flash_fwd_wgmma"]}}
    by_name["flash_attention_mma"]["path15"] = {
        a: r["launches"]["flash_fwd_mma"] for a, r in b15.items()
        if r["launches"]["flash_fwd_mma"]}
    by_name["mamba2_scan"]["path15"] = {
        "zamba2_per_step": a15["per_step"]["mamba2_scan"],
        "zamba2_steps": a15["launches"]["mamba2_scan"],
        **{a: r["launches"]["mamba2_scan"] for a, r in b15.items()
           if r["launches"]["mamba2_scan"]}}
    measured18 = {("zamba2_1p2b", "train"): (a15["s_per_step"],
                                             a15["peak_memory_gb"])}
    del p15, a15, b15

    # path 16: serving olmo-1b, phi4-mini-3.8b and qwen1.5-110b (4 of 80
    # layers) at full width (flash_fwd_wgmma at d 128), then the LM
    # training driver (launch/train.py: olmo-1b at full width and depth,
    # its resume over one layer, one int8-compressed step).  Before path
    # 13, for the same reason as paths 14 and 15
    p16 = path16(dev)
    a16, b16 = p16["16a"], p16["16b"]
    by_name["flash_attention"]["path16"] = {
        "serve": {a: {k: r[k] for k in ("launches", "layers", "serve",
                                        "gates", "kernel_timing")}
                  for a, r in a16.items()},
        "train_driver": {"olmo_1b_per_step": b16["train"]["per_step"][
                             "flash_fwd_wgmma"],
                         "olmo_1b_steps": b16["train"]["launches"][
                             "flash_fwd_wgmma"],
                         "s_per_step": b16["train"]["s_per_step"],
                         "tokens_per_s": b16["train"]["tokens_per_s"],
                         "resume_bit_equal": b16["resume"]["bit_equal"],
                         "int8": b16["int8"]}}
    measured18[("olmo_1b", "prefill")] = (
        a16["olmo_1b"]["serve"]["prefill_s"],
        a16["olmo_1b"]["serve"]["peak_memory_gb"])
    measured18[("olmo_1b", "train")] = (b16["train"]["s_per_step"],
                                        b16["train"]["peak_memory_gb"])
    del p16, a16, b16

    # path 17: the model-zoo graph importer: every registry config's
    # layer graph imported on the host, two placed flat on the card (the
    # gnn_mp pair, wc_trips), model:olmo_1b:full placed through the
    # hierarchy, the placement server with its defaults
    # path 18's host work (the dry-run on fake tensors) starts here, in
    # processes of their own at the lowest priority, beside path 17
    started18 = path18_start()
    path17(dev, by_name)

    # path 18: the sizing dry-run: six production cells on the fake
    # process group (host only), the one-card mesh's predictions beside
    # what paths 15a, 16a and 16b measured, its argument bytes against
    # the card's (flash_fwd_wgmma and mamba2_scan ran in those paths)
    path18(dev, measured18, started18)

    # path 13: serving xlstm-1.3b (mamba2_scan at N 1024 a head in every
    # mLSTM block; the sLSTM blocks' loop over time in plain PyTorch).
    # It runs beside the other serving paths: after the training paths,
    # its profiler sessions lost launches (PERF.md, Findings)
    by_name["mamba2_scan"]["xlstm"] = xlstm_path(dev)

    # path 4: training, Stage I and Stage II (gnn_mp's pair under autograd,
    # wc_oracle's wc_trips scoring every reward batch)
    gnn_ops.launches = gnn_ops.pair_launches = 0
    wc_ops.launches = wc_ops.trip_launches = 0
    train = train_path(dev)
    train_launches = _launch_counts()
    check(train_launches == train["counts"],
          f"the training path's launches: {train_launches}")
    check_train_path(train)
    prof = profile_update(train["trainer"], train["engine"],
                          sum(train["stage2_s"].values()))
    for name in ("gnn_mp_pair", "gnn_mp", "wc_oracle_trips", "wc_oracle"):
        by_name[name]["train"] = {
            "launches": train_launches[name],
            "per_stage1_episode": train["launches"]["stage1_episode"][name],
            "per_stage2_update": train["launches"]["stage2_update"][name],
            "device_ms": prof["device_ms_per_launch"].get(name)}
    check(train_launches["gnn_mp_pair"] > 0
          and train_launches["wc_oracle_trips"] > 0,
          "the training path ran the gnn_mp pair and wc_trips")
    nonfused_s1, nonfused_s2 = train["stage1_s"], train["stage2_s"]
    del train

    # path 5: fused training, each update one CUDA graph replay
    gnn_ops.launches = gnn_ops.pair_launches = 0
    wc_ops.launches = wc_ops.trip_launches = 0
    t_fused = time.perf_counter()
    fused = fused_path(dev)
    check(_launch_counts() == fused["counts"],
          f"the fused path's launches: {_launch_counts()}")
    check_fused_path(fused, nonfused_s1, nonfused_s2)
    fprof = profile_fused(fused["trainer"], fused["stage2_s"]["updates"])
    print(f"fused path wall s (gates, record, profile): "
          f"{time.perf_counter() - t_fused:.3f}")
    for name in ("gnn_mp_pair", "wc_oracle_trips"):
        by_name[name]["train_fused"] = {
            "launches_per_stage2_update": fused["captured"]["stage2"][name],
            "launches_per_stage1_update": fused["captured"]["stage1"][name],
            "device_ms": fprof["device_ms_per_launch"][name]}
    del fused

    # path 6: Stage III on the card (the executor on CUDA streams, the
    # calibration, then Stage I and II fused on the calibrated fleet:
    # gnn_mp's pair and wc_trips; Stage III against measured wall-clock)
    stage3 = stage3_path(dev)
    check(_launch_counts() == stage3["counts"],
          f"the Stage III path's launches: {_launch_counts()}")
    check_stage3_path(stage3)
    for name in ("gnn_mp_pair", "wc_oracle_trips"):
        by_name[name]["stage3"] = {"launches": stage3["counts"][name]}
    del stage3

    # path 10: checkpoints and resume (the fused capture kept), then the
    # baselines: GDP and Placeto on gnn_mp's pair, EnumOpt, one wc_trips
    # batch scoring them
    gnn_ops.launches = gnn_ops.pair_launches = 0
    wc_ops.launches = wc_ops.trip_launches = 0
    t_path = time.perf_counter()
    resume = resume_path(dev)
    base = baselines_path(dev, resume["trainer"])
    counts = _launch_counts()
    check(counts["gnn_mp_pair"] > 0 and counts["wc_oracle_trips"] > 0,
          f"path 10 ran the gnn_mp pair and wc_trips: {counts}")
    print_path10(resume, base)
    print(f"path 10 wall s: {time.perf_counter() - t_path:.3f}; launches "
          f"{counts}")
    by_name["gnn_mp_pair"]["resume_baselines"] = {
        "launches": counts["gnn_mp_pair"],
        "per_gdp_episode": base["gdp"]["per_episode"]["gnn_mp_pair"],
        "per_placeto_episode":
            base["placeto"]["per_episode"]["gnn_mp_pair"]}
    by_name["wc_oracle_trips"]["resume_baselines"] = {
        "launches": counts["wc_oracle_trips"]}
    del resume, base

    # path 11: hierarchical placement (coarsen -> place -> V-cycle refine)
    # and re-placement at 4,113 and 65,553 vertices (the gnn_mp pair on
    # the segment graph, wc_trips on segment and flat batches)
    gnn_ops.launches = gnn_ops.pair_launches = 0
    wc_ops.launches = wc_ops.trip_launches = 0
    t_path = time.perf_counter()
    hier = hier_path(dev)
    counts = _launch_counts()
    check(counts["gnn_mp_pair"] > 0 and counts["wc_oracle_trips"] > 0
          and counts["gnn_mp"] == counts["wc_oracle"] == 0,
          f"path 11 ran the gnn_mp pair and wc_trips: {counts}")
    print(f"path 11 wall s: {time.perf_counter() - t_path:.3f}; launches "
          f"{counts}")
    by_name["gnn_mp_pair"]["hierarchical_place"] = {
        "launches": counts["gnn_mp_pair"]}
    by_name["wc_oracle_trips"]["hierarchical_place"] = {
        "launches": counts["wc_oracle_trips"],
        "refine_batch_n4113": hier["train"]["trips"],
        "refine_batch_n65553": hier["big"]["trips"],
        "plain_checked_rows_n529": hier["check_rows"],
        "numpy_gap_n4113": hier["train"]["numpy_gap"]}
    del hier

    # path 12: pretraining, zero-shot serving, FleetTrainer and the
    # training CLI (gnn_mp's pair in all but FleetTrainer's numpy rewards'
    # scoring; wc_trips in the CLI's oracle and fused engines)
    # path 19a's processes start here: their imports, trainers, warm-up
    # update and captures run beside path 12; their timed updates wait
    # for path 19
    started19 = path19a_start()
    path12(dev, by_name)

    # path 19: the data-parallel fused Stage II (19a: two gloo ranks in
    # processes of their own, eager; a one-rank NCCL group captured; the
    # gnn_mp pair and wc_trips in every rank's updates) and olmo-1b
    # trained under remat "dots" beside "full" (19b: flash_fwd_wgmma)
    gnn_ops.launches = gnn_ops.pair_launches = 0
    wc_ops.launches = wc_ops.trip_launches = 0
    _zero_lm_counts()
    p19 = path19(dev, started19)
    a19, b19 = p19["19a"], p19["19b"]
    for name in ("gnn_mp_pair", "wc_oracle_trips"):
        by_name[name]["path19"] = {
            "launches_per_rank_update": a19["launches_per_rank_update"][
                name],
            "launches_captured_update": a19["nccl"]["captured"][name]}
    by_name["flash_attention"]["path19"] = {
        "olmo_1b_dots": b19["launches"]["dots"]["flash_fwd_wgmma"],
        "olmo_1b_full": b19["launches"]["full"]["flash_fwd_wgmma"]}
    del p19, a19, b19

    # path 20: sharded LM training (20a: the kernels on CUDA DTensors'
    # local shards, each rank of a (1, m) mesh on a fake group; 20b:
    # olmo-1b through the sharded loop on a one-rank NCCL group against
    # the unsharded loop; 20c: granite-moe's shard_map dispatch against
    # the gspmd plan)
    _zero_lm_counts()
    p20 = path20(dev)
    by_name["flash_attention"]["path20"] = {
        "20a_ranks": p20["20a"]["flash_fwd_wgmma"],
        "20b_olmo_1b": p20["20b"]["launches"],
        "20c_granite": p20["20c"]["launches"]["flash_fwd_wgmma"]}
    by_name["flash_attention_mma"]["path20"] = {
        "20a_ranks": p20["20a"]["flash_fwd_mma"]}
    by_name["mamba2_scan"]["path20"] = {
        "20a_ranks": p20["20a"]["mamba2_scan"]}
    del p20

    ported = {}
    for name, k in by_name.items():
        k["launches"] = launches[name]
        k["device_ms"] = device_ms.get(name)
        ported[k["replaces"]] = ported.get(k["replaces"], 0) + k["launches"]
    # every Pallas kernel: one of its ports launched on its path (the
    # oracle's path runs wc_trips, the encoder gnn_mp's pair; wc_step and
    # the single-direction gnn_mp record 0)
    for replaces, n in ported.items():
        check(n > 0, f"a port of {replaces} launched on its path")
    check(launches["wc_oracle_trips"] == len(REQUESTS)
          and launches["wc_oracle"] == 0,
          "the placement path ran wc_trips once a request, wc_step never")
    check(launches["gnn_mp_pair"] == 2 * len(REQUESTS)
          and launches["gnn_mp"] == 0,
          "the placement path ran the gnn_mp pair twice a request")

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
