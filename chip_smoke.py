#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py            # from the repository root, one card
  python3 chip_smoke.py --cards 4  # phase 2, then phase 25 on four cards

Phases (any failure exits non-zero; nothing is caught):
  1. card, power limit, torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
     ``nvcc`` per source, all started together); ``cuobjdump -sass`` on
     K3's library must show HGMMA (wgmma) and UTMALDG (TMA loads) in every
     bf16 kernel, and on K8's HMMA (its TF32 mma.sync);
  3. full-width ``qwen3-0.6b`` (28 layers, bf16, random weights from seed
     0): capture 2 calibration batches, compress per-(layer, site) tables
     for the MLP site, for every site (``--lut-sites all``) and for every
     site plus the logit softcap, and a shared-table plan;
  4. K1-K4 against their plain PyTorch versions on the card, at the
     serving path's shapes: K1/K2 bit for bit on bin edges +-1 ulp (bf16
     and f32, raw and packed slabs, a stack mixing w_lb == 0 and w_lb > 0);
     K3 bit for bit against its own GEMM followed by K1 (stacked tables) or
     K2 (per-plan tables), two launches bit-identical, and within 1% of
     ``torch.matmul`` followed by the plain LUT, at the serving shapes, at
     ragged M (1, 3, 5, 67, 257), F = 1000 and K = 1032, and on the f32
     route at one shape; K4 bit for bit against its
     plain version and, per site, against K1 on the all-sites super-slab
     (every layer, every site in one launch, f32 and bf16, a segment past
     its block cap), two launches bit-identical, single-site and
     all-sites calls replayed from a CUDA graph with eager's bits, and an
     entry without its launch record refused; K1/K2 again on
     the ``gate`` and ``up`` halves of a ``[gate|up]`` product (row stride
     2 x 3072, read in place: K1 there launches one kernel and no copy),
     a start 2 / 4 bytes past a 16-byte boundary and counts 1, 7 and
     8003, on every site's stack of the all-sites plans (every pack width
     their plans produce) and on per-layer plans;
  5. qwen3-0.6b served through the launcher's entry points, 4 requests x
     64 prompt tokens x 16 new tokens, decoding through the step captured
     in a CUDA graph: (a) stacked + cuda, (b) unrolled + cuda, (c) shared
     tables + cuda, (e) ``--lut-sites all`` stacked + cuda, (g)
     ``--lut-sites all --logit-softcap 30``, each token-identical to the
     gather backend on the same tables, and (d) ``--lut-fuse``, (f)
     ``--lut-sites all --lut-fuse`` (K3 + K4), (k) ``--kv-int8`` (the
     prompt replayed into an int8 cache), with their agreement with (a)
     and (e); launch counts are zeroed before each form and read after
     it; every form also decodes eagerly, with the captured run's tokens,
     and each replayed step's logits and the caches equal eager's bit for
     bit, with eager's launch counts;
  6. K5 (Eq. (1) at integer addresses) and K6 (plain lookup) bit for bit
     against their plain versions and ``plan.reconstruct()``: w_in 5-16,
     several M and w_lb, plain plans, odd query shapes, address counts of
     every residue mod 4, a view 4 bytes past a 16-byte alignment, tables
     under and over a block's shared-memory limit (neither kernel stages:
     a small table stays in L1, a large one does not);
  7. K7 (one LUT-NN layer) bit for bit against its plain version: ragged
     B x N x F x bits, the paper models' layer shapes, a case on each of
     ``k7_plan``'s routes (codes staged one byte each, staged as int32 at
     bits 9, unstaged where one row of codes does not fit a block's shared
     memory and where a row holds at most 16 codes), ragged last tiles;
     two launches and a CUDA-graph replay bit-identical on each route, and
     each launching its route's kernel (at the paper shapes the narrowed
     one, or the unstaged one where a row holds 16 codes);
  8. LUT-NN training through the captured step (each step one CUDA graph
     replay) bit for bit against the eager loop on jsc-2l, jsc-5l and
     mnist (a few epochs on small data); then the paper's LUT-NN toolflow
     at full paper width through
     ``repro_torch.launch.lutnn``'s functions (train, extract, don't cares,
     CompressedLUT / ReducedLUT, reconstruction through K5/K6, accuracy
     through K7, Verilog): jsc-2l at the launcher's data sizes, then the
     quickstart (jsc-5l and mnist at the paper's data scale are phase
     21's); launch counts zeroed before each and read after it (K5 / K6
     once per plan, K7 once per chunk, layer and pass), every K7 call's
     shape recorded;
  9. full-width ``rwkv6-3b`` (32 layers, bf16, random weights from seed
     0): plans for the ``ffn`` site and for every site; K3 non-gated at the
     ``ffn`` shape and around it (ragged M, N = 1000, K = 1032, per-plan
     tables) as in phase 4; K4 on
     its super-slab; K8 within ``rtol = atol = 1e-4`` of its plain version,
     finite and two launches bit-identical (layer 0's inputs of a real
     prefill, strong and weak decay, ``log_w = -e`` and ``-30`` on every
     step, ragged T, chunk 16, a given initial state);
  10. rwkv6-3b served in the same sizes, captured and eager as in
     phase 5: (x) exact (K8 only), (h)
     ``--lut-act`` stacked + cuda and (i) ``--lut-sites all``, each
     token-identical to gather, (j) ``--lut-sites all --lut-fuse`` (K3 + K4
     + K8) with its agreement with (i); each form must launch K8 once per
     layer of its prefill; and how far the LUT forms move the prefill
     logits, against the top-1 margin;
  11. per-kernel times (median CUDA-event time per launch over a run of
     launches after a warm-up; also with the host out of the loop, from a
     CUDA graph of the launches), the bound from bytes and operations, the
     plain versions' times, and the library yardstick where one PyTorch
     call computes the same function (K3: cuBLAS GEMM followed by K1, also
     from a CUDA graph; K6: ``torch.take``); K4 and K8 have none; K1 and K2
     on the served input (the ``gate`` view) and on a contiguous copy; K4
     at the shapes form (f) hands it in a prefill and a decode step,
     recorded from the served calls; K5-K7 after phase 21: K7 at the
     paper models' layer shapes and at every (layer, shape) the toolflow
     and phase 21's sweeps handed it, on their own inputs, each held bit
     for bit against its plain version, beside its bound and beside the
     route ``k7_plan`` did not choose (timed too, and summed over the
     path's launches);
  12. one profiled decode step (qwen3-0.6b exact, forms (a), (d) and (f);
     rwkv6-3b exact and form (j)): wall time, kernels launched (copies
     among them: form (a) must launch as many as the exact step), device
     busy time, idle share and the wrappers' launches in the step; then
     the same step captured in a CUDA graph: one profiled replay (wall,
     kernels, busy, idle share, launch counts equal to eager's) and the
     CUDA-event time of a replay;
  13. (run after phase 5, so that its launches count on the main path)
     the continuous batcher, qwen3-0.6b at full width with form (a)'s
     tables, 4 slots, 8 requests of 16-64 prompt tokens and 16 new
     tokens, ``eos_token=-1``, bf16 and int8 caches, ``prefill="step"``
     and ``"replay"``: replay and step serve identical tokens, no request
     is dropped, every bf16 request's tokens equal its decode alone in
     the pool, one ``swap_tables`` to form (e)'s tables mid-run captures
     the step again and serves on; the replay prefill of 4 x 64 tokens,
     bf16 and int8, timed;
  14. (run after phase 13) artifacts through the launcher: ``--calib-path``
     saves the captured calibration, reloads it bit for bit and serves
     form (a)'s tokens from it; ``--save-plan`` then ``--tuned-plan`` serve
     forms (a) and (f) token-identically to the in-process plans;
  15. (run last, once the earlier models are freed) the moe family at
     full width, random weights from seed 0, bf16, the same 4 x 64 x 16:
     ``deepseek-moe-16b`` (10 of its 28 layers, ``SERVE_DEPTH``; 64 routed
     experts top-6 at d_expert 1408, 2 shared) in forms exact, (a) stacked + cuda (K1 twice a layer
     a step: ``expert`` and the shared experts' ``mlp``), (b) unrolled
     (K2), (d) ``--lut-fuse`` (K3 on the shared MLP, the expert site
     through K4), (f) ``--lut-sites all --lut-fuse`` (K3 + K4) and (k)
     ``--kv-int8``, then ``qwen3-moe-30b-a3b`` (12 of its 48 layers,
     ``SERVE_DEPTH``; 128 experts top-8 at d_expert 768, no shared expert)
     exact and (a); each form
     captured and eager as in phase 5, (a) and (b) token-identical to the
     gather backend, every form launching the LUT kernels as often as its
     sites imply; every K1 / K2 / K4 call of a prefill and a decode step
     in forms (a), (b) and (f) held bit for bit against its plain version
     (K4 also against K1 per site) and timed from a CUDA graph beside its
     bound; K1 on the expert gate view launching one kernel and no copy;
     K4's copy of a strided expert input recorded; K3 at the shared-expert
     shape held against its own GEMM + K1 and timed beside cuBLAS + K1;
     the prefill's assignments dropped by capacity; parameter bytes, peak
     memory, and one eager and one captured decode step profiled per model
     (exact and (a));
  16. (run after phase 15, once the moe models are freed) the vlm and
     hybrid families at full width, random weights from seed 0, bf16, the
     same 4 x 64 x 16: ``phi-3-vision-4.2b`` (8 of 32 layers, d_model
     3072, 32 heads x 96, d_ff 8192 swiglu, 256 patch embeddings from
     ``model_batch`` before each prompt, so decoding starts at position
     256 + 64) in forms exact, (a), (b), (e) ``--lut-sites all`` (every
     site through K1) and (f) ``--lut-sites all --lut-fuse`` (K3 + K4),
     then ``recurrentgemma-9b`` (8 of 38 layers: 2 of its 12 groups of
     (rec, rec, attn) and its 2-layer rec tail, d_model = d_rnn 4096, 16
     heads x 256 with one KV head, window 2048, d_ff 12288 geglu) in
     forms exact, (a), (b), (d) ``--lut-fuse`` (K3 with the gelu table)
     and (f); each form captured
     and eager as in phase 5 (the hybrid's nested state compared tensor by
     tensor), (a), (b) and (e) token-identical to the gather backend, every
     form launching the LUT kernels as often as its sites imply; one
     recurrentgemma request of 2048 + 64 prompt tokens in form (a), the
     ring wrapped, captured and eager equal; every K1 / K2 / K4 call of a
     prefill and a decode step in forms (a), (b) and (f) held bit for bit
     against its plain version (K4 also against K1 per site) and timed
     from a CUDA graph beside its bound; K1 on the gated MLP's gate view
     one kernel and no copy; K3 at each model's MLP shape held against its
     own GEMM + K1 and timed beside cuBLAS + K1; parameter bytes, peak
     memory, and one eager and one captured decode step profiled per model
     (exact and (a));
  17. (run after phase 16, once its models are freed) the encdec family
     and the reference's other dense configurations at full width, random
     weights from seed 0, bf16, the same 4 x 64 x 16: ``whisper-small``
     (12 encoder layers over 1500 stub frames from ``model_batch``, 12
     decoder layers with cross-attention, d_model 768, 12 heads x 64, d_ff
     3072 gelu without a gate) in forms exact, (a), (b), (d) ``--lut-fuse``
     (K3 without a gate), (e) ``--lut-sites all`` and (f) ``--lut-sites all
     --lut-fuse`` (K4 on the cross-attention's scores over the 1500
     frames), its encoder timed apart from its decoder prefill; then
     ``phi4-mini-3.8b`` (16 of 32 layers) and ``nemotron-4-15b`` (8 of 32
     layers; relu2 without a gate, d_ff 24576) in forms exact, (a), (b)
     and (d), and ``deepseek-67b`` with its depth cut to 10 of 95 layers
     (134.9 GB in bf16 at full depth) in forms exact and (a) (the depth cuts:
     ``SERVE_DEPTH``); each form captured and eager as in phase 5 (whisper's
     cross K/V as prefill wrote them, bit for bit), (a), (b), (e)
     token-identical to the gather backend, every form launching the LUT
     kernels as often as its sites imply; every K1 / K2 / K4 call of a
     prefill and a decode step in forms (a), (b) and (f) held bit for bit
     against its plain version and timed beside its bound; K3 at each
     model's MLP shape held against its own GEMM + K1 and timed beside
     cuBLAS + K1; parameter bytes, peak memory, and one eager and one
     captured decode step profiled per model (exact and (a));
  18. (run after phase 17, once its models are freed) training through
     ``repro_torch.launch.train``'s functions, bf16, random weights from
     seed 0 (the measured runs drive ``setup(...)['step']`` directly, with
     no checkpoint in the timed steps): ``qwen3-0.6b`` at full width, 8 x
     512 tokens, 20 steps on the launcher's schedule (finite losses, the
     mean of the last five below the first; step time, tokens/s, peak
     memory and the model FLOPs' share of the bf16 peak), its step-19
     state saved and restored bit for bit,
     5 steps each with ``--remat`` (step 0's loss bit-identical),
     ``--microbatch 2`` and ``--grad-compress``, and a ``Supervisor`` run
     (``launch.train.run``, the widths at ``P18_SUP_DEPTH`` layers) of 10
     steps checkpointing every 5 (after its starting state) whose step 7
     raises once, ending
     bit-identical (parameters, moments, count, step) to an uninterrupted
     10-step run; K8b (K8's backward) held against its plain version at
     (4, 256, 40, 64) (dq, dk, dv, du within 1e-4 of their largest entry,
     dlog_w within 1e-5 of the running sums it is the difference of;
     strong and weak decay, ``log_w = -e`` and ``-30``, ragged T, an
     initial state, T shorter than a chunk; two launches and a graph
     replay bit-identical; HMMA in its state and gradient kernels' SASS,
     checked in phase 2), then ``rwkv6-3b`` at full width, ``--remat``,
     4 x 256, 5 steps, launching K8 64 and K8b 32 times a step, and K8b
     timed beside its bound (``k8b_work``: bytes, or its products at the
     3xTF32 tensor-core rate as K8's) with the CUDA kernels one call runs
     (``cuda_kernels`` in its entry of the kernel JSON line, counted in a
     graph of one call); ``whisper-small`` at full width and ``deepseek-moe-16b``,
     ``recurrentgemma-9b`` and ``phi-3-vision-4.2b`` with their depth cut
     (``P18_DEPTH`` gives why), 2 steps each at 4 x 64, losses and gradient
     norms finite; then AdamW in slices of the leading axis held bit for
     bit against AdamW whole, and an expert stack's shares' slab terms
     of the norm against the whole stack's, both on the card
     (``p18_update_slices``); the qwen3-0.6b step-19 checkpoint stays
     under ``build/p18_ckpt/`` for phase 19;
  19. (run after phase 18) the accuracy-parity autotuner and the serving
     control plane at full width: ``repro_torch.launch.tune``'s functions
     with the reference's flags (``--full --arch qwen3-0.6b --ckpt-dir``
     phase 18's checkpoint ``--backend cuda --calib-steps 4 --eval-steps 4
     --batch 4 --seq 64 --grid default``): ``trained_params`` restores the
     checkpoint, the default grid's 12 points are compressed and measured
     through K1 (each point's cost, table bytes, top-1 drop, KL and
     compress / evaluate seconds, the frontier, the selection, the greedy
     evaluations and each stage's seconds printed), gather == cuda on the
     tuned plans, the artifact (``artifacts/tuned_qwen3.npz`` in the
     output directory)
     round-trips token-identically on both backends, and the reference
     launcher's three strict rules must hold; then form (a)'s tables
     (``--lut-act --calib-steps 2``) from the same parameters serve 8
     requests of 16-64 prompt tokens through 4 slots of the batcher
     (replay prefill) under a ``DegradationLadder`` at its top rung
     (``cuda_fused``: K4): with nothing injected (no demotion), with
     ``cuda:lut_act_multi`` injected twice (``mlp`` demoted to ``cuda``,
     K1 while demoted, re-promoted after backoff, K4 again after), once
     from the capture's warm-up and once from inside the graph capture
     (the failed capture leaves no graph; the retry captures afresh), and
     with
     the super-slab bit-flipped (caught by revalidation against gather),
     every request's tokens equal to the run with nothing injected; then
     ``launch/serve``'s ``--reload-plan --degrade`` path hot-reloads the
     tuned artifact (the parity gate judges it, its measured drop printed)
     and a frozen copy of the active plans (cut over between ticks,
     tokens equal), no request dropped, no ladder demotion, and a
     corrupted copy of the tuned artifact is rejected at load; the
     checkpoint is removed after;
  20. telemetry on the served path (``repro_torch.obs``), full-width
     qwen3-0.6b from seed 0 with form (a)'s flags (``--lut-act
     --calib-steps 2``): (a) ``launch/serve``'s functions with
     ``--obs-log obs/serve.jsonl`` serve the tokens of the run without it,
     the port's ``read_events`` accepts the log, every calibration key has
     a ``drift`` row with lookups > 0, and ``python -m
     repro_torch.launch.obs`` renders it (its head logged); (b) 8 requests
     of 16-64 tokens through 4 slots of the batcher (step prefill) in
     forms (a) (K1) and (d) ``--lut-fuse`` (K3; monitored steps run K3's
     GEMM alone and K1), telemetry off and under the drift monitor at
     ``sample_every`` 1 and 4: tokens equal, 0 < sampled lookups < full
     lookups, the plain graph holds the telemetry-off graph's nodes kind
     for kind (counted in each graph's DOT dump, the graphs captured in
     debug mode; the monitored graph's extra nodes and both graphs' replay
     times logged); (c) one monitored eager prefill and
     decode step: the card's counters equal a host recount of the same
     pre-activations key for key, the calibration batches replayed through
     the capture's forward give 0 don't-care hits and tokens of another
     seed give some; (d) phase 19's K4 drill and ``--reload-plan
     --degrade`` of the tuned artifact and of a frozen copy of the plans,
     then a corrupted copy, each under an obs log (``obs/ladder.jsonl``,
     ``obs/reload.jsonl``): ``ladder_demote`` then ``ladder_promote``,
     ``reload_cutover`` and ``reload_reject`` at stage load, the counters
     equal to the events; (e) batcher new tok/s (replay prefill) with
     telemetry off, at ``--obs-drift-every`` 128 and at 1, in interleaved
     repeats;
  21. the paper's sweeps through ``repro_torch.bench``'s functions at
     ``scale="paper"`` (the paper widths of jsc-2l, jsc-5l and mnist,
     ``make_jsc(100000, 20000)`` / ``make_mnist_like(30000, 5000)``, 25
     epochs): each model trained once on the card, then Table 2's six rows
     per model (baseline, CompressedLUT, random fill, ReducedLUT at
     exiguity 20 / 150 / 250) and the serial-vs-engine timing on jsc-2l
     (6 engine processes), Fig. 3's nine rows and the four beyond-paper
     variants on jsc-2l (``bench/*.json`` in the output directory, a log
     line per row); every row's training accuracy must be the net's own,
     CompressedLUT's test accuracy too, the timing ``identical``, and each
     model's ReducedLUT ex 250 tables, run once more through the plain
     K5 / K6 and K7 on the same tensors, give the kernels' tables and
     accuracies bit for bit; launch counts zeroed before the phase and
     read after it (K5 + K6 once per plan rebuilt, K7 once per chunk,
     layer and pass, nothing else); a line per model sets the best
     ReducedLUT row against CompressedLUT, the baseline and the abstract's
     claim (1.63x, a test drop of at most 0.01), on the synthetic data.
  22. sharded serving (``repro_torch.serve.sharded``) on ranks that share
     ``cuda:0`` over gloo (``run_ranks``; the kernels built in phase 2,
     before any rank starts), bf16, random weights from seed 0, 4
     requests x 64 prompt x 16 new tokens, ``--lut-act --calib-steps
     2``, under PyTorch's default matmul settings (the ranks' own): (a)
     full-width qwen3-0.6b on a 2x2 mesh through ``launch/serve --mesh
     2,2`` (its ranks started by the launcher, rank 0 calibrating and
     compressing once): gspmd stacked, then through the launcher's rank
     function ``serve_rank`` (what ``--mesh`` starts), three runs one after
     another in one start of the ranks: gspmd stacked at a
     ``PlacementPolicy`` threshold of 0 (the 28-layer slab split over
     dp=2), gspmd unrolled and shard_map stacked, the cuda backend, each
     rank's first 8 served K1 (stacked) or K2 (unrolled) calls bit for
     bit their plain versions; each rank's
     tokens and logits a step bit for bit the single-device program's on
     that rank's rows (eager, at the same shapes), every rank's table
     checksum the single-device tables', K1 (stacked) or K2 (unrolled)
     launched on every rank; the whole batch on one device, its tokens
     and largest logit difference recorded; per rank the memory at rest
     and the parameter bytes against the single-device model's; (b)
     full-width deepseek-moe-16b on a 1x2 mesh (expert parallel): the
     single-device run first (its plans frozen), freed, then the ranks,
     each drawing only its share leaf by leaf: tokens and logits bit for
     bit, dropped assignments at prefill equal, each rank's expert bytes;
     (c) the batcher on 2x2 with phase 13's 8 requests through 4 slots
     (replay prefill, form (a)'s tables from the frozen plans): outputs
     equal the single-device batcher's on every rank, and each rank's
     first 8 served K1 calls bit for bit the plain version; (d) (a)'s
     first run with ``--obs-log obs/mesh.jsonl``: ``mesh_serving``, a
     ``table_placement`` a site and the ``drift`` rows, whose counts,
     summed over the ranks, equal the single-device runs' on the same
     rows.
  23. sharded training (``repro_torch.train`` on a mesh) through
     ``launch/train``'s functions (``setup(args, mesh=...)``, ``run``) on
     ranks that share ``cuda:0`` over gloo, bf16, random weights from seed
     0, each part held bit for bit against its single-device counterpart
     (run first, under PyTorch's default matmul settings, the ranks' own;
     every rank's shares held against the single-device state cut to that
     mesh by ``bits_hash``, a 128-bit position-weighted sum of the bits
     computed on the card, so no state is gathered or moved to compare it):
     (a) full-width qwen3-0.6b on 2x2 with ``--remat``, phase 18's 8 x 512
     tokens, 3 steps, against ``--microbatch 2``: losses, gradient norms and
     the state after step 3, the state at step 2 saved as a checkpoint
     (rank 0 writes full leaves); a rank's state bytes and card
     memory at rest against one device's, its peak, its step split into
     weight gather, forward and backward, gradient reduction and update;
     (b) ``--grad-compress`` on 2x2, 3 steps: the first loss (a)'s, the
     losses falling, step 1's mean gradient of ``P23_RECOUNT``'s leaves
     on every rank equal to the ranks' int8 codes summed and scaled on the
     host; (c) (a)'s checkpoint restored onto 1x1 (the files' crc32
     verified) and 2x1, each the single-device state after 2 steps, step 3
     on 2x1 (a)'s; (d) a supervised run on 2 ranks
     (``P23_SUP``), rank 1 failing once at the end of a step: every rank
     restores and the end state is the uninterrupted single-device
     ``--microbatch 2`` run's; (e) rwkv6-3b
     at its published widths, 4 of 32 layers (``P23_RWKV``), ``--remat``,
     4 x 256, dp 2, 3 steps against ``--microbatch 2``, each rank's first
     2 K8 and 2 K8b launches held against ``wkv_chunked_plain`` /
     ``wkv_backward_plain`` (phase 11's and 18's tolerances), K8 8 and K8b
     4 launches a rank a step; (f) deepseek-moe-16b at 2 layers (phase
     18's cut), 4 x 64, 2 steps, on 1x2 (expert parallel, against the
     plain step) and 2x1 (against ``--microbatch 2``); (h) full-width
     qwen3-0.6b (28 layers, float32) on 1x2 with ``--tp-mode
     partitioned`` (``P23_TP``: 2 x 32 tokens, the fewest that keep the
     widths and the depth), 2 steps: each loss within 1e-2 of the
     single-device step's and each gradient norm within 1e-2 relative
     (phase 24 (d)'s bound; float32 because in bf16 the single-device
     step's own reassociation moves these losses further: ``P23_TP``), no
     whole tp-split leaf gathered over the model axis (a spy
     on ``Placement.gather``), the same 2 steps in exact mode bit for bit
     the single-device run, each rank's peak beside exact mode's and both
     steps' splits printed; (c) on one device and (f), (h) on 1x2 run in
     threads beside the 2x1 ranks.
  24. the dry run (``repro_torch.launch.dryrun.trace_step``: the port's
     own step traced on ``meta`` tensors, the kernels' abstract
     route, the roofline's cost counter and ``MemTracker``) against the
     card: each case is traced at its shape on one device, and its first
     step then runs on the card under the same counter; the FLOPs, HBM
     bytes, operations and launches a kernel point must be equal (the
     same program under the same counter), the predicted peak within 1%
     plus 64 MiB of the card's (the bytes at rest plus the allocator's
     high-water mark over the step), and the step's measured ms at least
     the roofline bound (``bound_s`` from an H100's peaks; the share
     printed): (a) (run after phase 12, while phase 5's model lives)
     qwen3-0.6b's decode step at 4 requests and a cache of 64 + 16,
     exact and form (a), against phase 12's captured replay, K1's
     launches a step equal to phase 12's; (b) qwen3-0.6b's training step
     at phase 18's 8 x 512 against phase 18's step; (c) rwkv6-3b's with
     ``--remat`` at 4 x 256, K8 64 and K8b 32 launches a step as phase
     18 counted; (d) qwen3-0.6b's step with ``set_fast_stream(True)``:
     its loss within 1e-2 of (b)'s (the CPU test's bound against the
     reference), the dry run's change in HBM bytes beside the change in
     the measured step's median (3 steps each, on and off in turns on one
     state), with no pass or fail on the speed.
  25. (``--cards 4`` only: the build, then this phase alone; fewer than
     four cards visible exits non-zero and names the count) the sharded
     programs on four cards, rank ``r`` on ``cuda:r``, over NCCL, bf16,
     random weights from seed 0; each single-device reference first, in a
     process of its own on ``cuda:0`` (PyTorch's default matmul
     settings, the ranks' own), then one start of the four ranks runs
     every case, each rank's memory at rest and at peak and each case's
     seconds printed: (a) qwen3-0.6b at full width on 2x2 through
     ``launch/serve``'s rank function (phase 22's flags, rank 0
     calibrating), the decode step captured in a CUDA graph and once
     more eager: each data rank's tokens and logits bit for bit the
     single-device run's on its rows, the replay bit for bit eager, each
     rank's first 8 served K1 calls bit for bit ``lut_act_stacked_plain``,
     the gather seconds a session, decode tok/s captured and eager, the
     capture seconds; (d) the batcher on (a)'s mesh and frozen tables
     (phase 13's requests, replay prefill, the captured sharded step):
     outputs equal the single-device batcher's, new tok/s and the gather
     seconds a tick; (e) rwkv6-3b at 32 layers, ``--remat``, 4 x 256, 3
     steps on 2x2: bit for bit the single-device ``--microbatch 2`` run
     (every rank's shares by ``bits_hash``), 2 sampled K8 / K8b calls a
     rank against their plain versions, step ms with its splits; (g)
     qwen3-0.6b training, phase 23's 8 x 512 ``--remat``: 2 steps on
     2x2, the checkpoint, restored onto 1x4 and a third step, bit for bit
     the single-device 2 steps at ``--microbatch 2`` then one at 1; then
     on a 1x4 mesh over the same ranks (a quarter of the experts a rank):
     (b) qwen3-moe-30b-a3b and (c) deepseek-moe-16b at full depth, exact
     and form (a) (the reference's frozen plans), eager then captured in
     one session: bit for bit the single-device run, the replay's expert
     all-gathers counted inside the capture (one a layer); (f)
     deepseek-moe-16b training at its 28 layers (``P25_MOE_TRAIN``), 4 x
     64, 2 steps, each rank holding only its share of the expert stacks'
     gradients (the dry run: 43.8 GB a rank, 133.4 when the step gathered
     them whole): the first loss bit for bit the single-device forward,
     each rank's peak beside the dry run's for the same rank (traced in
     a process of its own on the meta device), and a 2-layer cut bit for
     bit the single-device step; (h) (g)'s qwen3-0.6b 8 x 512 ``--remat``
     with ``--tp-mode partitioned`` on 2x2, 3 steps in bf16 and 3 in
     float32: every float32 loss within 1e-2 of the single-device float32
     ``--microbatch 2`` step's (gradient norms 1e-2 relative), the first 2
     bf16 losses within 1e-2 of (g)'s exact steps on the same batches
     (``P25_TP_BF16_HELD``: at the third, the single-device program's own
     reassociations spread the bf16 loss over 0.45), step ms and splits
     beside (g)'s; (i) nemotron-4-15b at its 32 layers (``P25_TP_NEM``)
     on 1x4, ``--remat``, 4 x 64, 2 steps partitioned (exact mode would
     gather its 31.3 GB of bf16 parameters, then their gradients, on every
     card): the first loss within 1e-2 of a single-device forward's (its
     own process on ``cuda:0``), each rank's peak beside the dry run's
     partitioned trace of the same rank.
The last lines are the kernel JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``; with ``--cards 4`` the first is phase
25's summary and ``count`` is 4; the kernels' launches include phases
19's-24's (phases 22's and 23's summed over their ranks).  Long logs go to the
output directory beside the script (``OUT_DIR``: every logged line to
``chip_smoke.log``, phase 19's ``tune_bench/v1`` payload to
``tune_qwen3.json``, phase 20's obs logs and report under ``obs/``,
phase 21's results under ``bench/``).
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"

# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, bf16 and TF32
# tensor-core and f32 CUDA-core FLOP/s: the port's roofline constants, one
# source for the kernels' bounds here and the dry run's terms (phase 24).
# Run alone, without the checkout, there are none, and main() says why.
sys.path.insert(0, str(ROOT / "src"))
try:
    from repro_torch.roofline.analysis import (
        HBM_BW as PEAK_BYTES_S,
        PEAK_F32_FLOPS,
        PEAK_FLOPS as PEAK_BF16_FLOPS,
        PEAK_TF32_FLOPS,
    )
except ImportError:
    PEAK_BYTES_S = PEAK_BF16_FLOPS = PEAK_TF32_FLOPS = PEAK_F32_FLOPS = None

B, T, NEW = 4, 64, 16


LOG = []   # the open chiprun_out/chip_smoke.log, once main() opens it


def log(msg: str) -> None:
    print(msg, flush=True)
    for f in LOG:
        f.write(msg + "\n")
        f.flush()


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def sig4(o):
    """``o`` (JSON-like) with every float rounded to 4 significant
    digits."""
    if isinstance(o, float):
        return float(f"{o:.4g}")
    if isinstance(o, dict):
        return {k: sig4(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return [sig4(v) for v in o]
    return o


def timed_ms(fn, n: int = 50, warmup: int = 5, reps: int = 5) -> float:
    """Median over ``reps`` of (CUDA-event time of ``n`` back-to-back calls)
    / n, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(n):
            fn()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / n)
    return statistics.median(per)


def graph_ms(fn, n: int = 50, reps: int = 5) -> float:
    """Device time per call with the host out of the loop: ``n`` calls
    captured in one CUDA graph, replayed, CUDA-event timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        per.append(s.elapsed_time(e) / n)
    return statistics.median(per)


def bound(nbytes: float, flops: float, peak_flops: float, more=()):
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over their peak.  ``more``: (operations,
    peak) of further units that run beside the first (tensor cores beside
    the CUDA cores); the operation time is the largest of them."""
    tb = nbytes / PEAK_BYTES_S
    tf = max([flops / peak_flops] + [o / p for o, p in more])
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def k8_work(c: int, n: int, sub: int = 16) -> tuple[int, int]:
    """(f32 CUDA-core operations, TF32 tensor-core operations) of K8 for
    one (batch, head) and one chunk of ``c`` steps at head size ``n``, as
    ``csrc/wkv.cu`` computes it: the cumsum and its shift (2 a value);
    diagonal sub-chunk blocks direct (a pair: sub, exp, two multiplies,
    add; the u bonus: two multiplies, add); off-diagonal blocks as the
    product of q and k pre-scaled from the anchor row (sub, exp, multiply
    a value, then 2 a multiply-add); the decay of q (exp, multiply) and
    of k (sub, exp, multiply); the state's decay (multiply, add); and on
    the tensor cores y's triangle ``a @ v``, ``q~ @ S`` and the update
    ``k~^T v``, each three TF32 products (3xTF32)."""
    lens = [min(sub, c - s) for s in range(0, c, sub)]
    f32 = 2 * c * n + 5 * c * n + 2 * n * n + n
    for i, li in enumerate(lens):
        f32 += li * (li - 1) // 2 * n * 5 + li * n * 3
        for lj in lens[:i]:
            f32 += (li + lj) * n * 3 + 2 * li * lj * n
    tc = 3 * (c * (c + 1) * n + 4 * c * n * n)
    return f32, tc


def edge_values(torch, dtype, dev, w_in=10, x_lo=-8.0, x_hi=8.0):
    """Every bin edge and grid point of the input quantizer, each with its
    neighbours one step of ``dtype`` below and above."""
    levels = (1 << w_in) - 1
    k = torch.arange(levels + 1, dtype=torch.float64, device=dev)
    grid = x_lo + torch.cat([k[:-1] + 0.5, k]) / levels * (x_hi - x_lo)
    t = grid.to(dtype)
    ib = torch.int32 if dtype == torch.float32 else torch.int16
    vals = torch.cat([(t.view(ib) + d).view(dtype) for d in (-1, 0, 1)])
    return vals[torch.isfinite(vals)]


def kernel_inputs(torch, rows, dtype, dev, gen):
    """(rows, 3072) inputs: the edge values first, N(0, 3) after."""
    n = rows * 3072
    x = (torch.randn(n, generator=gen, device=dev) * 3).to(dtype)
    e = edge_values(torch, dtype, dev)
    m = min(n, e.numel())
    x[:m] = e[:m]
    return x.view(rows, 3072)


def bits_equal(torch, a, b) -> bool:
    ib = {4: torch.int32, 2: torch.int16, 1: torch.int8}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(ib), b.view(ib))


def k3_sass_counts(build, lib) -> dict:
    """``{kernel: {"HGMMA": n, "UTMALDG": n}}`` over K3's bf16 kernels in
    the built library's SASS (``cuobjdump`` from nvcc's ``bin``); raises
    unless every one of them holds both: the tensor-core route really runs
    wgmma fed by TMA."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            if "k3_tc_kernel" in name:
                counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name in counts:
            for op in ("HGMMA", "UTMALDG"):
                counts[name][op] += op in line
    if not counts or not all(c["HGMMA"] and c["UTMALDG"]
                             for c in counts.values()):
        raise AssertionError(f"K3's bf16 kernels lack HGMMA or UTMALDG in "
                             f"their SASS: {counts}")
    # k3_tc_kernel<8> ... : the template argument is the token tile
    return {"tok" + n.split("kernelILi")[1].split("E")[0]: c
            for n, c in sorted(counts.items())}


def k1_layouts(torch, rows, dtype, dev, gen):
    """The inputs K1 / K2 meet, as ``{label: tensor}``: the ``gate`` and
    ``up`` halves of a ``(rows, 2 x 3072)`` ``[gate|up]`` product (row
    stride 6144, no copy), a flat view one element past a 16-byte
    boundary, and counts 1, 7 and 8k + 3; edge values first in each."""
    x = torch.cat([kernel_inputs(torch, rows, dtype, dev, gen),
                   kernel_inputs(torch, rows, dtype, dev, gen)], dim=-1)
    gate, up = x.chunk(2, dim=-1)
    flat = kernel_inputs(torch, 3, dtype, dev, gen).reshape(-1)
    out = {"gate view": gate, "up view": up, "misaligned": flat[1:8004]}
    for n in (1, 7, 8 * 1000 + 3):
        out[f"count {n}"] = flat[:n]
    if out["misaligned"].data_ptr() % 16 == 0 or gate.is_contiguous():
        raise AssertionError("the strided / misaligned K1 inputs are not")
    return out


def check_k1_layouts(dev, stacks, luts, gen) -> tuple[int, dict]:
    """K1 and K2 bit for bit against their plain versions on
    :func:`k1_layouts`' inputs, f32 and bf16, every layer of every stack
    in ``stacks`` (``{label: stacked entry}``) and every plan in ``luts``
    (``{label: LUTActivation}``) raw and packed.  Returns (cases, the pack
    widths covered per component)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_act import (
        lut_act_plain,
        lut_act_stacked_plain,
    )
    from repro_torch.kernels.packing import COMPONENTS

    widths = {c: set() for c in COMPONENTS}
    cases = 0
    for rows in (B, B * T):
        for dtype in (torch.bfloat16, torch.float32):
            for label, x in k1_layouts(torch, rows, dtype, dev, gen).items():
                if rows == B * T and label.startswith(("count", "mis")):
                    continue   # the same inputs as at rows = B
                for name, st in stacks.items():
                    for c, p in (st["meta"].get("pack") or {}).items():
                        widths[c].add(p["width"])
                    for layer in range(st["meta"]["n_layers"]):
                        yk = ops.lut_act_stacked(x, st, layer)
                        yp = lut_act_stacked_plain(x, st, layer)
                        if yk.shape != x.shape or not bits_equal(torch, yk,
                                                                 yp):
                            raise AssertionError(
                                f"K1 differs from its plain version on "
                                f"{label} {tuple(x.shape)}: {name} layer "
                                f"{layer} {dtype}")
                        cases += 1
                for name, lut in luts.items():
                    for packed in (False, True):
                        pa = lut.plan_arrays(packed=packed, device=dev)
                        for c, p in (pa.pack or {}).items():
                            widths[c].add(p["width"])
                        kw = dict(x_lo=lut.x_lo, x_hi=lut.x_hi,
                                  y_lo=lut.y_lo, y_hi=lut.y_hi)
                        yk = ops.lut_act(x, pa, **kw)
                        yp = lut_act_plain(
                            x, pa.arrays, l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb,
                            w_in=pa.w_in, w_out=pa.w_out, pack=pa.pack, **kw)
                        if yk.shape != x.shape or not bits_equal(torch, yk,
                                                                 yp):
                            raise AssertionError(
                                f"K2 differs from its plain version on "
                                f"{label} {tuple(x.shape)}: {name} "
                                f"packed={packed} {dtype}")
                        cases += 1
    torch.cuda.synchronize()
    return cases, {c: sorted(w) for c, w in widths.items()}


# the PyTorch ops that copy a tensor (what a wrapper runs to make a strided
# input contiguous)
COPY_OPS = ("aten.clone.default", "aten.copy_.default",
            "aten.contiguous.default")


def torch_ops_of(fn) -> list:
    """The PyTorch (aten) ops one call of ``fn`` runs, in order, seen by a
    dispatch mode: a launch wrapper runs its output's allocation and, where
    it copies its input first, that copy; its own kernel is a ``ctypes``
    call, no op."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        fn()
    return rec.ops


def kernels_of(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` launches, in the order
    they ran, from the profiler (CPU and CUDA activity, as phase 12
    traces).  A first trace can miss the device's activity while CUPTI
    starts, so a trace that saw no device event at all is taken again, up
    to three times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # leave the tracer device memory
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        if names:
            return names
    raise AssertionError("the profiler saw no device activity in three "
                         "traces")


def profile_decode_step(launcher, label, scfg, sparams, sbatch, stab,
                        tag="12") -> dict:
    """Where one decode step's time goes: one eager step profiled (wall,
    kernels, copies among them, device busy, idle share, the wrappers'
    launches), then the same step captured in a CUDA graph: one profiled
    replay (its launch counts must be eager's) and the CUDA-event time of
    a replay.  Writes ``chiprun_out/profile_<label>[_captured].txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import CapturedStep

    start = launcher.decode_start(scfg, sbatch)
    logits, cache = launcher.prefill(sparams, scfg, sbatch,
                                     max_seq=start + 2, lut_tables=stab)
    tok = logits[:, -1].argmax(-1)[:, None]
    launcher.decode_step(sparams, scfg, cache, tok, start, stab)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # leave the tracer device memory
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        launcher.decode_step(sparams, scfg, cache, tok, start + 1, stab)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    step_launches = {k: v for k, v in launch_counts().items() if v}
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    copies = sum("copy" in e.name for e in kern)
    out = {"wall_ms": wall * 1e3, "kernels": len(kern),
           "copy_kernels": copies, "device_busy_ms": busy_us / 1e3,
           "idle_share": (1 - busy_us / 1e6 / wall) if kern else None,
           "launches": step_launches, "top_kernels_us": top}
    log(f"[{tag}] decode step ({label}): wall {wall * 1e3:.2f} ms, "
        f"{len(kern)} kernels ({copies} copies), device busy "
        f"{busy_us / 1e3:.2f} ms"
        + (f", idle share {out['idle_share']:.3f}" if kern
           else " (profiler saw no device events: idle not measured)")
        + f"; launches {step_launches}")
    for name, us in top[:5]:
        log(f"    {us:9.1f} us  {name[:90]}")
    (OUT_DIR / f"profile_{label.replace(' ', '_')}.txt").write_text(
        prof.key_averages().table(sort_by="cpu_time_total",
                                  row_limit=40))
    # the same step captured in a CUDA graph and replayed: one profiled
    # replay (wall, kernels, busy, idle share) and the device time per
    # replay from CUDA events over 20 replays
    step = CapturedStep(sparams, scfg, stab)
    step(cache, tok, start + 1)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(cache, tok, start + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    g_launches = {k: v for k, v in launch_counts().items() if v}
    if g_launches != step_launches:
        raise AssertionError(f"decode step ({label}): a replay counted "
                             f"{g_launches}, the eager step "
                             f"{step_launches}")
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    # the device's span of the replay: first kernel start to last end
    span_us = (max(e.time_range.end for e in kern)
               - min(e.time_range.start for e in kern)) if kern else 0
    replay_ms = timed_ms(lambda: step(cache, tok, start + 1), n=20,
                         warmup=2, reps=3)
    out["captured"] = {
        "wall_ms": wall * 1e3, "kernels": len(kern),
        "device_busy_ms": busy_us / 1e3,
        "idle_share": (1 - busy_us / 1e6 / wall) if kern else None,
        "device_span_ms": span_us / 1e3,
        "span_idle_share": (1 - busy_us / span_us) if kern else None,
        "replay_ms": replay_ms, "capture_s": step.capture_s}
    c = out["captured"]
    log(f"[{tag}] captured step ({label}): wall {c['wall_ms']:.2f} ms, "
        f"{len(kern)} kernels, device busy {busy_us / 1e3:.2f} ms"
        + (f", idle share {c['idle_share']:.3f}; the device's span "
           f"{span_us / 1e3:.2f} ms, idle {c['span_idle_share']:.3f} "
           f"of it" if kern else
           " (profiler saw no device events: idle not measured)")
        + f"; {replay_ms:.3f} ms a replay back to back (CUDA events)"
        + f"; capture {step.capture_s:.3f}s; launches as eager")
    (OUT_DIR / f"profile_{label.replace(' ', '_')}_captured.txt"
     ).write_text(prof.key_averages().table(sort_by="cuda_time_total",
                                            row_limit=40))
    del step
    return out


def hmma_by_function(build, lib) -> dict[str, int]:
    """HMMA instructions (tensor-core mma.sync) in each kernel of a built
    library's SASS (``cuobjdump -sass``), by mangled name."""
    cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = line.split("Function :")[1].strip()
            counts[cur] = 0
        elif cur is not None:
            counts[cur] += "HMMA" in line
    return counts


def k8_hmma_count(build, lib) -> int:
    """HMMA instructions in K8's kernel; raises if there are none: y and
    the state update really run on the tensor cores."""
    n = sum(v for k, v in hmma_by_function(build, lib).items()
            if "wkv_kernel" in k)
    if n == 0:
        raise AssertionError("K8's kernel has no HMMA in its SASS")
    return n


def k8b_hmma_counts(build, lib) -> dict[str, int]:
    """HMMA instructions in each of K8b's kernels (``csrc/wkv_bwd.cu``,
    named ``state<N>``, ``scan``, ``grad<N>``); raises unless the state and
    gradient kernels of every head size hold some: their products run on
    the tensor cores (the scan has none)."""
    from repro_torch.kernels.wkv import K8B_HEAD_SIZES

    counts = {}
    for name, n in hmma_by_function(build, lib).items():
        m = re.search(r"wkv_bwd_(\w+?)_kernel(?:ILi(\d+)E)?", name)
        if m:
            counts[m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")] = n
    bare = [f"{k}<{n}>" for n in K8B_HEAD_SIZES for k in ("state", "grad")
            if not counts.get(f"{k}<{n}>")]
    if bare:
        raise AssertionError(f"K8b's kernels in SASS: {counts}; without "
                             f"HMMA: {bare}")
    return counts


# -------------------------------------------------------------------------
# the LUT-NN toolflow's kernels: K5 / K6 (lut_gather.cu), K7 (lutnn_layer.cu)
# -------------------------------------------------------------------------
# (w_in, w_out, w_lb, M) of decomposed plans built directly from a
# decomposition: the golden tests' geometries, w_in 8-14, and w_in 16 with a
# low-bit table of 2^16 entries (256 KB: read from device memory)
GATHER_DECOMPOSED = [(5, 4, 0, 4), (5, 6, 2, 8), (6, 5, 1, 8), (9, 8, 3, 16),
                     (8, 4, 0, 8), (10, 6, 1, 16), (12, 8, 2, 32),
                     (14, 7, 1, 64), (16, 8, 1, 64)]
GATHER_PLAIN = [(5, 3), (7, 6), (12, 8), (16, 8)]   # (w_in, w_out)
# (B, P, N, F, bits) of the paper models' LUT-NN layers
LUTNN_SHAPES = {"jsc-2l L0": (3000, 16, 32, 3, 4),
                "jsc-2l L1": (3000, 32, 5, 3, 4),
                "jsc-5l L0": (20000, 16, 128, 2, 7),
                "mnist L0": (5000, 784, 256, 6, 2)}
# the route k7_plan takes at each: unstaged where a row holds 16 codes
LUTNN_ROUTES = {"jsc-2l L0": "unstaged", "jsc-2l L1": "narrow",
                "jsc-5l L0": "unstaged", "mnist L0": "narrow"}
# 32-bit integer ALU work is counted at the f32 CUDA-core peak: an H100 SM
# issues int32 no faster than f32, so the operation bound stays a lower
# bound on the time
PEAK_INT32_OPS = PEAK_F32_FLOPS


def max_abs_diff(a, b) -> int:
    if a.shape != b.shape:
        return -1
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def decomposed_plan(w_in, w_out, w_lb, m, seed):
    """A decomposed plan of a smooth random table (no plain fallback)."""
    from repro_torch.core import TableSpec
    from repro_torch.core.pipeline import pack_decomposition
    from repro_torch.core.similarity import make_decomposition

    spec = TableSpec.random(w_in, w_out, 0.3, seed, smooth=True)
    hb = spec.values >> w_lb
    lb = (spec.values & ((1 << w_lb) - 1)) if w_lb else None
    d = make_decomposition(hb, spec.care_mask(), m)
    return pack_decomposition(d, w_in=w_in, w_hb=w_out - w_lb, w_lb=w_lb,
                              lb_values=lb, name="g")


def gather_plain(x, pa):
    """The plain version of K5 or K6 for ``pa``'s kind."""
    from repro_torch.kernels.lut_gather import (
        COMPONENTS,
        lut_reconstruct_plain,
        plain_lookup_plain,
    )

    if pa.kind == "plain":
        return plain_lookup_plain(x, pa.arrays["table"])
    return lut_reconstruct_plain(x, *(pa.arrays[c] for c in COMPONENTS),
                                 l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb)


def table_bytes(pa) -> int:
    """Bytes of the tables K5 / K6 stage for ``pa`` (t_lb only when read)."""
    if pa.kind == "plain":
        return pa.arrays["table"].numel() * 4
    return 4 * sum(t.numel() for c, t in pa.arrays.items()
                   if c != "t_lb" or pa.w_lb > 0)


def check_gather_kernels(dev) -> dict:
    """K5 and K6 bit for bit against their plain versions (and the plan's
    own reconstruction), each on tables under and over a block's
    shared-memory limit (neither stages them, but a small table stays in
    L1 and a large one does not), on address counts of every residue mod 4
    and on a view whose data pointer is 4 but not 16 bytes aligned (the
    scalar path).  Returns each kernel's largest difference from its plain
    version."""
    import numpy as np
    import torch

    from repro_torch.core import PlainPlan, TableSpec
    from repro_torch.kernels import PlanArrays, lut_reconstruct

    limit = torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin
    plans = [decomposed_plan(*g, seed=sum(g)) for g in GATHER_DECOMPOSED]
    plans += [PlainPlan(TableSpec.random(w, o, 0.0, 2).values, w, o)
              for w, o in GATHER_PLAIN]
    rng = np.random.default_rng(3)
    covered = {"decomposed": set(), "plain": set()}
    errors = {"lut_reconstruct": 0, "plain_lookup": 0}
    cases = 0
    for plan in plans:
        pa = PlanArrays.from_plan(plan, device=dev)
        name = "plain_lookup" if pa.kind == "plain" else "lut_reconstruct"
        nbytes = table_bytes(pa)
        covered[pa.kind].add("under" if nbytes <= limit else "over")
        size = 1 << plan.w_in
        full = torch.arange(size, dtype=torch.int32, device=dev)
        addr = lambda *s: torch.as_tensor(rng.integers(0, size, s),
                                          dtype=torch.int32, device=dev)
        view = addr(4100)[1:]   # 4099 addresses, 4 bytes past an alignment
        if view.data_ptr() % 16 != 4:
            raise AssertionError("the misaligned view is aligned")
        queries = [full, view] + [addr(*s) for s in (
            (), (1,), (1000,), (3, 37), (1 << 20,), (4097,), (4098,),
            (4099,))]
        for x in queries:
            yk = lut_reconstruct(x, pa)
            yp = gather_plain(x, pa)
            errors[name] = max(errors[name], max_abs_diff(yk, yp))
            if yk.shape != x.shape or not torch.equal(yk, yp):
                raise AssertionError(
                    f"{pa.kind} plan w_in {plan.w_in} ({nbytes} table "
                    f"bytes): kernel differs from its plain version on "
                    f"query shape {tuple(x.shape)} (data pointer mod 16: "
                    f"{x.data_ptr() % 16})")
            cases += 1
        if not np.array_equal(lut_reconstruct(full, pa).cpu().numpy(),
                              plan.reconstruct()):
            raise AssertionError(f"{pa.kind} plan w_in {plan.w_in}: kernel "
                                 f"differs from plan.reconstruct()")
    torch.cuda.synchronize()
    # neither kernel stages its tables, but each is held on tables of
    # either size
    for kind, seen in covered.items():
        if seen != {"under", "over"}:
            raise AssertionError(f"{kind} plans covered only tables {seen} "
                                 f"the {limit}-byte limit")
    log(f"[6] K5/K6 bit-exact against their plain versions and "
        f"plan.reconstruct() on {cases} (plan, query) cases: tables under "
        f"and over a block's {limit}-byte shared-memory limit, address "
        f"counts 4k+1, 4k+2, 4k+3 and a view 4 bytes past a 16-byte "
        f"alignment")
    return errors


def lutnn_inputs(dev, rng, b, p, n, f, bits):
    """Random in-range (codes, conn, tables) int32 tensors on ``dev``."""
    import torch

    as_t = lambda a: torch.as_tensor(a, dtype=torch.int32, device=dev)
    return (as_t(rng.integers(0, 1 << bits, (b, p))),
            as_t(rng.integers(0, p, (n, f))),
            as_t(rng.integers(0, 1 << bits, (n, 1 << (bits * f)))))


# the kernel each K7 route launches, as the profiler names it
K7_KERNELS = {"narrow": "lutnn_tile_kernel<unsigned char>",
              "int32": "lutnn_tile_kernel<unsigned int>",
              "unstaged": "lutnn_unstaged_kernel"}


def k7_route(dev, b, p, n, f, bits):
    """K7's plan for a shape on ``dev`` (kernels/lutnn_layer.py)."""
    from repro_torch.kernels.lut_act import sm_count
    from repro_torch.kernels.lutnn_layer import k7_plan, smem_optin

    return k7_plan(b, p, n, f, bits, 1 << (bits * f), sm_count=sm_count(dev),
                   smem_limit=smem_optin(dev))


def check_lutnn_layer(dev) -> int:
    """K7 bit for bit against its plain version: a sweep of ragged sizes,
    the paper models' layer shapes, a case on each route (codes staged one
    byte each, staged as int32 at bits 9, unstaged where one row of codes
    does not fit a block's shared memory and where a row holds at most 16
    codes), row counts that leave a ragged last tile on every staged
    route, a tile past the 48 KB a block takes without opting in, two
    launches bit-identical and a CUDA-graph replay equal to eager on each
    route, and the profiler's kernel names: at the paper shapes the kernel
    of the route ``LUTNN_ROUTES`` names, each route's own kernel on its
    case.  Returns the largest difference from the plain version."""
    import numpy as np
    import torch

    from repro_torch.kernels import lutnn_layer
    from repro_torch.kernels.lutnn_layer import lutnn_layer_plain, smem_optin

    rng = np.random.default_rng(4)
    shapes = [(b, 50, n, f, bits) for b in (1, 7, 300) for n in (1, 13, 40)
              for f in range(2, 7) for bits in range(1, 8)
              if bits * f <= 14]
    shapes += list(LUTNN_SHAPES.values())
    # one row of codes past what a block can stage beside the wiring
    p_over = smem_optin(dev) + 1
    routes = {"narrow": (5000, 784, 256, 6, 2),
              "int32": (301, 50, 13, 2, 9),
              "unstaged": (5, p_over, 40, 3, 4)}
    ragged = [(b + 1, p, n, f, bits)
              for b, p, n, f, bits in LUTNN_SHAPES.values()]
    # a tile of three rows of 60000 codes: past the 48 KB a block takes
    # without opting in
    big = (500, 60000, 40, 3, 4)
    if k7_route(dev, *big).smem <= 48 * 1024:
        raise AssertionError(f"K7 at {big} stays under 48 KB")
    ragged += [(1697, 16, 128, 2, 7), (4099, 50, 40, 2, 9), big]
    shapes += list(routes.values()) + ragged
    err = 0
    seen = {}
    for b, p, n, f, bits in shapes:
        plan = k7_route(dev, b, p, n, f, bits)
        codes, conn, tables = lutnn_inputs(dev, rng, b, p, n, f, bits)
        yk = lutnn_layer(codes, conn, tables, bits=bits)
        yp = lutnn_layer_plain(codes, conn, tables, bits=bits)
        err = max(err, max_abs_diff(yk, yp))
        if yk.shape != (b, n) or not torch.equal(yk, yp):
            raise AssertionError(
                f"K7 differs from its plain version at B {b}, P {p}, N {n}, "
                f"F {f}, bits {bits} ({plan})")
        if plan.route != "unstaged" and b % plan.rows:
            seen.setdefault(plan.route, []).append((b, plan.rows))
    if set(seen) != {"narrow", "int32"}:
        raise AssertionError(f"ragged last tiles seen only on {seen}")
    repeat = dict(LUTNN_SHAPES, int32=routes["int32"],
                  unstaged=routes["unstaged"], **{"past 48 KB": big})
    fns, want = {}, {}
    for label, (b, p, n, f, bits) in repeat.items():
        want[label] = LUTNN_ROUTES.get(
            label, label if label in routes else "narrow")
        route = k7_route(dev, b, p, n, f, bits).route
        if route != want[label]:
            raise AssertionError(f"K7 at {label} {(b, p, n, f, bits)} "
                                 f"plans the {route} route, not "
                                 f"{want[label]}")
        codes, conn, tables = lutnn_inputs(dev, rng, b, p, n, f, bits)
        fns[label] = functools.partial(lutnn_layer, codes, conn, tables,
                                       bits=bits)
    names = {}
    for label, fn in fns.items():
        # 16 launches a trace: the profiler can miss the first launches
        # of a trace while CUPTI starts
        seen_names = set(kernels_of(lambda: [fn() for _ in range(16)]))
        names[label] = seen_names.pop()
        if seen_names or K7_KERNELS[want[label]] not in names[label]:
            raise AssertionError(f"K7 at {label} launched {names[label]} "
                                 f"and {seen_names}, not its "
                                 f"{want[label]} kernel")
        y1, y2 = fn(), fn()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            yg = fn()
        yg.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        if not (torch.equal(y1, y2) and torch.equal(y1, yg)):
            raise AssertionError(f"K7 at {label} {repeat[label]}: two "
                                 f"launches or a graph replay differ")
    torch.cuda.synchronize()
    log(f"[7] K7 bit-exact against its plain version on {len(shapes)} "
        f"shapes (B 1/7/300 x N 1/13/40 x F 2-6 x bits 1-7 with "
        f"bits*F <= 14, {', '.join(LUTNN_SHAPES)}, each route: "
        + ", ".join(f"{r} {s}" for r, s in routes.items())
        + f"; ragged last tiles (B, rows per tile): {seen}); two launches "
        f"and a graph replay bit-identical, and each launches its route's "
        f"kernel: " + ", ".join(f"{k} {v[:48]}" for k, v in names.items()))
    return err


# the toolflow of phase 8: jsc-2l at paper width (model.py::paper_model) and
# the launcher's data sizes, 12 epochs; jsc-5l and mnist at the paper's
# data scale are phase 21's
TOOLFLOWS = {"jsc-2l": []}


def run_lutnn(dev, model: str, extra: list) -> dict:
    """One toolflow through ``repro_torch.launch.lutnn.run`` on the card,
    launch counts zeroed before it and read after it: K5 / K6 once per
    decomposed / plain plan, K7 once per chunk, layer and table-network
    pass (the don't-care marking on the training set, then test and
    training accuracy before and after).  Records every K7 call's (B, P,
    N, F, bits) by layer, with the first such call's inputs and the number
    of such calls, as ``"k7_calls"``: ``{(layer, shape): ((codes, conn,
    tables), calls)}``."""
    import torch

    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.launch import lutnn
    from repro_torch.lutnn.inference import CHUNK

    argv = ["--model", model, *extra]
    if model == "jsc-2l":
        argv += ["--verilog-out", str(OUT_DIR / "jsc2l_reducedlut.v")]
    args = lutnn.parse_args(argv)
    calls, layers = {}, {}
    orig = ops.lutnn_layer_cuda

    def spy(codes, conn, tables, *, bits):
        # every pass hands a layer the same wiring tensor, and the first
        # chunk of the first pass meets the layers in order
        layer = layers.setdefault(conn.data_ptr(), len(layers))
        shape = (*codes.shape, *conn.shape, bits)
        inputs, seen = calls.get((layer, shape), ((codes, conn, tables), 0))
        calls[layer, shape] = (inputs, seen + 1)
        return orig(codes, conn, tables, bits=bits)

    ops.lutnn_layer_cuda = spy
    reset_launch_counts()
    try:
        out = lutnn.run(args, log=lambda m: log("    " + m))
        torch.cuda.synchronize()
    finally:
        ops.lutnn_layer_cuda = orig
    counts = launch_counts()
    if not out["device"].startswith("cuda"):
        raise AssertionError(f"the toolflow ran on {out['device']}")
    chunks = {k: -(-v // CHUNK) for k, v in out["samples"].items()}
    want = {"lut_reconstruct": out["plans"]["decomposed"],
            "plain_lookup": out["plans"]["plain"],
            "lutnn_layer": out["layers"] * (3 * chunks["train"]
                                            + 2 * chunks["test"])}
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{model}: {name} launched {counts[name]} "
                                 f"times, not {n}: {counts}")
    if counts["lut_reconstruct"] == 0:
        raise AssertionError(f"{model}: the toolflow did not launch K5: "
                             f"{counts}")
    if sum(c for _, c in calls.values()) != counts["lutnn_layer"]:
        raise AssertionError(f"{model}: {counts['lutnn_layer']} K7 launches"
                             f" counted, {calls.values()} recorded")
    acc, pl = out["accuracy"], out["pluts"]
    log(f"[8] toolflow {out['model']} on {out['device']} ({out['samples']} "
        f"samples, {args.epochs} epochs): P-LUTs baseline "
        f"{pl['baseline']}, CompressedLUT {pl['compressedlut']}, "
        f"ReducedLUT {pl['reducedlut']}; train acc {acc['train_before']:.4f}"
        f" -> {acc['train_after']:.4f} (equal), test acc "
        f"{acc['test_before']:.4f} -> {acc['test_after']:.4f}; seconds "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds"].items())
        + f"; launches {counts}; K7 (layer, (B, P, N, F, bits)): calls "
        + ", ".join(f"{k} {c}" for k, (_, c) in sorted(calls.items())))
    out["launches"] = counts
    out["k7_calls"] = calls
    return out


def check_captured_training(dev) -> dict:
    """LUT-NN training through the captured step (``lutnn/train.py::
    CapturedTrainStep``) against the eager loop (``graph=False``) on the
    card: each paper model from the same start on the same batches, every
    parameter and metric bit for bit.  Returns each run's seconds."""
    import torch

    from repro_torch.data import make_jsc, make_mnist_like
    from repro_torch.lutnn import train_lutnn
    from repro_torch.lutnn.model import paper_model

    seconds = {}
    for model, make, epochs in (("jsc-2l", make_jsc, 3),
                                ("jsc-5l", make_jsc, 2),
                                ("mnist", make_mnist_like, 2)):
        cfg = paper_model(model)
        data = make(6000, 1000) if make is make_jsc else make(3000, 500)
        runs = {}
        for graph in (False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net, _, metrics = train_lutnn(cfg, *data, epochs=epochs,
                                          device=dev, graph=graph)
            torch.cuda.synchronize()
            seconds[model, graph] = time.perf_counter() - t0
            runs[graph] = (net.state_dict(), metrics)
        (eager, m_e), (graph, m_g) = runs[False], runs[True]
        bad = [k for k in eager if not bits_equal(torch, eager[k], graph[k])]
        if bad or m_e != m_g:
            raise AssertionError(f"{model}: captured training differs from "
                                 f"eager in {bad}, metrics {m_g} vs {m_e}")
    log("[8] LUT-NN training through the captured step equals the eager "
        "loop bit for bit (every parameter, loss, accuracies) on jsc-2l, "
        "jsc-5l and mnist; seconds eager / captured: " + ", ".join(
            f"{m} {seconds[m, False]:.2f} / {seconds[m, True]:.2f}"
            for m in ("jsc-2l", "jsc-5l", "mnist")))
    return {f"{m} {'captured' if g else 'eager'}": v
            for (m, g), v in seconds.items()}


def run_toolflow(dev) -> dict:
    """The paper's LUT-NN toolflow at full paper width through the
    launcher's functions: jsc-2l, then the quickstart; launch counts
    zeroed before each and read after it."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import quickstart

    training = check_captured_training(dev)
    flows = {"jsc-2l": run_lutnn(dev, "jsc-2l", TOOLFLOWS["jsc-2l"])}
    reset_launch_counts()
    q = quickstart.run(log=lambda m: log("    " + m))
    torch.cuda.synchronize()
    qcounts = launch_counts()
    if qcounts["lut_reconstruct"] + qcounts["plain_lookup"] != 4 or \
            qcounts["plain_lookup"] == 0:
        raise AssertionError(f"the quickstart launched {qcounts} for its "
                             f"four plans (one plain)")
    log(f"[8] quickstart: CompressedLUT {q['compressedlut']}, ReducedLUT "
        f"{q['reducedlut_20']} / {q['reducedlut_250']} P-LUTs (ex 20 / 250),"
        f" care-exact {q['care_exact']}; launches {qcounts}")
    # the slice's main path: every entry point
    return {"flows": flows, "quickstart": dict(q, launches=qcounts),
            "captured_training_s": training,
            "main_launches": {
                k: qcounts[k] + sum(f["launches"][k] for f in flows.values())
                for k in qcounts}}


def n_unique(t) -> int:
    import torch

    return int(torch.unique(t).numel())


def gather_work(pa, x):
    """(bytes, ops) K5 / K6 needs for addresses ``x``: each address read
    and each output written once, and each table entry these addresses
    touch read once."""
    import torch

    n = x.numel()
    if pa.kind == "plain":
        return 4 * (2 * n + n_unique(x)), n
    xl = x.long()
    hb = xl >> pa.l
    idx = pa.arrays["t_idx"][hb].long()
    touched = 3 * n_unique(hb) + n_unique(idx * (1 << pa.l)
                                          + (xl & ((1 << pa.l) - 1)))
    if pa.w_lb > 0:
        touched += n_unique(xl)
    return 4 * (2 * n + touched), 12 * n


def lutnn_work(codes, conn, tables, bits):
    """(bytes, ops) K7 needs: the code columns the wiring reads, the
    wiring, the table entries the addresses touch, and the output."""
    import torch

    from repro_torch.kernels.lutnn_layer import pack_addresses

    b = codes.shape[0]
    n, f = conn.shape
    rows = torch.arange(n, device=codes.device)
    touched = n_unique(rows * tables.shape[1]
                       + pack_addresses(codes, conn, bits))
    nbytes = 4 * (b * n_unique(conn) + n * f + touched + b * n)
    return nbytes, b * n * (3 * f + 2)


def k7_other_route(dev, codes, conn, tables, bits):
    """``(plan, launch)`` of K7 on the route ``k7_plan`` does not take
    for this shape (staged where it plans unstaged, where a row fits;
    else unstaged), through ``lutnn_layer_cuda`` with that plan; ``(None,
    None)`` where no other route fits.  The yardstick of the plan's
    choice in the same run; not a wrapper launch, so it is not counted."""
    from repro_torch.kernels.lut_act import sm_count
    from repro_torch.kernels.lutnn_layer import (
        k7_staged_plan,
        k7_unstaged_plan,
        lutnn_layer_cuda,
        smem_optin,
    )

    b, p = codes.shape
    n, f = conn.shape
    if k7_route(dev, b, p, n, f, bits).route != "unstaged":
        plan = k7_unstaged_plan(b)
    else:
        plan = k7_staged_plan(b, p, n, f, bits, sm_count=sm_count(dev),
                              smem_limit=smem_optin(dev))
    if plan is None:
        return None, None
    return plan, functools.partial(lutnn_layer_cuda, codes, conn, tables,
                                   bits=bits, plan=plan)


def time_toolflow_kernels(dev, flow, errors, p21) -> list:
    """Per-kernel times of K5, K6 and K7 at the toolflow's shapes and at
    phase 21's; their launches on the main path are phase 8's and phase
    21's."""
    import numpy as np
    import torch

    from repro_torch.core import PlainPlan
    from repro_torch.kernels import PlanArrays, lut_reconstruct, lutnn_layer
    from repro_torch.kernels.lutnn_layer import lutnn_layer_plain

    launches = {k: flow["main_launches"][k] + p21["launches"][k]
                for k in ("lut_reconstruct", "plain_lookup", "lutnn_layer")}
    plan = next(p for p in flow["flows"]["jsc-2l"]["plan_list"]
                if p.kind == "decomposed")
    plain = PlainPlan(plan.reconstruct(), plan.w_in, plan.w_out)
    rng = np.random.default_rng(5)
    size = 1 << plan.w_in
    queries = {"one table": torch.arange(size, dtype=torch.int32,
                                         device=dev),
               "2^20 addresses": torch.as_tensor(
                   rng.integers(0, size, 1 << 20), dtype=torch.int32,
                   device=dev)}
    kernels = []
    for name, p, line in (("lut_reconstruct", plan, 43),
                          ("plain_lookup", plain, 83)):
        pa = PlanArrays.from_plan(p, device=dev)
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/lut_gather.cu",
                 "replaces": f"src/repro/kernels/lut_gather.py:{line}",
                 "launches": launches[name],
                 "max_abs_err": errors[name], "shapes": {}}
        for label, x in queries.items():
            nbytes, ops_ = gather_work(pa, x)
            bms, by = bound(nbytes, ops_, PEAK_INT32_OPS)
            t = {"shape": list(x.shape),
                 "ms": timed_ms(lambda: lut_reconstruct(x, pa)),
                 "graph_ms": graph_ms(lambda: lut_reconstruct(x, pa)),
                 "plain_ms": timed_ms(lambda: gather_plain(x, pa)),
                 "bound_ms": bms, "bound_by": by, "library_ms": None}
            if name == "plain_lookup":
                # torch.take indexes with int64 addresses
                table, xl = pa.arrays["table"], x.long()
                t["library_ms"] = timed_ms(lambda: torch.take(table, xl))
                t["library_graph_ms"] = graph_ms(
                    lambda: torch.take(table, xl))
            if not entry["shapes"]:
                entry.update({k: v for k, v in t.items()})
            entry["shapes"][label] = t
        kernels.append(entry)

    entry = {"name": "lutnn_layer", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/lutnn_layer.cu",
             "replaces": "src/repro/kernels/lutnn_layer.py:40",
             "launches": launches["lutnn_layer"],
             "max_abs_err": errors["lutnn_layer"], "shapes": {}}
    # the paper models' layer shapes on random in-range codes, then every
    # (layer, shape) the toolflow and phase 21's sweeps handed K7, on their
    # own inputs; each held bit for bit against the plain version and
    # against the other route, which is timed beside it
    cases = {label: (lutnn_inputs(dev, rng, *shape), shape[-1], 50, 0)
             for label, shape in LUTNN_SHAPES.items()}
    sources = [(f"{m} toolflow", fl["k7_calls"])
               for m, fl in flow["flows"].items()]
    sources += [(f"{m} bench", c) for m, c in p21["k7_calls"].items()]
    for tag, k7_calls in sources:
        for (layer, shape), (inputs, calls) in sorted(k7_calls.items()):
            cases[f"{tag} L{layer} B {shape[0]}"] = (inputs, shape[-1], 10,
                                                     calls)
    path = {"calls": 0, "plan_ms": 0.0, "other_ms": 0.0}
    for label, ((codes, conn, tables), bits, n_plain, calls) in \
            cases.items():
        shape = [*codes.shape, *conn.shape, bits]
        kfn = lambda: lutnn_layer(codes, conn, tables, bits=bits)
        want = lutnn_layer_plain(codes, conn, tables, bits=bits)
        other, ofn = k7_other_route(dev, codes, conn, tables, bits)
        if not torch.equal(kfn(), want) or (
                ofn is not None and not torch.equal(ofn(), want)):
            raise AssertionError(f"K7 differs from its plain version at "
                                 f"{label} {shape}")
        nbytes, ops_ = lutnn_work(codes, conn, tables, bits)
        bms, by = bound(nbytes, ops_, PEAK_INT32_OPS)
        t = {"shape": shape, "ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
             "plain_ms": timed_ms(lambda: lutnn_layer_plain(
                 codes, conn, tables, bits=bits), n=n_plain),
             "bound_ms": bms, "bound_by": by, "library_ms": None,
             "plan": list(k7_route(dev, *shape)), "calls": calls,
             "other_plan": None if other is None else list(other),
             "other_graph_ms": None if ofn is None else graph_ms(ofn)}
        if calls and ofn is not None:
            path["calls"] += calls
            path["plan_ms"] += calls * t["graph_ms"]
            path["other_ms"] += calls * t["other_graph_ms"]
        if not entry["shapes"]:
            entry.update(t)
        entry["shapes"][label] = t
    recorded = sum(1 for t in entry["shapes"].values() if t["calls"])
    if path["calls"] != launches["lutnn_layer"]:
        raise AssertionError(f"K7's recorded calls {path} are not the "
                             f"path's {launches['lutnn_layer']} launches")
    entry["path"] = path
    log(f"[11] K7 bit-exact against its plain version and its other route "
        f"at {len(cases)} shapes, {recorded} of them the (layer, shape) "
        f"cases the toolflow and phase 21 recorded; over the path's "
        f"{path['calls']} launches, from a graph: the plan's routes "
        f"{path['plan_ms'] * 1e3:.2f} us, the other routes "
        f"{path['other_ms'] * 1e3:.2f} us")
    kernels.append(entry)
    for k in kernels:
        for label, t in k["shapes"].items():
            log(f"[11] {k['name']} {label} {t['shape']}: {t['ms'] * 1e3:.2f} "
                f"us/launch (graph {t['graph_ms'] * 1e3:.2f} us), bound "
                f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), plain "
                f"{t['plain_ms'] * 1e3:.2f} us"
                + ("" if t["library_ms"] is None else
                   f", library {t['library_ms'] * 1e3:.2f} us (graph "
                   f"{t['library_graph_ms'] * 1e3:.2f} us)")
                + (f"; plan {t['plan']}" if "plan" in t else "")
                + (f"; other route {t['other_plan']} "
                   f"{t['other_graph_ms'] * 1e3:.2f} us (graph); "
                   f"{t['calls']} calls on the path"
                   if t.get("other_graph_ms") is not None else "")
                + f"; launches {k['launches']} (toolflow, quickstart and "
                  f"phase 21)")
    return kernels


# -------------------------------------------------------------------------
# the multi-site kernel K4 (lut_act_multi.cu) and the WKV kernel K8 (wkv.cu)
# -------------------------------------------------------------------------
# K4 segment lengths: one per per-layer site, different, one not a multiple
# of a block's elements, one past the per-segment block cap in both dtypes
# (a full card of resident threads at 16 bytes a thread: the kernel strides;
# kernels/lut_act.py::k4_plan)
MULTI_LENGTHS = (B * 3072, (1 << 22) + 3, 4, 5120 + 37)
# the element counts qwen3-0.6b form (f) hands K4 one site a call, at B
# requests of T tokens and a cache of T + NEW: decode attn_exp (4, 8, 2, 1,
# 80), norm_rsqrt (4, 1, 1), rope_table (1, 64); prefill (4, 8, 2, 64, 64),
# (4, 64, 1), (64, 64).  Phase 11 requires that the served calls have no
# other count.
SERVED_K4 = (5120, 4, 64, 262144, 256, 4096)


def site_edge_inputs(torch, entry, site, n, dtype, dev, gen):
    """``n`` inputs for ``site`` of a multi-site entry: every quantizer
    edge and grid point of its domain +-1 ulp of ``dtype`` first, then
    uniform draws across (and 5% beyond) the domain."""
    sm = entry["meta"]["site_meta"][site]
    lo, hi = sm["x_lo"], sm["x_hi"]
    span = hi - lo
    x = (torch.rand(n, generator=gen, device=dev) * 1.1 * span
         + (lo - 0.05 * span)).to(dtype)
    e = edge_values(torch, dtype, dev, w_in=sm["w_in"], x_lo=lo, x_hi=hi)
    e = e[torch.randperm(e.numel(), generator=gen, device=dev)]
    m = min(n, e.numel())
    x[:m] = e[:m]
    return x


def k4_held(torch, yk, yp, y1, what) -> None:
    """Fail unless K4's ``yk`` equals the plain K4's ``yp`` and K1's ``y1``
    bit for bit."""
    if not (bits_equal(torch, yk, yp) and bits_equal(torch, yk, y1)):
        raise AssertionError(
            f"K4 differs from its plain version or from K1: {what} "
            f"({int((yk != yp).sum())} / {int((yk != y1).sum())} elements)")


def check_multisite(dev, entry, gen) -> tuple[float, int]:
    """K4 bit for bit against its plain version and, per site, against K1
    on that site's slice of the super-slab, f32 and bf16, every layer:
    every per-layer site in one launch (the 8-segment entry, 16 bytes a
    thread), and each site alone (the served call's entry) at every count
    of ``SERVED_K4``, at the start of a buffer and one element past it,
    in both of its modes (one element a thread, 16 bytes a thread); two
    launches bit-identical; at the middle layer a single-site call and the
    all-sites call captured in a CUDA graph and replayed give eager's
    bits; an entry without its launch record is refused before anything
    launches.  Returns (largest difference, cases)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.lut_act import k4_plan, lut_act_multi_plain
    from repro_torch.serve.stacked import multi_site_stacked_entry

    sites = entry["meta"]["sites"]
    slices = {s: multi_site_stacked_entry(entry, s) for s in sites}
    n_layers = entry["meta"]["n_layers"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err, cases, modes = 0.0, 0, set()

    def same(a, b) -> bool:
        return all(bits_equal(torch, a[s], b[s]) for s in a)

    for dtype in (torch.float32, torch.bfloat16):
        xs = {s: site_edge_inputs(torch, entry, s, n, dtype, dev, gen)
              for s, n in zip(sites, MULTI_LENGTHS)}
        threads, vec, blocks = k4_plan(tuple(x.numel() for x in xs.values()),
                                       dtype, sm_count=sms)
        if max(blocks) < sms * 2048 // threads and len(sites) > 1:
            raise AssertionError(f"no segment of {MULTI_LENGTHS[:len(sites)]}"
                                 f" is past its block cap: {blocks}")
        for layer in range(n_layers):
            yk = ops.lut_act_multi(xs, entry, layer)
            yp = lut_act_multi_plain(xs, entry, layer)
            if not same(yk, ops.lut_act_multi(xs, entry, layer)):
                raise AssertionError(f"K4: two launches differ at layer "
                                     f"{layer} {dtype}")
            for s, x in xs.items():
                err = max(err, float((yk[s].float() - yp[s].float()).abs()
                                     .max()))
                k4_held(torch, yk[s], yp[s],
                        ops.lut_act_stacked(x, slices[s], layer),
                        f"all sites, site {s} layer {layer} {dtype}")
                cases += 1
        for s in sites:
            for n in SERVED_K4:
                buf = site_edge_inputs(torch, entry, s, n + 1, dtype, dev,
                                       gen)
                modes.add(k4_plan((n,), dtype, sm_count=sms)[1])
                for off, x in ((0, buf[:n]), (1, buf[1:])):
                    for layer in range(n_layers):
                        yk = ops.lut_act_multi({s: x}, entry, layer)[s]
                        yp = lut_act_multi_plain({s: x}, entry, layer)[s]
                        err = max(err, float((yk.float() - yp.float())
                                             .abs().max()))
                        k4_held(torch, yk, yp,
                                ops.lut_act_stacked(x, slices[s], layer),
                                f"site {s} alone, {n} elements at offset "
                                f"{off}, layer {layer} {dtype}")
                        cases += 1
        mid = n_layers // 2
        for group in [{s: xs[s][:5120]} for s in sites] + [xs]:
            eager = ops.lut_act_multi(group, entry, mid)
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                replayed = ops.lut_act_multi(group, entry, mid)
            g.replay()
            torch.cuda.synchronize()
            if not same(replayed, eager):
                raise AssertionError(f"K4 replayed from a CUDA graph differs "
                                     f"from eager: {sorted(group)} {dtype}")
    if not (1 in modes and max(modes) > 1):
        raise AssertionError(f"K4's single-site checks ran in modes {modes}"
                             f" (elements a thread); both 1 and 16 bytes' "
                             f"worth are served")
    bare = {k: v for k, v in entry.items() if k != "k4_record"}
    before = ops.lut_act_multi.launches
    try:
        ops.lut_act_multi(xs, bare, 0)
    except ValueError as e:
        if "launch record" not in str(e):
            raise
    else:
        raise AssertionError("K4 ran on an entry without its launch record")
    if ops.lut_act_multi.launches != before:
        raise AssertionError("K4 launched on an entry without its record")
    torch.cuda.synchronize()
    return err, cases


def wkv_cases(torch, dev, gen, layer0):
    """K8's comparison cases at rwkv6-3b's prefill shape: layer 0's inputs
    from the real prefill, random inputs with strong and with weak decay,
    ``log_w`` at the model's bound ``-e`` and at ``-30`` on every step, a
    ragged T, chunk 16, and a given initial state."""
    q0, k0, v0, lw0, u0 = layer0
    b, t, h, n = q0.shape

    def rnd(hi):
        q, k, v = (torch.randn(b, t, h, n, generator=gen, device=dev)
                   for _ in range(3))
        lw = -torch.exp(torch.rand(b, t, h, n, generator=gen, device=dev)
                        * (hi + 3.0) - 3.0)
        return q, k, v, lw, torch.randn(h, n, generator=gen, device=dev)

    strong, weak = rnd(0.7), rnd(-1.0)   # log_w = -exp(U(-3, hi))
    s0 = torch.randn(b, h, n, n, generator=gen, device=dev) * 0.1
    at = lambda lw: strong[:3] + (torch.full_like(strong[3], lw), strong[4])
    return {
        "layer-0 prefill": ((q0, k0, v0, lw0, u0), 64, None),
        "strong decay": (strong, 64, None),
        "weak decay": (weak, 64, None),
        "log_w = -e": (at(-math.e), 64, None),
        "log_w = -30, initial state": (at(-30.0), 64, s0),
        "ragged T 48": (tuple(a[:, :48] for a in strong[:4])
                        + (strong[4],), 64, None),
        "ragged T 37, chunk 16, initial state": (
            tuple(a[:, :37] for a in strong[:4]) + (strong[4],), 16, s0),
        "chunk 16": (strong, 16, None),
        "initial state": (weak, 64, s0),
    }


def check_wkv(dev, cases) -> float:
    """K8 against its plain version on the card, ``rtol = atol = 1e-4`` on
    y and on the final state, finite, and two launches bit-identical.
    Returns the largest absolute difference."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv import k8_plan, wkv_chunked_plain

    worst = 0.0
    for name, (args, chunk, s0) in cases.items():
        yk, sk = ops.wkv(*args, chunk=chunk, state=s0)
        y2, s2 = ops.wkv(*args, chunk=chunk, state=s0)
        yp, sp = wkv_chunked_plain(*args, chunk=chunk, state=s0)
        torch.cuda.synchronize()
        if not (torch.equal(yk, y2) and torch.equal(sk, s2)):
            raise AssertionError(f"K8 {name}: two launches differ")
        if not (torch.isfinite(yk).all() and torch.isfinite(sk).all()):
            raise AssertionError(f"K8 {name}: inf or nan")
        ey = float((yk - yp).abs().max())
        es = float((sk - sp).abs().max())
        worst = max(worst, ey, es)
        ok = (torch.allclose(yk, yp, rtol=1e-4, atol=1e-4)
              and torch.allclose(sk, sp, rtol=1e-4, atol=1e-4))
        log(f"    K8 {name} {tuple(args[0].shape)} chunk {chunk} "
            f"({k8_plan(*args[0].shape, chunk)}): max |y - plain| {ey:.3e}, "
            f"max |state - plain| {es:.3e} (|y| <= "
            f"{float(yp.abs().max()):.3g}); two launches bit-identical")
        if not ok:
            raise AssertionError(f"K8 differs from its plain version beyond "
                                 f"rtol = atol = 1e-4: {name}")
    return worst


def check_fused_nongated(dev, params, multi, lut, gen, site="ffn"):
    """K3 non-gated at rwkv6-3b's ``ffn`` shape and around it, through
    :func:`check_fused_case`: the serving M at three layers, the ragged M,
    an N that is not a multiple of the 128-column tile, a K that is not a
    multiple of S x 64 (stacked tables, held against K1), and ``lut``'s
    per-plan tables (held against K2).  Returns (largest difference from
    the plain path, {case: share differing})."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.stacked import multi_site_stacked_entry

    ws = params.blocks["w_ffn_k"]
    n_layers, k, n = ws.shape
    sl = multi_site_stacked_entry(multi, site)
    tab = lambda layer: {"multi_entry": multi, "site": site, "layer": layer}
    k1 = lambda layer: (lambda h: ops.lut_act_stacked(h, sl, layer))
    pa = lut.plan_arrays(packed=True, device=dev)
    ptab = {"meta": dict(lut.meta(), pack=pa.pack), "arrays": pa.arrays}
    k2 = lambda h: ops.lut_act(h, pa, x_lo=lut.x_lo, x_hi=lut.x_hi,
                               y_lo=lut.y_lo, y_hi=lut.y_hi)
    rand_x = lambda m, kk: torch.randn(m, kk, generator=gen, device=dev).to(
        ws.dtype)
    wstd = float(ws[0].float().std())
    rand_w = lambda kk, nn: (torch.randn(kk, nn, generator=gen, device=dev)
                             * wstd).to(ws.dtype)
    mid = n_layers // 2
    cases = [(f"M={m} layer {layer}", rand_x(m, k), ws[layer], tab(layer),
              k1(layer))
             for m in (B, B * T) for layer in (0, mid, n_layers - 1)]
    cases += [(f"M={m}", rand_x(m, k), ws[mid], tab(mid), k1(mid))
              for m in RAGGED_M]
    cases += [(f"M={m} per-plan", rand_x(m, k), ws[mid], ptab, k2)
              for m in (B, 67)]
    w_n, w_k = rand_w(k, 1000), rand_w(1032, n)
    for m in (B, 67):
        cases += [(f"N=1000 M={m}", rand_x(m, k), w_n, tab(mid), k1(mid)),
                  (f"K=1032 M={m}", rand_x(m, 1032), w_k, tab(mid), k1(mid))]
    err, share = 0.0, {}
    for label, x, w, t, lut_fn in cases:
        e, sh = check_fused_case(x, w, t, lut_fn, gated=False,
                                 label=f"non-gated {label}")
        err, share[label] = max(err, e), sh
    torch.cuda.synchronize()
    log(f"[9] K3 (non-gated) on {len(cases)} cases: bit-exact against its "
        f"own GEMM + K1 / K2, two launches bit-identical, share differing "
        f"from torch.matmul + plain LUT at most {max(share.values()):.6f}")
    return err, share


# K3's ragged token counts: 1, 3, 5 and 67 fill no token tile; 257 is one
# token past a multiple of every tile
RAGGED_M = (1, 3, 5, 67, 257)


def check_fused_case(x, w, tab, lut_fn, *, gated, label):
    """One K3 case: two launches bit-identical (the split-K sum is
    deterministic), bit for bit against the kernel's own GEMM
    (``epilogue=False``) followed by ``lut_fn`` (K1 or K2) and the gated
    product, and at most 1% of outputs differing from ``torch.matmul``
    followed by the plain LUT (bf16: bit for bit; f32: beyond rtol 1e-4).
    Returns (largest difference from the plain path, share differing);
    logs the plan."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_matmul_lut import (
        fused_matmul_lut_plain,
        k3_plan,
    )

    yk = ops.fused_matmul_lut(x, w, tab, gated=gated)
    again = ops.fused_matmul_lut(x, w, tab, gated=gated)
    h = ops.fused_matmul_lut(x, w, tab, gated=gated, epilogue=False)
    if gated:
        gate, up = h.chunk(2, dim=-1)
        yc = lut_fn(gate) * up
    else:
        yc = lut_fn(h)
    yp = fused_matmul_lut_plain(x, w, tab, gated=gated)
    if x.dtype == torch.float32:
        # up stays in f32, so the two GEMMs' sum orders reach every gated
        # output's last bits: count only differences past rtol 1e-4 (a bin
        # flip moves an output by a whole output level)
        differ = ~torch.isclose(yk, yp, rtol=1e-4, atol=1e-5)
    else:
        differ = yk != yp
    share = float(differ.float().mean())
    (m, k), n = x.shape, w.shape[1]
    plan = "f32 route" if x.dtype == torch.float32 else (
        lambda p: f"tokens {p.tok_tile} x {p.tok_tiles}, split {p.splits}, "
                  f"grid {p.grid}")(k3_plan(
                      m, k, n, gated=gated, dtype=x.dtype,
                      sm_count=torch.cuda.get_device_properties(
                          x.device).multi_processor_count))
    log(f"    K3 {label} ({m} x {k} x {n}, {plan}): share differing from "
        f"torch.matmul + plain LUT {share:.6f}")
    if not bits_equal(torch, yk, again):
        raise AssertionError(f"K3 {label}: two launches on the same inputs "
                             f"differ ({int((yk != again).sum())} elements)")
    if not bits_equal(torch, yk, yc):
        raise AssertionError(
            f"K3 {label}: differs from its own GEMM followed by the unfused "
            f"LUT ({int((yk != yc).sum())} elements)")
    if share > 0.01:
        raise AssertionError(f"K3 {label}: differs from the plain path on "
                             f"{share:.4%} of outputs (limit 1%)")
    return float((yk.float() - yp.float()).abs().max()), share


def largest_storages(n: int = 6) -> list:
    """The ``n`` largest storages on the card that Python objects still
    hold, as ``(bytes, a tensor's shape)``: what keeps memory allocated
    once a phase's models are deleted."""
    import torch

    gc.collect()
    seen = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            seen.setdefault(st.data_ptr(), (st.nbytes(), tuple(o.shape)))
    return sorted(seen.values(), reverse=True)[:n]


def served_k4_shapes(launcher, params, cfg, batch, tables) -> dict:
    """``{"prefill": {site: [shape, ...]}, "decode": {...}}``: the input
    shapes the served form hands K4 in one prefill of ``batch`` and one
    decode step after it (:func:`served_lut_calls`, which holds every call
    bit for bit against the plain K4 and K1); the calls must have used
    both of K4's modes (one element a thread, 16 bytes a thread)."""
    from repro_torch.kernels.lut_act import k4_plan

    calls = [c for c in served_lut_calls(launcher, params, cfg, batch,
                                         tables)
             if c["kernel"] == "lut_act_multi" and c["x"].numel()]
    seen = {"prefill": {}, "decode": {}}
    for c in calls:
        shapes = seen[c["step"]].setdefault(c["site"], [])
        if tuple(c["x"].shape) not in shapes:
            shapes.append(tuple(c["x"].shape))
    if not seen["prefill"] or not seen["decode"]:
        raise AssertionError(f"the form served no site through K4: {seen}")
    sm_count = tables["multi"]["k4_record"].sm_count
    modes = {k4_plan((c["x"].numel(),), c["x"].dtype, sm_count=sm_count)[1]
             for c in calls}
    if not (1 in modes and max(modes) > 1):
        raise AssertionError(f"the served K4 calls ran in modes {modes}")
    log(f"[11] {len(calls)} served K4 calls of one prefill and one decode "
        f"step equal the plain K4 and K1 bit for bit (modes {sorted(modes)}"
        f" elements a thread)")
    return seen


def form_config(plans, cfg0, args):
    """The served config of a launcher form: the plans' patched config with
    the form's flags, as ``launch.serve.setup`` applies them."""
    cfg = plans.patched_config(cfg0) if plans is not None else cfg0
    return dataclasses.replace(cfg, lut_fuse=args.lut_fuse,
                               lut_sites=args.lut_sites,
                               logit_softcap=args.logit_softcap)


def check_captured(cfg, params, batch, tables, kv_int8=False) -> float:
    """Decode ``NEW`` steps after the prompt eagerly and through a
    :class:`CapturedStep` on a copy of the same cache, side by side: every
    replayed step's logits and the final caches must be bit-identical to
    eager's, and the wrappers' launch counts over the replays must be the
    eager steps'.  ``kv_int8``: the cache is int8, filled by an eager
    replay of the prompt.  Decoding starts at ``decode_start`` (after a
    vlm's patches); a nested state (hybrid) is compared tensor by tensor;
    an encdec cache's cross K/V (``xk`` / ``xv``) must come out of the
    replays and of the eager steps as prefill wrote them, bit for bit.
    Returns the capture's seconds."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import (
        CapturedStep,
        clone_state,
        decode_start,
        decode_step,
        init_cache,
        prefill,
        prefill_replay,
        state_leaves,
    )

    toks = batch["tokens"]
    b = toks.shape[0]
    t = decode_start(cfg, batch)
    eager = lambda c, tk, pos: decode_step(params, cfg, c, tk, pos, tables)
    logits, cache = prefill(params, cfg, batch, max_seq=t + NEW,
                            lut_tables=tables)
    if kv_int8:
        cache = init_cache(cfg, b, t + NEW, device=toks.device,
                           kv_dtype="int8")
        logits, cache = prefill_replay(params, cfg, cache, toks, 0, tables,
                                       step=eager)
    graph_cache = clone_state(cache)
    cross = {n: cache[n].clone() for n in ("xk", "xv") if n in cache}
    step = CapturedStep(params, cfg, tables)
    step.capture(graph_cache, toks[:, :1])
    tok = logits[:, -1].argmax(-1)[:, None]
    counts = {}
    for i in range(NEW):
        for name, fn, c in (("eager", eager, cache),
                            ("graph", step, graph_cache)):
            reset_launch_counts()
            out, _ = fn(c, tok, t + i)
            counts[name] = launch_counts()
            if name == "eager":
                le = out
        if counts["eager"] != counts["graph"]:
            raise AssertionError(f"step {i}: a replay counted "
                                 f"{counts['graph']}, eager {counts['eager']}")
        if not bits_equal(torch, le, out):
            raise AssertionError(
                f"step {i}: the replayed logits differ from eager's "
                f"({int((le != out).sum())} of {le.numel()} elements, max "
                f"|diff| {float((le.float() - out.float()).abs().max())})")
        tok = le[:, -1].argmax(-1)[:, None]
    graph_leaves = dict(state_leaves(graph_cache))
    for k, v in state_leaves(cache):
        if not bits_equal(torch, v, graph_leaves[k]):
            raise AssertionError(f"the captured steps' cache {k!r} differs "
                                 f"from eager's")
    for n, c in cross.items():
        if not (bits_equal(torch, cache[n], c)
                and bits_equal(torch, graph_leaves[n], c)):
            raise AssertionError(f"the decode steps wrote the read-only "
                                 f"cross cache {n!r}")
    return step.capture_s


def serve_form(launcher, dev, label, args, cfg0, params, batch, plans, uses,
               results, totals, ref=None, want=None):
    """Serve one launcher form: a warm-up run, then a counted run (launch
    counts zeroed just before it and read just after), both decoding
    through the captured step; then an eager run, whose tokens must be
    the counted run's, and :func:`check_captured`.  ``ref`` is
    ``"gather"`` (tokens must equal the gather backend's on the same
    tables) or another form's label (token agreement is reported);
    ``want`` maps kernels to the exact launch count the run must show."""
    import argparse

    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    quiet = lambda m: None
    fcfg = form_config(plans, cfg0, args)
    tables = None if plans is None else launcher.serving_tables(
        args, plans, dev, log=quiet)
    launcher.serve(args, fcfg, params, batch, tables, log=quiet)
    reset_launch_counts()
    res = launcher.serve(args, fcfg, params, batch, tables, log=quiet)
    torch.cuda.synchronize()
    counts = launch_counts()
    if res["capture_s"] is None:
        raise AssertionError(f"form ({label}) decoded without a captured "
                             f"step")
    eager = launcher.serve(args, fcfg, params, batch, tables, log=quiet,
                           eager=True)
    if eager["tokens"] != res["tokens"]:
        raise AssertionError(
            f"form ({label}) captured tokens differ from eager's: "
            f"{res['tokens']} vs {eager['tokens']}")
    res["eager"] = {k: eager[k] for k in ("prefill_s", "replay_s",
                                          "decode_s", "decode_tok_s")}
    check_captured(fcfg, params, batch, tables, kv_int8=args.kv_int8
                   and fcfg.family in launcher.KV_INT8_FAMILIES)
    for k, v in counts.items():
        totals[k] += v
    for k in uses:
        if counts[k] == 0:
            raise AssertionError(f"form ({label}) launched no {k} kernel: "
                                 f"{counts}")
    for k, n in (want or {}).items():
        if counts[k] != n:
            raise AssertionError(f"form ({label}) launched {k} {counts[k]} "
                                 f"times, not {n}: {counts}")
    line = (f"({label}) {fcfg.name} exec={args.plan_exec} "
            f"fuse={args.lut_fuse} sites={args.lut_sites} softcap="
            f"{args.logit_softcap} kv_int8={args.kv_int8}: prefill "
            f"{res['prefill_s']:.4f}s"
            + (f", int8 replay {res['replay_s']:.4f}s (eager "
               f"{eager['replay_s']:.4f}s)" if res["replay_s"] else "")
            + f", capture {res['capture_s']:.4f}s, decode "
            f"{res['decode_tok_s']:.1f} tok/s captured, "
            f"{eager['decode_tok_s']:.1f} tok/s eager (tokens equal; "
            f"{NEW} replayed steps' logits and caches == eager's bit for "
            f"bit, launches as eager's)")
    if plans is not None:
        line += (f"; calib={plans.calib}, {plans.total_cost} P-LUTs, "
                 f"{launcher.tables_nbytes(tables)} table bytes")
    line += f"; launches {counts}"
    if ref == "gather":
        g_args = argparse.Namespace(**vars(args))
        g_args.lut_backend = "gather"
        g_tables = launcher.serving_tables(g_args, plans, dev, log=quiet)
        g = launcher.serve(g_args, fcfg, params, batch, g_tables, log=quiet)
        if g["tokens"] != res["tokens"]:
            raise AssertionError(
                f"form ({label}) tokens differ from the gather backend: "
                f"{res['tokens']} vs {g['tokens']}")
        line += (f"; tokens == gather (gather: prefill {g['prefill_s']:.4f}"
                 f"s, decode {g['decode_tok_s']:.1f} tok/s)")
        res["gather"] = {k: g[k] for k in ("prefill_s", "decode_s",
                                           "decode_tok_s")}
    elif ref is not None:
        agree = float(np.mean(np.array(results[ref]["tokens"])
                              == np.array(res["tokens"])))
        line += f"; token agreement with ({ref}): {agree:.4f}"
        res[f"agreement_with_{ref}"] = agree
    res["launches"] = counts
    log(line)
    log(f"    request 0: {res['tokens'][0]}")
    results[label] = res
    return res


# the batcher phase: 8 requests of 16-64 prompt tokens and 16 new tokens
# each through 4 slots of a cache of T + NEW positions
BATCHER_REQUESTS, BATCHER_SLOTS = 8, 4


def batcher_run(cfg, params, tables, prompts, *, kv_dtype="bfloat16",
                prefill="step", swap=None):
    """Serve ``prompts`` (``NEW`` tokens each) through a
    :class:`ContinuousBatcher`; ``swap``: ``(tick, tables, cfg)`` to swap
    to between ticks.  Returns ``(outs by request, batcher, seconds)``;
    with ``swap``, the batcher's ``served_before_swap`` holds each
    request's token count at the swap."""
    import torch

    from repro_torch.serve import ContinuousBatcher, Request

    b = ContinuousBatcher(cfg, params, BATCHER_SLOTS, T + NEW, eos_token=-1,
                          kv_dtype=kv_dtype, lut_tables=tables,
                          prefill=prefill)
    reqs = [Request(rid=i, prompt=p, max_new=NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    t0 = time.perf_counter()
    if swap is not None:
        while b.steps < swap[0]:
            b.step()
        b.served_before_swap = [len(r.out) for r in reqs]
        b.swap_tables(swap[1], cfg=swap[2])
    done = b.run()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return [r.out for r in sorted(done, key=lambda r: r.rid)], b, secs


def run_batcher(launcher, dev, cfg0, params, batch, form_a, form_e,
                totals) -> dict:
    """Phase 13: qwen3-0.6b at full width with form (a)'s tables through
    the continuous batcher, bf16 and int8 caches, both prefill modes
    (launch counts zeroed before each run and read after it): replay and
    step serve the same tokens, no request is dropped, in bf16 every
    request's tokens equal its decode alone in the same pool; one
    ``swap_tables`` to form (e)'s tables mid-run captures the step again
    and serves on; and the replay prefill of the 4 x 64 prompts, bf16 and
    int8, timed through a captured step."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serve import CapturedStep, init_cache, prefill_replay

    quiet = lambda m: None
    (args_a, plans), (args_e, plans_e) = form_a, form_e
    cfg = form_config(plans, cfg0, args_a)
    cfg_e = form_config(plans_e, cfg0, args_e)
    tabs = launcher.serving_tables(args_a, plans, dev, log=quiet)
    tabs_e = launcher.serving_tables(args_e, plans_e, dev, log=quiet)
    rng = np.random.default_rng(13)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, int(n))]
               for n in rng.integers(T // 4, T + 1, BATCHER_REQUESTS)]
    out = {"prompt_lens": [len(p) for p in prompts], "runs": {}}
    outs = {}
    batcher_run(cfg, params, tabs, prompts[:BATCHER_SLOTS])   # warm-up
    for kv in ("bfloat16", "int8"):
        for mode in ("step", "replay"):
            reset_launch_counts()
            got, b, secs = batcher_run(cfg, params, tabs, prompts,
                                       kv_dtype=kv, prefill=mode)
            counts = launch_counts()
            for k, v in counts.items():
                totals[k] += v
            m = b.metrics()
            if (counts["lut_act_stacked"] == 0 or m["dropped"]
                    or m["finished"] != len(prompts)
                    or any(len(o) != NEW for o in got)):
                raise AssertionError(f"batcher {kv} {mode}: launches "
                                     f"{counts}, metrics {m}")
            outs[kv, mode] = got
            new_tokens = sum(len(o) for o in got)
            out["runs"][f"{kv} {mode}"] = {
                "seconds": secs, "tok_s": new_tokens / secs,
                "ticks": m["ticks"], "utilization": m["utilization"],
                "replayed_tokens": m["replayed_tokens"],
                "captures": b._step.captures, "launches": counts,
                "latency_p50_s": m["latency_p50_s"],
                "ttft_p50_s": m["ttft_p50_s"]}
            log(f"[13] batcher {kv} prefill={mode}: {len(prompts)} requests "
                f"({sum(len(p) for p in prompts)} prompt tokens) in {secs:.3f}"
                f"s, {new_tokens / secs:.1f} new tok/s, {m['ticks']} ticks, "
                f"utilization {m['utilization']:.3f}, replayed "
                f"{m['replayed_tokens']}, latency p50 {m['latency_p50_s']:.3f}"
                f"s, ttft p50 {m['ttft_p50_s']:.3f}s, dropped 0; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
        if outs[kv, "step"] != outs[kv, "replay"]:
            raise AssertionError(f"batcher {kv}: replay tokens differ from "
                                 f"step tokens")
    alone = [batcher_run(cfg, params, tabs, [p])[0][0] for p in prompts]
    if alone != outs["bfloat16", "step"]:
        raise AssertionError(f"batcher bf16: a request's tokens differ from "
                             f"its decode alone: {outs['bfloat16', 'step']} "
                             f"vs {alone}")
    agree = float(np.mean(np.array(outs["int8", "step"])
                          == np.array(outs["bfloat16", "step"])))
    out["int8_agreement_with_bf16"] = agree
    log(f"[13] replay == step in bf16 and int8; every bf16 request's tokens "
        f"== its decode alone in the pool; int8 token agreement with bf16 "
        f"{agree:.4f}")
    # swap while the first slots are mid-decode: what they served before
    # the swap must be the unswapped run's, and the run must serve on
    tick = T + NEW // 2
    reset_launch_counts()
    swapped, b, secs = batcher_run(cfg, params, tabs, prompts,
                                   swap=(tick, tabs_e, cfg_e))
    counts = launch_counts()
    m = b.metrics()
    before = b.served_before_swap
    unswapped = outs["bfloat16", "step"]
    if (m["table_swaps"] != 1 or m["dropped"] or b._step.captures != 1
            or counts["lut_act_stacked"] == 0 or not sum(before)
            or any(len(o) != NEW for o in swapped)
            or any(o[:n] != u[:n]
                   for o, u, n in zip(swapped, unswapped, before))):
        raise AssertionError(f"batcher swap: metrics {m}, captures "
                             f"{b._step.captures}, launches {counts}, "
                             f"served before the swap {before}")
    after = [(o[n:], u[n:]) for o, u, n in zip(swapped, unswapped, before)]
    same = float(np.mean([x == y for o, u in after for x, y in zip(o, u)]))
    out["swap"] = {"tick": tick, "seconds": secs,
                   "served_before_swap": before,
                   "agreement_after_swap_with_unswapped": same}
    log(f"[13] swap_tables to form (e)'s tables at tick {tick}: the "
        f"{sum(before)} tokens served before it equal the unswapped run's; "
        f"captured again and served on ({m['finished']} finished, dropped "
        f"0) in {secs:.3f}s; token agreement after the swap with the "
        f"unswapped run {same:.4f}")
    replay = {}
    for kv in (None, "int8"):
        cache = init_cache(cfg, B, T + NEW, device=dev, kv_dtype=kv)
        step = CapturedStep(params, cfg, tabs)
        step.capture(cache, batch["tokens"][:, :1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill_replay(params, cfg, cache, batch["tokens"], 0, step=step)
        torch.cuda.synchronize()
        replay[kv or "bfloat16"] = {"seconds": time.perf_counter() - t0,
                                    "capture_s": step.capture_s}
    out["replay_prefill"] = replay
    log(f"[13] replay prefill of {B} x {T} tokens through the captured "
        f"step: " + ", ".join(f"{k} {v['seconds']:.4f}s (capture "
                              f"{v['capture_s']:.4f}s)"
                              for k, v in replay.items()))
    return out


def check_artifacts(launcher, common, results) -> None:
    """Phase 14, through the launcher's entry points at full width:
    ``--calib-path`` saves the captured calibration and loads it back bit
    for bit, and serves from it the tokens of form (a); ``--save-plan``
    then ``--tuned-plan`` serve forms (a) and (f) token-identically to the
    in-process plans."""
    import contextlib
    import io

    from repro_torch.calib import load_calibration

    art = OUT_DIR / "artifacts"
    art.mkdir(exist_ok=True)
    for f in art.iterdir():
        f.unlink()
    quiet = lambda m: None

    def main(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return launcher.main(argv)

    calib_path = str(art / "calib")
    args = launcher.parse_args(common + ["--calib-steps", "2",
                                         "--calib-path", calib_path])
    cfg, params, _, _ = launcher.setup(args)
    captured = launcher.calibration(args, cfg, params, log=quiet)
    loaded = load_calibration(calib_path)
    for f in ("masks", "hists", "ranges"):
        a, b = getattr(captured, f), getattr(loaded, f)
        if sorted(a) != sorted(b) or any(
                a[k].dtype != b[k].dtype or a[k].tobytes() != b[k].tobytes()
                for k in a):
            raise AssertionError(f"--calib-path: {f} did not reload bit for "
                                 f"bit")
    if (captured.w_in, captured.x_lo, captured.x_hi) != (
            loaded.w_in, loaded.x_lo, loaded.x_hi):
        raise AssertionError("--calib-path: the quantizer did not reload")
    del params
    got = main(common + ["--calib-path", calib_path])["tokens"]
    if got != results["a"]["tokens"]:
        raise AssertionError("--calib-path: the reloaded calibration serves "
                             "other tokens than form (a)")
    log(f"[14] --calib-path: {len(loaded.masks)} masks, histograms and "
        f"ranges reload bit for bit; served from the file: tokens == (a)")
    for label, flags in (("a", ["--calib-steps", "2"]),
                         ("f", ["--calib-steps", "2", "--lut-sites", "all",
                                "--lut-fuse"])):
        path = str(art / f"plan_{label}")
        saved = main(common + flags + ["--save-plan", path])["tokens"]
        served = main([a for a in common if a != "--lut-act"]
                      + flags[2:] + ["--tuned-plan", path])["tokens"]
        if not (saved == served == results[label]["tokens"]):
            raise AssertionError(f"--tuned-plan ({label}): {served} vs saved "
                                 f"{saved} vs form {results[label]['tokens']}")
        log(f"[14] --save-plan then --tuned-plan, form ({label}): tokens == "
            f"the in-process plans' ({Path(path + '.npz').stat().st_size} "
            f"bytes)")


def logit_drift(launcher, dev, cfg0, params, batch, a, b) -> dict:
    """How far form ``b`` moves the last-token prefill logits from form
    ``a`` (each ``(args, plans)``, plans ``None`` for the exact model),
    beside ``a``'s top-1 margin: the yardstick for a token agreement."""
    import torch

    def logits(args, plans):
        tabs = None if plans is None else launcher.serving_tables(
            args, plans, dev, log=lambda m: None)
        lg, _ = launcher.prefill(params, form_config(plans, cfg0, args),
                                 batch, max_seq=T, lut_tables=tabs)
        return lg[:, -1].float()

    la, lb = logits(*a), logits(*b)
    top2 = torch.topk(la, 2, dim=-1).values
    return {"max_abs_diff": float((la - lb).abs().max()),
            "mean_abs_diff": float((la - lb).abs().mean()),
            "logit_std": float(la.std()),
            "top1_margin": [float(m) for m in top2[:, 0] - top2[:, 1]],
            "same_argmax": [bool(x) for x in
                            la.argmax(-1) == lb.argmax(-1)]}


# -------------------------------------------------------------------------
# phase 15: the moe family at full width
# -------------------------------------------------------------------------
# the LUT kernels; phase 15's exact forms must launch none of them
MOE_LUT = ("lut_act_stacked", "lut_act", "fused_matmul_lut", "lut_act_multi")
# the forms phase 15 serves each moe configuration in, and the form each
# is held against: "gather" (token-identical to the gather backend on the
# same tables) or another form (token agreement reported)
MOE_FORMS = {"deepseek-moe-16b": ("exact", "a", "b", "d", "f", "k"),
             "qwen3-moe-30b-a3b": ("exact", "a")}
MOE_REFS = {"exact": None, "a": "gather", "b": "gather", "d": "a",
            "f": "exact", "k": "a"}


def same_layout(x):
    """A copy of ``x`` laid out as ``x`` is: a strided view (``rows`` rows
    of ``cols`` elements, ``ld`` apart, as the gate half of an expert's
    ``[gate|up]`` product) stays one, at a 16-byte aligned start."""
    import torch

    from repro_torch.kernels.lut_act import k1_view

    if x.is_contiguous():
        return x.clone()
    rows, cols, ld = k1_view(x)
    buf = torch.zeros((rows, ld), dtype=x.dtype, device=x.device)
    buf[:, :cols] = x.reshape(rows, cols)
    return buf[:, :cols].view(x.shape)


def served_lut_calls(launcher, params, cfg, batch, tables) -> list:
    """Every K1 / K2 / K4 call one prefill of ``batch`` and one decode step
    after it make in a served form (seen where the wrappers launch:
    ``launch_lut`` for K1 / K2, ``k4_call`` for K4), each with a copy of
    its input in the served layout, its output and its site's table entry
    as ``apply_lut_act`` takes it; every call is held bit for bit against
    the plain version on its input (K4 also against K1 per site), and the
    kernel on the copy against the served output."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.nn.mlp import apply_lut_act
    from repro_torch.serve.stacked import multi_site_stacked_entry

    entries = {}    # id(launch record) -> (site, entry as apply_lut_act's)
    for site, e in tables["sites"].items():
        if "stacked" in e:
            entries[id(e["stacked"]["k1_record"])] = (site, e["stacked"])
        for le in e.get("layers", ()):
            entries[id(le["k1_record"])] = (site, le)
    calls, step = [], ["prefill"]
    orig_k12, orig_k4 = ops.launch_lut, ops.k4_call

    def k12(fn, name, x, rec, layer):
        y = orig_k12(fn, name, x, rec, layer)
        site, e = entries[id(rec)]
        tab = {"stacked": e, "layer": layer} if name == "lut_act_stacked" \
            else e
        calls.append(dict(kernel=name, step=step[0], site=site, layer=layer,
                          x=same_layout(x), y=y, tab=tab))
        return y

    def k4(xs, rec, layer):
        if rec is not tables["multi"]["k4_record"]:
            raise AssertionError("K4 served from another entry's record")
        out, call = orig_k4(xs, rec, layer)
        for s, x in xs.items():
            calls.append(dict(kernel="lut_act_multi", step=step[0], site=s,
                              layer=layer, x=same_layout(x), y=out[s],
                              tab={"multi_entry": tables["multi"], "site": s,
                                   "layer": layer}))
        return out, call

    start = launcher.decode_start(cfg, batch)
    ops.launch_lut, ops.k4_call = k12, k4
    try:
        logits, cache = launcher.prefill(params, cfg, batch,
                                         max_seq=start + NEW,
                                         lut_tables=tables)
        step[0] = "decode"
        launcher.decode_step(params, cfg, cache,
                             logits[:, -1].argmax(-1)[:, None], start,
                             tables)
        torch.cuda.synchronize()
    finally:
        ops.launch_lut, ops.k4_call = orig_k12, orig_k4
    slices = {}
    for c in calls:
        x, y, tab = c["x"], c["y"], c["tab"]
        what = (f"{c['kernel']} {c['step']} site {c['site']} "
                f"{tuple(x.shape)} layer {c['layer']}")
        again = apply_lut_act(x, tab, "cuda")
        yp = apply_lut_act(x, tab, "gather")
        if c["kernel"] == "lut_act_multi":
            sl = slices.setdefault(c["site"], multi_site_stacked_entry(
                tables["multi"], c["site"]))
            k4_held(torch, y, yp, ops.lut_act_stacked(x, sl, c["layer"]),
                    f"served call {what}")
        if not (bits_equal(torch, y, yp) and bits_equal(torch, y, again)):
            raise AssertionError(
                f"served {what}: the kernel differs from its plain version "
                f"or from itself on a copy ({int((y != yp).sum())} / "
                f"{int((y != again).sum())} elements)")
    return calls


def lut_call_timing(c, name) -> dict:
    """One served call's kernel timed (from a CUDA graph and host-driven)
    beside its plain version and its bound from bytes: its input read and
    output written once, and one layer's slab of its site."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.lut_act import k1_view
    from repro_torch.nn.mlp import apply_lut_act
    from repro_torch.serve.stacked import multi_site_stacked_entry

    x, layer, tab = c["x"], c["layer"], c["tab"]
    kfn = lambda: apply_lut_act(x, tab, "cuda")
    pfn = lambda: apply_lut_act(x, tab, "gather")
    if c["kernel"] == "lut_act_stacked":
        arrays = {k: a[layer] for k, a in tab["stacked"]["arrays"].items()}
    elif c["kernel"] == "lut_act":
        arrays = tab["arrays"]
    else:
        arrays = {k: a[layer] for k, a in multi_site_stacked_entry(
            tab["multi_entry"], c["site"])["arrays"].items()}
    slab = sum(int(a.numel()) * 4 for a in arrays.values())
    n = x.numel()
    # operations an element: phase 11's count, 5 for K1 / K2, 20 for K4
    per = 20 if c["kernel"] == "lut_act_multi" else 5
    bms, by = bound(2 * n * x.element_size() + slab, per * n, PEAK_F32_FLOPS)
    before = launch_counts()[c["kernel"]]
    ops_run = torch_ops_of(kfn)
    launched = launch_counts()[c["kernel"]] - before
    t = {"name": name, "kernel": c["kernel"], "site": c["site"],
         "step": c["step"], "shape": list(x.shape),
         "layout": "contiguous" if x.is_contiguous() else
         f"strided view, row stride {k1_view(x)[2]}",
         "ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
         "plain_ms": timed_ms(pfn, n=10, warmup=2, reps=3),
         "bound_ms": bms, "bound_by": by,
         "launches_a_call": launched,
         "torch_ops": ops_run, "copies": sum(o in COPY_OPS for o in ops_run)}
    if c["kernel"] == "lut_act_multi" and not x.is_contiguous():
        # K4 copies a strided input before its launch (k4_call): the
        # same call on a contiguous copy shows what the copy costs
        xc = x.contiguous()
        cfn = lambda: apply_lut_act(xc, tab, "cuda")
        t.update(contiguous_ms=timed_ms(cfn), contiguous_graph_ms=graph_ms(
            cfn))
    return t


def served_timings(calls, label, phase="15") -> list:
    """Time each distinct (kernel, site, step, shape) the served calls
    show, at the middle one of its layers."""
    groups = {}
    for c in calls:
        key = (c["kernel"], c["site"], c["step"], tuple(c["x"].shape),
               c["x"].stride())
        groups.setdefault(key, []).append(c)
    out = []
    for key, cs in groups.items():
        t = lut_call_timing(cs[len(cs) // 2], label)
        t["calls"] = len(cs)
        out.append(t)
        log(f"[{phase}] {label} {t['kernel']} {t['site']} {t['step']} "
            f"{t['shape']} ({t['layout']}, {t['calls']} calls): "
            f"{t['graph_ms'] * 1e3:.2f} us a launch from a graph "
            f"({t['ms'] * 1e3:.2f} host-driven), bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), plain "
            f"{t['plain_ms'] * 1e3:.2f} us; {t['launches_a_call']} launch "
            f"a call, PyTorch ops around it {t['torch_ops']}"
            + (f" (on a contiguous input {t['contiguous_graph_ms'] * 1e3:.2f}"
               f" us from a graph)" if "contiguous_ms" in t else ""))
    return out


def k1_in_place(timings) -> None:
    """Every timed K1 call (a gate view read in place) launched one kernel
    and ran no PyTorch copy."""
    for t in timings:
        if t["kernel"] == "lut_act_stacked" and (
                t["launches_a_call"], t["copies"]) != (1, 0):
            raise AssertionError(
                f"K1 at {t['shape']} ({t['layout']}): {t['launches_a_call']}"
                f" launches a call and the PyTorch ops {t['torch_ops']}, not "
                f"one launch and no copy")


def prefill_drops(launcher, params, cfg, batch, tables) -> int:
    """Routed assignments dropped by capacity over one prefill of
    ``batch`` (every layer), counted where the routing computes them."""
    import torch

    from repro_torch.nn import moe as moe_mod

    orig, drops = moe_mod.route, []

    def spy(*a, **kw):
        r = orig(*a, **kw)
        drops.append(r.dropped())
        return r

    moe_mod.route = spy
    try:
        launcher.prefill(params, cfg, batch, max_seq=T, lut_tables=tables)
    finally:
        moe_mod.route = orig
    if len(drops) != cfg.n_layers:
        raise AssertionError(f"the prefill routed {len(drops)} times, not "
                             f"once a layer ({cfg.n_layers})")
    return int(torch.stack(drops).sum())


def k3_times(x, ws, tab, sl, layer, *, gated, n=50) -> dict:
    """K3 on ``x`` (M, K) bf16 against a stack of weights ``ws`` (L, K, N),
    a layer's weight in turn each launch (L2-cold, as a decode step meets
    them), from a CUDA graph and host-driven, beside its plain version,
    cuBLAS alone and the library yardstick, cuBLAS followed by K1 (``sl``,
    the site's stacked slice, at ``layer``) and the gated product: form
    (a)'s unfused path.  The bound: inputs read and output written once,
    the layer's slab, and ``2 M K N`` bf16 operations."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_matmul_lut import fused_matmul_lut_plain

    it = iter(range(10 ** 9))
    w = lambda: ws[next(it) % len(ws)]
    kfn = lambda: ops.fused_matmul_lut(x, w(), tab, gated=gated)
    pfn = lambda: fused_matmul_lut_plain(x, w(), tab, gated=gated)
    mfn = lambda: torch.matmul(x, w())

    def lfn():
        h = torch.matmul(x, w())
        if not gated:
            return ops.lut_act_stacked(h, sl, layer)
        gate, up = h.chunk(2, dim=-1)
        return ops.lut_act_stacked(gate, sl, layer) * up
    (m, k), n_out = x.shape, ws[0].shape[1]
    slab = sum(int(a[layer].numel()) * 4 for a in sl["arrays"].values())
    bms, by = bound(2 * (m * k + k * n_out + m * (n_out // 2 if gated
                                                   else n_out)) + slab,
                    2 * m * k * n_out, PEAK_BF16_FLOPS)
    return {"shape": [m, k, n_out], "ms": timed_ms(kfn, n=n),
            "graph_ms": graph_ms(kfn, n=n), "plain_ms": timed_ms(pfn, n=10),
            "bound_ms": bms, "bound_by": by, "library_ms": timed_ms(lfn, n=n),
            "library_graph_ms": graph_ms(lfn, n=n),
            "matmul_only_ms": timed_ms(mfn, n=n),
            "matmul_only_graph_ms": graph_ms(mfn, n=n)}


def check_shared_k3(dev, params, tables, gen) -> dict:
    """K3 at deepseek's shared-expert shape (K = d_model, N = 2 x 2816,
    gated) on form (d)'s super-slab: against its own GEMM + K1 and within
    1% of the plain path, at the decode and prefill M and ragged M; timed
    beside the plain version and cuBLAS + K1 (rotating the 28 layers'
    weights, L2-cold)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serve.stacked import multi_site_stacked_entry

    multi = tables["multi"]
    sl = multi_site_stacked_entry(multi, "mlp")
    w = params.blocks["sh_w_in"]
    L, K = w.shape[:2]
    tab = lambda layer: {"multi_entry": multi, "site": "mlp", "layer": layer}
    k1 = lambda layer: (lambda g: ops.lut_act_stacked(g, sl, layer))
    shares = {}
    for m in (B, B * T, 67):
        for layer in (0, L // 2, L - 1):
            x = torch.randn(m, K, generator=gen, device=dev).to(
                torch.bfloat16)
            _, shares[f"M={m} layer {layer}"] = check_fused_case(
                x, w[layer], tab(layer), k1(layer), gated=True,
                label=f"shared expert M={m} layer {layer}")
    out = {"mismatch_share_vs_plain": shares}
    for shape_name, m in (("decode", B), ("prefill", B * T)):
        x = torch.randn(m, K, generator=gen, device=dev).to(torch.bfloat16)
        out[shape_name] = t = k3_times(x, w, tab(L // 2), sl, L // 2,
                                       gated=True)
        log(f"[15] K3 shared expert {shape_name} {t['shape']}: "
            f"{t['graph_ms'] * 1e3:.2f} us from a graph ({t['ms'] * 1e3:.2f} "
            f"host-driven), bound {t['bound_ms'] * 1e3:.3f} us "
            f"({t['bound_by']}), plain {t['plain_ms'] * 1e3:.2f} us, cuBLAS + "
            f"K1 {t['library_graph_ms'] * 1e3:.2f} us from a graph "
            f"({t['library_ms'] * 1e3:.2f}), cuBLAS alone "
            f"{t['matmul_only_graph_ms'] * 1e3:.2f} us")
    return out


def run_moe_model(launcher, dev, arch, totals, results, stamp) -> dict:
    """Phase 15 for one moe configuration at full width (random weights
    from seed 0, bf16): plans from 2 calibration batches; the served forms
    ``MOE_FORMS[arch]`` through :func:`serve_form`, each
    captured and eager, with the launch counts its sites imply; every
    K1 / K2 / K4 call of a prefill and a decode step in forms (a), (b) and
    (f) held bit for bit against its plain version and timed; K1 on the
    expert gate view launching one kernel; the prefill's dropped
    assignments; K3 at the shared-expert shape (form (d)); one eager and
    one captured decode step profiled (exact and (a))."""
    import torch

    from repro_torch.nn.moe import moe_capacity

    labels = MOE_FORMS[arch]
    gen = torch.Generator(device=dev).manual_seed(15)
    parse = launcher.parse_args
    common = ["--arch", arch, "--full", "--batch", str(B), "--prompt-len",
              str(T), "--new-tokens", str(NEW), "--device", "cuda"]
    lut = common + ["--lut-act", "--calib-steps", "2"]
    args = {"exact": parse(common), "a": parse(lut),
            "b": parse(lut + ["--plan-exec", "unrolled"]),
            "d": parse(lut + ["--lut-fuse"]),
            "f": parse(lut + ["--lut-sites", "all", "--lut-fuse"]),
            "k": parse(lut + ["--kv-int8"])}
    depth, why = SERVE_DEPTH.get(arch, (None, None))
    torch.cuda.init()   # the allocator, before its peak is reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg0, params, batch, rng = setup_model(launcher, args["exact"], depth)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m = cfg0.moe
    n_params = sum(p.numel() for p in params.parameters())
    out = {"arch": arch, "init_s": init_s, "n_params": n_params,
           "n_layers": cfg0.n_layers, "depth_cut": why,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "peak_after_params": torch.cuda.max_memory_allocated(dev)}
    log(f"[15] {cfg0.name}: {cfg0.n_layers} layers"
        + (f" (cut: {why})" if depth else "") + f", d_model {cfg0.d_model}, "
        f"{cfg0.n_heads}/{cfg0.n_kv_heads} heads x {cfg0.d_head}, "
        f"{m.n_experts} experts top-{m.top_k} at d_expert {m.d_expert}, "
        f"{m.n_shared} shared, vocab {cfg0.vocab_size}, {cfg0.dtype}; "
        f"{launcher.param_summary(params)}; built in {init_s:.1f}s")
    quiet = lambda msg: None
    plans = launcher.build_plans(args["a"], cfg0, params, rng,
                                 log=lambda msg: log("    " + msg))
    plans_all = None
    if "f" in labels:
        plans_all = launcher.build_plans(
            args["f"], form_config(None, cfg0, args["f"]), params, rng,
            log=lambda msg: log("    " + msg))
    plan_of = {"exact": None, "f": plans_all}

    def served(label):
        """A form's served config and tables."""
        pl = plan_of.get(label, plans)
        tabs = (None if pl is None else
                launcher.serving_tables(args[label], pl, dev, log=quiet))
        return form_config(pl, cfg0, args[label]), tabs

    L, sites_a = cfg0.n_layers, len(plans.sites)
    steps = 1 + NEW                      # the prefill and NEW replays
    per_layer_f = 8   # expert, attn_exp, norm_rsqrt x 2, rope_table x 4
    forms = {   # the kernels a form must launch, and how often
        "exact": ([], {k: 0 for k in MOE_LUT}),
        "a": (["lut_act_stacked"], {"lut_act_stacked": steps * L * sites_a}),
        "b": (["lut_act"], {"lut_act": steps * L * sites_a}),
        # the shared MLP through K3, the expert site out of the super-slab
        "d": (["fused_matmul_lut", "lut_act_multi"],
              {"fused_matmul_lut": steps * L, "lut_act_multi": steps * L}),
        "f": (["fused_matmul_lut", "lut_act_multi"],
              {"fused_matmul_lut": steps * L,
               "lut_act_multi": steps * L * per_layer_f}),
        # one prefill, T replays into the int8 cache, NEW decode replays
        "k": (["lut_act_stacked"],
              {"lut_act_stacked": (1 + T + NEW) * L * sites_a}),
    }
    tag = "ds" if m.n_shared else "q3m"
    out["forms"] = {}
    for label in labels:
        uses, want = forms[label]
        ref = MOE_REFS[label]
        log(f"[15] {stamp()}")
        res = serve_form(launcher, dev, f"{tag} {label}", args[label], cfg0,
                         params, batch, plan_of.get(label, plans), uses,
                         results, totals, ref=ref if ref in (None, "gather")
                         else f"{tag} {ref}", want=want)
        out["forms"][label] = {k: v for k, v in res.items()
                               if k != "tokens"}
    # the served K1 / K2 / K4 calls at the moe shapes
    out["lut_calls"] = []
    for label in [l for l in ("a", "b", "f") if l in labels]:
        fcfg, tabs = served(label)
        calls = served_lut_calls(launcher, params, fcfg, batch, tabs)
        log(f"[15] form ({tag} {label}): {len(calls)} served K1/K2/K4 calls "
            f"of one prefill and one decode step equal their plain "
            f"versions bit for bit (K4 also K1 per site)")
        out["lut_calls"] += served_timings(calls, f"{tag} {label}")
        del calls
    # K1 reads the expert gate view in place: one launch, no copy
    k1_in_place(out["lut_calls"])
    drops = {}
    for label in ("exact", "a"):
        fcfg, tabs = served(label)
        drops[label] = prefill_drops(launcher, params, fcfg, batch, tabs)
    out["capacity"] = {"prefill": moe_capacity(B * T, m),
                       "decode": moe_capacity(B, m)}
    out["prefill_dropped"] = drops
    log(f"[15] {tag}: capacity {out['capacity']['prefill']} slots an expert "
        f"at prefill ({B * T} tokens x top-{m.top_k} over {m.n_experts}), "
        f"{out['capacity']['decode']} at decode; prefill assignments "
        f"dropped by capacity: {drops} of {B * T * m.top_k * L}")
    if m.n_shared and "d" in labels:
        out["shared_k3"] = check_shared_k3(dev, params, served("d")[1], gen)
    out["steps"] = {}
    for label in ("exact", "a"):
        fcfg, tabs = served(label)
        out["steps"][label] = profile_decode_step(
            launcher, f"{tag} {label}", fcfg, params, batch, tabs, tag="15")
    logits, _ = launcher.prefill(params, cfg0, batch, max_seq=T + 1)
    if logits.shape != (B, 1, cfg0.vocab_size) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"{arch}: bad logits {tuple(logits.shape)}")
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    log(f"[15] {tag}: parameters {out['param_bytes']} bytes, peak allocated "
        f"{out['peak_after_params']} after the parameters, "
        f"{out['peak']} over the phase")
    return out

# -------------------------------------------------------------------------
# phase 16: the vlm and hybrid families at full width
# -------------------------------------------------------------------------
# the forms phase 16 serves each configuration in, and what each is held
# against, as MOE_FORMS / MOE_REFS
FAMILY_FORMS = {"phi-3-vision-4.2b": ("exact", "a", "b", "e", "f"),
                "recurrentgemma-9b": ("exact", "a", "b", "d", "f")}
FAMILY_REFS = {"exact": None, "a": "gather", "b": "gather", "e": "gather",
               "d": "a", "f": "exact"}
# LUT calls a layer makes under --lut-sites all: vlm: mlp, attn_exp,
# norm_rsqrt twice (the two norms), rope_table four times (sine and cosine
# of q and of k); hybrid: mlp and norm_rsqrt twice (the temporal block's
# norm and the MLP's; sites.py hosts no attention site on hybrid)
ALL_SITE_CALLS = {"vlm": 8, "hybrid": 3}
# the wrapped-ring request: local_window + RING_EXTRA prompt tokens
RING_EXTRA = 64
# calibration flags of the all-sites plans per family: at full width with
# random weights every recurrentgemma L0 norm input (embeddings of std
# 0.0017, plus a small recurrent output) falls into the first bin of the
# rsqrt table's domain [1e-3, 64]; one care bin, which calibration refuses
# (calib/masks.py), so the neighbouring bin is kept as care too
ALL_SITE_CALIB = {"vlm": [], "hybrid": ["--calib-smoothing", "1"]}


def mlp_weights(params, cfg) -> list:
    """``[(layer id, w_in (d, 2 d_ff) or (d, d_ff))]`` of every layer's
    MLP, with the layer ids the served tables use (hybrid: ``group *
    len(pattern) + i``, then the tail's; encdec: the decoder's, the
    encoder serving no tables)."""
    if cfg.family != "hybrid":
        w = (params.dec_blocks if cfg.family == "encdec"
             else params.blocks)["w_in"]
        return [(l, w[l]) for l in range(cfg.n_layers)]
    from repro_torch.nn.transformer import block_pattern, hybrid_layout

    unit = len(block_pattern(cfg))
    n_groups, n_tail = hybrid_layout(cfg)
    out = [(g * unit + i, params.group(g)[f"m{i}"]["w_in"])
           for g in range(n_groups) for i in range(unit)]
    out += [(n_groups * unit + i, params.tail_layer(i)["m"]["w_in"])
            for i in range(n_tail)]
    return sorted(out, key=lambda lw: lw[0])


def check_mlp_k3(dev, params, cfg, tables, m_prefill, gen, tag,
                 phase="16") -> dict:
    """K3 at the model's MLP shape (K = d_model, N = 2 d_ff gated, or d_ff
    without a gate) on a fused form's super-slab: against its own GEMM +
    K1 and within 1% of the plain path at the decode and prefill M and a
    ragged M, at the first, middle and last layers; timed beside the plain
    version and cuBLAS + K1, rotating every layer's weights (L2-cold)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.nn.layers import is_gated
    from repro_torch.serve.stacked import multi_site_stacked_entry

    multi = tables["multi"]
    sl = multi_site_stacked_entry(multi, "mlp")
    layers = mlp_weights(params, cfg)
    tab = lambda layer: {"multi_entry": multi, "site": "mlp", "layer": layer}
    k1 = lambda layer: (lambda g: ops.lut_act_stacked(g, sl, layer))
    k = layers[0][1].shape[0]
    gated = is_gated(cfg.activation)
    shares = {}
    for m in (B, m_prefill, 67):
        for layer, w in (layers[0], layers[len(layers) // 2], layers[-1]):
            x = torch.randn(m, k, generator=gen, device=dev).to(
                torch.bfloat16)
            _, shares[f"M={m} layer {layer}"] = check_fused_case(
                x, w, tab(layer), k1(layer), gated=gated,
                label=f"{tag} mlp M={m} layer {layer}")
    out = {"mismatch_share_vs_plain": shares}
    mid = layers[len(layers) // 2][0]
    for shape_name, m in (("decode", B), ("prefill", m_prefill)):
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        out[shape_name] = t = k3_times(x, [w for _, w in layers], tab(mid),
                                       sl, mid, gated=gated)
        log(f"[{phase}] K3 {tag} mlp {shape_name} {t['shape']}"
            f"{'' if gated else ' (no gate)'}: "
            f"{t['graph_ms'] * 1e3:.2f} us from a graph ({t['ms'] * 1e3:.2f} "
            f"host-driven), bound {t['bound_ms'] * 1e3:.3f} us "
            f"({t['bound_by']}), plain {t['plain_ms'] * 1e3:.2f} us, cuBLAS + "
            f"K1 {t['library_graph_ms'] * 1e3:.2f} us from a graph "
            f"({t['library_ms'] * 1e3:.2f}), cuBLAS alone "
            f"{t['matmul_only_graph_ms'] * 1e3:.2f} us")
    return out


def wrapped_ring(launcher, dev, cfg0, params, args, plans, totals) -> dict:
    """One request of ``local_window + RING_EXTRA`` prompt tokens in form
    (a), decoding ``NEW`` tokens: the ring wraps and the window mask cuts
    at full width.  Served through the captured step (K1 once a layer a
    step, counted) and eagerly (tokens equal), then
    :func:`check_captured` (every replayed step and the state bit for bit
    against eager's)."""
    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts

    quiet = lambda m: None
    n = cfg0.local_window + RING_EXTRA
    toks = np.random.default_rng(16).integers(1, cfg0.vocab_size, (1, n))
    batch = {"tokens": torch.as_tensor(toks, device=dev).long()}
    fcfg = form_config(plans, cfg0, args)
    tables = launcher.serving_tables(args, plans, dev, log=quiet)
    reset_launch_counts()
    res = launcher.serve(args, fcfg, params, batch, tables, log=quiet)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = (1 + NEW) * cfg0.n_layers
    if counts["lut_act_stacked"] != want:
        raise AssertionError(f"the wrapped ring launched K1 "
                             f"{counts['lut_act_stacked']} times, not {want}")
    eager = launcher.serve(args, fcfg, params, batch, tables, log=quiet,
                           eager=True)
    if eager["tokens"] != res["tokens"]:
        raise AssertionError(f"the wrapped ring's captured tokens differ "
                             f"from eager's: {res['tokens']} vs "
                             f"{eager['tokens']}")
    capture_s = check_captured(fcfg, params, batch, tables)
    for k, v in counts.items():
        totals[k] += v
    out = {"prompt": n, "prefill_s": res["prefill_s"],
           "capture_s": capture_s, "decode_tok_s": res["decode_tok_s"],
           "eager_decode_tok_s": eager["decode_tok_s"], "launches": counts,
           "tokens": res["tokens"][0]}
    log(f"[16] wrapped ring: 1 x {n} prompt tokens (window "
        f"{cfg0.local_window}), form (a): prefill {res['prefill_s']:.4f}s, "
        f"decode {res['decode_tok_s']:.1f} tok/s captured, "
        f"{eager['decode_tok_s']:.1f} eager (tokens equal; {NEW} replayed "
        f"steps' logits and state == eager's bit for bit); K1 {want} "
        f"launches; tokens {res['tokens'][0]}")
    return out


def run_family_model(launcher, dev, arch, totals, results, stamp) -> dict:
    """Phase 16 for one configuration at full width (random weights from
    seed 0, bf16): plans from 2 calibration batches (``mlp``; every site
    for (e) / (f)); the forms ``FAMILY_FORMS[arch]`` through
    :func:`serve_form`, each captured and eager, with the launch counts
    its sites imply (vlm decoding from ``n_patches + T``); the wrapped
    ring (hybrid); every K1 / K2 / K4 call of a prefill and a decode step
    in forms (a), (b) and (f) held bit for bit against its plain version
    and timed; K1 on the gate view one kernel; K3 at the MLP shape; one
    eager and one captured decode step profiled (exact and (a))."""
    import torch

    labels = FAMILY_FORMS[arch]
    gen = torch.Generator(device=dev).manual_seed(16)
    parse = launcher.parse_args
    common = ["--arch", arch, "--full", "--batch", str(B), "--prompt-len",
              str(T), "--new-tokens", str(NEW), "--device", "cuda"]
    lut = common + ["--lut-act", "--calib-steps", "2"]
    lut_all = lut + ["--lut-sites", "all"] + ALL_SITE_CALIB[
        launcher.get_config(arch).family]
    args = {"exact": parse(common), "a": parse(lut),
            "b": parse(lut + ["--plan-exec", "unrolled"]),
            "d": parse(lut + ["--lut-fuse"]), "e": parse(lut_all),
            "f": parse(lut_all + ["--lut-fuse"])}
    depth, why = SERVE_DEPTH.get(arch, (None, None))
    torch.cuda.init()   # the allocator, before its peak is reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg0, params, batch, rng = setup_model(launcher, args["exact"], depth)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    vlm = cfg0.family == "vlm"
    start = launcher.decode_start(cfg0, batch)
    if start != T + cfg0.n_patches:
        raise AssertionError(f"{arch}: decoding would start at {start}, not "
                             f"{T + cfg0.n_patches}")
    out = {"arch": arch, "init_s": init_s, "decode_start": start,
           "n_layers": cfg0.n_layers, "depth_cut": why,
           "n_params": sum(p.numel() for p in params.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "peak_after_params": torch.cuda.max_memory_allocated(dev)}
    shape = (f"{cfg0.n_patches} patches of d_model before the prompt "
             f"(decoding from {start})" if vlm else
             f"pattern {cfg0.block_pattern}, d_rnn {cfg0.d_rnn}, window "
             f"{cfg0.local_window}")
    log(f"[16] {cfg0.name}: {cfg0.n_layers} layers"
        + (f" (cut: {why})" if depth else "") + f", d_model {cfg0.d_model}, "
        f"{cfg0.n_heads}/{cfg0.n_kv_heads} heads x {cfg0.d_head}, d_ff "
        f"{cfg0.d_ff} {cfg0.activation}, vocab {cfg0.vocab_size}, "
        f"{cfg0.dtype}; {shape}; {launcher.param_summary(params)}; built "
        f"in {init_s:.1f}s")
    quiet = lambda msg: None
    plans = launcher.build_plans(args["a"], cfg0, params, rng,
                                 log=lambda msg: log("    " + msg))
    plans_all = launcher.build_plans(
        args["f"], form_config(None, cfg0, args["f"]), params, rng,
        log=lambda msg: log("    " + msg))
    plan_of = {"exact": None, "e": plans_all, "f": plans_all}

    def served(label):
        """A form's served config and tables."""
        pl = plan_of.get(label, plans)
        tabs = (None if pl is None else
                launcher.serving_tables(args[label], pl, dev, log=quiet))
        return form_config(pl, cfg0, args[label]), tabs

    L, steps = cfg0.n_layers, 1 + NEW    # the prefill and NEW replays
    per_all = ALL_SITE_CALLS[cfg0.family]
    forms = {   # the kernels a form must launch, and how often
        "exact": ([], {k: 0 for k in MOE_LUT}),
        "a": (["lut_act_stacked"], {"lut_act_stacked": steps * L}),
        "b": (["lut_act"], {"lut_act": steps * L}),
        "d": (["fused_matmul_lut"], {"fused_matmul_lut": steps * L,
                                     "lut_act_multi": 0}),
        "e": (["lut_act_stacked"], {"lut_act_stacked": steps * L * per_all}),
        "f": (["fused_matmul_lut", "lut_act_multi"],
              {"fused_matmul_lut": steps * L,
               "lut_act_multi": steps * L * (per_all - 1)}),
    }
    tag = "vlm" if vlm else "hyb"
    out["forms"] = {}
    for label in labels:
        uses, want = forms[label]
        ref = FAMILY_REFS[label]
        log(f"[16] {stamp()}")
        res = serve_form(launcher, dev, f"{tag} {label}", args[label], cfg0,
                         params, batch, plan_of.get(label, plans), uses,
                         results, totals, ref=ref if ref in (None, "gather")
                         else f"{tag} {ref}", want=want)
        if res["start"] != start:
            raise AssertionError(f"form ({tag} {label}) decoded from "
                                 f"{res['start']}, not {start}")
        out["forms"][label] = {k: v for k, v in res.items()
                               if k != "tokens"}
    if vlm:
        log(f"[16] vlm: every form decoded from position {start} = "
            f"{cfg0.n_patches} patches + {T} prompt tokens")
    else:
        log(f"[16] {stamp()}")
        out["ring"] = wrapped_ring(launcher, dev, cfg0, params, args["a"],
                                   plans, totals)
    # the served K1 / K2 / K4 calls at the new shapes
    out["lut_calls"] = []
    for label in ("a", "b", "f"):
        fcfg, tabs = served(label)
        calls = served_lut_calls(launcher, params, fcfg, batch, tabs)
        log(f"[16] form ({tag} {label}): {len(calls)} served K1/K2/K4 calls "
            f"of one prefill and one decode step equal their plain "
            f"versions bit for bit (K4 also K1 per site)")
        out["lut_calls"] += served_timings(calls, f"{tag} {label}", "16")
        del calls
    k1_in_place(out["lut_calls"])
    out["k3"] = check_mlp_k3(dev, params, cfg0, served("f")[1], B * start,
                             gen, tag)
    out["steps"] = {}
    for label in ("exact", "a"):
        fcfg, tabs = served(label)
        out["steps"][label] = profile_decode_step(
            launcher, f"{tag} {label}", fcfg, params, batch, tabs, tag="16")
    logits, _ = launcher.prefill(params, cfg0, batch, max_seq=start + 1)
    if logits.shape != (B, 1, cfg0.vocab_size) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"{arch}: bad logits {tuple(logits.shape)}")
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    log(f"[16] {tag}: parameters {out['param_bytes']} bytes, peak allocated "
        f"{out['peak_after_params']} after the parameters, "
        f"{out['peak']} over the phase")
    return out

# -------------------------------------------------------------------------
# phase 17: the encdec family and the other dense configurations
# -------------------------------------------------------------------------
# the forms phase 17 serves each configuration in, and what each is held
# against, as MOE_FORMS / MOE_REFS
P17_FORMS = {"whisper-small": ("exact", "a", "b", "d", "e", "f"),
             "phi4-mini-3.8b": ("exact", "a", "b", "d"),
             "nemotron-4-15b": ("exact", "a", "b", "d"),
             "deepseek-67b": ("exact", "a")}
P17_REFS = {"exact": None, "a": "gather", "b": "gather", "e": "gather",
            "d": "a", "f": "e"}
# LUT calls a whisper decoder layer makes under --lut-sites all: mlp,
# attn_exp twice (self- and cross-attention), norm_rsqrt three times (the
# self-attention's, the cross-attention's and the MLP's norms) and
# rope_table four times (sine and cosine of q and of k); the encoder
# serves no tables
P17_ALL_SITE_CALLS = 10
# depth cuts of the served models (phases 15-17), with their reason; the
# widths stay the published ones.  deepseek-67b's 95 layers at d_model 8192
# are 67.4 G parameters, 134.9 GB in bf16, more than one 80 GB card holds;
# the others are cut so that the script, with phase 23, stays within its
# 1200 s (PERF.md section 4 lists them): every check of the phases is
# per layer or per step, so half the depth leaves each of them in place
SERVE_TIME = "the script's 1200 s with phases 23-24"
SERVE_DEPTH = {
    "deepseek-moe-16b": (10, f"28 layers, 33.8 GB; {SERVE_TIME}"),
    "qwen3-moe-30b-a3b": (12, f"48 layers, 61.1 GB; {SERVE_TIME}"),
    "phi-3-vision-4.2b": (8, f"32 layers; {SERVE_TIME}"),
    "recurrentgemma-9b": (8, f"38 layers, 12 (rec, rec, attn) groups and "
                             f"2 tail; 2 groups and the tail: "
                             f"{SERVE_TIME}"),
    "phi4-mini-3.8b": (16, f"32 layers; {SERVE_TIME}"),
    "nemotron-4-15b": (8, f"32 layers; {SERVE_TIME}"),
    "deepseek-67b": (10, "95 layers are 134.9 GB in bf16, more than one "
                         f"80 GB card; 10: {SERVE_TIME}"),
}
P17_TAGS = {"whisper-small": "wsp", "phi4-mini-3.8b": "phi4",
            "nemotron-4-15b": "nem", "deepseek-67b": "ds67"}


def setup_model(launcher, args, n_layers=None):
    """``launch.serve.setup(args)``, with the configuration's depth cut to
    ``n_layers`` where one is given (its widths stay the published ones)."""
    if n_layers is None:
        return launcher.setup(args)
    orig = launcher.get_config
    launcher.get_config = lambda name: dataclasses.replace(
        orig(name), n_layers=n_layers)
    try:
        return launcher.setup(args)
    finally:
        launcher.get_config = orig


def encoder_split(launcher, params, cfg, batch, reps=3) -> dict:
    """whisper's prefill in two parts: the encoder alone over the batch's
    frames, and the whole prefill (encoder, cross K/V, decoder); the
    decoder's share is their difference.  Medians of ``reps`` runs, host
    clock around synchronised work."""
    import torch

    from repro_torch.nn.transformer import encoder_forward

    def run(fn):
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[1:])   # the first warms up

    enc_s = run(lambda: encoder_forward(params, cfg, batch["frames"]))
    pre_s = run(lambda: launcher.prefill(params, cfg, batch,
                                         max_seq=T + NEW))
    return {"encoder_s": enc_s, "prefill_s": pre_s,
            "decoder_prefill_s": pre_s - enc_s}


def run_phase17_model(launcher, dev, arch, totals, results, stamp) -> dict:
    """Phase 17 for one configuration at full width (random weights from
    seed 0, bf16; depth cuts in ``SERVE_DEPTH``): plans from 2
    calibration batches (``mlp``; every site for whisper's (e) / (f)); the
    forms ``P17_FORMS[arch]`` through :func:`serve_form`, each captured
    and eager (whisper's cross K/V left as prefill wrote them), with the
    launch counts its sites imply; every K1 / K2 / K4 call of a prefill
    and a decode step in forms (a), (b) and (f) held bit for bit against
    its plain version and timed; K3 at the MLP shape (gated or not);
    whisper's encoder timed apart from its decoder prefill; one eager and
    one captured decode step profiled (exact and (a))."""
    import torch

    labels = P17_FORMS[arch]
    tag = P17_TAGS[arch]
    gen = torch.Generator(device=dev).manual_seed(17)
    parse = launcher.parse_args
    common = ["--arch", arch, "--full", "--batch", str(B), "--prompt-len",
              str(T), "--new-tokens", str(NEW), "--device", "cuda"]
    lut = common + ["--lut-act", "--calib-steps", "2"]
    lut_all = lut + ["--lut-sites", "all"]
    args = {"exact": parse(common), "a": parse(lut),
            "b": parse(lut + ["--plan-exec", "unrolled"]),
            "d": parse(lut + ["--lut-fuse"]), "e": parse(lut_all),
            "f": parse(lut_all + ["--lut-fuse"])}
    depth, why = SERVE_DEPTH.get(arch, (None, None))
    torch.cuda.init()   # the allocator, before its peak is reset
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cfg0, params, batch, rng = setup_model(launcher, args["exact"], depth)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    start = launcher.decode_start(cfg0, batch)
    if start != T:
        raise AssertionError(f"{arch}: decoding would start at {start}, "
                             f"not {T}")
    encdec = cfg0.family == "encdec"
    out = {"arch": arch, "init_s": init_s, "n_layers": cfg0.n_layers,
           "depth_cut": why,
           "n_params": sum(p.numel() for p in params.parameters()),
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "peak_after_params": torch.cuda.max_memory_allocated(dev)}
    full_layers = launcher.get_config(arch).n_layers
    shape = (f"{cfg0.n_encoder_layers} encoder layers over "
             f"{cfg0.n_frames} stub frames (batch frames "
             f"{tuple(batch['frames'].shape)})" if encdec else
             "[gate|up] w_in" if cfg0.activation == "swiglu" else
             "w_in without a gate")
    log(f"[17] {cfg0.name}: {cfg0.n_layers} layers"
        + (f" (cut from {full_layers}: {why})" if depth else "")
        + f", d_model {cfg0.d_model}, {cfg0.n_heads}/{cfg0.n_kv_heads} "
        f"heads x {cfg0.d_head}, d_ff {cfg0.d_ff} {cfg0.activation}, vocab "
        f"{cfg0.vocab_size}, {cfg0.dtype}; {shape}; "
        f"{launcher.param_summary(params)}; built in {init_s:.1f}s")
    quiet = lambda msg: None
    plans = launcher.build_plans(args["a"], cfg0, params, rng,
                                 log=lambda msg: log("    " + msg))
    plan_of = {"exact": None}
    if "e" in labels:
        plan_of["e"] = plan_of["f"] = launcher.build_plans(
            args["f"], form_config(None, cfg0, args["f"]), params, rng,
            log=lambda msg: log("    " + msg))

    def served(label):
        """A form's served config and tables."""
        pl = plan_of.get(label, plans)
        tabs = (None if pl is None else
                launcher.serving_tables(args[label], pl, dev, log=quiet))
        return form_config(pl, cfg0, args[label]), tabs

    L, steps = cfg0.n_layers, 1 + NEW    # the prefill and NEW replays
    per_all = P17_ALL_SITE_CALLS
    forms = {   # the kernels a form must launch, and how often
        "exact": ([], {k: 0 for k in MOE_LUT}),
        "a": (["lut_act_stacked"], {"lut_act_stacked": steps * L}),
        "b": (["lut_act"], {"lut_act": steps * L}),
        "d": (["fused_matmul_lut"], {"fused_matmul_lut": steps * L,
                                     "lut_act_multi": 0}),
        "e": (["lut_act_stacked"], {"lut_act_stacked": steps * L * per_all}),
        "f": (["fused_matmul_lut", "lut_act_multi"],
              {"fused_matmul_lut": steps * L,
               "lut_act_multi": steps * L * (per_all - 1)}),
    }
    out["forms"] = {}
    for label in labels:
        uses, want = forms[label]
        ref = P17_REFS[label]
        log(f"[17] {stamp()}")
        res = serve_form(launcher, dev, f"{tag} {label}", args[label], cfg0,
                         params, batch, plan_of.get(label, plans), uses,
                         results, totals, ref=ref if ref in (None, "gather")
                         else f"{tag} {ref}", want=want)
        out["forms"][label] = {k: v for k, v in res.items()
                               if k != "tokens"}
    if encdec:
        split = encoder_split(launcher, params, cfg0, batch)
        a = out["forms"]["a"]
        out["encoder"] = dict(split, capture_s=a["capture_s"],
                              decode_tok_s=a["decode_tok_s"])
        log(f"[17] {tag} encoder over {B} x {cfg0.n_frames} frames: "
            f"{split['encoder_s']:.4f}s")
        log(f"[17] {tag} decoder prefill {B} x {T} (the whole prefill "
            f"{split['prefill_s']:.4f}s less the encoder): "
            f"{split['decoder_prefill_s']:.4f}s")
        log(f"[17] {tag} capture of the decode step, form (a): "
            f"{a['capture_s']:.4f}s")
        log(f"[17] {tag} decode, form (a): {a['decode_tok_s']:.1f} tok/s "
            f"captured, {a['eager']['decode_tok_s']:.1f} eager")
    # the served K1 / K2 / K4 calls at the new shapes
    out["lut_calls"] = []
    for label in [l for l in ("a", "b", "f") if l in labels]:
        fcfg, tabs = served(label)
        calls = served_lut_calls(launcher, params, fcfg, batch, tabs)
        log(f"[17] form ({tag} {label}): {len(calls)} served K1/K2/K4 calls "
            f"of one prefill and one decode step equal their plain "
            f"versions bit for bit (K4 also K1 per site)")
        out["lut_calls"] += served_timings(calls, f"{tag} {label}", "17")
        del calls
    k1_in_place(out["lut_calls"])
    fused_tabs = launcher.serving_tables(args["d"], plans, dev, log=quiet)
    out["k3"] = check_mlp_k3(dev, params, cfg0, fused_tabs, B * start, gen,
                             tag, phase="17")
    del fused_tabs
    out["steps"] = {}
    for label in ("exact", "a"):
        fcfg, tabs = served(label)
        out["steps"][label] = profile_decode_step(
            launcher, f"{tag} {label}", fcfg, params, batch, tabs, tag="17")
    logits, _ = launcher.prefill(params, cfg0, batch, max_seq=start + 1)
    if logits.shape != (B, 1, cfg0.vocab_size) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"{arch}: bad logits {tuple(logits.shape)}")
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    log(f"[17] {tag}: parameters {out['param_bytes']} bytes, peak allocated "
        f"{out['peak_after_params']} after the parameters, "
        f"{out['peak']} over the phase")
    return out


# ---------------------------------------------------------------------------
# phase 18: training through launch/train
# ---------------------------------------------------------------------------
P18_QWEN = ["--arch", "qwen3-0.6b", "--full", "--batch", "8", "--seq", "512",
            "--device", "cuda"]
P18_RWKV = ["--arch", "rwkv6-3b", "--full", "--remat", "--batch", "4",
            "--seq", "256", "--steps", "5", "--device", "cuda"]
P18_DEPTH = {
    "whisper-small": (None, None),
    "deepseek-moe-16b": (2, "16.88 G parameters take 135 GB with bf16 "
                            "gradients and moments; 2 of 28 layers keep the "
                            "published widths on one 80 GB card"),
    "recurrentgemma-9b": (3, "10.44 G parameters take 84 GB with bf16 "
                             "gradients and moments; one (rec, rec, attn) "
                             "group of the 38 layers"),
    "phi-3-vision-4.2b": (2, "3.83 G parameters would fit (31 GB with "
                             "gradients and moments); 2 of 32 layers keep "
                             "the phase within its time"),
}
# the supervised run's depth: its three checkpoints of the full depth took
# 44 s (4.5 GB each); phase 23 (d) runs the restart on ranks at this depth
P18_SUP_DEPTH = 2
P18_OTHERS = ["--full", "--batch", "4", "--seq", "64", "--steps", "2",
              "--device", "cuda"]


def attention_flops(cfg, b, t) -> float:
    """Forward and backward FLOPs of the attention products (scores and the
    value contraction, every query against every key as the port computes
    them): 3 x 4 B H T^2 Dh a layer."""
    return 12.0 * b * cfg.n_heads * t * t * cfg.d_head * cfg.n_layers


def model_flops(cfg, params, b, t) -> float:
    """6 x (parameters but the embedding table, which is a lookup) x tokens
    plus the attention products."""
    n = sum(p.numel() for n_, p in params.named_parameters()
            if n_ != "embed")
    return 6.0 * n * b * t + attention_flops(cfg, b, t)


def leaves_equal(torch, a: dict, b: dict) -> list:
    """The train-state leaves (``train.checkpoint.state_leaves``) where
    ``a`` and ``b`` differ in any bit."""
    from repro_torch.train.checkpoint import state_leaves

    bad = []
    for (p, x), (_, y) in zip(state_leaves(a), state_leaves(b)):
        same = (torch.equal(x, y) and x.dtype == y.dtype
                if isinstance(x, torch.Tensor) else x == y)
        if not same:
            bad.append(p)
    return bad


def train_steps(torch, s, n) -> dict:
    """``n`` steps of ``setup(...)['step']`` on ``setup(...)['batch_at']``
    from the state's step, each timed on the host clock with the device
    synchronized (no checkpoint is written)."""
    state = s["state"]
    out = {"losses": [], "grad_norms": [], "seconds": []}
    for step in range(state["step"], n):
        batch = s["batch_at"](step)
        t0 = time.perf_counter()
        state, m = s["step"](state, batch)
        torch.cuda.synchronize()
        out["seconds"].append(time.perf_counter() - t0)
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    return dict(out, state=state)


def train_run(tl, torch, dev, argv, label, cfg=None) -> dict:
    """``args.steps`` train steps of ``launch.train.setup`` from a fresh
    state (seed 0) with the peak memory of the run; the state is returned
    for checks and then freed by the caller."""
    args = tl.parse_args(argv)
    s = tl.setup(args, cfg=cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    out = train_steps(torch, s, args.steps)
    peak = torch.cuda.max_memory_allocated(dev)
    secs = out["seconds"][2:] or out["seconds"]
    step_s = statistics.median(secs)
    toks = args.batch * args.seq
    flops = model_flops(s["cfg"], out["state"]["params"], args.batch,
                        args.seq)
    r = {"label": label, "losses": out["losses"],
         "grad_norms": out["grad_norms"], "step_s": step_s,
         "seconds": out["seconds"], "tokens_s": toks / step_s,
         "peak_gb": peak / 1e9, "model_tflop": flops / 1e12,
         "bf16_peak_share": flops / step_s / PEAK_BF16_FLOPS,
         "params": sum(p.numel() for p in out["state"]["params"]
                       .parameters())}
    if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
        raise AssertionError(f"[18] {label}: a loss or gradient norm is not "
                             f"finite: {r['losses']} {r['grad_norms']}")
    log(f"[18] {label}: {r['params'] / 1e9:.3f}G params, "
        f"{args.batch}x{args.seq}, step {step_s * 1e3:.2f} ms (median of "
        f"steps >= 2), {r['tokens_s']:.0f} tokens/s, {r['model_tflop']:.2f}"
        f" TFLOP a step, {r['bf16_peak_share']:.3f} of the bf16 peak, peak "
        f"memory {r['peak_gb']:.2f} GB; losses "
        f"{[round(x, 4) for x in r['losses']]}, grad norms "
        f"{[round(x, 3) for x in r['grad_norms']]}")
    return dict(r, _state=out["state"], _setup=s, _args=args)


def k8b_cases(torch, dev, gen):
    """K8b's comparison cases at rwkv6-3b's training shape (4, 256, 40,
    64): random inputs with strong and with weak decay, ``log_w`` at the
    model's bound ``-e`` and at ``-30`` on every step, a ragged T, a
    given initial state and a T shorter than a chunk (40 of 64)."""
    b, t, h, n = 4, 256, 40, 64

    def rnd(hi, tt=t):
        q, k, v, dy = (torch.randn(b, tt, h, n, generator=gen, device=dev)
                       for _ in range(4))
        lw = -torch.exp(torch.rand(b, tt, h, n, generator=gen, device=dev)
                        * (hi + 3.0) - 3.0)
        return q, k, v, lw, torch.randn(h, n, generator=gen, device=dev), dy

    strong, weak = rnd(0.7), rnd(-1.0)
    at = lambda lw: strong[:3] + (torch.full_like(strong[3], lw),
                                  strong[4], strong[5])
    s0 = torch.randn(b, h, n, n, generator=gen, device=dev) * 0.1
    return {"strong decay": (strong, None), "weak decay": (weak, None),
            "log_w = -e": (at(-math.e), None),
            "log_w = -30": (at(-30.0), None),
            "ragged T 201": (rnd(0.7, 201), None),
            "initial state": (weak, s0),
            "T 40 (shorter than a chunk)": (rnd(0.7, 40), None)}


def check_k8b(dev, gen) -> tuple[float, tuple]:
    """K8b against ``wkv_backward_plain`` on the card: dq, dk, dv and du
    within ``1e-4`` of their largest entry (their entries are sums over up
    to T steps, du's over B x T, that cancel: an elementwise relative
    bound holds for neither of two float32 orders), dlog_w within ``1e-5``
    of the running sums it is the difference of (``max sum_t |q_t *
    dq_t|`` or ``|k_t * dk_t|``: at ``log_w = -30`` the exact dlog_w is
    about 1e-13 and both sides give the sums' float32 rounding); finite,
    two launches bit-identical, and a CUDA graph's replay of a call equal
    to the eager call bit for bit.  Returns the largest absolute
    difference and the strong-decay case's inputs (for timing)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.wkv import wkv_backward_plain

    worst = 0.0
    cases = k8b_cases(torch, dev, gen)
    for name, (args, s0) in cases.items():
        gk = ops.wkv_backward(*args, state=s0)
        g2 = ops.wkv_backward(*args, state=s0)
        gp = wkv_backward_plain(*args, state=s0)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            gg = ops.wkv_backward(*args, state=s0)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(a, c) for a, c in zip(gk, g2)):
            raise AssertionError(f"K8b {name}: two launches differ")
        if not all(torch.equal(a, c) for a, c in zip(gk, gg)):
            raise AssertionError(f"K8b {name}: a graph replay differs from "
                                 f"the eager call")
        del graph, gg
        if not all(torch.isfinite(a).all() for a in gk):
            raise AssertionError(f"K8b {name}: inf or nan")
        errs = [float((a - p).abs().max()) for a, p in zip(gk, gp)]
        tops = [float(p.abs().max()) for p in gp]
        sums = max(float((args[0] * gp[0]).abs().sum(1).max()),
                   float((args[1] * gp[1]).abs().sum(1).max()))
        tols = [1e-4 * t for t in tops]
        tols[3] = 1e-5 * sums
        worst = max([worst] + errs)
        log(f"    K8b {name} {tuple(args[0].shape)}: max |grad - plain| / "
            f"max |plain|: "
            + ", ".join(f"{g} {e:.2e} / {t:.3g}" for g, e, t in zip(
                ("dq", "dk", "dv", "dlog_w", "du"), errs, tops))
            + f" (dlog_w's running sums {sums:.3g}); two launches and a "
              f"graph replay bit-identical")
        if any(e > t for e, t in zip(errs, tols)):
            raise AssertionError(f"K8b differs from its plain version "
                                 f"beyond its tolerance: {name}")
    return worst, cases["strong decay"][0]


def k8b_work(b, t, h, n) -> tuple[int, int, int]:
    """(bytes, f32 CUDA-core operations, TF32 tensor-core operations) of
    one K8b launch, in K8's convention (``k8_work``): q, k, v, log_w, dy
    read and dq, dk, dv, dlog_w written once (u in, du out); per step and
    (batch, head) on the CUDA cores the decays of S and G (N^2 each) and
    about 24 N of vector work (the exps, beta, a, the gradients' bonus
    terms, the running sums), and as products the tensor cores could take
    (each three TF32 products, 3xTF32) the updates ``k v^T`` and ``q
    dy^T``, ``S dy``, ``G v`` and ``G^T k`` (2 N^2 each)."""
    steps = b * h * t
    return (4 * (9 * b * t * h * n + 2 * h * n),
            steps * (2 * n * n + 24 * n), steps * 3 * 10 * n * n)


def graph_kinds_of(fn) -> list[str]:
    """The kinds of the nodes one call of ``fn`` puts in a CUDA graph
    (after a warm-up call), from the graph's DOT dump (:func:`graph_nodes`):
    its kernels, copies and memsets."""
    import torch

    fn()
    torch.cuda.synchronize()
    with DebugGraphs():
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph_nodes(graph, OUT_DIR / "k8b_graph.dot")


KERNEL_KINDS = (("GEMM", ("gemm", "cutlass", "sm90", "nvjet", "xmma")),
                ("K8 / K8b", ("wkv",)),
                ("softmax / logsumexp", ("softmax", "logsumexp")),
                ("reduction", ("reduce",)),
                ("index / scatter / gather", ("index", "scatter", "gather")),
                ("copy / cast", ("copy", "cast")),
                ("elementwise", ("elementwise", "vectorized")))


def kernel_kind(name: str) -> str:
    low = name.lower()
    for kind, keys in KERNEL_KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def profile_train_step(label, setup, step) -> dict:
    """Where one training step's time goes (after the measured steps, so
    the step's state moves on): wall, kernels, device busy and idle share,
    and device time by kind of kernel.  Writes
    ``chiprun_out/profile_train_<label>.txt``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, batch = setup["state"], setup["batch_at"](step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        setup["step"](state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    kinds = {}
    for e in kern:
        k = kernel_kind(e.name)
        kinds[k] = kinds.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
    out = {"wall_ms": wall * 1e3, "kernels": len(kern),
           "device_busy_ms": busy_us / 1e3,
           "idle_share": (1 - busy_us / 1e6 / wall) if kern else None,
           "by_kind_ms": dict(sorted(kinds.items(), key=lambda kv: -kv[1]))}
    log(f"[18] training step ({label}) profiled: wall {wall * 1e3:.1f} ms, "
        f"{len(kern)} kernels, device busy {busy_us / 1e3:.1f} ms"
        + (f", idle share {out['idle_share']:.3f}" if kern else
           " (profiler saw no device events: idle not measured)")
        + "; by kind (ms): "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["by_kind_ms"].items()))
    (OUT_DIR / f"profile_train_{label}.txt").write_text(
        prof.key_averages().table(sort_by="cuda_time_total", row_limit=40))
    return out


# AdamW in slices against AdamW whole on the card: leaves cut at a
# threshold of 2^16 elements (one row a slice, 21 rows, one of 100000,
# whole) against the same update with no cut
P18_SLICE_CHUNK = 1 << 16
P18_SLICE_SHAPES = ((4, 64, 1024), (40, 3000), (2, 100000), (777,))


def p18_update_slices(dev) -> dict:
    """On the card: ``adamw_apply`` in slices of the leading axis bit for
    bit the whole leaves' update (float32 and bf16 leaves, the clip
    binding, the step's values as Python floats and as the captured
    form's 0-d tensors); an expert stack's share's slab terms
    (``slab_square_sums``) bit for bit its experts' columns of the whole
    stack's (deepseek-moe-16b's ``moe_w_in`` at 2 layers, bf16 and
    float32, the shares of tp 2 and 4); and the slab terms' cost beside
    one ``square_sum`` of the stack (``timed_ms``: host and device)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.optim import adamw as aw

    gen = torch.Generator(device=dev).manual_seed(18)
    cfg = aw.AdamWConfig(lr=1e-3, grad_clip_norm=1.0)
    clip = torch.tensor(np.float32(1.0), device=dev)
    count = 3
    c1 = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(count))
    c2 = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(count))
    forms = {"floats": (c1, c2, float(cfg.lr_at(count))),
             "scalars": tuple(torch.as_tensor(aw.adamw_step_scalars(
                 cfg, count), device=dev).unbind())}
    held = 0
    for dtype in (torch.float32, torch.bfloat16):
        leaves = [[torch.randn(sh, generator=gen, device=dev) * k
                   for sh in P18_SLICE_SHAPES] for k in (1.0, 2.0, 0.1, 0.01)]
        for form, (a1, a2, lr) in forms.items():
            outs = []
            for chunk in (P18_SLICE_CHUNK, None):
                ps, gs, ms, vs = ([t.to(dtype, copy=True) for t in ts]
                                  for ts in leaves)
                vs = [v.abs() for v in vs]
                st = {"mu": ms, "nu": vs, "count": count}
                old = aw.ADAMW_CHUNK
                aw.ADAMW_CHUNK = chunk or max(t.numel() for t in ps)
                try:
                    gn = aw.adamw_apply(gs, st, ps, cfg, clip, a1, a2, lr)
                finally:
                    aw.ADAMW_CHUNK = old
                outs.append([gn] + ps + ms + vs)
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise AssertionError(f"[18] AdamW in slices differs from "
                                     f"AdamW whole ({dtype}, {form})")
            held += 1
    m = get_config("deepseek-moe-16b").moe
    shape = (2, m.n_experts, get_config("deepseek-moe-16b").d_model,
             2 * m.d_expert)
    times = {}
    for dtype in (torch.bfloat16, torch.float32):
        t = torch.randn(shape, generator=gen, device=dev).to(dtype)
        whole = aw.slab_square_sums(t)
        for tp in (2, 4):
            e = shape[1] // tp
            for k in range(tp):
                part = aw.slab_square_sums(t[:, k * e:(k + 1) * e].contiguous())
                if not torch.equal(part, whole[:, k * e:(k + 1) * e]):
                    raise AssertionError(f"[18] the slab terms of share {k} "
                                         f"of {tp} differ from the whole "
                                         f"stack's ({dtype})")
        times[str(dtype)] = {
            "slabs_ms": timed_ms(lambda: aw.slab_square_sums(t), n=5,
                                 warmup=1, reps=3),
            "square_sum_ms": timed_ms(lambda: aw.square_sum(t), n=5,
                                      warmup=1, reps=3)}
        del t, whole
    out = {"adamw_cases": held, "slab_shape": shape,
           "slabs": shape[0] * shape[1], "times": times}
    log(f"[18] AdamW in slices (threshold {P18_SLICE_CHUNK}, leaves "
        f"{P18_SLICE_SHAPES}) bit for bit AdamW whole in {held} cases "
        f"(float32 and bf16, the clip binding, floats and the captured "
        f"form's tensors); slab terms of the shares of tp 2 and 4 bit for "
        f"bit the whole stack's at {shape}; the {out['slabs']} slabs' "
        f"terms / one square_sum of the stack: " + ", ".join(
            f"{k} {v['slabs_ms']:.3f} / {v['square_sum_ms']:.3f} ms"
            for k, v in times.items()))
    return out


def run_phase18(dev, stamp, gen) -> dict:
    """Training through ``repro_torch.launch.train``'s functions (module
    docstring, phase 18).  Returns the numbers for ``chip_smoke.json`` and
    K8b's kernel entry."""
    import shutil

    import torch

    from repro_torch.bridge import train_state_from_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.kernels.wkv import wkv_backward_plain
    from repro_torch.launch import train as tl
    from repro_torch.train import Supervisor, save_checkpoint

    ckpt_root = ROOT / "build" / "p18_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    res = {}

    def free(*rs):
        for r in rs:
            r.pop("_state", None)
            r.pop("_setup", None)
        gc.collect()
        torch.cuda.empty_cache()

    # ---- qwen3-0.6b at full width: 20 steps, the checkpoint restored --------
    main_dir = ckpt_root / "main"
    q = train_run(tl, torch, dev, P18_QWEN + ["--steps", "20"],
                  "qwen3-0.6b 20 steps")
    first, last5 = q["losses"][0], statistics.mean(q["losses"][-5:])
    if not last5 < first:
        raise AssertionError(f"[18] qwen3-0.6b: the mean of the last five "
                             f"losses {last5:.4f} is not below the first "
                             f"{first:.4f}")
    t0 = time.perf_counter()
    save_checkpoint(str(main_dir), q["_state"], 19)
    q["save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    restored, rstep = train_state_from_checkpoint(
        str(main_dir), q["_setup"]["cfg"], q["_setup"]["tcfg"], device=dev)
    bad = leaves_equal(torch, restored, q["_state"])
    if rstep != 19 or bad:
        raise AssertionError(f"[18] the full-width checkpoint (step "
                             f"{rstep}) differs from the state in {bad}")
    q["restore_s"] = time.perf_counter() - t0
    n_leaves = len(list(restored["params"].parameters())) * 3 + 2
    log(f"[18] {stamp()} qwen3-0.6b: losses fall (first {first:.4f}, mean of "
        f"the last five {last5:.4f}); the step-19 checkpoint ({n_leaves} "
        f"leaves) written in {q['save_s']:.1f}s and restored bit for bit "
        f"in {q['restore_s']:.1f}s")
    del restored
    q["profile"] = profile_train_step("qwen3", q["_setup"], 20)
    free(q)
    res["qwen3"] = q

    # the same first steps with --remat, --microbatch 2, --grad-compress
    for label, extra in (("remat", ["--remat"]),
                         ("microbatch 2", ["--microbatch", "2"]),
                         ("grad-compress", ["--grad-compress"])):
        r = train_run(tl, torch, dev,
                      P18_QWEN + ["--steps", "5"] + extra,
                      f"qwen3-0.6b 5 steps {label}")
        if label == "remat" and r["losses"][0] != q["losses"][0]:
            raise AssertionError(f"[18] --remat changed step 0's loss: "
                                 f"{r['losses'][0]!r} != {q['losses'][0]!r}")
        free(r)
        res[f"qwen3 {label}"] = r
    log(f"[18] {stamp()} --remat: step 0's loss bit-identical "
        f"({q['losses'][0]!r}); peak memory "
        f"{res['qwen3 remat']['peak_gb']:.2f} GB against {q['peak_gb']:.2f} "
        f"GB without")

    # a supervised run that fails once at step 7 against an uninterrupted
    # one, at P18_SUP_DEPTH layers
    args10 = tl.parse_args(P18_QWEN + ["--steps", "10"])
    sup_cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                                  n_layers=P18_SUP_DEPTH)
    ref = tl.setup(args10, cfg=sup_cfg)
    for i in range(10):
        ref["state"], _ = ref["step"](ref["state"], ref["batch_at"](i))
    raised = []
    s2 = tl.setup(args10, cfg=sup_cfg)

    def once(state, batch):
        if state["step"] == 7 and not raised:
            raised.append(True)
            raise RuntimeError("injected failure at step 7")
        return s2["step"](state, batch)

    t0 = time.perf_counter()
    out = tl.run(args10, s2, log=lambda m: log("    " + m),
                 supervisor=Supervisor(str(ckpt_root / "sup"), ckpt_every=5),
                 step_fn=once)
    bad = leaves_equal(torch, out["state"], ref["state"])
    if out["stats"]["restarts"] != 1 or bad:
        raise AssertionError(f"[18] the restarted run ({out['stats']}) "
                             f"differs from the uninterrupted one in {bad}")
    res["supervisor"] = {"restarts": 1, "seconds": time.perf_counter() - t0,
                         "losses": out["losses"]}
    log(f"[18] {stamp()} supervisor ({P18_SUP_DEPTH} of 28 layers): 10 "
        f"steps, checkpoints every 5, step 7 "
        f"raised once, resumed from step 4; parameters, moments, count and "
        f"step bit-identical to the uninterrupted run "
        f"({res['supervisor']['seconds']:.1f}s)")
    del ref, s2, out
    gc.collect()
    torch.cuda.empty_cache()
    # the step-19 checkpoint stays for phase 19, which removes it
    shutil.rmtree(ckpt_root / "sup", ignore_errors=True)

    # ---- rwkv6-3b at full width: K8b held, then 5 steps through K8 / K8b ----
    k8b_err, (kq, kk, kv, klw, ku, kdy) = check_k8b(dev, gen)
    log(f"[18] {stamp()} K8b held against its plain version (dq, dk, dv, du "
        f"within 1e-4 of their largest entry, dlog_w within 1e-5 of its "
        f"running sums); largest difference {k8b_err:.3e}")
    reset_launch_counts()
    r = train_run(tl, torch, dev, P18_RWKV, "rwkv6-3b 5 steps remat")
    counts = {k: v for k, v in launch_counts().items() if v}
    cfg = r["_setup"]["cfg"]
    want = {"wkv": 5 * 2 * cfg.n_layers, "wkv_backward": 5 * cfg.n_layers}
    if counts != want:
        raise AssertionError(f"[18] rwkv6-3b's 5 steps launched {counts}, "
                             f"not {want} (K8 twice a layer a step under "
                             f"remat, K8b once)")
    log(f"[18] rwkv6-3b launches in 5 steps: {counts} (K8 "
        f"{counts['wkv'] // 5}, K8b {counts['wkv_backward'] // 5} a step)")
    r["profile"] = profile_train_step("rwkv6", r["_setup"], 5)
    free(r)
    res["rwkv6"] = r
    kfn = lambda: ops.wkv_backward(kq, kk, kv, klw, ku, kdy)
    nbytes, nops, tc_ops = k8b_work(*kq.shape)
    bms, by = bound(nbytes, nops, PEAK_F32_FLOPS,
                    more=[(tc_ops, PEAK_TF32_FLOPS)])
    k8b = {"name": "wkv_backward", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/wkv_bwd.cu",
           "replaces": "src/repro/kernels/wkv.py:68",
           "backward_of": "wkv", "launches": counts["wkv_backward"],
           "max_abs_err": k8b_err, "shape": list(kq.shape),
           "ms": timed_ms(kfn, n=10), "graph_ms": graph_ms(kfn, n=10),
           "plain_ms": timed_ms(lambda: wkv_backward_plain(
               kq, kk, kv, klw, ku, kdy), n=1, warmup=1, reps=3),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    kinds = graph_kinds_of(kfn)
    k8b["cuda_kernels"] = kinds.count("KERNEL")
    log(f"[18] K8b: one call runs {k8b['cuda_kernels']} CUDA kernels (the "
        f"nodes of a graph of one call: {kinds})")
    log(f"[18] K8b at {k8b['shape']}: {k8b['ms'] * 1e3:.2f} us/launch (graph "
        f"{k8b['graph_ms'] * 1e3:.2f} us), bound {bms * 1e3:.2f} us ({by}: "
        f"{nbytes / 1e6:.1f} MB, {nops / 1e9:.2f} GFLOP f32, "
        f"{tc_ops / 1e9:.2f} GFLOP TF32), plain "
        f"{k8b['plain_ms'] * 1e3:.0f} us; launches {k8b['launches']}")
    del kq, kk, kv, klw, ku, kdy, kfn

    # ---- the other families, 2 steps each ---------------------------------
    for arch, (depth, why) in P18_DEPTH.items():
        cfg = get_config(arch)
        if depth is not None:
            log(f"[18] {arch}: n_layers cut from {cfg.n_layers} to {depth}: "
                f"{why}")
            cfg = dataclasses.replace(cfg, n_layers=depth)
        r = train_run(tl, torch, dev, ["--arch", arch] + P18_OTHERS,
                      f"{arch} 2 steps", cfg=cfg)
        free(r)
        res[arch] = r
    slices = p18_update_slices(dev)
    log(f"[18] {stamp()} done")
    for r in res.values():
        r.pop("_args", None)
    return {"runs": res, "k8b": k8b, "k8_launches": counts["wkv"],
            "update_slices": slices,
            "rwkv_step_launches": {f"cuda:{k}": v // 5
                                   for k, v in counts.items()},
            "ckpt_dir": main_dir}


# ---------------------------------------------------------------------------
# phase 24: the dry run (repro_torch.launch.dryrun) against the card
# ---------------------------------------------------------------------------
# the predicted peak against the card's: within 1% of the card's plus
# 64 MiB.  The trace counts each tensor's bytes; the caching allocator
# rounds every block up to 512 bytes, and a library workspace (cuBLAS /
# cuBLASLt, up to 32 MiB a handle on Hopper) first taken inside the step
# counts there only
P24_PEAK_RTOL = 0.01
P24_PEAK_ATOL = 64 * 2**20
# how far the fast stream may move a bf16 training loss: the CPU test's
# bound against the reference (tests/test_torch_dryrun.py, FAST_LOSS_RTOL)
P24_FAST_LOSS_RTOL = 1e-2
P24_FAST_STEPS = 3


def p24_real(run, rest, dev):
    """One step ``run()`` on the card under the roofline's cost counter:
    ``(costs, peak bytes, output)``, the peak the bytes of ``rest`` (the
    step's state and inputs at rest, as the dry run counts them) plus the
    allocator's high-water mark over the step above what was allocated
    before it (so other residents of the card do not count)."""
    import torch

    from repro_torch.launch.dryrun import _storages
    from repro_torch.roofline.costs import count_costs

    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with count_costs(dev) as c:
        out = run()
    torch.cuda.synchronize(dev)
    temp = torch.cuda.max_memory_allocated(dev) - before
    return c, sum(_storages(rest).values()) + temp, out


def p24_check(label, tr, real, real_peak, step_ms, what,
              want_launches=None) -> dict:
    """The dry run's trace ``tr`` of a step against the card's run of it:
    FLOPs, HBM bytes and launches a kernel point equal (the same program
    under the same counter), the predicted peak within P24_PEAK_*, and
    ``step_ms`` (``what`` says whose time it is) at least the bound."""
    fake = tr["costs"]
    ops_ = set(fake.per_comp_hbm) | set(real.per_comp_hbm)
    diff = {k: (fake.per_comp_hbm.get(k), real.per_comp_hbm.get(k))
            for k in sorted(ops_)
            if fake.per_comp_hbm.get(k) != real.per_comp_hbm.get(k)}
    if ((fake.flops, fake.hbm_bytes, fake.launches, fake.n_ops)
            != (real.flops, real.hbm_bytes, real.launches, real.n_ops)
            or diff):
        raise AssertionError(
            f"[24] {label}: the dry run counts {fake.flops} FLOPs, "
            f"{fake.hbm_bytes} bytes, {fake.n_ops} ops, {fake.launches}; "
            f"the card's step {real.flops}, {real.hbm_bytes}, {real.n_ops}"
            f", {real.launches}; bytes differ at {diff}")
    if want_launches is not None and fake.launches != want_launches:
        raise AssertionError(f"[24] {label}: the dry run prices "
                             f"{fake.launches}, the card launched "
                             f"{want_launches}")
    pred = tr["peak_bytes"]
    tol = P24_PEAK_RTOL * real_peak + P24_PEAK_ATOL
    if abs(pred - real_peak) > tol:
        raise AssertionError(f"[24] {label}: predicted peak {pred} bytes, "
                             f"the card's {real_peak} (tolerance {tol:.0f})")
    terms = tr["terms"]
    bound_ms = terms.bound_s * 1e3
    share = bound_ms / step_ms
    if share > 1.0:
        raise AssertionError(f"[24] {label}: {what} {step_ms:.3f} ms is "
                             f"below the bound {bound_ms:.3f} ms")
    out = {"flops": fake.flops, "hbm_bytes": fake.hbm_bytes,
           "n_ops": fake.n_ops, "launches": dict(fake.launches),
           "predicted_peak_bytes": pred, "card_peak_bytes": real_peak,
           "peak_diff_bytes": pred - real_peak, "bound_ms": bound_ms,
           "dominant": terms.dominant, "step_ms": step_ms,
           "step_ms_is": what, "bound_share": share,
           "trace_s": tr["trace_s"]}
    log(f"[24] {label}: dry run == card: {fake.flops:.6g} FLOPs, "
        f"{fake.hbm_bytes:.6g} HBM bytes, {fake.n_ops} ops, launches "
        f"{dict(fake.launches)}; peak predicted {pred / 1e9:.4f} GB, card "
        f"{real_peak / 1e9:.4f} GB (diff {(pred - real_peak) / 2**20:+.2f} "
        f"MiB); bound {bound_ms:.4f} ms ({terms.dominant}) against "
        f"{what} {step_ms:.4f} ms: share {share:.4f}; traced in "
        f"{tr['trace_s']:.1f}s")
    return out


def run_phase24_decode(dev, cfg0, plans, params, steps) -> dict:
    """Phase 24 (a): qwen3-0.6b's decode step at phase 5's shape (4
    requests, a cache of 64 + 16), exact and form (a) (``plans``' stacked
    tables on the cuda backend: K1), traced without data and run on the
    card under the same counter.  The bound is held against phase 12's
    replay of the same form's captured step (its cache of 64 + 2 a little
    smaller: the bound at 80 is the larger)."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.serve import decode_step, init_cache

    with ops.abstract():   # the trace's tables: same slabs, no data
        traced = plans.tables_for_model(backend="cuda", device="meta")
    tables = plans.tables_for_model(backend="cuda", device=dev)
    cfg = plans.patched_config(cfg0)
    out = {}
    seq = T + NEW
    for label, scfg, tab, ttab in (("exact", cfg0, None, None),
                                   ("a", cfg, tables, traced)):
        tr = trace_step(scfg, "decode", B, seq, lut_tables=ttab)
        cache = init_cache(scfg, B, seq, device=dev)
        tok = torch.zeros((B, 1), dtype=torch.long, device=dev)
        pos = torch.tensor(seq - 1, dtype=torch.long, device=dev)
        real, peak, _ = p24_real(
            lambda: decode_step(params, scfg, cache, tok, pos,
                                lut_tables=tab),
            (params, (cache, tok, pos), tab), dev)
        want = {f"cuda:{k}": v for k, v in steps[label]["launches"].items()}
        out[label] = p24_check(
            f"(a) qwen3-0.6b decode {label}", tr, real, peak,
            steps[label]["captured"]["replay_ms"],
            "phase 12's captured replay", want)
        del cache
    return out


def run_phase24_train(dev, stamp, p18) -> dict:
    """Phase 24 (b)-(d): qwen3-0.6b's training step at phase 18's 8 x 512
    and rwkv6-3b's with ``--remat`` at 4 x 256, each traced without data
    and its first step run on the card under the same counter, the
    bound held against phase 18's step times; then qwen3-0.6b's step with
    the fast stream on and off (losses within P24_FAST_LOSS_RTOL, the dry
    run's HBM bytes beside the measured step ms)."""
    import torch

    from repro_torch.launch import train as tl
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.nn.layers import set_fast_stream
    from repro_torch.train.step import batch_to_device

    runs = p18["runs"]
    out = {}

    def case(argv, label, step_ms, want=None, fast=False):
        """Trace, count and check one step; with ``step_ms`` ``None``,
        time P24_FAST_STEPS pairs of steps after it on the same state,
        the fast stream on and off in turns."""
        args = tl.parse_args(argv)
        set_fast_stream(fast)
        times = {True: [], False: []}
        try:
            s = tl.setup(args)
            cfg, tcfg = s["cfg"], s["tcfg"]
            tr = trace_step(cfg, "train", args.batch, args.seq, tcfg=tcfg)
            state = s["state"]
            batch = batch_to_device(s["batch_at"](0), dev)
            real, peak, (_, m) = p24_real(
                lambda: s["step"](state, batch), (state, batch), dev)
            for _ in range(P24_FAST_STEPS if step_ms is None else 0):
                for on in (True, False):
                    set_fast_stream(on)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    s["step"](state, batch)
                    torch.cuda.synchronize()
                    times[on].append(time.perf_counter() - t0)
        finally:
            set_fast_stream(False)
        med = {on: statistics.median(v) * 1e3 for on, v in times.items()
               if v}
        r = p24_check(label, tr, real, peak,
                      med[fast] if step_ms is None else step_ms,
                      "phase 18's step" if step_ms is not None
                      else "the step's median", want)
        r.update(loss=float(m["loss"]), median_ms=med)
        del s, state, batch
        gc.collect()
        torch.cuda.empty_cache()
        return r

    args_q = P18_QWEN + ["--steps", "1"]
    out["b"] = case(args_q, "(b) qwen3-0.6b train 8x512",
                    runs["qwen3"]["step_s"] * 1e3)
    log(f"[24] {stamp()}")
    out["c"] = case(P18_RWKV, "(c) rwkv6-3b train remat 4x256",
                    runs["rwkv6"]["step_s"] * 1e3,
                    p18["rwkv_step_launches"])
    log(f"[24] {stamp()}")
    # (d): the fast stream's step against (b)'s, from the same state and
    # batch; then steps with it on and off in turns
    d = case(args_q, "(d) qwen3-0.6b train 8x512 fast stream", None,
             fast=True)
    lf, lo = d["loss"], out["b"]["loss"]
    if abs(lf - lo) > P24_FAST_LOSS_RTOL * abs(lo):
        raise AssertionError(f"[24] (d) the fast stream's loss {lf} is not "
                             f"within {P24_FAST_LOSS_RTOL} of {lo}")
    d_bytes = d["hbm_bytes"] - out["b"]["hbm_bytes"]
    on_ms, off_ms = d["median_ms"][True], d["median_ms"][False]
    out["d"] = dict(d, loss_rel_diff=abs(lf - lo) / abs(lo),
                    hbm_bytes_change=d_bytes, step_ms_change=on_ms - off_ms)
    log(f"[24] (d) fast stream: loss {lf:.6f} against {lo:.6f} off "
        f"(relative {abs(lf - lo) / abs(lo):.2e}, within "
        f"{P24_FAST_LOSS_RTOL}); the dry run's HBM bytes change by "
        f"{d_bytes:+.6g} ({d_bytes / out['b']['hbm_bytes']:+.2%}, "
        f"{d_bytes / PEAK_BYTES_S * 1e3:+.3f} ms at the HBM peak); the "
        f"step's median of {P24_FAST_STEPS}, on and off in turns, by "
        f"{on_ms - off_ms:+.3f} ms ({on_ms:.3f} against {off_ms:.3f}; no "
        f"pass or fail on the speed)")
    return out


# ---------------------------------------------------------------------------
# phase 19: the autotuner and the serving control plane at full width
# ---------------------------------------------------------------------------
# launch/tune's flags (the reference's own): 4 x 64 x 4 held-out tokens
# resolve a top-1 drop of 1/1024
P19_TUNE = ["--full", "--arch", "qwen3-0.6b", "--backend", "cuda",
            "--calib-steps", "4", "--eval-steps", "4", "--batch", "4",
            "--seq", "64", "--grid", "default", "--device", "cuda"]
# form (a) through the batcher: 4 slots, 16 new tokens a request
P19_SERVE = ["--arch", "qwen3-0.6b", "--full", "--batch", str(BATCHER_SLOTS),
             "--prompt-len", str(T), "--new-tokens", str(NEW), "--lut-act",
             "--calib-steps", "2", "--device", "cuda"]


def ladder_run(cfg, params, plans, prompts, dev, *, inject=None,
               corrupt=False) -> dict:
    """Serve ``prompts`` (``NEW`` tokens each, replay prefill) through
    ``BATCHER_SLOTS`` slots under a :class:`DegradationLadder` at its
    default top rung (``cuda_fused``: the mlp site through K4 on the
    super-slab).  ``inject``: ``(point, times, after)`` armed for the run;
    ``corrupt``: the ``cuda_fused`` rung's super-slab bit-flipped before
    the first step, with revalidation every tick.  Returns the tokens by
    request, the ladder, the batcher's metrics, the launch counts of the
    run, the rung and counts at each tick, and the seconds."""
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.serve import ContinuousBatcher, Request
    from repro_torch.serve.degrade import (
        CompositeSupervisor,
        DegradationLadder,
    )
    from repro_torch.serve.faults import FaultInjector, corrupt_rung

    lad = DegradationLadder(plans, plan_exec="stacked", device=dev,
                            revalidate_every=1 if corrupt else 0)
    if lad.status() != {"mlp": "cuda_fused"}:
        raise AssertionError(f"[19] the ladder's top rung: {lad.status()}")
    if corrupt:
        corrupt_rung(lad, "cuda_fused", "mlp")
    trace = []

    class Trace:   # the rung and the counts as each tick starts
        def on_tick(self, b):
            trace.append((b.steps, lad.rung_for("mlp"), launch_counts()))

    b = ContinuousBatcher(cfg, params, BATCHER_SLOTS,
                          max(len(p) for p in prompts) + NEW, eos_token=-1,
                          lut_tables=lad.tables(), prefill="replay",
                          supervisor=CompositeSupervisor(lad, Trace()))
    reqs = [Request(rid=i, prompt=p, max_new=NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        b.submit(r)
    before = launch_counts()
    with FaultInjector() as fi:
        if inject:
            fi.inject(inject[0], times=inject[1], after=inject[2],
                      message=f"injected fault at {inject[0]}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = b.run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    after = launch_counts()
    m = b.metrics()
    if m["dropped"] or m["finished"] != len(prompts) or any(
            len(r.out) != NEW for r in done):
        raise AssertionError(f"[19] ladder run: metrics {m}")
    return {"tokens": [r.out for r in sorted(done, key=lambda r: r.rid)],
            "ladder": lad, "metrics": m, "seconds": secs, "trace": trace,
            "fired": list(fi.log), "end": after,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}


def run_phase19(dev, stamp, ckpt_dir) -> dict:
    """The autotuner and the serving control plane (module docstring,
    phase 19): tune full-width qwen3-0.6b from phase 18's checkpoint
    through ``launch/tune``'s functions, then serve form (a) and the tuned
    artifact through the batcher behind the parity gate and the ladder.
    Returns the numbers for ``chip_smoke.json`` and the phase's launches;
    removes the checkpoint."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve as launcher
    from repro_torch.launch import tune as tl
    from repro_torch.serve.faults import corrupt_file
    from repro_torch.serve.reload import PlanReloader
    from repro_torch.tune import save_tuned_plan, tuned_plan_from_serving

    start = launch_counts()
    art = OUT_DIR / "artifacts"
    art.mkdir(parents=True, exist_ok=True)
    out = {}

    # ---- tune from the checkpoint -----------------------------------------
    targs = tl.parse_args(P19_TUNE + [
        "--ckpt-dir", str(ckpt_dir), "--out", str(art / "tuned_qwen3.npz"),
        "--bench-out", str(OUT_DIR / "tune_qwen3.json")])
    t0 = time.perf_counter()
    tuned = tl.run(targs, log=lambda m: log("    " + m))
    oc = tuned["outcome"]
    params, cfg0 = tuned["params"], tuned["cfg"]
    if tuned["info"]["source"] != "checkpoint":
        raise AssertionError(f"[19] trained_params did not restore phase "
                             f"18's checkpoint: {tuned['info']}")
    k1_sweep = tuned["sweep_launches"].get("lut_act_stacked", 0)
    if not k1_sweep:
        raise AssertionError(f"[19] the sweep launched no K1: "
                             f"{tuned['sweep_launches']}")
    if tuned["failures"]:
        raise AssertionError(f"[19] launch/tune's strict rules failed: "
                             f"{tuned['failures']}")
    out["tune"] = {
        "seconds": time.perf_counter() - t0, "stages": tuned["stages"],
        "info": tuned["info"], "sweep_launches": tuned["sweep_launches"],
        "default_cost": oc.default.cost, "cost": oc.cost,
        "frontier": [r.point.label() for r in oc.frontier],
        "selected": oc.selected.point.label() if oc.selected else None,
        "assignment": {k: p.label() for k, p in oc.assignment.items()},
        "metrics": oc.metrics.to_dict(), "greedy": {
            k: v for k, v in oc.greedy.items() if k != "history"},
        "sweep": [r.to_dict() for r in oc.results]}
    log(f"[19] {stamp()} tuned from the step-{tuned['info']['step']} "
        f"checkpoint: {oc.cost} P-LUTs against the default's "
        f"{oc.default.cost} at a top-1 drop of {oc.metrics.top1_drop:.4f} "
        f"over {oc.metrics.n_tokens} tokens; frontier "
        f"{out['tune']['frontier']}; selected {out['tune']['selected']}; "
        f"{len(oc.results)} points; gather == cuda and the round trip "
        f"token-identical on both; K1 launched {k1_sweep} times in the "
        f"sweep; stages (s) "
        f"{ {k: round(v, 2) for k, v in tuned['stages'].items()} }")

    # ---- form (a) from the same parameters ---------------------------------
    args = launcher.parse_args(P19_SERVE)
    cfg_s, _, _, rng = launcher.setup(args)
    if cfg_s != cfg0:
        raise AssertionError("[19] the serving and tuning configs differ")
    gc.collect()
    torch.cuda.empty_cache()
    plans = launcher.build_plans(args, cfg0, params, rng,
                                 log=lambda m: log("    " + m))
    cfg = plans.patched_config(cfg0)
    prng = np.random.default_rng(19)
    prompts = [[int(t) for t in prng.integers(1, cfg.vocab_size, int(n))]
               for n in prng.integers(T // 4, T + 1, BATCHER_REQUESTS)]

    # ---- the ladder: no fault, the K4 fault drill (the first fault in
    # the capture's warm-up, and again inside the graph capture itself), a
    # corrupted slab --------------------------------------------------------
    from repro_torch.serve.graphs import WARMUP_STEPS

    point = "cuda:lut_act_multi"
    in_capture = WARMUP_STEPS * cfg.n_layers    # K4 hits before the capture
    runs = {}
    ladder_run(cfg, params, plans, prompts[:BATCHER_SLOTS], dev)  # warm-up
    clean = runs["clean"] = ladder_run(cfg, params, plans, prompts, dev)
    runs["drill"] = ladder_run(cfg, params, plans, prompts, dev,
                               inject=(point, 2, 0))
    runs["drill in capture"] = ladder_run(cfg, params, plans, prompts, dev,
                                          inject=(point, 2, in_capture))
    slab = runs["corrupt slab"] = ladder_run(cfg, params, plans, prompts, dev,
                                             corrupt=True)
    if clean["ladder"].demotions or not clean["launches"].get(
            "lut_act_multi"):
        raise AssertionError(f"[19] the run with nothing injected: "
                             f"{clean['ladder'].demotions} demotions "
                             f"{clean['ladder'].faults}, launches "
                             f"{clean['launches']}")
    drills = {}
    for label, after in (("drill", 0), ("drill in capture", in_capture)):
        r = runs[label]
        lad = r["ladder"]
        rungs = [x for _, x, _ in r["trace"]]
        promoted = next((i for i, x in enumerate(rungs)
                         if x == "cuda_fused" and "cuda" in rungs[:i]), None)
        if (r["fired"] != [(point, after + 1), (point, after + 2)]
                or lad.demotions != 1 or lad.promotions != 1
                or lad.faults[0][:2] != ("mlp", "cuda_fused")
                or "injected fault" not in lad.faults[0][2]
                or lad.status() != {"mlp": "cuda_fused"}
                or promoted is None):
            raise AssertionError(f"[19] the K4 fault {label}: fired "
                                 f"{r['fired']}, demotions {lad.demotions}, "
                                 f"promotions {lad.promotions}, faults "
                                 f"{lad.faults}, rungs by tick {rungs}")
        # the run with nothing injected launches no K1: every K1 of a
        # drill ran while the site was demoted
        d = {"promoted_tick": promoted,
             "k1_demoted": (r["trace"][promoted][2]["lut_act_stacked"]
                            - r["trace"][0][2]["lut_act_stacked"]),
             "k4_after": (r["end"]["lut_act_multi"]
                          - r["trace"][promoted][2]["lut_act_multi"])}
        if d["k4_after"] <= 0 or d["k1_demoted"] <= 0:
            raise AssertionError(f"[19] the {label}'s launches: {d}")
        drills[label] = d
    if slab["ladder"].demotions != 1 or slab["ladder"].status() != {
            "mlp": "cuda"} or "validation vs gather failed" not in (
            slab["ladder"].health["mlp"].last_fault or ""):
        raise AssertionError(f"[19] the corrupted super-slab: "
                             f"{slab['ladder'].status()}, "
                             f"{slab['ladder'].faults}")
    for label in ("drill", "drill in capture", "corrupt slab"):
        if runs[label]["tokens"] != clean["tokens"]:
            raise AssertionError(f"[19] {label}: the tokens differ from the "
                                 f"run with nothing injected")
    for label, r in runs.items():
        log(f"[19] {stamp()} ladder {label}: {len(prompts)} requests in "
            f"{r['seconds']:.3f}s, {r['metrics']['ticks']} ticks, "
            f"{r['metrics']['table_swaps']} table swaps, demotions "
            f"{r['ladder'].demotions}, promotions {r['ladder'].promotions}, "
            f"rungs by tick {[x for _, x, _ in r['trace']]}, launches "
            f"{r['launches']}, fired {r['fired']}")
    log(f"[19] the K4 fault drill, the first fault in the capture's "
        f"warm-up and inside the graph capture ({in_capture} K4 calls "
        f"after): mlp demoted cuda_fused -> cuda at the first fault, "
        + "; ".join(f"{k}: K1 launched {d['k1_demoted']} times while "
                    f"demoted, re-promoted at tick {d['promoted_tick']}, "
                    f"K4 launched {d['k4_after']} times after"
                    for k, d in drills.items())
        + f"; the corrupted super-slab caught by revalidation "
        f"({slab['ladder'].health['mlp'].last_fault}); every request's "
        f"tokens equal the run with nothing injected; no unforced demotion")

    # ---- hot reload through the launcher: the tuned artifact, a frozen
    # copy of the active plans, a corrupted file ----------------------------
    frozen = save_tuned_plan(str(art / "frozen_qwen3_a.npz"),
                             tuned_plan_from_serving(cfg, plans))
    reloads = {}
    for label, path in (("tuned", tuned["path"]), ("frozen", frozen)):
        rargs = launcher.parse_args(P19_SERVE + ["--reload-plan", path,
                                                 "--degrade"])
        r = launcher.serve_with_reload(
            rargs, cfg, params, None,
            launcher.serving_tables(rargs, plans, dev, log=lambda m: None),
            plans, log=lambda m: log("    " + m), prompts=prompts)
        rec = r["reloader"].records[-1]
        m = r["metrics"]
        if (m["dropped"] or m["finished"] != len(prompts)
                or r["ladder"].demotions
                or rec.stage not in ("cutover", "gate")):
            raise AssertionError(f"[19] reload {label}: {rec}, metrics {m}, "
                                 f"ladder {r['ladder'].faults}")
        toks = [x.out for x in sorted(r["finished"], key=lambda x: x.rid)]
        if label == "frozen" and (not rec.ok or toks != clean["tokens"]):
            raise AssertionError(f"[19] the frozen plan's reload: {rec}; "
                                 f"tokens equal the clean run's: "
                                 f"{toks == clean['tokens']}")
        reloads[label] = {
            "stage": rec.stage, "ok": rec.ok, "reason": rec.reason,
            "top1_drop": rec.top1_drop,
            "token_agreement": rec.token_agreement, "load_s": rec.load_s,
            "gate_s": rec.gate_s, "tick": rec.tick, "seconds": r["seconds"],
            "table_swaps": m["table_swaps"],
            "counters": dict(r["reloader"].counters)}
        log(f"[19] {stamp()} reload {label}: {rec.summary()}; "
            f"{m['finished']} finished, dropped 0, {m['table_swaps']} table "
            f"swaps, ladder {r['ladder'].status()} with no demotion")
    bad = corrupt_file(tuned["path"], str(art / "tuned_qwen3_bad.npz"))
    rec = PlanReloader(r["batcher"], cfg, params).reload(bad)
    if rec.ok or rec.stage != "load" or "tuned_qwen3_bad" not in rec.reason:
        raise AssertionError(f"[19] the corrupted artifact: {rec}")
    reloads["corrupt"] = {"stage": rec.stage, "reason": rec.reason}
    log(f"[19] corrupted artifact rejected at load: {rec.reason}")
    out["ladder"] = {k: {"seconds": r["seconds"], "tokens": r["tokens"],
                         "launches": r["launches"], "fired": r["fired"],
                         "rungs": [x for _, x, _ in r["trace"]],
                         "demotions": r["ladder"].demotions,
                         "promotions": r["ladder"].promotions,
                         "metrics": r["metrics"]}
                     for k, r in runs.items()}
    out["drill"] = drills
    out["reload"] = reloads
    out["tuned_path"] = str(tuned["path"])
    end = launch_counts()
    out["launches"] = {k: end[k] - start[k] for k in end
                       if end[k] != start[k]}
    log(f"[19] {stamp()} phase 19's launches: {out['launches']}")
    shutil.rmtree(ROOT / "build" / "p18_ckpt", ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: telemetry on the served path at full width
# ---------------------------------------------------------------------------
# form (a) through the launcher and the batcher: 4 slots, 16 new tokens a
# request (form (d) adds --lut-fuse)
P20_SERVE = P19_SERVE
# interleaved repeats of the overhead runs (eager walls vary up to 2x)
P20_ROUNDS = 3


def p20_batcher(cfg, params, tables, prompts, *, monitor=None,
                prefill="step", batcher=None):
    """Serve ``prompts`` (``NEW`` tokens each) through ``BATCHER_SLOTS``
    slots of a :class:`ContinuousBatcher` (``batcher``, whose steps are
    captured already, or a new one), under a telemetry with ``monitor``
    when one is given.  Returns the tokens by request, the batcher, the
    telemetry (or ``None``), the monitor's counts and the seconds of the
    run (the device synchronized)."""
    import contextlib

    import torch

    from repro_torch import obs
    from repro_torch.serve import ContinuousBatcher, Request

    b = batcher or ContinuousBatcher(
        cfg, params, BATCHER_SLOTS, max(len(p) for p in prompts) + NEW,
        eos_token=-1, lut_tables=tables, prefill=prefill)
    n0 = len(b.finished)
    for i, p in enumerate(prompts):
        b.submit(Request(rid=i, prompt=p, max_new=NEW))
    tel = (obs.Telemetry(events=obs.EventLog(), monitor=monitor)
           if monitor is not None else None)
    with tel if tel is not None else contextlib.nullcontext():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = b.run()[n0:]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = monitor.counts() if monitor is not None else {}
    m = b.metrics()
    if m["dropped"] or len(done) != len(prompts) or any(
            len(r.out) != NEW for r in done):
        raise AssertionError(f"[20] batcher run: metrics {m}")
    return ([r.out for r in sorted(done, key=lambda r: r.rid)], b, tel,
            counts, secs)


def graph_nodes(graph, path: Path) -> list:
    """The kinds of the nodes (kernels, copies, memsets) of a CUDA graph,
    one entry a node, from the graph's DOT dump
    (``cudaGraphDebugDotPrint``; the graph was captured in debug mode,
    which keeps it): exact, where a profiler trace of one replay can drop
    events (the whole script's run lost a replay's first 52, and saw none
    of one K8b call's)."""
    graph.debug_dump(str(path))
    if not path.exists():
        raise AssertionError("the captured graph was not kept: no DOT dump")
    text = path.read_text()
    path.unlink()
    starts = [m.end() for m in re.finditer(
        r'(?<!-> )"graph_\d+_node_\d+"\s*\[', text)]
    # a node's kind opens its label (an edge's attributes have none)
    kinds = [re.match(r'[^\]]*?label="\{?\s*(\w+)', text[i:i + 400])
             for i in starts]
    kinds = [k[1] for k in kinds if k]
    if not kinds:
        raise AssertionError(f"no labelled node in the DOT dump: "
                             f"{text[:300]!r}")
    return kinds


def p20_same_graph(form, off, plain) -> None:
    """The plain graph holds the telemetry-off graph's nodes, kind for
    kind."""
    import collections

    if collections.Counter(off) != collections.Counter(plain):
        raise AssertionError(
            f"[20] form ({form}): the plain graph has {len(plain)} nodes "
            f"({dict(collections.Counter(plain))}), the telemetry-off graph "
            f"{len(off)} ({dict(collections.Counter(off))})")


class DebugGraphs:
    """Inside, every ``torch.cuda.CUDAGraph`` keeps its graph after the
    capture (``keep_graph=True``: instantiated at the first replay) and is
    in debug mode, for :func:`graph_nodes`: on the card's PyTorch
    (2.11), debug mode alone drops the graph at the end of the capture."""

    def __enter__(self):
        import torch

        self.real = real = torch.cuda.CUDAGraph

        class DebugGraph(real):
            def __new__(cls, *args, **kw):
                return super().__new__(cls, keep_graph=True)

            def __init__(self, *args, **kw):
                super().__init__(keep_graph=True)
                self.enable_debug_mode()

        torch.cuda.CUDAGraph = DebugGraph
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.CUDAGraph = self.real


def run_phase20(dev, stamp, tuned_path=None) -> dict:
    """Telemetry on the served path (module docstring, phase 20):
    full-width qwen3-0.6b, random weights from seed 0, form (a) through
    the launcher with ``--obs-log`` and through the batcher under the
    drift monitor (forms (a) and (d)), the card's counts against a host
    recount, in-distribution and out-of-distribution drift, the control
    plane's timeline, and the overhead of telemetry on the batcher.
    Returns the numbers for ``chip_smoke.json`` and the phase's
    launches."""
    import collections
    import subprocess

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.calib import synthetic_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch import serve as launcher
    from repro_torch.nn.transformer import decoder_forward
    from repro_torch.serve.faults import corrupt_file
    from repro_torch.serve.reload import PlanReloader
    from repro_torch.tune import save_tuned_plan, tuned_plan_from_serving

    quiet = lambda m: None
    start = launch_counts()
    obs_dir = OUT_DIR / "obs"
    obs_dir.mkdir(parents=True, exist_ok=True)
    for f in obs_dir.iterdir():   # the event logs append
        f.unlink()
    art = OUT_DIR / "artifacts"
    art.mkdir(parents=True, exist_ok=True)
    out = {}

    # ---- (a) the launcher's functions with --obs-log ----------------------
    serve_log = obs_dir / "serve.jsonl"
    args_o = launcher.parse_args(P20_SERVE + ["--obs-log", str(serve_log)])
    args_a = launcher.parse_args(P20_SERVE)
    args_d = launcher.parse_args(P20_SERVE + ["--lut-fuse"])
    cfg0, params, batch, rng = launcher.setup(args_a)
    tel = launcher.open_telemetry(args_o)
    with tel:
        plans = launcher.build_plans(args_o, cfg0, params, rng, log=quiet,
                                     tel=tel)
        cfg = plans.patched_config(cfg0)
        tabs_a = launcher.serving_tables(args_o, plans, dev, log=quiet)
        on = launcher.serve(args_o, cfg, params, batch, tabs_a, log=quiet)
    calib = tel.monitor.calib
    off = launcher.serve(args_a, cfg, params, batch, tabs_a, log=quiet)
    if on["tokens"] != off["tokens"]:
        raise AssertionError(f"[20] the launcher's tokens with --obs-log "
                             f"{on['tokens'][0]} differ from without "
                             f"{off['tokens'][0]}")
    recs = obs.read_events(str(serve_log))
    drift = {r["site"]: r for r in recs if r["event"] == "drift"}
    missing = [k for k in calib.masks
               if k not in drift or drift[k]["lookups"] <= 0]
    if missing:
        raise AssertionError(f"[20] calibration keys with no served "
                             f"lookups in the drift rows: {missing}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.obs", str(serve_log),
         "--limit", "12"], env=env, capture_output=True, text=True,
        timeout=300)
    if cli.returncode != 0:
        raise AssertionError(f"[20] launch.obs failed: {cli.stderr}")
    (obs_dir / "serve_report.txt").write_text(cli.stdout)
    served = sum(r["lookups"] for r in drift.values())
    hits = sum(r["dontcare_hits"] for r in drift.values())
    out["launcher"] = {
        "records": len(recs), "drift_keys": len(drift), "lookups": served,
        "dontcare_hits": hits, "decode_tok_s_on": on["decode_tok_s"],
        "decode_tok_s_off": off["decode_tok_s"]}
    log(f"[20] {stamp()} (a) launch/serve --obs-log: tokens equal without "
        f"it; {len(recs)} records read back; {len(drift)} drift rows, one "
        f"per calibration key, {served} lookups, {hits} don't-care hits "
        f"({hits / served:.6f}); decode {on['decode_tok_s']:.1f} tok/s on "
        f"(every step monitored), {off['decode_tok_s']:.1f} off; "
        f"launch.obs renders it (head):")
    for line in cli.stdout.splitlines()[:16]:
        log(f"      {line}")

    # ---- (b) the batcher under the monitor, forms (a) and (d) --------------
    cfg_d = form_config(plans, cfg0, args_d)
    tabs_d = launcher.serving_tables(args_d, plans, dev, log=quiet)
    prng = np.random.default_rng(20)
    prompts = [[int(t) for t in prng.integers(1, cfg.vocab_size, int(n))]
               for n in prng.integers(T // 4, T + 1, BATCHER_REQUESTS)]
    tok = torch.zeros((BATCHER_SLOTS, 1), dtype=torch.long, device=dev)
    dot = obs_dir / "graph.dot"
    out["batcher"] = {}
    for form, fcfg, ftabs in (("a", cfg, tabs_a), ("d", cfg_d, tabs_d)):
        with DebugGraphs():
            base, b_off, _, _, secs_off = p20_batcher(fcfg, params, ftabs,
                                                      prompts)
        nodes_off = graph_nodes(b_off._step.graph, dot)
        k_off = len(nodes_off)
        row = {"kernels_off": k_off, "seconds_off": secs_off}
        sums = {}
        for every in (1, 4):
            mon = obs.DontCareMonitor(calib, sample_every=every, device=dev)
            with DebugGraphs():
                got, b, t, counts, secs = p20_batcher(
                    fcfg, params, ftabs, prompts, monitor=mon)
            if got != base:
                raise AssertionError(f"[20] form ({form}) sample_every "
                                     f"{every}: tokens differ from the "
                                     f"run with telemetry off")
            sums[every] = sum(v[1] for v in counts.values())
            row[f"lookups_{every}"] = sums[every]
            row[f"hits_{every}"] = sum(v[0] for v in counts.values())
            row[f"seconds_{every}"] = secs
            if every == 4:
                nodes_plain = graph_nodes(b._step_plain.graph, dot)
                k_plain = len(nodes_plain)
                k_mon = len(graph_nodes(b._step.graph, dot))
                with mon:
                    row["replay_ms_monitored"] = timed_ms(
                        lambda: b._step(b.cache, tok, 0), n=20, warmup=2,
                        reps=3)
                row["replay_ms_plain"] = timed_ms(
                    lambda: b._plain(b.cache, tok, 0), n=20, warmup=2,
                    reps=3)
                row.update(kernels_plain=k_plain, kernels_monitored=k_mon)
                p20_same_graph(form, nodes_off, nodes_plain)
            del b
        del b_off
        if not 0 < sums[4] < sums[1]:
            raise AssertionError(f"[20] form ({form}): sampled lookups "
                                 f"{sums[4]}, full {sums[1]}")
        out["batcher"][form] = row
        log(f"[20] {stamp()} (b) batcher form ({form}), {len(prompts)} "
            f"requests / {BATCHER_SLOTS} slots: tokens equal with "
            f"telemetry off and at sample_every 1 and 4; lookups "
            f"{sums[1]} (1) > {sums[4]} (4) > 0, hits {row['hits_1']} / "
            f"{row['hits_4']}; graph nodes (kernels, copies, memsets; "
            f"{dict(collections.Counter(nodes_off))} off): off {k_off}, "
            f"plain {k_plain} (equal, kind for kind), monitored {k_mon} "
            f"(+{k_mon - k_off}); replay {row['replay_ms_plain']:.3f} ms "
            f"plain, {row['replay_ms_monitored']:.3f} ms monitored "
            f"(CUDA events)")
        gc.collect()
        torch.cuda.empty_cache()

    # ---- (c) the card's counts against a host recount; drift in and out of
    # distribution --------------------------------------------------------
    class Recorder(obs.DontCareMonitor):
        """Counts on the card and keeps a host copy of what it saw."""

        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.seen = []

        def observe(self, site, layer, x):
            self.seen.append((site, layer, x.detach().cpu()))
            super().observe(site, layer, x)

    rec = Recorder(calib, device=dev)
    with rec, torch.no_grad():
        logits, cache = launcher.prefill(params, cfg, batch,
                                         max_seq=T + 2, lut_tables=tabs_a)
        launcher.decode_step(params, cfg, cache,
                             logits[:, -1].argmax(-1)[:, None], T, tabs_a)
    host = obs.DontCareMonitor(calib, device="cpu")
    for site, layer, x in rec.seen:
        host.observe(site, layer, x)
    card, recount = rec.counts(), host.counts()
    if card != recount or not card:
        raise AssertionError(f"[20] the card's counts differ from the host "
                             f"recount: {card} vs {recount}")
    del rec, host, cache

    def forward_hits(seed):
        mon = obs.DontCareMonitor(calib, device=dev)
        with mon, torch.no_grad():
            for bt in synthetic_batches(cfg0, args_a.calib_steps,
                                        batch_size=args_a.batch,
                                        seq_len=args_a.prompt_len,
                                        seed=seed):
                decoder_forward(params, cfg0, torch.as_tensor(
                    np.asarray(bt["tokens"], np.int32), device=dev).long())
        c = mon.counts()
        return (sum(v[0] for v in c.values()),
                sum(v[1] for v in c.values()))

    in_hits, in_n = forward_hits(1)     # the calibration's own batches
    ood_hits, ood_n = forward_hits(9)
    out["counts"] = {"keys": len(card),
                     "lookups": sum(v[1] for v in card.values()),
                     "hits": sum(v[0] for v in card.values()),
                     "in_distribution": [in_hits, in_n],
                     "out_of_distribution": [ood_hits, ood_n]}
    if in_hits != 0 or ood_hits <= 0:
        raise AssertionError(f"[20] drift: {in_hits} don't-care hits of "
                             f"{in_n} replaying the calibration batches, "
                             f"{ood_hits} of {ood_n} out of distribution")
    log(f"[20] {stamp()} (c) one monitored eager prefill + decode step: "
        f"the card's counters equal the host recount key for key "
        f"({len(card)} keys, {out['counts']['lookups']} lookups, "
        f"{out['counts']['hits']} hits); the calibration batches replayed: "
        f"{in_hits} hits of {in_n}; tokens of another seed: {ood_hits} "
        f"of {ood_n} ({ood_hits / ood_n:.6f})")

    # ---- (d) the control plane's timeline ---------------------------------
    ladder_log = obs_dir / "ladder.jsonl"
    lt = obs.Telemetry(events=obs.EventLog(str(ladder_log)))
    with lt:
        drill = ladder_run(cfg, params, plans, prompts, dev,
                           inject=("cuda:lut_act_multi", 2, 0))
    lrecs = obs.read_events(str(ladder_log))
    names = [r["event"] for r in lrecs]
    lm = lrecs[-1]["metrics"]
    lad = drill["ladder"]
    n_dem = names.count("ladder_demote")
    n_pro = names.count("ladder_promote")
    if (lad.demotions != 1 or lad.promotions != 1 or n_dem != 1
            or n_pro != 1
            or names.index("ladder_demote") > names.index("ladder_promote")
            or names.index("serve_fault") > names.index("ladder_demote")
            or lm["ladder_demotions_total"]['{site="mlp"}'] != n_dem
            or lm["ladder_promotions_total"]['{site="mlp"}'] != n_pro
            or lm["batcher_table_swaps_total"][""]
            != names.count("table_swap")):
        raise AssertionError(f"[20] the ladder drill's timeline: "
                             f"{[n for n in names if n != 'tick']}, "
                             f"metrics {lm}")
    reload_log = obs_dir / "reload.jsonl"
    frozen = save_tuned_plan(str(art / "frozen_qwen3_p20.npz"),
                             tuned_plan_from_serving(cfg, plans))
    rt = obs.Telemetry(events=obs.EventLog(str(reload_log)))
    reloads = {}
    with rt:
        for label, path in (("tuned", tuned_path), ("frozen", frozen)):
            if path is None:
                continue
            rargs = launcher.parse_args(P20_SERVE + [
                "--reload-plan", str(path), "--degrade"])
            r = launcher.serve_with_reload(
                rargs, cfg, params, None,
                launcher.serving_tables(rargs, plans, dev, log=quiet),
                plans, log=quiet, prompts=prompts)
            if r["metrics"]["dropped"]:
                raise AssertionError(f"[20] reload {label}: {r['metrics']}")
            reloads[label] = r["reloader"].records[-1].stage
        bad = corrupt_file(frozen, str(art / "frozen_qwen3_p20_bad.npz"))
        reloads["corrupt"] = PlanReloader(r["batcher"], cfg,
                                          params).reload(bad).stage
    rrecs = obs.read_events(str(reload_log))
    rm = rrecs[-1]["metrics"].get("reloads_total", {})
    by = {}
    for e in rrecs:
        if e["event"] == "reload_cutover":
            by[("cutover", "true")] = by.get(("cutover", "true"), 0) + 1
        elif e["event"] == "reload_reject":
            k = (e["stage"], "false")
            by[k] = by.get(k, 0) + 1
    counted = {(k.split('stage="')[1].split('"')[0],
                k.split('ok="')[1].split('"')[0]): v for k, v in rm.items()}
    if (reloads.get("frozen") != "cutover" or reloads["corrupt"] != "load"
            or by.get(("cutover", "true"), 0) < 1
            or by.get(("load", "false")) != 1 or counted != by):
        raise AssertionError(f"[20] the reload timeline: stages "
                             f"{reloads}, events {by}, counters {rm}")
    out["control_plane"] = {"ladder_events": n_dem + n_pro,
                            "reload_stages": reloads,
                            "reload_events": {f"{k[0]}/{k[1]}": v
                                              for k, v in by.items()}}
    log(f"[20] {stamp()} (d) the K4 drill's timeline "
        f"(chiprun_out/obs/ladder.jsonl): serve_fault, ladder_demote "
        f"cuda_fused -> cuda, ladder_promote, in order, counters equal the "
        f"events; reloads (chiprun_out/obs/reload.jsonl): {reloads}, "
        f"events {out['control_plane']['reload_events']} equal "
        f"reloads_total")

    # ---- (e) the overhead: new tok/s off, at every 128 and at every 1, each
    # setting's batcher and monitor kept across the rounds, so that its
    # steps are captured once, in an untimed first run --------------------
    runs = {"off": [], "128": [], "1": []}
    mons = {m: None if m == "off" else obs.DontCareMonitor(
        calib, sample_every=int(m), device=dev) for m in runs}
    warm = {m: p20_batcher(cfg, params, tabs_a, prompts, monitor=mons[m],
                           prefill="replay")[1] for m in runs}
    for _ in range(P20_ROUNDS):
        for mode in runs:
            got, _, _, _, secs = p20_batcher(
                cfg, params, tabs_a, prompts, monitor=mons[mode],
                prefill="replay", batcher=warm[mode])
            runs[mode].append(len(prompts) * NEW / secs)
    captures = {m: (b._step.captures, b._step_plain.captures)
                for m, b in warm.items()}
    del warm
    tok_s = {m: statistics.median(v) for m, v in runs.items()}
    out["overhead"] = {"tok_s": runs, "median_tok_s": tok_s,
                       "captures": captures}
    log(f"[20] {stamp()} (e) batcher, replay prefill, form (a), steps "
        f"captured in a first untimed run (captures, monitored / plain: "
        f"{captures}): new tok/s (median of {P20_ROUNDS} interleaved "
        f"runs) off "
        f"{tok_s['off']:.1f}, --obs-drift-every 128 {tok_s['128']:.1f} "
        f"({tok_s['128'] / tok_s['off'] - 1:+.3%}), every 1 "
        f"{tok_s['1']:.1f} ({tok_s['1'] / tok_s['off'] - 1:+.3%}); runs "
        + "; ".join(f"{m}: {[round(x, 1) for x in v]}"
                    for m, v in runs.items()))

    end = launch_counts()
    out["launches"] = {k: end[k] - start[k] for k in end
                       if end[k] != start[k]}
    for k in ("lut_act_stacked", "fused_matmul_lut", "lut_act_multi"):
        if not out["launches"].get(k):
            raise AssertionError(f"[20] phase 20 launched no {k}: "
                                 f"{out['launches']}")
    log(f"[20] {stamp()} phase 20's launches: {out['launches']}")
    return out


# -------------------------------------------------------------------------
# phase 21: the paper's sweeps (repro_torch.bench) at the paper's scale
# -------------------------------------------------------------------------
P21_SCALE = "paper"
# the engine's processes: the card's host has 8 cores (the reference's
# default, 2, leaves compression a minute of the phase; 6 a third of that)
P21_WORKERS = 6
# the abstract's claim (PAPER.md): up to 1.63x fewer P-LUTs at a
# test-accuracy drop of at most 0.01
PAPER_CLAIM = (1.63, 0.01)


class LogLines:
    """A text stream that passes what is written to ``out`` and copies
    each whole line to ``chip_smoke.log``: under it the sweeps' own row
    lines (and any ``print``) reach both, as ``log`` lines do."""

    def __init__(self, out):
        self.out, self.part = out, ""

    def write(self, text: str) -> int:
        self.out.write(text)
        *lines, self.part = (self.part + text).split("\n")
        for f in LOG:
            f.writelines(line + "\n" for line in lines)
            f.flush()
        return len(text)

    def flush(self) -> None:
        self.out.flush()


def plain_check(net, rec) -> None:
    """One compressed row's tables once more through the plain versions:
    K5 / K6 on the same addresses and plan arrays, then K7 on the rebuilt
    tables with the same wiring; tables and both accuracies must equal
    the kernels' bit for bit."""
    import torch

    from repro_torch.kernels.lutnn_layer import lutnn_layer_plain
    from repro_torch.lutnn import inference

    flat = [gather_plain(x, pa) for x, pa in rec["calls"]]
    k = 0
    for l, (n, t) in enumerate(zip(net.cfg.layer_sizes, rec["tables"])):
        if not torch.equal(torch.stack(flat[k:k + n]), t):
            raise AssertionError(f"{net.cfg.name} L{l}: the plain K5 / K6 "
                                 f"tables differ from the kernels'")
        k += n
    xtr, ytr, xte, yte = net.data
    orig = inference.lutnn_layer
    inference.lutnn_layer = lutnn_layer_plain
    try:
        acc = (inference.table_accuracy(rec["tables"], net.conn, net.cfg,
                                        xte, yte),
               inference.table_accuracy(rec["tables"], net.conn, net.cfg,
                                        xtr, ytr))
    finally:
        inference.lutnn_layer = orig
    if acc != (rec["row"]["test_acc"], rec["row"]["train_acc"]):
        raise AssertionError(
            f"{net.cfg.name}: plain K7 accuracies {acc} differ from the "
            f"kernels' ({rec['row']['test_acc']}, "
            f"{rec['row']['train_acc']})")


def run_phase21(dev, stamp) -> dict:
    """The paper's sweeps through ``repro_torch.bench``'s functions at the
    paper's scale on the card (module docstring, phase 21): Table 2 for
    jsc-2l, jsc-5l and mnist with the engine timing on jsc-2l, Fig. 3 and
    the beyond-paper variants on jsc-2l; each model trained once.  Checks
    the accuracy invariants, ``identical``, the ReducedLUT ex 250 rows
    against the plain versions and the launch counts; records every K7
    call's (layer, shape) per model with the first call's inputs, as
    ``run_lutnn`` does."""
    import contextlib

    import torch

    from repro_torch.bench import beyond, common, fig3, table2
    from repro_torch.core.engine import shutdown_pools
    from repro_torch.kernels import launch_counts, ops, reset_launch_counts
    from repro_torch.lutnn import inference
    from repro_torch.lutnn.inference import CHUNK

    out_dir = OUT_DIR / "bench"
    kw = dict(scale=P21_SCALE, device=dev, out_dir=out_dir)
    calls = {}        # (conn data_ptr, shape) -> (inputs, calls)
    recs = []         # one per reconstruct_tables call, in order
    orig_k7, orig_rt = ops.lutnn_layer_cuda, common.reconstruct_tables
    orig_k5 = inference.lut_reconstruct

    def spy_k7(codes, conn, tables, *, bits):
        key = (conn.data_ptr(), (*codes.shape, *conn.shape, bits))
        inputs, seen = calls.get(key, ((codes, conn, tables), 0))
        calls[key] = (inputs, seen + 1)
        return orig_k7(codes, conn, tables, bits=bits)

    def spy_k5(x, pa):
        recs[-1]["calls"].append((x, pa))
        return orig_k5(x, pa)

    def spy_rt(plans, cfg, d):
        recs.append({"model": cfg.name, "plans": plans, "calls": []})
        recs[-1]["tables"] = orig_rt(plans, cfg, d)
        return recs[-1]["tables"]

    seconds = {}
    ops.lutnn_layer_cuda, common.reconstruct_tables = spy_k7, spy_rt
    inference.lut_reconstruct = spy_k5
    reset_launch_counts()
    try:
        # the sweeps print a line per row; ``print`` here is ``log``
        with contextlib.redirect_stdout(LogLines(sys.stdout)):
            nets = {}
            for model in table2.MODELS:
                t0 = time.perf_counter()
                net = nets[model] = common.get_trained(model, P21_SCALE, dev)
                seconds[f"train {model}"] = time.perf_counter() - t0
                print(f"[21] {stamp()} {model} ("
                      f"{'+'.join(map(str, net.cfg.layer_sizes))} neurons, "
                      f"{len(net.data[0])} / {len(net.data[2])} samples, "
                      f"{common.EPOCHS[P21_SCALE]} epochs) trained, "
                      f"extracted and marked in "
                      f"{seconds[f'train {model}']:.1f} s: test acc "
                      f"{net.test_acc:.4f}, train acc {net.train_acc:.4f}",
                      flush=True)
            sections = {}
            for name, fn in (
                    ("table2", lambda: table2.run(
                        table2.MODELS, workers=P21_WORKERS, **kw)),
                    ("fig3", lambda: fig3.run("jsc-2l", workers=P21_WORKERS,
                                              **kw)),
                    ("beyond", lambda: beyond.run("jsc-2l", **kw))):
                print(f"[21] {stamp()} {name}", flush=True)
                t0 = time.perf_counter()
                sections[name] = fn()
                seconds[name] = time.perf_counter() - t0
        torch.cuda.synchronize()
    finally:
        ops.lutnn_layer_cuda, common.reconstruct_tables = orig_k7, orig_rt
        inference.lut_reconstruct = orig_k5
        shutdown_pools()
    counts = launch_counts()
    (rows, timing), f3, bey = (sections[k] for k in ("table2", "fig3",
                                                    "beyond"))

    # the compressed rows in the order they rebuilt their tables
    compressed = [("table2", r) for r in rows
                  if r["method"] in ("compressedlut", "reducedlut")]
    compressed += [("fig3", r) for r in f3 if r["exiguity"] != "baseline"]
    if [(r["model"], r["pluts"]) for _, r in compressed] != [
            (c["model"], sum(p.plut_cost() for p in c["plans"]))
            for c in recs]:
        raise AssertionError("phase 21: the rebuilt tables do not follow "
                             "the compressed rows")
    for c, (section, r) in zip(recs, compressed):
        c["section"], c["row"] = section, r

    # accuracy invariants and the timing section
    for model, net in nets.items():
        mine = [r for r in rows + f3 if r["model"] == model]
        bad = [r for r in mine if r["train_acc"] != net.train_acc]
        if bad:
            raise AssertionError(f"{model}: training accuracy moved from "
                                 f"{net.train_acc} in {bad}")
        comp = next(r for r in mine if r.get("method") == "compressedlut")
        if comp["test_acc"] != net.test_acc:
            raise AssertionError(f"{model}: CompressedLUT moved test "
                                 f"accuracy {net.test_acc} -> "
                                 f"{comp['test_acc']}")
    if not all(t["identical"] for t in timing):
        raise AssertionError(f"phase 21: serial and engine plans differ: "
                             f"{timing}")

    # launch counts: K5 + K6 once per plan rebuilt, K7 once per chunk,
    # layer and pass (the marking pass, the net's two accuracies, then two
    # for every row that is not a baseline); no other kernel
    chunks = lambda n: -(-n // CHUNK)
    n_plans = sum(len(c["plans"]) for c in recs)
    n_dec = sum(p.kind == "decomposed" for c in recs for p in c["plans"])
    k7 = 0
    for model, net in nets.items():
        n_rows = sum(1 for c in recs if c["model"] == model) + sum(
            1 for r in rows if r["model"] == model
            and r["method"] == "random")
        tr, te = chunks(len(net.data[0])), chunks(len(net.data[2]))
        k7 += len(net.cfg.layer_sizes) * (tr + (1 + n_rows) * (tr + te))
    want = dict({k: 0 for k in counts}, lut_reconstruct=n_dec,
                plain_lookup=n_plans - n_dec, lutnn_layer=k7)
    if counts != want or n_dec == 0:
        raise AssertionError(f"phase 21 launched {counts}, not {want} (K5 "
                             f"at least once)")
    ptrs = {c.data_ptr(): (m, l) for m, net in nets.items()
            for l, c in enumerate(net.conn)}
    k7_calls = {m: {} for m in nets}
    for (ptr, shape), v in calls.items():
        m, l = ptrs[ptr]
        k7_calls[m][l, shape] = v
    if sum(c for _, c in calls.values()) != counts["lutnn_layer"]:
        raise AssertionError(f"phase 21: {counts['lutnn_layer']} K7 "
                             f"launches counted, {calls.values()} recorded")

    # the ReducedLUT ex 250 rows of Table 2 once more through the plain
    # versions, launching nothing
    checked = []
    for c in recs:
        r = c["row"]
        if (c["section"], r.get("method"), r["exiguity"]) == (
                "table2", "reducedlut", 250):
            plain_check(nets[c["model"]], c)
            checked.append(c["model"])
        del c["calls"]
    if checked != list(nets) or launch_counts() != counts:
        raise AssertionError(f"phase 21: plain checks of {checked}, "
                             f"launches {launch_counts()} after {counts}")

    # the paper's claim, row by row, on the synthetic stand-ins
    claims = {}
    for model, net in nets.items():
        mine = {(r["method"], r["exiguity"]): r for r in rows
                if r["model"] == model}
        base = mine["baseline", None]["pluts"]
        comp = mine["compressedlut", None]["pluts"]
        best = min((r for r in mine.values() if r["method"] == "reducedlut"),
                   key=lambda r: r["pluts"])
        c = claims[model] = {
            "exiguity": best["exiguity"], "pluts": best["pluts"],
            "compressedlut": comp, "baseline": base,
            "x_vs_compressedlut": comp / best["pluts"],
            "x_vs_baseline": base / best["pluts"],
            "test_drop": net.test_acc - best["test_acc"]}
        log(f"[21] the paper's claim on synthetic data (make_jsc / "
            f"make_mnist_like stand in for JSC and MNIST), {model}: the "
            f"best ReducedLUT row (ex {c['exiguity']}) {c['pluts']} P-LUTs, "
            f"{c['x_vs_compressedlut']:.3f}x fewer than CompressedLUT "
            f"({comp}) and {c['x_vs_baseline']:.3f}x fewer than the "
            f"baseline ({base}) (the abstract: up to {PAPER_CLAIM[0]}x "
            f"fewer); test-accuracy drop {c['test_drop']:+.4f} (the "
            f"abstract: at most {PAPER_CLAIM[1]})")

    engine = sum(r["compress_seconds"] for _, r in compressed)
    passes = sum(r["seconds"] for r in rows + f3
                 if r.get("method", "reducedlut") != "baseline"
                 and r["exiguity"] != "baseline") - engine
    log(f"[21] {stamp()} seconds: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; the engine in the compressed rows {engine:.1f}, their tables "
          f"rebuilt (K5 / K6) and the rows' accuracy passes (K7) "
          f"{passes:.1f}; timing {timing}; launches {want}; K5 / K6 and "
          f"K7 on the plain versions for the ReducedLUT ex 250 rows of "
          f"{checked}: tables and accuracies equal; every row's training "
          f"accuracy the net's own, CompressedLUT's test accuracy too")
    return {"launches": counts, "k7_calls": k7_calls, "seconds": seconds,
            "rows": rows, "timing": timing, "fig3": f3, "beyond": bey,
            "claims": claims, "engine_s": engine, "passes_s": passes,
            "nets": {m: {"test_acc": n.test_acc, "train_acc": n.train_acc,
                         "layers": list(n.cfg.layer_sizes),
                         "samples": [len(n.data[0]), len(n.data[2])]}
                     for m, n in nets.items()}}


def compact(t) -> dict:
    """A timed call's numbers for the kernel JSON line (``chip_smoke.json``
    keeps them all)."""
    return {k: t[k] for k in ("shape", "graph_ms", "plain_ms", "bound_ms",
                              "library_graph_ms") if k in t}


# -------------------------------------------------------------------------
# phase 22: sharded serving on a mesh of ranks sharing cuda:0
# -------------------------------------------------------------------------
P22_COMMON = ["--full", "--batch", str(B), "--prompt-len", str(T),
              "--new-tokens", str(NEW), "--lut-act", "--device", "cuda"]
P22_QWEN = ["--arch", "qwen3-0.6b", *P22_COMMON, "--calib-steps", "2"]
# (a)'s runs on the 2x2 mesh: (label, extra flags, the gspmd placement
# threshold in bytes (None: the default policy), the kernels whose served
# calls each rank holds against their plain versions (none: the run goes
# through ``launcher.main``, the user's command))
P22_RUNS = [("gspmd stacked", [], None, ()),
            ("gspmd stacked threshold 0", [], 0, ("K1",)),
            ("gspmd unrolled", ["--plan-exec", "unrolled"], None, ("K2",)),
            ("shard_map stacked", ["--mesh-mode", "shard_map"], None,
             ("K1",))]
P22_SAMPLE = 8   # served calls of a kernel a rank holds against its plain


@contextlib.contextmanager
def torch_matmul_defaults():
    """PyTorch's default matmul settings (bf16 reductions in reduced
    precision allowed, TF32 cuDNN), which the mesh's fresh rank processes
    run with, for the single-device runs they are held against; the
    script's parity settings come back after."""
    import torch

    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32,
             m.allow_bf16_reduced_precision_reduction)
    m.allow_tf32, c.allow_tf32 = False, True
    m.allow_bf16_reduced_precision_reduction = True
    try:
        yield
    finally:
        (m.allow_tf32, c.allow_tf32,
         m.allow_bf16_reduced_precision_reduction) = saved


def single_device_run(cfg, params, batch, tables, rows=None):
    """The single-device program, eager, on ``batch``'s ``rows`` (all by
    default): ``(tokens (b, NEW), last-position logits a step on the
    host)``."""
    import torch

    from repro_torch.serve import decode_step, prefill

    if rows is not None:
        batch = {k: v[rows[0]:rows[-1] + 1] for k, v in batch.items()}
    logits, cache = prefill(params, cfg, batch, max_seq=T + NEW,
                            lut_tables=tables)
    seen = [logits[:, -1].cpu()]
    tok = logits[:, -1].argmax(-1)[:, None]
    toks = []
    for i in range(NEW):
        toks.append(tok)
        logits, cache = decode_step(params, cfg, cache, tok, T + i, tables)
        seen.append(logits[:, -1].cpu())
        tok = logits[:, -1].argmax(-1)[:, None]
    return torch.cat(toks, dim=1).tolist(), seen


def held_bit_for_bit(label, rank, want, got, phase="22") -> None:
    """A rank's tokens and logits a step against the single-device run on
    its rows."""
    import torch

    toks, logits = want
    if rank["rank_tokens"] != toks:
        raise AssertionError(f"[{phase}] {label}: rank {rank['rank']}'s "
                             f"tokens {rank['rank_tokens']} differ from the "
                             f"single-device run's {toks}")
    if len(got) != len(logits):
        raise AssertionError(f"[{phase}] {label}: {len(got)} steps of "
                             f"logits, not {len(logits)}")
    for i, (a, b) in enumerate(zip(logits, got)):
        if not torch.equal(a, b):
            raise AssertionError(
                f"[{phase}] {label}: rank {rank['rank']}'s logits at step {i} "
                f"differ from the single-device run's (max "
                f"{float((a.float() - b.float()).abs().max())})")


def p22_spy(n: int):
    """Keep the inputs, entries and outputs of the first ``n`` served K1
    calls (a stacked entry on the ``cuda`` backend) and of the first ``n``
    K2 calls (a per-plan entry) of the LUT sites' dispatch; the wrappers
    themselves, whose launches count, are untouched: ``({"K1": [...],
    "K2": [...]}, restore)``."""
    from repro_torch.nn import mlp

    orig, recs = mlp.apply_lut_act, {"K1": [], "K2": []}

    def spy(x, tab, backend="gather"):
        y = orig(x, tab, backend)
        if (tab.get("backend", backend) == "cuda"
                and "multi_entry" not in tab):
            calls = recs["K1" if "stacked" in tab else "K2"]
            if len(calls) < n:
                calls.append((x.clone(), tab, y.clone()))
        return y

    mlp.apply_lut_act = spy
    return recs, lambda: setattr(mlp, "apply_lut_act", orig)


def p22_check(recs, want) -> dict:
    """The spied calls against their plain versions on the same inputs,
    bit for bit: ``{kernel: [calls held, largest difference (0.0)]}``;
    raises where a call differs or a kernel of ``want`` was never
    called."""
    import torch

    from repro_torch.kernels.lut_act import (
        lut_act_plain,
        lut_act_stacked_plain,
    )

    for kind in want:
        if not recs[kind]:
            raise AssertionError(f"[22] no served {kind} call was recorded")
    out = {}
    for kind, calls in recs.items():
        worst = 0.0
        for x, tab, y in calls:
            if kind == "K1":
                yp = lut_act_stacked_plain(x, tab["stacked"], tab["layer"])
            else:
                yp = lut_act_plain(x, tab["arrays"], **tab["meta"])
            if not torch.equal(y, yp):
                raise AssertionError(f"[22] a served {kind} call differs "
                                     f"from its plain version")
            worst = max(worst, float((y.float() - yp.float()).abs().max()))
        out[kind] = [len(calls), worst]
    return out


def p22_serve_rank(mesh, argv, threshold, want):
    """One rank of an (a) run: the launcher's rank function
    (``launch/serve.py::serve_rank``, what ``--mesh`` starts) with the
    placement threshold given as a policy, and its first served calls of
    the kernels in ``want`` held against their plain versions."""
    from repro_torch.launch import serve as launcher
    from repro_torch.serve.sharded import PlacementPolicy

    policy = (None if threshold is None
              else PlacementPolicy(shard_threshold_bytes=threshold))
    recs, restore = p22_spy(P22_SAMPLE)
    try:
        out = launcher.serve_rank(mesh, argv, policy)
    finally:
        restore()
    return dict(out, held=p22_check(recs, want))


def p22_serve_ranks(mesh, specs) -> list:
    """Several (a) runs, ``(argv, threshold, want)`` each, one after
    another in one start of the ranks: each with its launch counts and
    peak memory from zero and its seconds (``wall_s``)."""
    import torch

    from repro_torch.kernels import reset_launch_counts

    out = []
    for argv, threshold, want in specs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        reset_launch_counts()
        t0 = time.perf_counter()
        rec = p22_serve_rank(mesh, argv, threshold, want)
        out.append(dict(rec, wall_s=time.perf_counter() - t0))
    return out


def p22_batcher_rank(mesh, tuned_path, prompts):
    """Phase 22 (c) on one rank of the 2x2 mesh: qwen3-0.6b's shares drawn
    leaf by leaf, form (a)'s tables from the frozen plans, the batcher over
    the sharded pool (replay prefill), and the first served K1 calls held
    against the plain version."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.serve import ContinuousBatcher, Request
    from repro_torch.serve.sharded import init_params_sharded, rank_memory
    from repro_torch.tune import load_tuned_plan

    dev = mesh.device
    cfg0 = get_config("qwen3-0.6b")
    params = init_params_sharded(cfg0, 0, mesh, dev)
    tp = load_tuned_plan(tuned_path)
    cfg = tp.patched_config(cfg0)
    tables = tp.tables_for_model(backend="cuda", plan_exec="stacked",
                                 device=dev)
    at_rest = rank_memory(dev)
    recs, restore = p22_spy(P22_SAMPLE)
    try:
        b = ContinuousBatcher(cfg, params, BATCHER_SLOTS, T + NEW,
                              eos_token=-1, lut_tables=tables,
                              prefill="replay", mesh=mesh)
        for i, p in enumerate(prompts):
            b.submit(Request(rid=i, prompt=list(p), max_new=NEW))
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        done = b.run()
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
    finally:
        restore()
    return {"rank": mesh.rank, "outs": [r.out for r in sorted(
        done, key=lambda r: r.rid)], "seconds": secs,
        "metrics": b.metrics(), "launches": launch_counts(),
        "held": p22_check(recs, ("K1",)),
        "memory_at_rest": at_rest}


def p22_moe_rank(mesh, tuned_path):
    """Phase 22 (b) on one rank of the 1x2 mesh: deepseek-moe-16b's shares
    drawn leaf by leaf (half the experts), the frozen plans' tables, one
    prefill with its dropped assignments counted and NEW eager steps."""
    import numpy as np
    import torch

    from repro_torch.calib import model_batch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.nn import moe as moe_mod
    from repro_torch.serve.plans import _greedy
    from repro_torch.serve.sharded import (
        ShardedServe,
        init_params_sharded,
        rank_memory,
    )
    from repro_torch.tune import load_tuned_plan

    dev = mesh.device
    cfg0 = get_config("deepseek-moe-16b")
    params = init_params_sharded(cfg0, 0, mesh, dev)
    torch.cuda.synchronize(dev)
    at_rest = rank_memory(dev)
    named = dict(params.named_parameters())
    expert_bytes = sum(p.numel() * p.element_size()
                       for n, p in named.items()
                       if n.rsplit(".", 1)[-1].startswith("moe_"))
    tp = load_tuned_plan(tuned_path)
    cfg = tp.patched_config(cfg0)
    serve = ShardedServe(cfg, mesh, tp.tables_for_model(
        backend="cuda", plan_exec="stacked", device=dev))
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in model_batch(cfg, rng, B, T).items()}
    batch["tokens"] = batch["tokens"].long()
    orig, drops = moe_mod.route, []

    def spy(*a, **kw):
        r = orig(*a, **kw)
        drops.append(r.dropped())
        return r

    local = serve.place_batch(batch)
    with serve.session(params):
        moe_mod.route = spy
        try:
            serve.prefill(params, local, T + NEW)
        finally:
            moe_mod.route = orig
        n_drop = int(torch.stack(drops).sum())
        t0 = time.perf_counter()
        toks, logits = _greedy(cfg, params, local, NEW, T + NEW,
                               serve=serve)
        torch.cuda.synchronize(dev)
    return {"rank": mesh.rank, "rank_tokens": toks,
            "logits": [lg.cpu() for lg in logits], "gather_s": serve.gather_s,
            "seconds": time.perf_counter() - t0, "drops": n_drop,
            "expert_bytes": expert_bytes,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in named.values()),
            "memory_at_rest": at_rest,
            "memory_peak": torch.cuda.max_memory_allocated(dev),
            "launches": launch_counts()}


def run_phase22(dev, stamp, parts=("a", "c", "b")) -> dict:
    """Phase 22 (module docstring): sharded serving through
    ``repro_torch.launch.serve --mesh`` and the batcher, on ranks that
    share ``cuda:0`` over gloo: ``parts`` of (a) with (d), (c) and (b).
    Returns the numbers for ``chip_smoke.json`` and the ranks' launches,
    summed."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.serve.sharded import tables_checksum
    from repro_torch.tune import save_tuned_plan, tuned_plan_from_serving

    quiet = lambda m: None
    out, launches = {}, {}

    def add_launches(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    art = OUT_DIR / "artifacts"
    art.mkdir(parents=True, exist_ok=True)
    obs_dir = OUT_DIR / "obs"
    obs_dir.mkdir(parents=True, exist_ok=True)
    mesh_log = obs_dir / "mesh.jsonl"
    if mesh_log.exists():
        mesh_log.unlink()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[22] {stamp()} card memory allocated before the phase: "
        f"{torch.cuda.memory_allocated(dev)} bytes")

    # ---- single-device references (qwen3-0.6b, PyTorch's defaults) ------
    with torch_matmul_defaults():
        args_a = launcher.parse_args(P22_QWEN)
        cfg0, params, batch, rng = launcher.setup(args_a)
        plans, calib = launcher.compress_plans(args_a, cfg0, params, rng,
                                               log=quiet)
        cfg = plans.patched_config(cfg0)
        tabs = {e: plans.tables_for_model(backend="cuda", plan_exec=e,
                                          device=dev)
                for e in ("stacked", "unrolled")}
        checksum = tables_checksum(tabs["stacked"])
        full_bytes = sum(p.numel() * p.element_size()
                         for p in params.parameters())
        ref = {e: [single_device_run(cfg, params, batch, t, rows)
                   for rows in ([0, 1], [2, 3])] for e, t in tabs.items()}
        whole = single_device_run(cfg, params, batch, tabs["stacked"])
        # (d): the drift counts of the same rows, single-device
        mon = obs.DontCareMonitor(calib, device=dev)
        with mon:
            for rows in ([0, 1], [2, 3]):
                single_device_run(cfg, params, batch, tabs["stacked"], rows)
        single_counts = mon.counts()
    tuned = save_tuned_plan(str(art / "p22_qwen3"),
                            tuned_plan_from_serving(cfg, plans))
    log(f"[22] {stamp()} single-device references: qwen3-0.6b "
        f"{full_bytes} parameter bytes, tables {checksum[:16]}")

    if "a" in parts:
        # ---- (a) + (d): qwen3-0.6b on 2x2 through the launcher, then the
        # other runs through its rank function in one start of the ranks --
        out["a"] = {}
        runs = {}
        for label, extra, threshold, want in P22_RUNS:
            if not want:
                t0 = time.perf_counter()
                runs[label] = (launcher.main(
                    P22_QWEN + ["--mesh", "2,2", *extra, "--obs-log",
                                str(mesh_log)])["ranks"],
                    time.perf_counter() - t0)
        rest = [(label, (P22_QWEN + ["--mesh", "2,2", *extra], threshold,
                         want))
                for label, extra, threshold, want in P22_RUNS if want]
        per_rank = run_ranks(p22_serve_ranks, ([spec for _, spec in rest],),
                             dp=2, tp=2)
        for i, (label, _) in enumerate(rest):
            ranks = [recs[i] for recs in per_rank]
            runs[label] = (ranks, ranks[0]["wall_s"])
        for label, extra, threshold, want in P22_RUNS:
            ranks, wall = runs[label]
            form = "unrolled" if "unrolled" in label else "stacked"
            kernel = "lut_act" if form == "unrolled" else "lut_act_stacked"
            rows = {}
            for r in ranks:
                if r["checksum"] != tables_checksum(tabs[form]):
                    raise AssertionError(f"[22] {label}: rank {r['rank']}'s "
                                         f"tables differ from the reference's")
                d = r["coords"]["data"]
                held_bit_for_bit(label, r, ref[form][d], r["logits"])
                if r["launches"][kernel] == 0:
                    raise AssertionError(f"[22] {label}: rank {r['rank']} "
                                         f"launched no {kernel}")
                add_launches(r["launches"])
                rows[r["rank"]] = {
                    "memory_at_rest": r["memory_at_rest"],
                    "param_bytes": r["param_bytes"],
                    "memory_peak": r["memory_peak"],
                    "K1": r["launches"]["lut_act_stacked"],
                    "K2": r["launches"]["lut_act"],
                    "placement": {s: v["placement"]
                                  for s, v in r["placement"].items()},
                    "table_bytes_held": sum(v["per_device_bytes"] for v
                                            in r["placement"].values()),
                    "held": r.get("held"),
                    "prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
                    "gather_s": r["gather_s"]}
            tokens = ranks[0]["tokens"]
            diff = max(float((a.float() - b.float()).abs().max())
                       for i in range(NEW + 1)
                       for a, b in [(torch.cat([ranks[0]["logits"][i],
                                                ranks[2]["logits"][i]]),
                                     whole[1][i])])
            out["a"][label] = {"wall_s": wall, "ranks": rows,
                               "whole_tokens_equal": tokens == whole[0],
                               "whole_max_logit_diff": diff}
            placements = {v for r in rows.values()
                          for v in r["placement"].values()}
            if "threshold 0" in label and "layer_sharded" not in placements:
                raise AssertionError(f"[22] {label}: no layer-sharded slab "
                                     f"({placements})")
            if "shard_map" in label and placements != {"replicated"}:
                raise AssertionError(f"[22] {label}: {placements}")
            log(f"[22] {stamp()} (a) {label}: {wall:.1f}s; each rank's rows "
                f"bit for bit the single-device run's; per rank "
                + "; ".join(f"r{k} at rest {v['memory_at_rest']} B "
                            f"(params {v['param_bytes']} of {full_bytes}), "
                            f"tables {v['table_bytes_held']} B, "
                            f"K1 {v['K1']} K2 {v['K2']} (held against "
                            f"plain {v['held']}), gather "
                            f"{v['gather_s']:.2f}s, prefill "
                            f"{v['prefill_s']:.3f}s decode {v['decode_s']:.3f}s"
                            for k, v in rows.items())
                + f"; placement {sorted(placements)}; the whole batch on one "
                  f"device: tokens equal {tokens == whole[0]}, largest logit "
                  f"difference {diff}")

        # (d): the mesh run's obs log
        recs = obs.read_events(str(mesh_log))
        kinds = {r["event"] for r in recs}
        for ev in ("mesh_serving", "table_placement", "drift"):
            if ev not in kinds:
                raise AssertionError(f"[22] (d) no {ev} event in the mesh log")
        drift = {r["site"]: (r["dontcare_hits"], r["lookups"])
                 for r in recs if r["event"] == "drift"}
        want = {k: (v[0], v[1]) for k, v in single_counts.items()}
        if drift != want:
            raise AssertionError(f"[22] (d) summed drift counts {drift} differ "
                                 f"from the single-device runs' {want}")
        out["d"] = {"events": sorted(kinds), "drift_keys": len(drift),
                    "lookups": sum(v[1] for v in drift.values()),
                    "hits": sum(v[0] for v in drift.values())}
        log(f"[22] {stamp()} (d) the mesh's obs log: "
            f"{sum(r['event'] == 'table_placement' for r in recs)} "
            f"table_placement, mesh_serving, {len(drift)} drift rows whose "
            f"summed counts equal the single-device runs' "
            f"({out['d']['hits']} hits of {out['d']['lookups']} lookups)")

    if "c" in parts:
        # ---- (c): the batcher on 2x2 with phase 13's requests ------------
        prng = np.random.default_rng(13)
        prompts = [[int(t) for t in prng.integers(1, cfg.vocab_size, int(n))]
                   for n in prng.integers(T // 4, T + 1, BATCHER_REQUESTS)]
        with torch_matmul_defaults():
            want_outs, b1, secs1 = batcher_run(cfg, params, tabs["stacked"],
                                               prompts, prefill="replay")
        ranks = run_ranks(p22_batcher_rank, (tuned, prompts), dp=2, tp=2)
        for r in ranks:
            if r["outs"] != want_outs:
                raise AssertionError(f"[22] (c) rank {r['rank']}'s batcher "
                                     f"outputs differ from the single-device "
                                     f"batcher's")
            if r["metrics"]["dropped"] or r["launches"]["lut_act_stacked"] == 0:
                raise AssertionError(f"[22] (c) rank {r['rank']}: {r['metrics']}"
                                     f", launches {r['launches']}")
            add_launches(r["launches"])
        out["c"] = {"seconds": [r["seconds"] for r in ranks],
                    "single_seconds": secs1,
                    "ticks": ranks[0]["metrics"]["ticks"],
                    "K1": [r["launches"]["lut_act_stacked"] for r in ranks],
                    "held": [r["held"] for r in ranks]}
        log(f"[22] {stamp()} (c) the batcher on 2x2 (replay prefill, 8 requests "
            f"of {[len(p) for p in prompts]} tokens, 4 slots): outputs equal "
            f"the single-device batcher's on every rank; "
            f"{ranks[0]['metrics']['ticks']} ticks in "
            f"{max(r['seconds'] for r in ranks):.1f}s (one device "
            f"{secs1:.1f}s); K1 launches {out['c']['K1']}; each rank's first "
            f"{P22_SAMPLE} served K1 calls bit for bit the plain version")
        del params, tabs, plans, b1
        gc.collect()
        torch.cuda.empty_cache()

    if "b" in parts:
        # ---- (b): deepseek-moe-16b on 1x2 (expert parallel) --------------
        with torch_matmul_defaults():
            args_m = launcher.parse_args(["--arch", "deepseek-moe-16b",
                                          *P22_COMMON, "--calib-steps", "2"])
            mcfg0, mparams, mbatch, mrng = launcher.setup(args_m)
            mplans = launcher.build_plans(args_m, mcfg0, mparams, mrng,
                                          log=quiet)
            mcfg = mplans.patched_config(mcfg0)
            mtabs = mplans.tables_for_model(backend="cuda", device=dev)
            drops_one = prefill_drops(launcher, mparams, mcfg, mbatch, mtabs)
            mref = single_device_run(mcfg, mparams, mbatch, mtabs)
            m_full = sum(p.numel() * p.element_size()
                         for p in mparams.parameters())
            m_experts = sum(p.numel() * p.element_size()
                            for n, p in mparams.named_parameters()
                            if n.rsplit(".", 1)[-1].startswith("moe_"))
        mtuned = save_tuned_plan(str(art / "p22_moe"),
                                 tuned_plan_from_serving(mcfg, mplans))
        del mparams, mtabs, mplans
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[22] {stamp()} (b) deepseek-moe-16b single-device reference "
            f"({m_full} parameter bytes, experts {m_experts}); freed: "
            f"{torch.cuda.memory_allocated(dev)} bytes allocated")
        ranks = run_ranks(p22_moe_rank, (mtuned,), dp=1, tp=2)
        for r in ranks:
            held_bit_for_bit("(b)", r, mref, r["logits"])
            if r["drops"] != drops_one:
                raise AssertionError(f"[22] (b) rank {r['rank']} dropped "
                                     f"{r['drops']} assignments at prefill, "
                                     f"one device {drops_one}")
            if r["launches"]["lut_act_stacked"] == 0:
                raise AssertionError(f"[22] (b) rank {r['rank']} launched "
                                     f"no K1")
            add_launches(r["launches"])
        out["b"] = {"experts_bytes_one_device": m_experts,
                    "param_bytes_one_device": m_full,
                    "ranks": {r["rank"]: {k: r[k] for k in (
                        "expert_bytes", "param_bytes", "memory_at_rest",
                        "memory_peak", "drops", "seconds")} for r in ranks},
                    "drops_one_device": drops_one}
        log(f"[22] {stamp()} (b) deepseek-moe-16b on 1x2: tokens and logits "
            f"bit for bit the single-device run's; dropped at prefill "
            f"{[r['drops'] for r in ranks]} (one device {drops_one}); per rank "
            + "; ".join(f"r{r['rank']} experts {r['expert_bytes']} of "
                        f"{m_experts} B, params {r['param_bytes']} of {m_full} "
                        f"B, at rest {r['memory_at_rest']} B, peak "
                        f"{r['memory_peak']} B, K1 "
                        f"{r['launches']['lut_act_stacked']}, gather "
                        f"{r['gather_s']:.2f}s, {NEW} steps "
                        f"{r['seconds']:.1f}s" for r in ranks))
    return {"out": out, "launches": launches}



# -------------------------------------------------------------------------
# phase 23: sharded training on a mesh of ranks sharing cuda:0
# -------------------------------------------------------------------------
# (a) / (b) / (c): phase 18's qwen3-0.6b tokens (8 x 512) for 3 steps,
# under --remat: without it four ranks at 4 x 512 each (about 18 GB a rank,
# from phase 18's 24.3 GB at --microbatch 2) do not fit one 80 GB card
P23_QWEN = ["--arch", "qwen3-0.6b", "--full", "--batch", "8", "--seq", "512",
            "--steps", "3", "--remat", "--device", "cuda"]
# (d): the supervised run at qwen3-0.6b's widths, depth cut so that its
# three checkpoints (the start, step 1, the end) take 2 GB each, not 4.5
P23_SUP = (2, ["--arch", "qwen3-0.6b", "--full", "--batch", "4", "--seq",
               "128", "--steps", "3", "--ckpt-every", "2", "--device",
               "cuda"])
# (e): rwkv6-3b's published widths; two ranks with full-depth state (each
# the whole model's parameters and gradients in the compute) do not fit
# one 80 GB card, so 4 of its 32 layers
P23_RWKV = (4, ["--arch", "rwkv6-3b", "--full", "--remat", "--batch", "4",
                "--seq", "256", "--steps", "3", "--device", "cuda"])
# (f): phase 18's cut of deepseek-moe-16b (P18_DEPTH), 2 steps at 4 x 64
P23_MOE = (2, ["--arch", "deepseek-moe-16b", "--full", "--batch", "4",
               "--seq", "64", "--steps", "2", "--device", "cuda"])
# (h): qwen3-0.6b's published widths and 28 layers on 1x2, partitioned,
# at the fewest tokens that keep them (a step's weight exchange and
# all-reduces through the host over gloo, within the 60 s the case has),
# in float32: in bf16 at these 2 x 32 tokens the single-device step's own
# reassociation (--microbatch 2) moves step 2's loss by 0.030, past the
# bound, so the bound would not tell a fault from rounding; in float32
# the partitioned step is within 3e-6 of it (PERF.md section 4)
P23_TP = ["--arch", "qwen3-0.6b", "--full", "--batch", "2", "--seq", "32",
          "--steps", "2", "--device", "cuda"]
P23_TP_DTYPE = "float32"
P23_TP_RTOL = 1e-2    # phase 24 (d)'s bf16 bound on the loss


def p23_tp_cfg():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen3-0.6b"), dtype=P23_TP_DTYPE)
# (b): the leaves whose step-1 mean gradient is recounted on the host
P23_RECOUNT = ("final_norm", "blocks.ln1", "blocks.wk")
P23_SAMPLE = 2   # K8 / K8b calls a rank holds against their plain versions


def p23_cut(argv_depth):
    """(config with the depth cut, argv) of a ``(depth, argv)`` pair."""
    from repro_torch.configs import get_config

    depth, argv = argv_depth
    arch = argv[argv.index("--arch") + 1]
    return dataclasses.replace(get_config(arch), n_layers=depth), argv


# a position-weighted sum of a tensor's bits, on the card, in chunks of
# 2^26 words: two 64-bit sums with odd weights (a changed word always
# moves both), so states are compared bit for bit without moving them
P23_HASH_CHUNK = 1 << 26
P23_HASH_MULT = (-7046029254386353131, 6364136223846793005)


def bits_hash(t) -> tuple:
    """``(shape, dtype, h1, h2)`` of ``t``'s bits: ``h = sum_i (w_i + 1)
    * ((i * m) | 1) mod 2^64`` over its words ``w_i`` (int16 for bf16,
    int32 for float32) for each of ``P23_HASH_MULT``'s ``m``."""
    import torch

    w = t.detach().contiguous().reshape(-1)
    w = w.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}[w.element_size()])
    h = [0, 0]
    for s0 in range(0, w.numel(), P23_HASH_CHUNK):
        c = w[s0:s0 + P23_HASH_CHUNK].to(torch.int64) + 1
        i = torch.arange(s0, s0 + c.numel(), dtype=torch.int64,
                         device=c.device)
        for j, m in enumerate(P23_HASH_MULT):
            h[j] = (h[j] + int((c * torch.bitwise_or(i * m, 1)).sum())) \
                % 2 ** 64
    return tuple(t.shape), str(t.dtype), h[0], h[1]


def p23_hashes(state, cfg=None, tcfg=None, layout=None) -> list:
    """:func:`bits_hash` of every leaf of ``state`` (the counters as they
    are), in checkpoint order: a rank's own shares, or with ``layout``
    ``(dp, tp)`` a full state cut to each rank's shares of that mesh (a
    list a rank)."""
    from repro_torch.nn.sharding import Mesh
    from repro_torch.train import train_state_shardings
    from repro_torch.train.checkpoint import leaf_placements, state_leaves

    def one(pls):
        return [bits_hash(pl.local(leaf) if pl is not None else leaf)
                if hasattr(leaf, "dtype") else leaf
                for (_, leaf), pl in zip(state_leaves(state), pls)]

    if layout is None:
        return one(leaf_placements(state, None))
    dp, tp = layout
    return [one(leaf_placements(state, train_state_shardings(
        cfg, tcfg, Mesh(("data", "model"), (dp, tp), rank=r))))
        for r in range(dp * tp)]


def p23_steps(s, start, stop, after=None) -> dict:
    """Steps ``start .. stop - 1`` of ``setup(...)['step']`` on
    ``setup(...)['batch_at']``, each timed on the host clock with the
    device synchronized, the sharded step's split beside it;
    ``after(step, state)`` runs after each."""
    import torch

    out = {"metrics": [], "seconds": [], "splits": []}
    timings = getattr(s["step"], "timings", None)
    for i in range(start, stop):
        batch = s["batch_at"](i)
        t0 = time.perf_counter()
        s["state"], m = s["step"](s["state"], batch)
        torch.cuda.synchronize(s["device"])
        out["seconds"].append(time.perf_counter() - t0)
        out["metrics"].append((float(m["loss"]), float(m["grad_norm"])))
        if timings is not None:
            out["splits"].append(dict(timings))
        if after is not None:
            after(i, s["state"])
    return out


def p23_reference(argv, cfg=None, layouts=None) -> dict:
    """The single-device run of ``argv`` (PyTorch's default matmul
    settings, the ranks' own): its metrics a step, its state bytes and
    peak memory, and ``layouts`` ``{steps done: [(dp, tp), ...]}``: the
    state's hashes after that many steps cut to each layout's shares
    (``(1, 1)``: the whole state)."""
    import torch

    from repro_torch.launch import train as tl

    layouts = layouts or {}
    hashes = {}

    def after(i, st):
        for lay in layouts.get(i + 1, ()):
            hashes[i + 1, lay] = (p23_hashes(st) if lay == (1, 1) else
                                  p23_hashes(st, s["cfg"], s["tcfg"], lay))

    with torch_matmul_defaults():
        args = tl.parse_args(argv)
        s = tl.setup(args, cfg=cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = p23_steps(s, 0, args.steps, after=after)
    out = dict(run, hashes=hashes, state_bytes=tl.state_bytes(s["state"]),
               peak=torch.cuda.max_memory_allocated())
    del s
    gc.collect()
    torch.cuda.empty_cache()
    return out


def p23_held(label, ranks, want) -> None:
    """Every rank's shares (``ranks``: a hash list a rank, in rank
    order) bit for bit the single-device state's cut to that mesh."""
    for r, (got, exp) in enumerate(zip(ranks, want)):
        bad = [i for i, (g, e) in enumerate(zip(got, exp)) if g != e]
        if bad or len(got) != len(exp):
            raise AssertionError(f"[23] {label}: rank {r}'s leaves {bad} "
                                 f"differ from the single-device state's")


def p23_same(label, got, want) -> None:
    if got != want:
        raise AssertionError(f"[23] {label}: {got} != {want}")


def p23_rank_setup(argv, mesh, cfg=None):
    import torch

    from repro_torch.launch import train as tl
    from repro_torch.serve.sharded import rank_memory

    s = tl.setup(tl.parse_args(argv), cfg=cfg, mesh=mesh)
    torch.cuda.synchronize(mesh.device)
    torch.cuda.reset_peak_memory_stats(mesh.device)
    return s, {"state_bytes": tl.state_bytes(s["state"]),
               "memory_at_rest": rank_memory(mesh.device)}


def p23_free(mesh):
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(mesh.device)


def p23_mesh22_rank(mesh, ckpt_dir):
    """(a) and (b) on one rank of the 2x2 mesh."""
    import torch

    from repro_torch.train import save_checkpoint
    from repro_torch.train import step as step_mod
    from repro_torch.train.compression import ef_compress_grads

    dev = mesh.device
    t0 = time.perf_counter()
    s, a = p23_rank_setup(P23_QWEN + ["--dp", "2", "--tp", "2"], mesh)
    a["setup_s"] = time.perf_counter() - t0

    def save_at_2(i, state):
        if i == 1:
            t = time.perf_counter()
            save_checkpoint(ckpt_dir, state, 2, shardings=s["shardings"])
            a["save_s"] = time.perf_counter() - t

    a.update(p23_steps(s, 0, 3, after=save_at_2))
    a["peak"] = torch.cuda.max_memory_allocated(dev)
    a["hashes"] = p23_hashes(s["state"])
    del s
    p23_free(mesh)

    # (b): --grad-compress; step 1's codes, scales and mean of a few leaves
    s, b = p23_rank_setup(P23_QWEN + ["--dp", "2", "--tp", "2",
                                      "--grad-compress"], mesh)
    names = [n for n, _ in s["state"]["params"].named_parameters()]
    calls = []
    orig = step_mod.compressed_dp_mean

    def spy(g, e, *rest):
        mean, new_e = orig(g, e, *rest)
        i = len(calls)
        if i < len(names):
            rec = None
            if names[i] in P23_RECOUNT:
                q, sc, _ = ef_compress_grads(g, e)
                rec = (names[i], q[0].cpu(), sc[0].cpu(), mean[0].cpu())
            calls.append(rec)
        return mean, new_e

    step_mod.compressed_dp_mean = spy
    try:
        b.update(p23_steps(s, 0, 3))
    finally:
        step_mod.compressed_dp_mean = orig
    b["recount"] = [c for c in calls if c is not None]
    b["peak"] = torch.cuda.max_memory_allocated(dev)
    return {"rank": mesh.rank, "coords": mesh.coords(), "a": a, "b": b}


def p23_wkv_spy():
    """Keep the inputs and outputs of the first ``P23_SAMPLE`` K8 and K8b
    launches (the kernels' own calls inside the wrappers, whose launch
    counts are untouched): ``(records, restore)``."""
    from repro_torch.kernels import ops

    recs = {"K8": [], "K8b": []}
    orig = {"K8": ops.wkv_cuda, "K8b": ops.wkv_backward_cuda}

    def make(kind):
        def spy(*args):
            out = orig[kind](*args)
            if len(recs[kind]) < P23_SAMPLE:
                recs[kind].append((
                    [a.clone() if hasattr(a, "clone") else a for a in args],
                    [o.clone() for o in out]))
            return out
        return spy

    ops.wkv_cuda, ops.wkv_backward_cuda = make("K8"), make("K8b")

    def restore():
        ops.wkv_cuda, ops.wkv_backward_cuda = orig["K8"], orig["K8b"]
    return recs, restore


def p23_wkv_held(recs) -> dict:
    """The sampled K8 calls against ``wkv_chunked_plain`` (rtol = atol =
    1e-4, phase 11's) and the K8b calls against ``wkv_backward_plain``
    (phase 18's: dq, dk, dv, du within 1e-4 of their largest entry, dlog_w
    within 1e-5 of its running sums): ``{kernel: [calls, largest
    difference]}``."""
    import torch

    from repro_torch.kernels.wkv import wkv_backward_plain, wkv_chunked_plain

    out = {}
    worst = 0.0
    for args, (y, st) in recs["K8"]:
        q, k, v, lw, u, chunk, s0 = args
        yp, sp = wkv_chunked_plain(q, k, v, lw, u, chunk=chunk, state=s0)
        if not (torch.allclose(y, yp, rtol=1e-4, atol=1e-4)
                and torch.allclose(st, sp, rtol=1e-4, atol=1e-4)):
            raise AssertionError("[23] (e) a K8 call differs from its plain "
                                 "version beyond rtol = atol = 1e-4")
        worst = max(worst, float((y - yp).abs().max()),
                    float((st - sp).abs().max()))
    out["K8"] = [len(recs["K8"]), worst]
    worst = 0.0
    for args, gk in recs["K8b"]:
        q, k, v, lw, u, dy, s0 = args
        gp = wkv_backward_plain(q, k, v, lw, u, dy, state=s0)
        errs = [float((a - p).abs().max()) for a, p in zip(gk, gp)]
        tols = [1e-4 * float(p.abs().max()) for p in gp]
        tols[3] = 1e-5 * max(float((q * gp[0]).abs().sum(1).max()),
                             float((k * gp[1]).abs().sum(1).max()))
        if any(e > t for e, t in zip(errs, tols)):
            raise AssertionError(f"[23] (e) a K8b call differs from its "
                                 f"plain version: {errs} against {tols}")
        worst = max([worst] + errs)
    out["K8b"] = [len(recs["K8b"]), worst]
    for kind in ("K8", "K8b"):
        if out[kind][0] < P23_SAMPLE:
            raise AssertionError(f"[23] (e) {out[kind][0]} {kind} calls "
                                 f"recorded, not {P23_SAMPLE}")
    return out


def p23_mesh21_rank(mesh, ckpt_dir, sup_dir):
    """(c), (d), (e) and (f) at 2x1 on one rank of the 2x1 mesh."""
    import torch

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import train as tl
    from repro_torch.train import Supervisor, restore_checkpoint

    out = {"rank": mesh.rank}
    # (c): (a)'s step-2 checkpoint onto 2x1, then step 3
    t0 = time.perf_counter()
    s, c = p23_rank_setup(P23_QWEN + ["--dp", "2"], mesh)
    s["state"], c["step"] = restore_checkpoint(ckpt_dir, s["state"],
                                               shardings=s["shardings"])
    c["restore_s"] = time.perf_counter() - t0
    c["restored"] = p23_hashes(s["state"])
    c.update(p23_steps(s, c["step"], 3))
    c["hashes"] = p23_hashes(s["state"])
    out["c"] = c
    del s
    p23_free(mesh)

    # (d): the supervised run with rank 1 failing once
    cfg, argv = p23_cut(P23_SUP)
    argv = argv + ["--dp", "2"]
    s, d = p23_rank_setup(argv, mesh, cfg)
    raised = []

    def once(state, batch):
        state, m = s["step"](state, batch)
        if mesh.rank == 1 and state["step"] == 3 and not raised:
            raised.append(True)
            raise RuntimeError("injected failure on rank 1 at step 2")
        return state, m

    t0 = time.perf_counter()
    run = tl.run(tl.parse_args(argv), s, log=lambda m: None,
                 supervisor=Supervisor(sup_dir, ckpt_every=2,
                                       shardings=s["shardings"]),
                 step_fn=once)
    d["supervised_s"] = time.perf_counter() - t0
    d["restarts"] = run["stats"]["restarts"]
    d["losses"] = run["losses"]
    d["grad_norms"] = run["grad_norms"]
    d["hashes"] = p23_hashes(run["state"])
    out["d"] = d
    del s, run
    p23_free(mesh)

    # (e): rwkv6-3b, 4 layers, K8 / K8b held against their plain versions
    cfg, argv = p23_cut(P23_RWKV)
    s, e = p23_rank_setup(argv + ["--dp", "2"], mesh, cfg)
    recs, restore = p23_wkv_spy()
    reset_launch_counts()
    try:
        e.update(p23_steps(s, 0, 3))
    finally:
        restore()
    e["launches"] = {k: v for k, v in launch_counts().items() if v}
    e["held"] = p23_wkv_held(recs)
    e["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    e["hashes"] = p23_hashes(s["state"])
    out["e"] = e
    del s, recs
    p23_free(mesh)

    # (f) at 2x1
    out["f"] = p23_moe(mesh, ["--dp", "2"])
    return out


def p23_moe(mesh, flags) -> dict:
    """(f): deepseek-moe-16b, 2 layers, 2 steps on this mesh."""
    import torch

    cfg, argv = p23_cut(P23_MOE)
    s, f = p23_rank_setup(argv + flags, mesh, cfg)
    f.update(p23_steps(s, 0, 2))
    f["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    f["hashes"] = p23_hashes(s["state"])
    del s
    p23_free(mesh)
    return f


class WholeGatherSpy:
    """Count the :meth:`Placement.gather` calls that put a leaf split over
    the model axis back together whole over it (the model axis not
    kept)."""

    def __enter__(self):
        from repro_torch.nn import sharding

        self.orig, self.whole = sharding.Placement.gather, []
        orig, whole = self.orig, self.whole

        def spy(pl, local, keep=()):
            if (sharding.TP_AXIS not in keep
                    and not pl.only((sharding.TP_AXIS,)).replicated):
                whole.append(tuple(pl.spec))
            return orig(pl, local, keep)

        sharding.Placement.gather = spy
        return self

    def __exit__(self, *exc):
        from repro_torch.nn import sharding

        sharding.Placement.gather = self.orig


def p23_tp(mesh) -> dict:
    """(h) on one rank of 1x2: qwen3-0.6b partitioned, then exact, 2
    steps each, every gather of the steps spied."""
    import torch

    out = {}
    for mode in ("partitioned", "exact"):
        s, h = p23_rank_setup(P23_TP + ["--tp", "2", "--tp-mode", mode],
                              mesh, p23_tp_cfg())
        with WholeGatherSpy() as spy:
            h.update(p23_steps(s, 0, 2))
        h["whole_gathered"] = len(spy.whole)
        h["peak"] = torch.cuda.max_memory_allocated(mesh.device)
        if mode == "exact":
            h["hashes"] = p23_hashes(s["state"])
        out[mode] = h
        del s
        p23_free(mesh)
    return out


def p23_mesh12_rank(mesh):
    """(f) and (h) at 1x2 on one rank of the 1x2 mesh."""
    f = p23_moe(mesh, ["--tp", "2"])
    t0 = time.perf_counter()
    h = p23_tp(mesh)
    h["seconds_h"] = time.perf_counter() - t0
    return {"rank": mesh.rank, "f": f, "h": h}


def p23_split(splits) -> str:
    """A step's split, the median of each part over the steps."""
    keys = ("gather_s", "forward_backward_s", "reduce_s", "update_s")
    med = lambda k: statistics.median(sp[k] for sp in splits)
    return ", ".join(f"{k[:-2]} {med(k):.2f}" for k in keys) + " s"


def p23_tp_held(ranks12, ref_h, ref_s, stamp) -> dict:
    """(h)'s checks on the 1x2 ranks' records against the single-device
    run ``ref_h``; its numbers."""
    recs = [r["h"] for r in ranks12]
    want = ref_h["metrics"]
    for i, h in enumerate(recs):
        part, exact = h["partitioned"], h["exact"]
        for j, ((l, g), (wl, wg)) in enumerate(zip(part["metrics"], want)):
            if abs(l - wl) > P23_TP_RTOL or abs(g - wg) > P23_TP_RTOL * wg:
                raise AssertionError(
                    f"[23] (h) rank {i} step {j}: partitioned loss / norm "
                    f"{l!r} / {g!r} against the single-device step's "
                    f"{wl!r} / {wg!r} (bounds {P23_TP_RTOL}, "
                    f"{P23_TP_RTOL} relative)")
        if part["whole_gathered"]:
            raise AssertionError(f"[23] (h) rank {i}: the partitioned steps "
                                 f"gathered {part['whole_gathered']} whole "
                                 f"tp-split leaves")
        p23_same(f"(h) rank {i}'s exact-mode metrics", exact["metrics"],
                 want)
    p23_held("(h) exact mode: the state after 2 steps",
             [h["exact"]["hashes"] for h in recs], ref_h["hashes"][2, (1, 2)])
    out = {"metrics": recs[0]["partitioned"]["metrics"],
           "one_device_metrics": want, "one_device_peak": ref_h["peak"],
           "reference_s": ref_s,
           "ranks": [{mode: {k: h[mode][k] for k in (
               "state_bytes", "memory_at_rest", "peak", "seconds",
               "splits")} for mode in ("partitioned", "exact")}
               | {"seconds_h": h["seconds_h"]} for h in recs]}
    log(f"[23] {stamp()} (h) qwen3-0.6b (28 layers, {P23_TP_DTYPE}, 2 x 32) "
        f"on 1x2 with "
        f"--tp-mode partitioned: losses / norms "
        f"{out['metrics']} within {P23_TP_RTOL} of the single-device "
        f"step's {want}; no whole tp-split leaf gathered; exact mode's 2 "
        f"steps bit for bit the single-device run; per rank "
        + "; ".join(
            f"r{i} partitioned peak {h['partitioned']['peak']} B, state "
            f"{h['partitioned']['state_bytes']} B, steps "
            f"{[round(x, 2) for x in h['partitioned']['seconds']]} s "
            f"({p23_split(h['partitioned']['splits'])}); exact peak "
            f"{h['exact']['peak']} B, steps "
            f"{[round(x, 2) for x in h['exact']['seconds']]} s "
            f"({p23_split(h['exact']['splits'])}); (h) "
            f"{h['seconds_h']:.1f}s on the ranks" for i, h in enumerate(recs))
        + f"; one device: peak {ref_h['peak']} B, reference {ref_s:.1f}s")
    return out


def run_phase23(dev, stamp) -> dict:
    """Phase 23 (module docstring): sharded training through
    ``repro_torch.launch.train``'s functions on ranks that share
    ``cuda:0`` over gloo, each part held bit for bit against its
    single-device counterpart (every rank's shares against the
    single-device state cut to that mesh, by :func:`bits_hash`).  Returns
    the numbers for ``chip_smoke.json`` and the ranks' K8 / K8b launches,
    summed."""
    import shutil

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.train import (
        TrainConfig,
        init_train_state,
        restore_checkpoint,
    )

    root = ROOT / "build" / "p23_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    ckpt_dir, sup_dir = str(root / "a"), str(root / "sup")
    out, t_phase = {}, time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    # ---- single-device references (PyTorch's default matmul settings) --
    t0 = time.perf_counter()
    ref_a = p23_reference(P23_QWEN + ["--microbatch", "2"], layouts={
        2: [(1, 1), (2, 1)], 3: [(2, 2), (2, 1)]})
    rwkv_cfg, rwkv_argv = p23_cut(P23_RWKV)
    ref_e = p23_reference(rwkv_argv + ["--microbatch", "2"], rwkv_cfg,
                          layouts={3: [(2, 1)]})
    sup_cfg, sup_argv = p23_cut(P23_SUP)
    ref_d = p23_reference(sup_argv + ["--microbatch", "2"], sup_cfg,
                          layouts={3: [(2, 1)]})
    moe_cfg, moe_argv = p23_cut(P23_MOE)
    ref_f = {"2x1": p23_reference(moe_argv + ["--microbatch", "2"], moe_cfg,
                                  layouts={2: [(2, 1)]}),
             "1x2": p23_reference(moe_argv, moe_cfg, layouts={2: [(1, 2)]})}
    refs_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_h = p23_reference(P23_TP, p23_tp_cfg(), layouts={2: [(1, 2)]})
    ref_h_s = time.perf_counter() - t0
    log(f"[23] {stamp()} single-device references in {refs_s:.1f}s: "
        f"qwen3-0.6b --microbatch 2 {ref_a['state_bytes']} state bytes, "
        f"peak {ref_a['peak']} B, steps "
        f"{[round(x, 3) for x in ref_a['seconds']]} s, metrics "
        f"{ref_a['metrics']}")

    # ---- (a) + (b): qwen3-0.6b on 2x2 ----------------------------------
    t0 = time.perf_counter()
    ranks = run_ranks(p23_mesh22_rank, (ckpt_dir,), dp=2, tp=2)
    wall22 = time.perf_counter() - t0
    for r in ranks:
        p23_same(f"(a) rank {r['rank']}'s losses and gradient norms",
                 r["a"]["metrics"], ref_a["metrics"])
    p23_held("(a) the state after step 3", [r["a"]["hashes"] for r in ranks],
             ref_a["hashes"][3, (2, 2)])
    a0 = ranks[0]["a"]
    out["a"] = {"wall_s": wall22,
                "one_device_state_bytes": ref_a["state_bytes"],
                "one_device_peak": ref_a["peak"],
                "one_device_seconds": ref_a["seconds"],
                "metrics": a0["metrics"],
                "ranks": {r["rank"]: {k: r["a"][k] for k in (
                    "state_bytes", "memory_at_rest", "peak", "seconds",
                    "splits", "setup_s", "save_s")} for r in ranks}}
    log(f"[23] {stamp()} (a) qwen3-0.6b on 2x2 ({wall22:.1f}s for (a) and "
        f"(b)): every rank's losses, gradient norms and shares of the state "
        f"after step 3 bit for bit the single-device --microbatch 2 run's; "
        f"per rank "
        + "; ".join(f"r{r['rank']} state at rest {r['a']['state_bytes']} B "
                    f"of {ref_a['state_bytes']} (card "
                    f"{r['a']['memory_at_rest']} B), peak {r['a']['peak']} "
                    f"B, steps {[round(x, 2) for x in r['a']['seconds']]} s "
                    f"({p23_split(r['a']['splits'])})" for r in ranks)
        + f"; one device: peak {ref_a['peak']} B, steps "
          f"{[round(x, 3) for x in ref_a['seconds']]} s; set-up "
          f"{a0['setup_s']:.1f}s, the step-2 checkpoint {a0['save_s']:.1f}s")

    b = [r["b"] for r in ranks]
    b_losses = [m[0] for m in b[0]["metrics"]]
    if b_losses[0] != a0["metrics"][0][0]:
        raise AssertionError(f"[23] (b) first loss {b_losses[0]!r} != (a)'s "
                             f"{a0['metrics'][0][0]!r}")
    if not b_losses[-1] < b_losses[0]:
        raise AssertionError(f"[23] (b) losses do not fall: {b_losses}")
    for j in range(len(b[0]["recount"])):
        name = b[0]["recount"][j][0]
        for col in (0, 1):       # model columns: ranks (0, 2) and (1, 3)
            r0, r1 = b[col]["recount"][j], b[2 + col]["recount"][j]
            summed = r0[1].to(torch.int32) + r1[1].to(torch.int32)
            mean = (summed.float() * torch.maximum(r0[2], r1[2])
                    / torch.tensor(2.0))
            for r in (r0, r1):
                if not torch.equal(r[3], mean):
                    raise AssertionError(f"[23] (b) {name}: a rank's step-1 "
                                         f"mean gradient is not its codes "
                                         f"recounted")
    out["b"] = {"losses": b_losses,
                "recounted": [c[0] for c in b[0]["recount"]],
                "ranks": {r["rank"]: {"seconds": r["b"]["seconds"],
                                      "peak": r["b"]["peak"],
                                      "splits": r["b"]["splits"]}
                          for r in ranks}}
    log(f"[23] {stamp()} (b) --grad-compress on 2x2: losses "
        f"{[round(x, 4) for x in b_losses]} (the first (a)'s, bit for bit; "
        f"falling); step 1's mean gradient of {out['b']['recounted']} on "
        f"every rank equal to the int8 codes summed over the data ranks "
        f"times the largest scale over 2, recounted on the host; steps "
        f"{[round(x, 2) for x in b[0]['seconds']]} s "
        f"({p23_split(b[0]['splits'])}), peak {b[0]['peak']} B")
    del ranks, b

    # ---- (c) on one device and (f) on 1x2, each in a thread beside (c)-(f)
    # on 2x1 (their peaks, about 4.5 + 2 x 13 + 2 x 16 GB, fit the card) ---
    def restore_1x1():
        t = time.perf_counter()
        one = init_train_state(get_config("qwen3-0.6b"),
                               TrainConfig(remat=True), device=dev)
        one, step = restore_checkpoint(ckpt_dir, one)
        p23_same("(c) 1x1: step", step, 2)
        p23_held("(c) 1x1: the restored state (files' digests verified)",
                 [p23_hashes(one)], [ref_a["hashes"][2, (1, 1)]])
        return time.perf_counter() - t

    def ranks_1x2():
        t = time.perf_counter()
        return run_ranks(p23_mesh12_rank, (), dp=1, tp=2), \
            time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        fut1, fut12 = pool.submit(restore_1x1), pool.submit(ranks_1x2)
        t0 = time.perf_counter()
        ranks = run_ranks(p23_mesh21_rank, (ckpt_dir, sup_dir), dp=2, tp=1)
        wall21 = time.perf_counter() - t0
        one_s = fut1.result()
        ranks12, wall12 = fut12.result()
    gc.collect()
    torch.cuda.empty_cache()
    c0 = ranks[0]["c"]
    p23_held("(c) 2x1: the restored state", [r["c"]["restored"]
                                              for r in ranks],
             ref_a["hashes"][2, (2, 1)])
    for r in ranks:
        p23_same(f"(c) rank {r['rank']}'s step 3", r["c"]["metrics"],
                 a0["metrics"][2:])
    p23_held("(c) 2x1: the state after step 3", [r["c"]["hashes"]
                                                  for r in ranks],
             ref_a["hashes"][3, (2, 1)])
    out["c"] = {"step": c0["step"], "restore_2x1_s": c0["restore_s"],
                "restore_1x1_s": one_s, "step3": c0["metrics"],
                "seconds": c0["seconds"]}
    log(f"[23] {stamp()} (c) elastic re-mesh: the 2x2 checkpoint of step 2 "
        f"(the files' digests verified) restored onto 1x1 ({one_s:.1f}s) "
        f"and 2x1 ({c0['restore_s']:.1f}s with its set-up), each the "
        f"single-device state after 2 steps bit for bit; step 3 on 2x1 "
        f"(a)'s ({c0['metrics']}) and its shares the single-device state's")

    d = ranks[0]["d"]
    for r in ranks:
        if r["d"]["restarts"] != 1:
            raise AssertionError(f"[23] (d) rank {r['rank']}: "
                                 f"{r['d']['restarts']} restarts, not 1")
        p23_same(f"(d) rank {r['rank']}'s restarted metrics",
                 list(zip(r["d"]["losses"], r["d"]["grad_norms"])),
                 ref_d["metrics"])
    p23_held("(d) the restarted run's state", [r["d"]["hashes"]
                                                for r in ranks],
             ref_d["hashes"][3, (2, 1)])
    out["d"] = {"restarts": 1, "seconds": d["supervised_s"],
                "losses": d["losses"]}
    log(f"[23] {stamp()} (d) supervised run on 2 ranks (qwen3-0.6b widths at "
        f"{P23_SUP[0]} layers, 3 steps, checkpoints every 2): rank 1 failed "
        f"once at the end of step 2, both ranks agreed, restored step 1 and "
        f"ended bit for bit the uninterrupted single-device --microbatch 2 "
        f"run ({d['supervised_s']:.1f}s)")

    launches = {}
    for r in ranks:
        e = r["e"]
        p23_same(f"(e) rank {r['rank']}'s metrics", e["metrics"],
                 ref_e["metrics"])
        want = {"wkv": 3 * 2 * rwkv_cfg.n_layers,
                "wkv_backward": 3 * rwkv_cfg.n_layers}
        p23_same(f"(e) rank {r['rank']}'s launches in 3 steps", e["launches"],
                 want)
        for k, v in e["launches"].items():
            launches[k] = launches.get(k, 0) + v
    p23_held("(e) the state after 3 steps", [r["e"]["hashes"] for r in ranks],
             ref_e["hashes"][3, (2, 1)])
    out["e"] = {"depth": rwkv_cfg.n_layers,
                "metrics": ranks[0]["e"]["metrics"],
                "ranks": {r["rank"]: {k: r["e"][k] for k in (
                    "state_bytes", "memory_at_rest", "peak", "seconds",
                    "splits", "launches", "held")} for r in ranks},
                "one_device_state_bytes": ref_e["state_bytes"],
                "one_device_peak": ref_e["peak"]}
    log(f"[23] {stamp()} (e) rwkv6-3b (published widths, {rwkv_cfg.n_layers} "
        f"of 32 layers, --remat, 4 x 256) on 2x1: bit for bit the "
        f"single-device --microbatch 2 run; per rank "
        + "; ".join(f"r{r['rank']} K8 {r['e']['launches']['wkv'] // 3} and "
                    f"K8b {r['e']['launches']['wkv_backward'] // 3} launches "
                    f"a step, sampled calls held against plain "
                    f"{r['e']['held']}, steps "
                    f"{[round(x, 2) for x in r['e']['seconds']]} s "
                    f"({p23_split(r['e']['splits'])}), peak "
                    f"{r['e']['peak']} B" for r in ranks))

    out["f"] = {}
    for shape, layout, rs in (("2x1", (2, 1), [r["f"] for r in ranks]),
                              ("1x2", (1, 2), [r["f"] for r in ranks12])):
        for i, f in enumerate(rs):
            p23_same(f"(f) {shape} rank {i}'s metrics", f["metrics"],
                     ref_f[shape]["metrics"])
        p23_held(f"(f) {shape}: the state after 2 steps",
                 [f["hashes"] for f in rs], ref_f[shape]["hashes"][2, layout])
        out["f"][shape] = {
            "metrics": rs[0]["metrics"],
            "one_device_state_bytes": ref_f[shape]["state_bytes"],
            "ranks": [{k: f[k] for k in ("state_bytes", "memory_at_rest",
                                         "peak", "seconds", "splits")}
                      for f in rs]}
        log(f"[23] {stamp()} (f) deepseek-moe-16b ({moe_cfg.n_layers} layers) "
            f"on {shape}: 2 steps bit for bit the single-device "
            f"{'--microbatch 2 ' if shape == '2x1' else ''}run; per rank "
            + "; ".join(f"state at rest {f['state_bytes']} B of "
                        f"{ref_f[shape]['state_bytes']}, peak {f['peak']} B, "
                        f"steps {[round(x, 2) for x in f['seconds']]} s "
                        f"({p23_split(f['splits'])})" for f in rs))
    out["h"] = p23_tp_held(ranks12, ref_h, ref_h_s, stamp)
    out["seconds"] = time.perf_counter() - t_phase
    out["walls"] = {"references": refs_s, "2x2": wall22, "1x1": one_s,
                    "2x1": wall21, "1x2": wall12}
    shutil.rmtree(root, ignore_errors=True)
    log(f"[23] {stamp()} phase 23 in {out['seconds']:.0f}s (references "
        f"{refs_s:.0f}s, the 2x2 ranks {wall22:.0f}s, then 1x1 {one_s:.0f}s "
        f"and the 2x1 ranks {wall21:.0f}s beside the 1x2 ranks "
        f"{wall12:.0f}s); the ranks' K8 / K8b launches {launches}")
    return {"out": out, "launches": launches}


# -------------------------------------------------------------------------
# phase 25: the sharded programs on four cards, a card a rank, over NCCL
# -------------------------------------------------------------------------
P25_CARDS = 4
# (b) / (c): the moe configurations served whole on 1x4, exact and form (a)
P25_MOE = ("qwen3-moe-30b-a3b", "deepseek-moe-16b")
# (e): rwkv6-3b at its 32 layers on 2x2 (two ranks sharing a card did not
# fit in phase 23; one rank a card does: 18.5 GB a rank by the dry run)
P25_RWKV = ["--arch", "rwkv6-3b", "--full", "--remat", "--batch", "4",
            "--seq", "256", "--steps", "3", "--device", "cuda"]
# (f): deepseek-moe-16b on 1x4, 4 x 64, 2 steps, at its 28 layers.  A
# rank keeps its share of each expert stack's gradient: the norm takes
# the (layer, expert) slabs' square sums and AdamW one layer at a time.
# The dry run (launch/dryrun.py's trace_step on the meta device, a fake
# four-rank group) gives a rank a peak of 43.8 GB at 28 layers and 17.1
# at 10 (133.4 and 48.2 while the step gathered each expert gradient
# whole for the norm, which ran out of memory at 14 layers)
P25_MOE_TRAIN = (28, ["--arch", "deepseek-moe-16b", "--full", "--batch",
                      "4", "--seq", "64", "--steps", "2", "--device",
                      "cuda"])
P25_MOE_CUT = 2   # (f)'s cut held against the single-device step
# (i): nemotron-4-15b at its published 32 layers on 1x4, partitioned.  In
# exact mode a rank would gather its 31.3 GB of bf16 parameters, then
# their gradients; partitioned, a rank holds a quarter of each split
# leaf.  The dry run (a fake four-rank group, the meta device) gives a
# rank's peak; above P25_TP_NEM_LIMIT the depth would be cut here, beside
# SERVE_DEPTH's cuts
P25_TP_NEM = (32, ["--arch", "nemotron-4-15b", "--full", "--remat",
                   "--batch", "4", "--seq", "64", "--steps", "2",
                   "--device", "cuda", "--tp-mode", "partitioned"])
P25_TP_NEM_LIMIT = 70e9
P25_TP_RTOL = P23_TP_RTOL
# (h): bf16 beside (g) for the step's time, held on its first
# P25_TP_BF16_HELD steps: at the third the single-device program's own
# reassociations (--microbatch 1 / 2 / 4) spread its bf16 loss over 0.45
# (11.05-11.50), so a 1e-2 bound there would not tell a fault from
# rounding; the same 3 steps in float32 are held on every step (there the
# partitioned step is within 5e-4 of exact mode's; PERF.md section 4)
P25_TP_BF16_HELD = 2


def p25_in_process(fn, *args):
    """``fn(*args)`` in a fresh process on ``cuda:0`` (spawn; PyTorch's
    default matmul settings, the ranks' own), so that its memory is gone
    before the ranks start."""
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as ex:
        return ex.submit(fn, *args).result()


def p25_ref_qwen(art: str) -> dict:
    """(a) and (d)'s single-device references: qwen3-0.6b through the
    launcher's set-up and compression, each data rank's rows decoded
    eagerly, the frozen plans saved, and the single-device batcher on
    phase 13's requests."""
    import numpy as np
    import torch

    from repro_torch.launch import serve as launcher
    from repro_torch.serve.sharded import tables_checksum
    from repro_torch.tune import save_tuned_plan, tuned_plan_from_serving

    dev = torch.device("cuda", 0)
    args = launcher.parse_args(P22_QWEN)
    cfg0, params, batch, rng = launcher.setup(args)
    plans, _ = launcher.compress_plans(args, cfg0, params, rng,
                                       log=lambda m: None)
    cfg = plans.patched_config(cfg0)
    tabs = plans.tables_for_model(backend="cuda", plan_exec="stacked",
                                  device=dev)
    rows = [single_device_run(cfg, params, batch, tabs, r)
            for r in ([0, 1], [2, 3])]
    tuned = save_tuned_plan(str(Path(art) / "p25_qwen3"),
                            tuned_plan_from_serving(cfg, plans))
    prng = np.random.default_rng(13)
    prompts = [[int(t) for t in prng.integers(1, cfg.vocab_size, int(n))]
               for n in prng.integers(T // 4, T + 1, BATCHER_REQUESTS)]
    outs, b, secs = batcher_run(cfg, params, tabs, prompts, prefill="replay")
    return {"rows": rows, "checksum": tables_checksum(tabs), "tuned": tuned,
            "prompts": prompts, "batcher_outs": outs, "batcher_s": secs,
            "batcher_ticks": b.metrics()["ticks"],
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters())}


def p25_ref_moe(arch: str, art: str) -> dict:
    """(b) / (c)'s single-device reference: ``arch`` at its full depth,
    exact and form (a) (the plans frozen for the ranks), decoded eagerly;
    its parameter and expert bytes and the peak."""
    import torch

    from repro_torch.launch import serve as launcher
    from repro_torch.tune import save_tuned_plan, tuned_plan_from_serving

    dev = torch.device("cuda", 0)
    args = launcher.parse_args(["--arch", arch, *P22_COMMON,
                                "--calib-steps", "2"])
    cfg0, params, batch, rng = launcher.setup(args)
    named = dict(params.named_parameters())
    out = {"layers": cfg0.n_layers,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in named.values()),
           "expert_bytes": sum(p.numel() * p.element_size()
                               for n, p in named.items()
                               if n.rsplit(".", 1)[-1].startswith("moe_")),
           "exact": single_device_run(cfg0, params, batch, None)}
    plans = launcher.build_plans(args, cfg0, params, rng, log=lambda m: None)
    cfg = plans.patched_config(cfg0)
    out["a"] = single_device_run(cfg, params, batch, plans.tables_for_model(
        backend="cuda", plan_exec="stacked", device=dev))
    out["tuned"] = save_tuned_plan(str(Path(art) / f"p25_{arch}"),
                                   tuned_plan_from_serving(cfg, plans))
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def p25_ref_rwkv() -> dict:
    """(e)'s reference: rwkv6-3b, 32 layers, ``--microbatch 2``, 3 steps,
    the state cut to 2x2 after them."""
    return p23_reference(P25_RWKV + ["--microbatch", "2"],
                         layouts={3: [(2, 2)]})


def p25_ref_moe_train() -> dict:
    """(f)'s references: the first step's loss as one forward at (f)'s
    depth (parameters only, no state), and the 2-layer cut's single-device
    run with its state cut to 1x4 after 2 steps."""
    import torch

    from repro_torch.launch import train as tl
    from repro_torch.nn import init_params
    from repro_torch.nn.transformer import loss_fn
    from repro_torch.train.step import batch_to_device

    dev = torch.device("cuda", 0)
    cfg, argv = p23_cut(P25_MOE_TRAIN)
    args = tl.parse_args(argv)
    tcfg = tl.train_config(args)
    params = init_params(cfg, tcfg.seed, dev)
    batch = batch_to_device(tl.batch_fn(cfg, args)(0), dev)
    with torch.no_grad():
        loss = float(loss_fn(cfg)(params, batch=batch, remat=tcfg.remat,
                                  chunk_q=tcfg.chunk_q, lut_tables=None))
    out = {"loss": loss, "depth": cfg.n_layers,
           "param_bytes": sum(p.numel() * p.element_size()
                              for p in params.parameters()),
           "peak": torch.cuda.max_memory_allocated(dev)}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cut = dataclasses.replace(cfg, n_layers=P25_MOE_CUT)
    out["cut"] = p23_reference(argv, cut, layouts={2: [(1, 4)]})
    return out


def p25_ref_nemotron() -> dict:
    """(i)'s reference: the first step's loss as one forward at (i)'s
    depth on ``cuda:0`` (parameters only, no state)."""
    import torch

    from repro_torch.launch import train as tl
    from repro_torch.nn import init_params
    from repro_torch.nn.transformer import loss_fn
    from repro_torch.train.step import batch_to_device

    dev = torch.device("cuda", 0)
    cfg, argv = p23_cut(P25_TP_NEM)
    args = tl.parse_args(argv)
    tcfg = tl.train_config(args)
    params = init_params(cfg, tcfg.seed, dev)
    batch = batch_to_device(tl.batch_fn(cfg, args)(0), dev)
    with torch.no_grad():
        loss = float(loss_fn(cfg)(params, batch=batch, remat=tcfg.remat,
                                  chunk_q=tcfg.chunk_q, lut_tables=None))
    return {"loss": loss, "depth": cfg.n_layers,
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in params.parameters()),
            "peak": torch.cuda.max_memory_allocated(dev)}


def p25_dryrun_nemotron() -> int:
    """(i)'s rank peak by the dry run, in bytes: one 1x4 rank's
    partitioned step at (i)'s depth and shape traced on the meta device
    in a fake four-rank group."""
    from repro_torch.launch import train as tl
    from repro_torch.launch.dryrun import dryrun_cell

    cfg, argv = p23_cut(P25_TP_NEM)
    args = tl.parse_args(argv)
    r = dryrun_cell(args.arch, "train_4k", False, tl.train_config(args),
                    quiet=True, cfg=cfg,
                    info=dict(kind="train", seq=args.seq, batch=args.batch),
                    mesh_shape=(1, P25_CARDS), tp_mode="partitioned")
    if r["status"] != "ok":
        raise AssertionError(f"[25] (i) the dry run: {r.get('error')}")
    return r["peak_bytes"]


def p25_dryrun_moe_train() -> int:
    """(f)'s rank peak by the dry run, in bytes: one 1x4 rank's step at
    (f)'s depth and shape traced on the meta device in a fake four-rank
    group (``launch/dryrun.py``; nothing runs on the card)."""
    from repro_torch.launch import train as tl
    from repro_torch.launch.dryrun import dryrun_cell

    cfg, argv = p23_cut(P25_MOE_TRAIN)
    args = tl.parse_args(argv)
    r = dryrun_cell(args.arch, "train_4k", False, tl.train_config(args),
                    quiet=True, cfg=cfg,
                    info=dict(kind="train", seq=args.seq, batch=args.batch),
                    mesh_shape=(1, P25_CARDS))
    if r["status"] != "ok":
        raise AssertionError(f"[25] (f) the dry run: {r.get('error')}")
    return r["peak_bytes"]


def p25_ref_qwen_train() -> dict:
    """(g)'s reference: qwen3-0.6b, phase 23's 8 x 512 with ``--remat``, 2
    steps at ``--microbatch 2`` and a third at ``--microbatch 1`` on the
    same state; the state cut to 1x4 after steps 2 and 3."""
    import torch

    from repro_torch.launch import train as tl
    from repro_torch.train import make_train_step

    args = tl.parse_args(P23_QWEN + ["--microbatch", "2"])
    s = tl.setup(args)
    run = p23_steps(s, 0, 2)
    h2 = p23_hashes(s["state"], s["cfg"], s["tcfg"], (1, 4))
    tcfg1 = dataclasses.replace(s["tcfg"], microbatch=None)
    s["step"] = make_train_step(s["cfg"], tcfg1, s["device"])
    run3 = p23_steps(s, 2, 3)
    h3 = p23_hashes(s["state"], s["cfg"], s["tcfg"], (1, 4))
    return {"metrics": run["metrics"] + run3["metrics"], "hashes2": h2,
            "hashes3": h3, "peak": torch.cuda.max_memory_allocated()}


def p25_rank_reset(mesh):
    """Free what the last case left, zero the launch counts and the peak."""
    import torch

    from repro_torch.kernels import reset_launch_counts

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    reset_launch_counts()


def p25_collective_spy():
    """Count the gathers' all-gather calls, in a CUDA graph capture and
    outside one: ``(counts, restore)``."""
    import torch

    from repro_torch.nn import sharding as sh

    orig, counts = sh._all_gather, {"captured": 0, "eager": 0}

    def spy():
        fn = orig()

        def call(*a, **kw):
            counts["captured" if torch.cuda.is_current_stream_capturing()
                   else "eager"] += 1
            return fn(*a, **kw)
        return call

    sh._all_gather = spy
    return counts, lambda: setattr(sh, "_all_gather", orig)


def p25_serve(mesh, argv, eager: bool) -> dict:
    """(a) on one rank: the launcher's rank function (captured under NCCL,
    or eager), its first served K1 calls held against the plain
    version."""
    import torch

    from repro_torch.launch import serve as launcher

    p25_rank_reset(mesh)
    recs, restore = p22_spy(P22_SAMPLE)
    t0 = time.perf_counter()
    try:
        out = launcher.serve_rank(mesh, argv, eager=eager)
    finally:
        restore()
    return dict(out, wall_s=time.perf_counter() - t0,
                held=p22_check(recs, ("K1",)),
                memory_peak=torch.cuda.max_memory_allocated(mesh.device))


def p25_batcher(mesh, tuned_path, prompts) -> dict:
    """(d) on one rank: p22_batcher_rank's batcher over NCCL (the captured
    sharded step), each tick's gather seconds."""
    from repro_torch.serve import ContinuousBatcher

    p25_rank_reset(mesh)
    ticks = []
    orig = ContinuousBatcher.step

    def step(self):
        orig(self)
        if self._serve is not None and self._serve.gather_s is not None:
            ticks.append(self._serve.gather_s)

    ContinuousBatcher.step = step
    try:
        out = p22_batcher_rank(mesh, tuned_path, prompts)
    finally:
        ContinuousBatcher.step = orig
    return dict(out, tick_gather_s=ticks)


def p25_moe_serve(mesh, arch, tuned_path) -> dict:
    """(b) / (c) on one rank of 1x4: ``arch`` at full depth, its experts a
    quarter a rank, exact and form (a) (the frozen plans); each form's
    prefill and NEW greedy steps eagerly, then through the captured
    step in the same session; the all-gathers counted inside the
    capture."""
    import numpy as np
    import torch

    from repro_torch.calib import model_batch
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.serve.sharded import (
        ShardedCapturedStep,
        ShardedServe,
        init_params_sharded,
        rank_memory,
    )
    from repro_torch.tune import load_tuned_plan

    p25_rank_reset(mesh)
    dev = mesh.device
    cfg0 = get_config(arch)
    t0 = time.perf_counter()
    params = init_params_sharded(cfg0, 0, mesh, dev)
    torch.cuda.synchronize(dev)
    out = {"rank": mesh.rank, "backend": mesh.backend,
           "init_s": time.perf_counter() - t0,
           "memory_at_rest": rank_memory(dev)}
    named = dict(params.named_parameters())
    out["expert_bytes"] = sum(p.numel() * p.element_size()
                              for n, p in named.items()
                              if n.rsplit(".", 1)[-1].startswith("moe_"))
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in named.values())
    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in model_batch(cfg0, rng, B, T).items()}
    batch["tokens"] = batch["tokens"].long()
    tp = load_tuned_plan(tuned_path)
    for form in ("exact", "a"):
        cfg = cfg0 if form == "exact" else tp.patched_config(cfg0)
        tabs = None if form == "exact" else tp.tables_for_model(
            backend="cuda", plan_exec="stacked", device=dev)
        serve = ShardedServe(cfg, mesh, tabs)
        local = serve.place_batch(batch)
        rec = {}
        counts, restore = p25_collective_spy()
        try:
            with serve.session(params):
                rec["gather_s"] = serve.gather_s
                for how in ("eager", "captured"):
                    step = (serve.decode_fn(params) if how == "captured"
                            else lambda c, tk, pos: serve.decode(
                                params, c, tk, pos))
                    if how == "captured" and not isinstance(
                            step, ShardedCapturedStep):
                        raise AssertionError(f"[25] {arch}: no captured "
                                             f"step under {mesh.backend}")
                    logits, cache = serve.prefill(params, local, T + NEW)
                    seen = [logits[:, -1].cpu()]
                    tok = logits[:, -1].argmax(-1)[:, None]
                    toks = []
                    if how == "captured":
                        before = dict(counts)
                        step.capture(cache, tok)
                        rec["capture_s"] = step.capture_s
                        rec["captured_all_gathers"] = (
                            counts["captured"] - before["captured"])
                    torch.cuda.synchronize(dev)
                    t0 = time.perf_counter()
                    for i in range(NEW):
                        toks.append(tok)
                        logits, cache = step(cache, tok, T + i)
                        seen.append(logits[:, -1].cpu())
                        tok = logits[:, -1].argmax(-1)[:, None]
                    torch.cuda.synchronize(dev)
                    secs = time.perf_counter() - t0
                    rec[how] = {"rank_tokens": torch.cat(toks, 1).tolist(),
                                "logits": seen, "decode_s": secs,
                                "tok_s": B * NEW / secs}
                    del step, cache
        finally:
            restore()
        rec["launches"] = launch_counts()
        out[form] = rec
        del serve, tabs
        gc.collect()
        torch.cuda.empty_cache()
    out["memory_peak"] = torch.cuda.max_memory_allocated(dev)
    return out


def p25_train_rwkv(mesh) -> dict:
    """(e) on one rank of 2x2: rwkv6-3b at 32 layers, 3 steps, the first
    K8 / K8b launches held against their plain versions."""
    import torch

    from repro_torch.kernels import launch_counts

    p25_rank_reset(mesh)
    s, e = p23_rank_setup(P25_RWKV + ["--dp", "2", "--tp", "2"], mesh)
    recs, restore = p23_wkv_spy()
    try:
        e.update(p23_steps(s, 0, 3))
    finally:
        restore()
    e["launches"] = {k: v for k, v in launch_counts().items() if v}
    e["held"] = p23_wkv_held(recs)
    e["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    e["hashes"] = p23_hashes(s["state"])
    return e


def p25_train_qwen22(mesh, ckpt_dir) -> dict:
    """(g)'s first half on one rank of 2x2: 2 steps, the step-2
    checkpoint."""
    import torch

    from repro_torch.train import save_checkpoint

    p25_rank_reset(mesh)
    s, g = p23_rank_setup(P23_QWEN + ["--dp", "2", "--tp", "2"], mesh)
    g.update(p23_steps(s, 0, 2))
    t0 = time.perf_counter()
    save_checkpoint(ckpt_dir, s["state"], 2, shardings=s["shardings"])
    g["save_s"] = time.perf_counter() - t0
    g["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    return g


def p25_train_qwen14(mesh, ckpt_dir) -> dict:
    """(g)'s second half on one rank of 1x4: the 2x2 checkpoint restored,
    step 3."""
    from repro_torch.train import restore_checkpoint

    p25_rank_reset(mesh)
    t0 = time.perf_counter()
    s, g = p23_rank_setup(P23_QWEN + ["--tp", "4"], mesh)
    s["state"], g["step"] = restore_checkpoint(ckpt_dir, s["state"],
                                               shardings=s["shardings"])
    g["restore_s"] = time.perf_counter() - t0
    g["restored"] = p23_hashes(s["state"])
    g.update(p23_steps(s, g["step"], 3))
    g["hashes"] = p23_hashes(s["state"])
    return g


def p25_qwen_f32():
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen3-0.6b"), dtype="float32")


def p25_ref_qwen_tp32() -> dict:
    """(h)'s float32 reference: (g)'s single-device run at
    ``--microbatch 2`` in float32, 3 steps."""
    return {"metrics": p23_reference(P23_QWEN + ["--microbatch", "2"],
                                     p25_qwen_f32())["metrics"]}


def p25_train_qwen_tp(mesh) -> dict:
    """(h) on one rank of 2x2: (g)'s qwen3-0.6b run with ``--tp-mode
    partitioned``, 3 steps in bf16, then in float32."""
    import torch

    out = {}
    for dt, cfg in (("bf16", None), ("f32", p25_qwen_f32())):
        p25_rank_reset(mesh)
        s, h = p23_rank_setup(P23_QWEN + ["--dp", "2", "--tp", "2",
                                          "--tp-mode", "partitioned"],
                              mesh, cfg)
        with WholeGatherSpy() as spy:
            h.update(p23_steps(s, 0, 3))
        h["whole_gathered"] = len(spy.whole)
        h["peak"] = torch.cuda.max_memory_allocated(mesh.device)
        out[dt] = h
        del s
    return out


def p25_train_nemotron(mesh) -> dict:
    """(i) on one rank of 1x4: nemotron-4-15b partitioned at (i)'s depth,
    2 steps."""
    import torch

    p25_rank_reset(mesh)
    cfg, argv = p23_cut(P25_TP_NEM)
    t0 = time.perf_counter()
    s, i = p23_rank_setup(argv + ["--tp", str(P25_CARDS)], mesh, cfg)
    i["setup_s"] = time.perf_counter() - t0
    with WholeGatherSpy() as spy:
        i.update(p23_steps(s, 0, 2))
    i["whole_gathered"] = len(spy.whole)
    i["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    return i


def p25_train_moe(mesh) -> dict:
    """(f) on one rank of 1x4: deepseek-moe-16b at (f)'s depth, 2 steps;
    then the 2-layer cut, 2 steps, its state hashed."""
    import torch

    p25_rank_reset(mesh)
    cfg, argv = p23_cut(P25_MOE_TRAIN)
    s, f = p23_rank_setup(argv + ["--tp", "4"], mesh, cfg)
    f.update(p23_steps(s, 0, 2))
    f["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    del s
    p25_rank_reset(mesh)
    cut = dataclasses.replace(cfg, n_layers=P25_MOE_CUT)
    s, c = p23_rank_setup(argv + ["--tp", "4"], mesh, cut)
    c.update(p23_steps(s, 0, 2))
    c["hashes"] = p23_hashes(s["state"])
    f["cut"] = c
    return f


def p25_rank(mesh, spec) -> dict:
    """Every case of phase 25 on one rank: the 2x2 cases on the mesh
    ``run_ranks`` made, then the 1x4 cases on a second mesh over the same
    ranks; each case's seconds."""
    from repro_torch.launch.mesh import make_host_mesh

    if mesh.backend != "nccl":
        raise AssertionError(f"[25] rank {mesh.rank}: backend "
                             f"{mesh.backend}, not nccl")
    out, walls = {"rank": mesh.rank, "device": str(mesh.device)}, {}
    parts = spec["parts"]

    def timed(key, fn, *args):
        t0 = time.perf_counter()
        out[key] = fn(*args)
        walls[key] = time.perf_counter() - t0

    argv = P22_QWEN + ["--mesh", "2,2"]
    if "a" in parts:
        timed("a_captured", p25_serve, mesh, argv, False)
        timed("a_eager", p25_serve, mesh, argv, True)
    if "d" in parts:
        timed("d", p25_batcher, mesh, spec["qwen_tuned"], spec["prompts"])
    if "e" in parts:
        timed("e", p25_train_rwkv, mesh)
    if "g" in parts:
        timed("g22", p25_train_qwen22, mesh, spec["ckpt_dir"])
    if "h" in parts:
        timed("h", p25_train_qwen_tp, mesh)
    mesh14 = make_host_mesh(1, 4, device=mesh.device)
    if "g" in parts:
        timed("g14", p25_train_qwen14, mesh14, spec["ckpt_dir"])
    for part, arch in zip("bc", P25_MOE):
        if part in parts:
            timed(part, p25_moe_serve, mesh14, arch, spec["moe_tuned"][arch])
    if "f" in parts:
        timed("f", p25_train_moe, mesh14)
    if "i" in parts:
        timed("i", p25_train_nemotron, mesh14)
    p25_rank_reset(mesh)
    out["walls"] = walls
    return out


def p25_split(split: dict) -> str:
    """One step's split (``train/step.py``'s timings), in ms."""
    return ", ".join(f"{k[:-2]} {v * 1e3:.1f}" for k, v in split.items()) \
        + " ms"


def p25_mem(recs, key_rest="memory_at_rest", key_peak="memory_peak") -> str:
    return ", ".join(f"r{i} {r.get(key_rest)} / {r.get(key_peak)} B"
                     for i, r in enumerate(recs))


def run_phase25(stamp, parts=("a", "b", "c", "d", "e", "f", "g", "h", "i")
                ) -> dict:
    """Phase 25 (module docstring): the references, each in a process of
    its own on ``cuda:0``, then the four ranks (a card each, NCCL) run
    ``parts``; every case held as the table in ``PERF.md`` section 4
    says.  Returns the numbers for ``chip_smoke.json`` and the ranks'
    launches, summed."""
    import shutil

    import torch

    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    art = OUT_DIR / "artifacts"
    art.mkdir(parents=True, exist_ok=True)
    ckpt = ROOT / "build" / "p25_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    refs, ref_s = {}, {}

    def ref(key, fn, *args):
        t0 = time.perf_counter()
        refs[key] = p25_in_process(fn, *args)
        ref_s[key] = time.perf_counter() - t0
        log(f"[25] {stamp()} reference {key} in {ref_s[key]:.1f}s "
            f"(its own process on cuda:0)")

    if {"a", "d"} & set(parts):
        ref("qwen", p25_ref_qwen, str(art))
    for part, arch in zip("bc", P25_MOE):
        if part in parts:
            ref(arch, p25_ref_moe, arch, str(art))
    if "e" in parts:
        ref("rwkv", p25_ref_rwkv)
    if "f" in parts:
        ref("moe_train", p25_ref_moe_train)
        ref("moe_train_dryrun", p25_dryrun_moe_train)
    if {"g", "h"} & set(parts):
        ref("qwen_train", p25_ref_qwen_train)
    if "h" in parts:
        ref("qwen_tp32", p25_ref_qwen_tp32)
    if "i" in parts:
        ref("nemotron", p25_ref_nemotron)
        ref("nemotron_dryrun", p25_dryrun_nemotron)
        if refs["nemotron_dryrun"] > P25_TP_NEM_LIMIT:
            raise AssertionError(
                f"[25] (i) the dry run gives a rank "
                f"{refs['nemotron_dryrun'] / 1e9:.2f} GB at "
                f"{P25_TP_NEM[0]} layers, over {P25_TP_NEM_LIMIT / 1e9:.0f}"
                f" GB: cut P25_TP_NEM's depth")

    spec = {"parts": tuple(parts), "ckpt_dir": str(ckpt),
            "qwen_tuned": refs.get("qwen", {}).get("tuned"),
            "prompts": refs.get("qwen", {}).get("prompts"),
            "moe_tuned": {a: refs[a]["tuned"] for a in P25_MOE if a in refs}}
    t0 = time.perf_counter()
    ranks = run_ranks(p25_rank, (spec,), dp=2, tp=2, timeout=900)
    wall = time.perf_counter() - t0
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[25] {stamp()} the four ranks ran {list(parts)} in {wall:.1f}s: "
        f"devices {[r['device'] for r in ranks]}, backend nccl; cases "
        + ", ".join(f"{k} {v:.1f}s" for k, v in ranks[0]["walls"].items()))
    out = {"references_s": ref_s, "ranks_s": wall,
           "walls": [r["walls"] for r in ranks]}
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    if "a" in parts:
        q = refs["qwen"]
        rows = {}
        for how in ("captured", "eager"):
            recs = [r[f"a_{how}"] for r in ranks]
            for r in recs:
                if r["backend"] != "nccl" or r["checksum"] != q["checksum"]:
                    raise AssertionError(f"[25] (a) {how} rank {r['rank']}: "
                                         f"backend {r['backend']}, tables "
                                         f"{r['checksum'][:16]}")
                held_bit_for_bit(f"(a) {how}", r,
                                 q["rows"][r["coords"]["data"]], r["logits"],
                                 phase="25")
                if r["launches"]["lut_act_stacked"] == 0:
                    raise AssertionError(f"[25] (a) rank {r['rank']} "
                                         f"launched no K1")
                add(r["launches"])
            if how == "captured" and any(r["capture_s"] is None
                                         for r in recs):
                raise AssertionError("[25] (a) a rank did not capture")
            rows[how] = {r["rank"]: {k: r[k] for k in (
                "gather_s", "prefill_s", "decode_s", "decode_tok_s",
                "capture_s", "memory_at_rest", "memory_peak", "held",
                "wall_s")} for r in recs}
        for r in ranks:
            c, e = r["a_captured"], r["a_eager"]
            if c["rank_tokens"] != e["rank_tokens"] or not all(
                    torch.equal(x, y) for x, y in zip(c["logits"],
                                                      e["logits"])):
                raise AssertionError(f"[25] (a) rank {r['rank']}: the "
                                     f"captured replay differs from eager")
        out["a"] = rows
        cap, eag = rows["captured"], rows["eager"]
        log(f"[25] {stamp()} (a) qwen3-0.6b on 2x2 through launch/serve's "
            f"rank function, backend nccl: every rank's tokens and logits "
            f"bit for bit the single-device run's on its rows, captured "
            f"and eager, and the captured replay bit for bit eager; each "
            f"rank's first {P22_SAMPLE} served K1 calls bit for bit "
            f"lut_act_stacked_plain; gather a session: the first, with "
            f"the communicators' set-up, "
            + ", ".join(f"r{k} {v['gather_s']:.4f}s" for k, v in cap.items())
            + ", the second "
            + ", ".join(f"r{k} {v['gather_s']:.4f}s" for k, v in eag.items())
            + "; decode tok/s captured "
            + ", ".join(f"{v['decode_tok_s']:.1f}" for v in cap.values())
            + ", eager "
            + ", ".join(f"{v['decode_tok_s']:.1f}" for v in eag.values())
            + "; capture "
            + ", ".join(f"{v['capture_s']:.3f}s" for v in cap.values())
            + "; memory at rest / peak " + p25_mem(list(cap.values())))

    if "d" in parts:
        q = refs["qwen"]
        recs = [r["d"] for r in ranks]
        for r in recs:
            if r["outs"] != q["batcher_outs"]:
                raise AssertionError(f"[25] (d) rank {r['rank']}'s batcher "
                                     f"outputs differ from the single-device "
                                     f"batcher's")
            if r["metrics"]["dropped"] or r["launches"]["lut_act_stacked"] == 0:
                raise AssertionError(f"[25] (d) rank {r['rank']}: "
                                     f"{r['metrics']}, {r['launches']}")
            add(r["launches"])
        new_tok = sum(len(o) for o in recs[0]["outs"])
        out["d"] = {"seconds": [r["seconds"] for r in recs],
                    "single_seconds": q["batcher_s"],
                    "ticks": recs[0]["metrics"]["ticks"],
                    "new_tok_s": [new_tok / r["seconds"] for r in recs],
                    "single_new_tok_s": new_tok / q["batcher_s"],
                    "tick_gather_s": [statistics.median(r["tick_gather_s"])
                                      for r in recs],
                    "held": [r["held"] for r in recs],
                    "memory_at_rest": [r["memory_at_rest"] for r in recs]}
        log(f"[25] {stamp()} (d) the batcher on 2x2 over NCCL (replay "
            f"prefill, {BATCHER_REQUESTS} requests, {BATCHER_SLOTS} slots, "
            f"the captured sharded step): outputs equal the single-device "
            f"batcher's on every rank; {out['d']['ticks']} ticks, new tok/s "
            + ", ".join(f"{x:.1f}" for x in out["d"]["new_tok_s"])
            + f" (one device {out['d']['single_new_tok_s']:.1f}); gather a "
              f"tick (median) "
            + ", ".join(f"{x:.4f}s" for x in out["d"]["tick_gather_s"]))

    for part, arch in zip("bc", P25_MOE):
        if part not in parts:
            continue
        m = refs[arch]
        recs = [r[part] for r in ranks]
        n_moe = m["layers"]
        form_out = {}
        for form in ("exact", "a"):
            want = m[form]
            for r in recs:
                f = r[form]
                for how in ("eager", "captured"):
                    held_bit_for_bit(f"({part}) {arch} {form} {how}",
                                     dict(f[how], rank=r["rank"]), want,
                                     f[how]["logits"], phase="25")
                if f["captured_all_gathers"] != n_moe:
                    raise AssertionError(
                        f"[25] ({part}) {arch} {form}: rank {r['rank']} "
                        f"captured {f['captured_all_gathers']} expert "
                        f"all-gathers a step, not {n_moe}")
                if form == "a" and f["launches"]["lut_act_stacked"] == 0:
                    raise AssertionError(f"[25] ({part}) rank {r['rank']} "
                                         f"launched no K1")
                add(f["launches"])
            form_out[form] = {
                "gather_s": [r[form]["gather_s"] for r in recs],
                "capture_s": [r[form]["capture_s"] for r in recs],
                "captured_all_gathers": recs[0][form]["captured_all_gathers"],
                "tok_s_eager": [r[form]["eager"]["tok_s"] for r in recs],
                "tok_s_captured": [r[form]["captured"]["tok_s"]
                                   for r in recs]}
        out[part] = {"arch": arch, "layers": n_moe,
                     "one_device_param_bytes": m["param_bytes"],
                     "one_device_expert_bytes": m["expert_bytes"],
                     "one_device_peak": m["peak"],
                     "expert_bytes": [r["expert_bytes"] for r in recs],
                     "param_bytes": [r["param_bytes"] for r in recs],
                     "memory_at_rest": [r["memory_at_rest"] for r in recs],
                     "memory_peak": [r["memory_peak"] for r in recs],
                     "init_s": [r["init_s"] for r in recs], **form_out}
        o = out[part]
        log(f"[25] {stamp()} ({part}) {arch} ({n_moe} layers, the whole "
            f"model) on 1x4, backend nccl, experts "
            f"{o['expert_bytes'][0]} of {m['expert_bytes']} B a rank: exact "
            f"and form (a), eager and captured, every rank's tokens and "
            f"logits bit for bit the single-device run's (peak "
            f"{m['peak']} B); {o['a']['captured_all_gathers']} expert "
            f"all-gathers captured a step; " + "; ".join(
                f"{form}: gather {statistics.median(o[form]['gather_s']):.4f}"
                f"s, capture {statistics.median(o[form]['capture_s']):.3f}s, "
                f"decode tok/s captured "
                f"{statistics.median(o[form]['tok_s_captured']):.1f} / eager "
                f"{statistics.median(o[form]['tok_s_eager']):.1f}"
                for form in ("exact", "a"))
            + f"; memory at rest / peak "
            + ", ".join(f"r{i} {a} / {p} B" for i, (a, p) in enumerate(
                zip(o["memory_at_rest"], o["memory_peak"]))))

    if "e" in parts:
        rf = refs["rwkv"]
        recs = [r["e"] for r in ranks]
        for i, e in enumerate(recs):
            p23_same(f"(e) rank {i}'s metrics", e["metrics"], rf["metrics"])
            p23_same(f"(e) rank {i}'s launches in 3 steps", e["launches"],
                     {"wkv": 3 * 2 * 32, "wkv_backward": 3 * 32})
            add(e["launches"])
        p23_held("(e) the state after 3 steps", [e["hashes"] for e in recs],
                 rf["hashes"][3, (2, 2)])
        out["e"] = {"metrics": recs[0]["metrics"],
                    "one_device_seconds": rf["seconds"],
                    "one_device_peak": rf["peak"],
                    "ranks": [{k: e[k] for k in (
                        "state_bytes", "memory_at_rest", "peak", "seconds",
                        "splits", "launches", "held")} for e in recs]}
        log(f"[25] {stamp()} (e) rwkv6-3b (32 layers, --remat, 4 x 256) on "
            f"2x2 over NCCL: 3 steps bit for bit the single-device "
            f"--microbatch 2 run (metrics, every rank's shares); per rank "
            + "; ".join(f"r{i} steps {[round(x * 1e3, 1) for x in e['seconds']]}"
                        f" ms (step 3: {p25_split(e['splits'][-1])}), "
                        f"sampled K8 / K8b "
                        f"{e['held']}, at rest {e['memory_at_rest']} B, peak "
                        f"{e['peak']} B" for i, e in enumerate(recs))
            + f"; one device steps "
              f"{[round(x * 1e3, 1) for x in rf['seconds']]} ms, peak "
              f"{rf['peak']} B")

    if "f" in parts:
        rf = refs["moe_train"]
        recs = [r["f"] for r in ranks]
        for i, f in enumerate(recs):
            if f["metrics"][0][0] != rf["loss"]:
                raise AssertionError(f"[25] (f) rank {i}'s first loss "
                                     f"{f['metrics'][0][0]!r} != the "
                                     f"single-device forward's "
                                     f"{rf['loss']!r}")
            p23_same(f"(f) cut rank {i}'s metrics", f["cut"]["metrics"],
                     rf["cut"]["metrics"])
        p23_held("(f) cut: the state after 2 steps",
                 [f["cut"]["hashes"] for f in recs],
                 rf["cut"]["hashes"][2, (1, 4)])
        pred = refs["moe_train_dryrun"]
        out["f"] = {"depth": rf["depth"], "loss": rf["loss"],
                    "metrics": recs[0]["metrics"],
                    "one_device_forward_peak": rf["peak"],
                    "dryrun_peak": pred,
                    "ranks": [{k: f[k] for k in (
                        "state_bytes", "memory_at_rest", "peak", "seconds",
                        "splits")} for f in recs]}
        log(f"[25] {stamp()} (f) deepseek-moe-16b ({rf['depth']} of 28 "
            f"layers, 4 x 64) on 1x4 over NCCL, each rank its share of the "
            f"expert gradients: the first loss "
            f"{rf['loss']!r} bit for bit the single-device forward's, and "
            f"the {P25_MOE_CUT}-layer cut's 2 steps bit for bit the "
            f"single-device step; per rank "
            + "; ".join(f"r{i} steps {[round(x * 1e3, 1) for x in f['seconds']]}"
                        f" ms (step 2: {p25_split(f['splits'][-1])}), state "
                        f"{f['state_bytes']} B, peak {f['peak']} B "
                        f"({f['peak'] / 1e9:.2f} GB; the dry run "
                        f"{pred / 1e9:.2f} GB, "
                        f"{(f['peak'] - pred) / 1e9:+.2f})"
                        for i, f in enumerate(recs)))

    if "g" in parts:
        rf = refs["qwen_train"]
        r22 = [r["g22"] for r in ranks]
        r14 = [r["g14"] for r in ranks]
        for i, (a, b) in enumerate(zip(r22, r14)):
            p23_same(f"(g) rank {i}'s steps 1-3", a["metrics"] + b["metrics"],
                     rf["metrics"])
            p23_same(f"(g) rank {i}'s restored step", b["step"], 2)
        p23_held("(g) 1x4: the restored state", [b["restored"] for b in r14],
                 rf["hashes2"])
        p23_held("(g) 1x4: the state after step 3",
                 [b["hashes"] for b in r14], rf["hashes3"])
        out["g"] = {"metrics": rf["metrics"],
                    "splits_2x2": [a["splits"] for a in r22],
                    "save_s": r22[0]["save_s"],
                    "restore_s": [b["restore_s"] for b in r14],
                    "seconds_2x2": [a["seconds"] for a in r22],
                    "seconds_1x4": [b["seconds"] for b in r14],
                    "peak_2x2": [a["peak"] for a in r22]}
        log(f"[25] {stamp()} (g) qwen3-0.6b training: 2 steps on 2x2, the "
            f"step-2 checkpoint ({r22[0]['save_s']:.1f}s) restored onto 1x4 "
            f"(the single-device state after 2 steps, every rank's shares), "
            f"step 3 there: the metrics and the state after it bit for bit "
            f"the single-device 2 steps at --microbatch 2 and a third at "
            f"--microbatch 1; the 2x2 steps "
            + "; ".join(f"r{i} {[round(x * 1e3, 1) for x in a['seconds']]} ms"
                        f" (step 2: {p25_split(a['splits'][-1])})"
                        for i, a in enumerate(r22))
            + f"; the 1x4 step "
            + ", ".join(f"{b['seconds'][0] * 1e3:.1f}" for b in r14)
            + " ms")
    if "h" in parts:
        rf, r32 = refs["qwen_train"], refs["qwen_tp32"]
        both = [r["h"] for r in ranks]
        for i, hh in enumerate(both):
            for dt, want, n in (("f32", r32["metrics"], 3),
                                ("bf16", rf["metrics"], P25_TP_BF16_HELD)):
                for j, ((l, g), (wl, wg)) in enumerate(zip(
                        hh[dt]["metrics"][:n], want)):
                    if abs(l - wl) > P25_TP_RTOL or \
                            abs(g - wg) > P25_TP_RTOL * wg:
                        raise AssertionError(
                            f"[25] (h) {dt} rank {i} step {j}: partitioned "
                            f"loss / norm {l!r} / {g!r} against the exact "
                            f"steps' {wl!r} / {wg!r}")
                if hh[dt]["whole_gathered"]:
                    raise AssertionError(f"[25] (h) {dt} rank {i} gathered "
                                         f"{hh[dt]['whole_gathered']} whole "
                                         f"tp-split leaves")
        recs = [hh["bf16"] for hh in both]
        g22 = [r["g22"] for r in ranks] if "g" in parts else None
        out["h"] = {"metrics": recs[0]["metrics"],
                    "exact_metrics": rf["metrics"],
                    "f32_metrics": both[0]["f32"]["metrics"],
                    "f32_one_device_metrics": r32["metrics"],
                    "ranks": [{k: h[k] for k in (
                        "state_bytes", "memory_at_rest", "peak", "seconds",
                        "splits")} for h in recs]}
        log(f"[25] {stamp()} (h) qwen3-0.6b 8 x 512 --remat on 2x2 with "
            f"--tp-mode partitioned, 3 steps: float32 losses / norms "
            f"{out['h']['f32_metrics']} within {P25_TP_RTOL} of the "
            f"single-device float32 --microbatch 2 steps' {r32['metrics']}; "
            f"bf16 {out['h']['metrics']}, the first {P25_TP_BF16_HELD} "
            f"within {P25_TP_RTOL} of (g)'s exact steps {rf['metrics']}; no "
            f"whole tp-split leaf gathered; per rank (bf16) "
            + "; ".join(f"r{i} steps "
                        f"{[round(x * 1e3, 1) for x in h['seconds']]} ms "
                        f"(step 2: {p25_split(h['splits'][1])}), state "
                        f"{h['state_bytes']} B, peak {h['peak']} B"
                        + (f"; (g) exact steps "
                           f"{[round(x * 1e3, 1) for x in g22[i]['seconds']]}"
                           f" ms (step 2: {p25_split(g22[i]['splits'][1])}),"
                           f" peak {g22[i]['peak']} B" if g22 else "")
                        for i, h in enumerate(recs)))

    if "i" in parts:
        rf, pred = refs["nemotron"], refs["nemotron_dryrun"]
        recs = [r["i"] for r in ranks]
        for i, x in enumerate(recs):
            l0 = x["metrics"][0][0]
            if abs(l0 - rf["loss"]) > P25_TP_RTOL:
                raise AssertionError(f"[25] (i) rank {i}'s first loss "
                                     f"{l0!r} against the single-device "
                                     f"forward's {rf['loss']!r}")
            if x["whole_gathered"] or not all(
                    math.isfinite(v) for m in x["metrics"] for v in m):
                raise AssertionError(f"[25] (i) rank {i}: "
                                     f"{x['whole_gathered']} whole gathers, "
                                     f"metrics {x['metrics']}")
        out["i"] = {"depth": rf["depth"], "loss": rf["loss"],
                    "metrics": recs[0]["metrics"],
                    "one_device_param_bytes": rf["param_bytes"],
                    "one_device_forward_peak": rf["peak"],
                    "dryrun_peak": pred,
                    "ranks": [{k: x[k] for k in (
                        "state_bytes", "memory_at_rest", "peak", "seconds",
                        "splits", "setup_s")} for x in recs]}
        log(f"[25] {stamp()} (i) nemotron-4-15b ({rf['depth']} of 32 layers, "
            f"--remat, 4 x 64) on 1x4 with --tp-mode partitioned: the first "
            f"loss {recs[0]['metrics'][0][0]!r} within {P25_TP_RTOL} of the "
            f"single-device forward's {rf['loss']!r} (parameters "
            f"{rf['param_bytes']} B, forward peak {rf['peak']} B); no "
            f"whole tp-split leaf gathered; per rank "
            + "; ".join(f"r{i} steps "
                        f"{[round(v * 1e3, 1) for v in x['seconds']]} ms "
                        f"(step 2: {p25_split(x['splits'][-1])}), metrics "
                        f"{x['metrics']}, state {x['state_bytes']} B, peak "
                        f"{x['peak']} B ({x['peak'] / 1e9:.2f} GB; the dry "
                        f"run {pred / 1e9:.2f} GB, "
                        f"{(x['peak'] - pred) / 1e9:+.2f}), set-up "
                        f"{x['setup_s']:.1f}s" for i, x in enumerate(recs)))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[25] {stamp()} phase 25 in {out['seconds']:.0f}s (references "
        + ", ".join(f"{k} {v:.0f}s" for k, v in ref_s.items())
        + f", the ranks {wall:.0f}s); the ranks' launches {launches}")
    return {"out": out, "launches": launches}


def main_cards(smi, stamp, t_start) -> int:
    """``--cards 4``: phase 25 alone, after the build; its numbers in
    ``chip_smoke.json``, its summary on the line before the card's."""
    import torch

    log(f"[25] {stamp()} {torch.cuda.device_count()} cards: "
        + ", ".join(torch.cuda.get_device_name(i)
                    for i in range(torch.cuda.device_count())))
    p25 = run_phase25(stamp)
    summary = {"card": smi, "seconds": time.perf_counter() - t_start,
               "phase25": p25["out"], "launches": p25["launches"]}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        summary, indent=1, default=str))
    log(f"done in {time.perf_counter() - t_start:.0f}s")
    print(json.dumps({"phase25": sig4({
        "seconds": p25["out"]["seconds"], "launches": p25["launches"],
        **{k: p25["out"][k] for k in ("a", "b", "c", "d", "e", "f", "g",
                                      "h", "i") if k in p25["out"]}})},
        separators=(",", ":"), default=str),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, P25_CARDS), default=1,
                    help="1 (default): phases 1-24 on cuda:0; 4: the "
                         "kernels' build (phase 2) and phase 25 on four "
                         "cards, a card a rank, over NCCL")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false — this "
              "script runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__} — run it "
              f"from a checkout of the repository", file=sys.stderr)
        return 2
    n_cards = torch.cuda.device_count()
    if n_cards < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} cards, "
              f"and {n_cards} card(s) are visible: phase 25 runs a card a "
              f"rank and never on fewer cards", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import build, launch_counts, ops
    from repro_torch.kernels.lut_act import (
        lut_act_multi_plain,
        lut_act_plain,
        lut_act_stacked_plain,
    )
    from repro_torch.kernels.wkv import wkv_chunked_plain
    from repro_torch.launch import serve as launcher
    from repro_torch.nn import ssm as ssm_mod
    from repro_torch.nn.lut_act import build_lut_activation
    from repro_torch.serve import verify_backend_equivalence
    from repro_torch.serve.stacked import (
        StackedPlanArrays,
        multi_site_stacked_entry,
    )

    t_start = time.perf_counter()
    stamp = lambda: f"[{time.perf_counter() - t_start:.0f}s]"
    OUT_DIR.mkdir(exist_ok=True)
    LOG.append(open(OUT_DIR / "chip_smoke.log", "w"))
    # parity runs: no TF32, no reduced-precision bf16 reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # ---- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build(verbose=True)
    build.load()
    log(f"[2] built {sorted(built)} in {time.perf_counter() - t0:.1f}s "
        f"(per source: "
        + ", ".join(f"{k} {v['seconds']:.1f}s" for k, v in built.items())
        + ")")
    if args.cards == P25_CARDS:
        return main_cards(smi, stamp, t_start)
    ptxas = "\n".join(v["log"] for v in built.values())
    (OUT_DIR / "ptxas.log").write_text(ptxas)
    for line in ptxas.splitlines():
        if "Used" in line:
            log(f"    ptxas: {line.strip()}")
    sass = k3_sass_counts(build, built["fused_matmul_lut"]["path"])
    log(f"[2] K3's bf16 kernels in SASS (cuobjdump -sass): "
        + ", ".join(f"{k}: {v['HGMMA']} HGMMA, {v['UTMALDG']} UTMALDG"
                    for k, v in sass.items())
        + f"; K8: {k8_hmma_count(build, built['wkv']['path'])} HMMA "
          f"(TF32 mma.sync); K8b: "
        + ", ".join(f"{k} {v}" for k, v in k8b_hmma_counts(
            build, built["wkv_bwd"]["path"]).items()) + " HMMA")

    # ---- 3. model, calibration, plans ------------------------------------
    common = ["--arch", "qwen3-0.6b", "--full", "--batch", str(B),
              "--prompt-len", str(T), "--new-tokens", str(NEW), "--lut-act",
              "--device", "cuda"]
    parse = launcher.parse_args
    # no --lut-backend: the launcher's default on the card, the kernels
    args_a = parse(common + ["--calib-steps", "2"])
    if args_a.lut_backend != "cuda":
        raise AssertionError(f"the launcher's default backend on the card "
                             f"is {args_a.lut_backend!r}, not 'cuda'")
    t0 = time.perf_counter()
    cfg0, params, batch, rng = launcher.setup(args_a)
    torch.cuda.synchronize()
    log(f"[3] {stamp()} {cfg0.name}: {cfg0.n_layers} layers, d_model "
        f"{cfg0.d_model}, d_ff {cfg0.d_ff}, vocab {cfg0.vocab_size}, "
        f"{cfg0.dtype}; "
        f"{sum(p.numel() for p in params.parameters()) / 1e9:.3f}G params "
        f"in {time.perf_counter() - t0:.1f}s")
    plans = launcher.build_plans(args_a, cfg0, params, rng,
                                 log=lambda m: log("    " + m))
    rep = plans.report
    log(f"    per-site plans: {plans.total_cost} P-LUTs, dedup_rate "
        f"{rep.dedup_rate:.3f}, {len(rep.plans)} tables")
    args_c = parse(common)
    # per-site capture leaves rng where the launcher's shared path reads it
    shared = launcher.build_plans(args_c, cfg0, params, rng,
                                  log=lambda m: log("    " + m))
    cfg = plans.patched_config(cfg0)
    # path A: every LUT site (--lut-sites all), and with the logit softcap
    args_e = parse(common + ["--calib-steps", "2", "--lut-sites", "all"])
    args_f = parse(common + ["--calib-steps", "2", "--lut-sites", "all",
                             "--lut-fuse"])
    args_g = parse(common + ["--calib-steps", "2", "--lut-sites", "all",
                             "--logit-softcap", "30"])
    plans_all = launcher.build_plans(
        args_e, form_config(None, cfg0, args_e), params, rng,
        log=lambda m: log("    " + m))
    plans_cap = launcher.build_plans(
        args_g, form_config(None, cfg0, args_g), params, rng,
        log=lambda m: log("    " + m))

    # ---- 4. kernels against their plain versions on the card -------------
    gen = torch.Generator(device=dev).manual_seed(1)
    st_cuda = plans.tables_for_model(backend="cuda", device=dev)
    st_raw = plans.tables_for_model(backend="gather", device=dev)
    stacks = {"packed": st_cuda["sites"]["mlp"]["stacked"],
              "raw": st_raw["sites"]["mlp"]["stacked"]}
    # a stack whose layers mix w_lb == 0 and w_lb > 0 (the main path's
    # engine may pick w_lb == 0 everywhere)
    crng = np.random.default_rng(2)
    mixed = [build_lut_activation("silu", crng.normal(size=20000) * s,
                                  lb_candidates=lb)
             for s, lb in ((2, (0,)), (3, (2,)))]
    assert [m.plan.w_lb for m in mixed] == [0, 2]
    mst = StackedPlanArrays.from_entries(
        [{"meta": m.meta(), "arrays": m.plan_arrays(device="cpu").arrays}
         for m in mixed])
    stacks["mixed-packed"] = mst.entry(packed=True, device=dev)
    stacks["mixed-raw"] = mst.entry(packed=False, device=dev)
    checked = 0
    max_err = {"lut_act_stacked": 0.0, "lut_act": 0.0,
               "fused_matmul_lut": 0.0}

    def note_err(name, yk, yp):
        d = float((yk.float() - yp.float()).abs().max())
        max_err[name] = max(max_err[name], d)

    for rows in (B, B * T):
        for dtype in (torch.bfloat16, torch.float32):
            x = kernel_inputs(torch, rows, dtype, dev, gen)
            for name, st in stacks.items():
                for layer in range(st["meta"]["n_layers"]):
                    yk = ops.lut_act_stacked(x, st, layer)
                    yp = lut_act_stacked_plain(x, st, layer)
                    note_err("lut_act_stacked", yk, yp)
                    if not bits_equal(torch, yk, yp):
                        raise AssertionError(
                            f"K1 lut_act_stacked differs from its plain "
                            f"version: {name} layer {layer} rows {rows} "
                            f"{dtype} ({int((yk != yp).sum())} elements)")
                    checked += 1
            for name, lut in [("shared", shared.sites["mlp"].lut),
                              ("layer0", plans.sites["mlp"].luts[0]),
                              ("w_lb0", mixed[0]), ("w_lb2", mixed[1])]:
                for packed in (False, True):
                    pa = lut.plan_arrays(packed=packed, device=dev)
                    kw = dict(x_lo=lut.x_lo, x_hi=lut.x_hi, y_lo=lut.y_lo,
                              y_hi=lut.y_hi)
                    yk = ops.lut_act(x, pa, **kw)
                    yp = lut_act_plain(x, pa.arrays, l=pa.l, w_lb=pa.w_lb,
                                       w_hb=pa.w_hb, w_in=pa.w_in,
                                       w_out=pa.w_out, pack=pa.pack, **kw)
                    note_err("lut_act", yk, yp)
                    if not bits_equal(torch, yk, yp):
                        raise AssertionError(
                            f"K2 lut_act differs from its plain version: "
                            f"{name} packed={packed} rows {rows} {dtype}")
                    checked += 1
    torch.cuda.synchronize()
    log(f"[4] {stamp()} K1/K2 bit-exact against their plain versions on "
        f"{checked} (slab, layer, shape, dtype) cases")
    # the layouts the serving path gives K1 / K2, on every site's stack of
    # the all-sites plans and the mixed stack, and K2 on per-layer plans
    site_stacks = plans_all.tables_for_model(backend="cuda", device=dev)
    lay_stacks = {f"{site} packed": e["stacked"]
                  for site, e in site_stacks["sites"].items()
                  if "stacked" in e}
    lay_stacks["mixed-packed"] = stacks["mixed-packed"]
    lay_stacks["mixed-raw"] = stacks["mixed-raw"]
    lay_luts = {"shared": shared.sites["mlp"].lut, "w_lb0": mixed[0],
                "w_lb2": mixed[1]}
    lay_luts.update({f"{site} layer {i}": sp.luts[i]
                     for site, sp in plans_all.sites.items() if sp.per_layer
                     for i in (0, cfg.n_layers - 1)})
    lay_cases, lay_widths = check_k1_layouts(dev, lay_stacks, lay_luts, gen)
    gate = k1_layouts(torch, B, torch.bfloat16, dev, gen)["gate view"]
    k1_kernels = kernels_of(
        lambda: ops.lut_act_stacked(gate, stacks["packed"], 0))
    if len(k1_kernels) != 1:
        raise AssertionError(f"K1 on the gate view launched {k1_kernels}, "
                             f"not one kernel")
    log(f"[4] {stamp()} K1/K2 bit-exact on {lay_cases} more cases: the gate "
        f"and up halves of [gate|up] (row stride 6144), a start 2 / 4 bytes "
        f"past a 16-byte boundary, counts 1, 7 and 8003, stacks "
        f"{sorted(lay_stacks)} (any_lb with a w_lb == 0 layer: mixed), pack "
        f"widths {lay_widths}; K1 on the gate view launches one kernel "
        f"({k1_kernels[0][:60]}) and no copy")

    f_tables = plans.tables_for_model(backend="cuda", kernel="fused",
                                      device=dev)
    ftab = lambda layer: {"multi_entry": f_tables["multi"], "site": "mlp",
                          "layer": layer}
    f_slice = multi_site_stacked_entry(f_tables["multi"], "mlp")
    # K3: the serving shapes, then ragged and repeated cases; stacked tables
    # (held against K1) and per-plan tables (shared or unrolled tables under
    # --lut-fuse: scalars as kernel arguments, held against K2)
    L, K = cfg.n_layers, cfg.d_model
    w_in = params.blocks["w_in"]
    lut = shared.sites["mlp"].lut
    pa_sh = lut.plan_arrays(packed=True, device=dev)
    ptab = {"meta": dict(lut.meta(), pack=pa_sh.pack), "arrays": pa_sh.arrays}
    k2 = lambda g: ops.lut_act(g, pa_sh, x_lo=lut.x_lo, x_hi=lut.x_hi,
                               y_lo=lut.y_lo, y_hi=lut.y_hi)
    k1 = lambda layer: (lambda g: ops.lut_act_stacked(g, f_slice, layer))
    rand_x = lambda m, k: torch.randn(m, k, generator=gen, device=dev).to(
        torch.bfloat16)
    wstd = float(w_in[0].float().std())
    rand_w = lambda k, n: (torch.randn(k, n, generator=gen, device=dev)
                           * wstd).to(torch.bfloat16)
    cases = []   # (label, x, w, site entry, the unfused LUT)
    for m in (B, B * T):
        for layer in (0, L // 2, L - 1):
            cases.append((f"M={m} layer {layer}", rand_x(m, K), w_in[layer],
                          ftab(layer), k1(layer)))
        cases.append((f"M={m} per-plan", rand_x(m, K), w_in[0], ptab, k2))
    for m in RAGGED_M:
        x = rand_x(m, K)
        cases += [(f"M={m}", x, w_in[L // 2], ftab(L // 2), k1(L // 2)),
                  (f"M={m} per-plan", x, w_in[0], ptab, k2)]
    w_f = rand_w(K, 2000)               # F = 1000: not a multiple of 64
    w_k = rand_w(1032, w_in.shape[2])   # K = 1032: not a multiple of S x 64
    for m in (B, 67):
        cases += [(f"F=1000 M={m}", rand_x(m, K), w_f, ftab(L // 2),
                   k1(L // 2)),
                  (f"F=1000 M={m} per-plan", rand_x(m, K), w_f, ptab, k2),
                  (f"K=1032 M={m}", rand_x(m, 1032), w_k, ftab(L // 2),
                   k1(L // 2)),
                  (f"K=1032 M={m} per-plan", rand_x(m, 1032), w_k, ptab, k2)]
    # the f32 route (CUDA cores) at one shape
    cases.append((f"f32 M={B}", rand_x(B, K).float(), w_in[L // 2].float(),
                  ftab(L // 2), k1(L // 2)))
    k3_mismatch = {}
    for label, x, w, tab, lut_fn in cases:
        err, share = check_fused_case(x, w, tab, lut_fn, gated=True,
                                      label=label)
        max_err["fused_matmul_lut"] = max(max_err["fused_matmul_lut"], err)
        k3_mismatch[label] = share
    torch.cuda.synchronize()
    log(f"[4] {stamp()} K3 (gated) on {len(cases)} cases: bit-exact against "
        f"its own GEMM + K1 (stacked) / K2 (per-plan), two launches "
        f"bit-identical, share differing from torch.matmul + plain LUT at "
        f"most {max(k3_mismatch.values()):.6f}")

    a_tables = plans_all.tables_for_model(backend="cuda", kernel="fused",
                                          device=dev)
    a_multi = a_tables["multi"]
    k4_err, k4_cases = check_multisite(dev, a_multi, gen)
    max_err["lut_act_multi"] = k4_err
    log(f"[4] {stamp()} K4 bit-exact against its plain version and against "
        f"K1 per site on {k4_cases} (site, layer, dtype, launch) cases: "
        f"sites {a_multi['meta']['sites']} in one launch per layer, segment"
        f" lengths {MULTI_LENGTHS}, and each site alone at {SERVED_K4} "
        f"elements, aligned and one element past, both modes; f32 and "
        f"bf16, bin edges +-1 ulp; two "
        f"launches bit-identical; single-site and all-sites calls replayed "
        f"from a CUDA graph give eager's bits; an entry without its launch "
        f"record is refused")

    # ---- 5. the serving path, qwen3-0.6b (path A: forms e-g) --------------
    results = {}
    totals = {k: 0 for k in launch_counts()}
    quiet = lambda m: None
    # the exact activation (no LUT) on the same weights, as a yardstick
    launcher.serve(args_a, cfg0, params, batch, None, log=quiet)
    exact = launcher.serve(args_a, cfg0, params, batch, None, log=quiet)
    log(f"[5] {stamp()} exact (no LUT): prefill {exact['prefill_s']:.4f}s, "
        f"decode {exact['decode_tok_s']:.1f} tok/s")
    forms = [
        ("a", args_a, plans, ["lut_act_stacked"], "gather"),
        ("b", parse(common + ["--calib-steps", "2", "--plan-exec",
                              "unrolled"]), plans, ["lut_act"], "gather"),
        ("c", args_c, shared, ["lut_act"], "gather"),
        ("d", parse(common + ["--calib-steps", "2", "--lut-fuse"]), plans,
         ["fused_matmul_lut"], "a"),
        ("e", args_e, plans_all, ["lut_act_stacked"], "gather"),
        ("f", args_f, plans_all, ["fused_matmul_lut", "lut_act_multi"],
         "e"),
        ("g", args_g, plans_cap, ["lut_act_stacked", "lut_act"], "gather"),
        ("k", parse(common + ["--calib-steps", "2", "--kv-int8"]), plans,
         ["lut_act_stacked"], "a"),
    ]
    for label, args, pl, uses, ref in forms:
        log(f"[5] {stamp()}")
        serve_form(launcher, dev, label, args, cfg0, params, batch, pl, uses,
                   results, totals, ref=ref)
    logits, _ = launcher.prefill(params, cfg, batch, max_seq=T + 1,
                                 lut_tables=st_cuda)
    if logits.shape != (B, 1, cfg.vocab_size) or not torch.isfinite(
            logits.float()).all():
        raise AssertionError(f"bad logits {tuple(logits.shape)}")
    # the port's own backend check (cuda == gather, token for token) on a
    # small input: the smoke config, per-layer tables, both exec forms
    s_args = parse(["--arch", "qwen3-0.6b", "--batch", "2", "--prompt-len",
                    "8", "--new-tokens", "4", "--lut-act", "--lut-backend",
                    "cuda", "--calib-steps", "1", "--device", "cuda"])
    s_cfg, s_params, s_batch, s_rng = launcher.setup(s_args)
    s_plans = launcher.build_plans(s_args, s_cfg, s_params, s_rng, log=quiet)
    for exec_ in ("stacked", "unrolled"):
        toks = verify_backend_equivalence(
            s_cfg, s_params, s_plans, s_batch["tokens"].cpu().numpy(), 4,
            plan_exec=exec_)
        log(f"[5] verify_backend_equivalence ({s_cfg.name}, {exec_}): "
            f"cuda == gather, request 0 {toks[0]}")

    # ---- 13. the continuous batcher and 14. artifacts (run here, so that
    # the batcher's launches count on the main path) ------------------------
    log(f"[13] {stamp()}")
    batcher = run_batcher(launcher, dev, cfg0, params, batch,
                          (args_a, plans), (args_e, plans_all), totals)
    log(f"[14] {stamp()}")
    check_artifacts(launcher, common, results)

    # ---- 6. K5/K6 and 7. K7 against their plain versions on the card ------
    errors = check_gather_kernels(dev)
    errors["lutnn_layer"] = check_lutnn_layer(dev)

    # ---- 8. the LUT-NN toolflows (paper width), quickstart ---------------
    log(f"[8] {stamp()}")
    flow = run_toolflow(dev)

    # ---- 9. rwkv6-3b (path B): model, plans, K3 non-gated and K8 ----------
    rcommon = ["--arch", "rwkv6-3b", "--full", "--batch", str(B),
               "--prompt-len", str(T), "--new-tokens", str(NEW),
               "--device", "cuda"]
    r_args_x = parse(rcommon)
    r_args_h = parse(rcommon + ["--lut-act", "--calib-steps", "2"])
    r_args_i = parse(rcommon + ["--lut-act", "--calib-steps", "2",
                                "--lut-sites", "all"])
    r_args_j = parse(rcommon + ["--lut-act", "--calib-steps", "2",
                                "--lut-sites", "all", "--lut-fuse"])
    t0 = time.perf_counter()
    rcfg0, rparams, rbatch, rrng = launcher.setup(r_args_x)
    torch.cuda.synchronize()
    log(f"[9] {stamp()} {rcfg0.name}: {rcfg0.n_layers} layers, d_model "
        f"{rcfg0.d_model}, {rcfg0.d_model // rcfg0.rwkv_head_dim} heads x "
        f"{rcfg0.rwkv_head_dim}, d_ff {rcfg0.d_ff}, vocab "
        f"{rcfg0.vocab_size}, {rcfg0.dtype}; "
        f"{sum(p.numel() for p in rparams.parameters()) / 1e9:.3f}G params "
        f"in {time.perf_counter() - t0:.1f}s")
    r_plans = launcher.build_plans(r_args_h, rcfg0, rparams, rrng,
                                   log=lambda m: log("    " + m))
    r_plans_all = launcher.build_plans(
        r_args_i, form_config(None, rcfg0, r_args_i), rparams, rrng,
        log=lambda m: log("    " + m))
    r_multi = r_plans_all.tables_for_model(backend="cuda", kernel="fused",
                                           device=dev)["multi"]
    k3_err, k3_ng_share = check_fused_nongated(
        dev, rparams, r_multi, r_plans.sites["ffn"].luts[0], gen)
    max_err["fused_matmul_lut"] = max(max_err["fused_matmul_lut"], k3_err)
    k4_err, k4_cases = check_multisite(dev, r_multi, gen)
    max_err["lut_act_multi"] = max(max_err["lut_act_multi"], k4_err)
    log(f"[9] K4 bit-exact on rwkv6-3b's super-slab "
        f"({r_multi['meta']['sites']}), {k4_cases} (site, layer, dtype, "
        f"launch) cases as in [4]; repeat launches, graph replays and the "
        f"refusal as in [4]")
    # layer 0's WKV inputs of a real full-width prefill
    seen = []
    orig_wkv = ssm_mod.wkv_chunked

    def record(*a, **kw):
        if not seen:
            seen.append(a)
        return orig_wkv(*a, **kw)

    ssm_mod.wkv_chunked = record
    try:
        launcher.prefill(rparams, rcfg0, rbatch, max_seq=T,
                         lut_tables=None)
    finally:
        ssm_mod.wkv_chunked = orig_wkv
    k8_cases = wkv_cases(torch, dev, gen, seen[0])
    max_err["wkv"] = check_wkv(dev, k8_cases)
    log(f"[9] {stamp()} K8 within rtol = atol = 1e-4 of its plain version "
        f"on {len(k8_cases)} cases; largest difference {max_err['wkv']:.3e}")

    # ---- 10. the serving path, rwkv6-3b (path B: forms x, h-j) -------------
    n_wkv = {"wkv": rcfg0.n_layers}   # one K8 launch per layer per prefill
    r_forms = [
        ("x", r_args_x, None, ["wkv"], None),
        ("h", r_args_h, r_plans, ["lut_act_stacked", "wkv"], "gather"),
        ("i", r_args_i, r_plans_all, ["lut_act_stacked", "wkv"], "gather"),
        ("j", r_args_j, r_plans_all,
         ["fused_matmul_lut", "lut_act_multi", "wkv"], "i"),
    ]
    for label, args, pl, uses, ref in r_forms:
        log(f"[10] {stamp()}")
        serve_form(launcher, dev, label, args, rcfg0, rparams, rbatch, pl,
                   uses, results, totals, ref=ref, want=n_wkv)
    drift = {
        "qwen e->f": logit_drift(launcher, dev, cfg0, params, batch,
                                 (args_e, plans_all), (args_f, plans_all)),
        "rwkv x->h": logit_drift(launcher, dev, rcfg0, rparams, rbatch,
                                 (r_args_x, None), (r_args_h, r_plans)),
        "rwkv i->j": logit_drift(launcher, dev, rcfg0, rparams, rbatch,
                                 (r_args_i, r_plans_all),
                                 (r_args_j, r_plans_all))}
    for k, v in drift.items():
        log(f"[10] prefill logits {k}: max |diff| {v['max_abs_diff']:.4g}, "
            f"mean {v['mean_abs_diff']:.4g}, logit std {v['logit_std']:.4g},"
            f" top-1 margins {[round(m, 4) for m in v['top1_margin']]}, "
            f"same argmax {v['same_argmax']}")
    r_logits, r_state = launcher.prefill(rparams, rcfg0, rbatch,
                                         max_seq=T, lut_tables=None)
    if r_logits.shape != (B, 1, rcfg0.vocab_size) or not torch.isfinite(
            r_logits.float()).all() or not all(
                torch.isfinite(v.float()).all() for v in r_state.values()):
        raise AssertionError(f"bad rwkv6-3b logits or state "
                             f"{tuple(r_logits.shape)}")

    # ---- 11. per-kernel times ---------------------------------------------
    log(f"[11] {stamp()}")
    L = cfg.n_layers
    st = stacks["packed"]
    slab_bytes = sum(int(st["arrays"][c][0].numel()) * 4
                     for c in st["arrays"])
    kernels = []
    for name, replaces, source in (
            ("lut_act_stacked", "src/repro/kernels/lut_act.py:174",
             "src/repro_torch/kernels/csrc/lut_act.cu"),
            ("lut_act", "src/repro/kernels/lut_act.py:82",
             "src/repro_torch/kernels/csrc/lut_act.cu")):
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": totals[name],
                 "max_abs_err": max_err[name]}
        for shape_name, rows in (("decode", B), ("prefill", B * T)):
            # the served input: the gate half of the [gate|up] product, a
            # (rows, 3072) view with row stride 6144 that K1 reads in place
            x = k1_layouts(torch, rows, torch.bfloat16, dev, gen)["gate view"]
            xc = x.contiguous()
            if name == "lut_act_stacked":
                kfn = lambda: ops.lut_act_stacked(x, st, L // 2)
                cfn = lambda: ops.lut_act_stacked(xc, st, L // 2)
                pfn = lambda: lut_act_stacked_plain(x, st, L // 2)
            else:
                # the served form: an unrolled layer's entry and the record
                # built with it; "per_call_record_ms" builds it per call
                lut = plans.sites["mlp"].luts[L // 2]
                pa = lut.plan_arrays(packed=True, device=dev)
                kw = dict(x_lo=lut.x_lo, x_hi=lut.x_hi, y_lo=lut.y_lo,
                          y_hi=lut.y_hi)
                rec = plans.sites["mlp"].entry(
                    form="layers", packed=True,
                    device=dev)["layers"][L // 2]["k1_record"]
                kfn = lambda: ops.lut_act(x, pa, **kw, record=rec)
                cfn = lambda: ops.lut_act(xc, pa, **kw, record=rec)
                rfn = lambda: ops.lut_act(x, pa, **kw)
                pfn = lambda: lut_act_plain(
                    x, pa.arrays, l=pa.l, w_lb=pa.w_lb, w_hb=pa.w_hb,
                    w_in=pa.w_in, w_out=pa.w_out, pack=pa.pack, **kw)
            n = x.numel()
            bms, by = bound(2 * n * 2 + slab_bytes + 20, 5 * n,
                            PEAK_F32_FLOPS)
            t = {"ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
                 "contiguous_ms": timed_ms(cfn),
                 "contiguous_graph_ms": graph_ms(cfn),
                 "plain_ms": timed_ms(pfn), "bound_ms": bms,
                 "bound_by": by, "input": "gate view, row stride 6144"}
            if name == "lut_act":
                t["per_call_record_ms"] = timed_ms(rfn)
            if shape_name == "decode":
                entry.update(t, library_ms=None, shape=[rows, 3072])
            else:
                entry["prefill"] = dict(t, shape=[rows, 3072])
        kernels.append(entry)

    entry = {"name": "fused_matmul_lut", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/fused_matmul_lut.cu",
             "replaces": "src/repro/kernels/fused_matmul_lut.py:62",
             "launches": totals["fused_matmul_lut"],
             "max_abs_err": max_err["fused_matmul_lut"],
             "mismatch_share_vs_plain": k3_mismatch,
             "mismatch_share_vs_plain_nongated": k3_ng_share}
    K = cfg.d_model
    for shape_name, m in (("decode", B), ("prefill", B * T)):
        x = torch.randn(m, K, generator=gen, device=dev).to(torch.bfloat16)
        t = k3_times(x, params.blocks["w_in"], ftab(L // 2), f_slice, L // 2,
                     gated=True)
        if shape_name == "decode":
            entry.update(t)
        else:
            entry["prefill"] = t
    # rwkv6-3b's ffn site: non-gated, K 2560 x N 8960
    rws = rparams.blocks["w_ffn_k"]
    RL, RK = rws.shape[:2]
    r_slice = multi_site_stacked_entry(r_multi, "ffn")
    rtab = {"multi_entry": r_multi, "site": "ffn", "layer": RL // 2}
    entry["ffn_nongated"] = {}
    for shape_name, m in (("decode", B), ("prefill", B * T)):
        x = torch.randn(m, RK, generator=gen, device=dev).to(torch.bfloat16)
        entry["ffn_nongated"][shape_name] = k3_times(
            x, rws, rtab, r_slice, RL // 2, gated=False, n=20)
    kernels.append(entry)

    # K4 at the shapes form (f) hands it, per site, in a prefill and a
    # decode step, and the decode shapes in one multi-segment launch
    f_cfg = form_config(plans_all, cfg0, args_f)
    f_tabs = launcher.serving_tables(args_f, plans_all, dev, log=quiet)
    served = served_k4_shapes(launcher, params, f_cfg, batch, f_tabs)
    log(f"[11] K4's inputs in form (f) (site: shapes): {served}")
    counts = {math.prod(sh) for step in served.values()
              for shapes in step.values() for sh in shapes}
    if not counts <= set(SERVED_K4):
        raise AssertionError(f"form (f) hands K4 counts {sorted(counts)}; "
                             f"phases 4 and 9 check only {SERVED_K4}")
    meta_bytes = 4 * (3 + 2)   # a layer's meta_i and [y_lo, span] rows

    def multi_work(xs):
        nbytes = sum(2 * x.numel() * x.element_size() for x in xs.values())
        for s in xs:
            sl = multi_site_stacked_entry(a_multi, s)
            nbytes += meta_bytes + sum(
                int(sl["arrays"][c][0].numel()) * 4 for c in sl["arrays"]
                if c != "t_lb" or sl["meta"]["any_lb"])
        return nbytes, 20 * sum(x.numel() for x in xs.values())

    entry = {"name": "lut_act_multi", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/lut_act_multi.cu",
             "replaces": "src/repro/kernels/lut_act.py:279",
             "launches": totals["lut_act_multi"],
             "max_abs_err": max_err["lut_act_multi"], "library_ms": None,
             "shapes": {}}
    # the largest site first (attn_exp): its decode time heads the entry
    dshapes = dict(sorted(((s, max(sh, key=math.prod))
                           for s, sh in served["decode"].items()),
                          key=lambda kv: -math.prod(kv[1])))
    groups = {s: {s: sh} for s, sh in dshapes.items()}
    groups["multi-segment"] = dshapes
    groups.update({f"{s} prefill": {s: max(sh, key=math.prod)}
                   for s, sh in served["prefill"].items()})
    for label, group in groups.items():
        xs = {s: site_edge_inputs(torch, a_multi, s, math.prod(sh),
                                  torch.float32, dev, gen).view(sh)
              for s, sh in group.items()}
        kfn = lambda: ops.lut_act_multi(xs, a_multi, L // 2)
        yk, yp = kfn(), lut_act_multi_plain(xs, a_multi, L // 2)
        if not all(bits_equal(torch, yk[s], yp[s]) for s in xs):
            raise AssertionError(f"K4 {label}: differs from its plain "
                                 f"version at the timed inputs")
        nbytes, ops_ = multi_work(xs)
        bms, by = bound(nbytes, ops_, PEAK_F32_FLOPS)
        t = {"shape": {s: list(sh) for s, sh in group.items()},
             "ms": timed_ms(kfn), "graph_ms": graph_ms(kfn),
             "plain_ms": timed_ms(
                 lambda: lut_act_multi_plain(xs, a_multi, L // 2)),
             "bound_ms": bms, "bound_by": by, "library_ms": None}
        if not entry["shapes"]:
            entry.update({k: v for k, v in t.items() if k != "shape"},
                         shape=t["shape"])
        if label == "attn_exp prefill":
            entry["prefill"] = t
        entry["shapes"][label] = t
    kernels.append(entry)

    # K8 at rwkv6-3b's prefill shape, layer 0's real inputs
    (q, k, v, lw, u), chunk, _ = k8_cases["layer-0 prefill"]
    f32 = [a.float().contiguous() for a in (q, k, v, lw, u)]
    kfn = lambda: ops.wkv(*f32, chunk=chunk)
    bsz, tt, hh, nn = q.shape
    n_chunks = -(-tt // chunk)
    cc = min(chunk, tt)
    wkv_bytes = 4 * (5 * bsz * tt * hh * nn + hh * nn + bsz * hh * nn * nn)
    f32_ops, tc_ops = k8_work(cc, nn)
    per = bsz * hh * n_chunks
    bms, by = bound(wkv_bytes, per * f32_ops, PEAK_F32_FLOPS,
                    more=[(per * tc_ops, PEAK_TF32_FLOPS)])
    entry = {"name": "wkv", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/wkv.cu",
             "replaces": "src/repro/kernels/wkv.py:68",
             "launches": totals["wkv"], "max_abs_err": max_err["wkv"],
             "shape": [bsz, tt, hh, nn, chunk], "ms": timed_ms(kfn, n=20),
             "graph_ms": graph_ms(kfn, n=20),
             "plain_ms": timed_ms(lambda: wkv_chunked_plain(
                 *f32, chunk=chunk), n=5),
             "bound_ms": bms, "bound_by": by, "library_ms": None}
    kernels.append(entry)
    for k in kernels:
        line = (f"[11] {k['name']}: {k['ms'] * 1e3:.2f} us/launch (graph "
                f"{k['graph_ms'] * 1e3:.2f} us) at {k['shape']}, bound "
                f"{k['bound_ms'] * 1e3:.3f} us ({k['bound_by']}), plain "
                f"{k['plain_ms'] * 1e3:.2f} us; launches {k['launches']}")
        if "prefill" in k:
            line += (f"; prefill {k['prefill']['ms'] * 1e3:.2f} us (graph "
                     f"{k['prefill']['graph_ms'] * 1e3:.2f}), bound "
                     f"{k['prefill']['bound_ms'] * 1e3:.3f} us, plain "
                     f"{k['prefill']['plain_ms'] * 1e3:.2f} us")
        if "contiguous_ms" in k:
            line += (f"; input {k['input']}; on a contiguous copy "
                     f"{k['contiguous_ms'] * 1e3:.2f} us (graph "
                     f"{k['contiguous_graph_ms'] * 1e3:.2f}), prefill "
                     f"{k['prefill']['contiguous_ms'] * 1e3:.2f} us (graph "
                     f"{k['prefill']['contiguous_graph_ms'] * 1e3:.2f})")
        if "per_call_record_ms" in k:
            line += (f"; record built per call "
                     f"{k['per_call_record_ms'] * 1e3:.2f} us, prefill "
                     f"{k['prefill']['per_call_record_ms'] * 1e3:.2f} us")
        if k.get("library_ms") is not None:
            line += (f"; library {k['library_ms'] * 1e3:.2f} us (graph "
                     f"{k['library_graph_ms'] * 1e3:.2f}), prefill "
                     f"{k['prefill']['library_ms'] * 1e3:.2f} us (graph "
                     f"{k['prefill']['library_graph_ms'] * 1e3:.2f}); "
                     f"cuBLAS alone {k['matmul_only_ms'] * 1e3:.2f} us "
                     f"(graph {k['matmul_only_graph_ms'] * 1e3:.2f})")
        log(line)
        for label, t in k.get("shapes", {}).items():
            log(f"    {label} {t['shape']}: {t['ms'] * 1e3:.2f} us (graph "
                f"{t['graph_ms'] * 1e3:.2f}), bound {t['bound_ms'] * 1e3:.3f}"
                f" us ({t['bound_by']}), plain {t['plain_ms'] * 1e3:.2f} us")
        for label, t in k.get("ffn_nongated", {}).items():
            log(f"    ffn non-gated {label} {t['shape']}: {t['ms'] * 1e3:.2f}"
                f" us (graph {t['graph_ms'] * 1e3:.2f}), bound "
                f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}), plain "
                f"{t['plain_ms'] * 1e3:.2f} us, library (cuBLAS + K1) "
                f"{t['library_ms'] * 1e3:.2f} us (graph "
                f"{t['library_graph_ms'] * 1e3:.2f})")
    # K5-K7's times come after phase 21, which hands them more shapes

    # ---- 12. where a decode step's time goes -------------------------------
    log(f"[12] {stamp()}")
    r_tables_j = launcher.serving_tables(r_args_j, r_plans_all, dev,
                                         log=quiet)
    steps = {}
    for label, scfg, sparams, sbatch, stab in (
            ("exact", cfg0, params, batch, None),
            ("a", cfg, params, batch, st_cuda),
            ("d", dataclasses.replace(cfg, lut_fuse=True), params, batch,
             f_tables),
            ("f", f_cfg, params, batch, f_tabs),
            ("rwkv exact", rcfg0, rparams, rbatch, None),
            ("rwkv j", form_config(r_plans_all, rcfg0, r_args_j), rparams,
             rbatch, r_tables_j)):
        steps[label] = profile_decode_step(launcher, label, scfg, sparams,
                                           sbatch, stab)

    # K1 reads the gate half in place: form (a) launches what the exact
    # activation does (one kernel for the activation, one for the product)
    if (steps["a"]["kernels"], steps["a"]["copy_kernels"]) != (
            steps["exact"]["kernels"], steps["exact"]["copy_kernels"]):
        raise AssertionError(
            f"decode step (a) launched {steps['a']['kernels']} kernels "
            f"({steps['a']['copy_kernels']} copies), the exact step "
            f"{steps['exact']['kernels']} ({steps['exact']['copy_kernels']})")
    log(f"[12] form (a) launches as many kernels per step as the exact "
        f"model, copies included: K1 takes the gate view without a copy")
    if not steps["f"]["launches"].get("lut_act_multi"):
        raise AssertionError(f"form (f)'s decode step launched no K4: "
                             f"{steps['f']['launches']}")

    # ---- 24 (a). the dry run against the card: qwen3-0.6b's decode step
    # (run here, while phase 5's model and form (a)'s tables live); the
    # counted steps' K1 launches join its entry
    log(f"[24] {stamp()}")
    p24 = {"a": run_phase24_decode(dev, cfg0, plans, params, steps)}
    for k in kernels:
        k["launches"] += p24["a"]["a"]["launches"].get(f"cuda:{k['name']}",
                                                       0)

    # ---- 15. the moe family, after the others (their models freed first)
    log(f"[15] {stamp()}")
    del (params, rparams, sparams, s_params, cases, w_in, rws, st, stacks)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[15] after freeing the earlier models: "
        f"{torch.cuda.memory_allocated(dev)} bytes allocated; the largest "
        f"live storages (bytes, a tensor's shape): {largest_storages()}")
    moe_totals = {k: 0 for k in launch_counts()}
    moe = {}
    for arch in MOE_FORMS:
        moe[arch] = run_moe_model(launcher, dev, arch, moe_totals, results,
                                  stamp)
        gc.collect()
        torch.cuda.empty_cache()
    # the kernels' launches on the main path include phase 15's forms; the
    # moe shapes join their entries
    for k in kernels:
        k["launches"] += moe_totals.get(k["name"], 0)
        shapes = {f"{t['name']} {t['site']} {t['step']}": compact(t)
                  for r in moe.values() for t in r["lut_calls"]
                  if t["kernel"] == k["name"]}
        if shapes:
            k["moe"] = shapes
        if k["name"] == "fused_matmul_lut":
            k["shared_expert"] = {
                n: v for n, v in moe["deepseek-moe-16b"]["shared_k3"].items()
                if n != "mismatch_share_vs_plain"}
    log(f"[15] phase 15's launches: {moe_totals}")

    # ---- 16. the vlm and hybrid families, after the moe models are freed
    log(f"[16] {stamp()}")
    fam_totals = {k: 0 for k in launch_counts()}
    fam = {}
    for arch in FAMILY_FORMS:
        fam[arch] = run_family_model(launcher, dev, arch, fam_totals,
                                     results, stamp)
        gc.collect()
        torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] += fam_totals.get(k["name"], 0)
        for key, arch in (("vlm", "phi-3-vision-4.2b"),
                          ("hybrid", "recurrentgemma-9b")):
            shapes = {f"{t['name']} {t['site']} {t['step']}": compact(t)
                      for t in fam[arch]["lut_calls"]
                      if t["kernel"] == k["name"]}
            if shapes:
                k[key] = shapes
            if k["name"] == "fused_matmul_lut":
                k[f"{key}_mlp"] = {n: compact(fam[arch]["k3"][n])
                                   for n in ("decode", "prefill")}
    log(f"[16] phase 16's launches: {fam_totals}")

    # ---- 17. the encdec family and the other dense configurations, after
    # the vlm and hybrid models are freed
    log(f"[17] {stamp()}")
    p17_totals = {k: 0 for k in launch_counts()}
    p17 = {}
    for arch in P17_FORMS:
        p17[arch] = run_phase17_model(launcher, dev, arch, p17_totals,
                                      results, stamp)
        gc.collect()
        torch.cuda.empty_cache()
    for k in kernels:
        k["launches"] += p17_totals.get(k["name"], 0)
        for arch, key in P17_TAGS.items():
            shapes = {f"{t['name']} {t['site']} {t['step']}": compact(t)
                      for t in p17[arch]["lut_calls"]
                      if t["kernel"] == k["name"]}
            if shapes:
                k[key] = shapes
            if k["name"] == "fused_matmul_lut":
                k[f"{key}_mlp"] = {n: compact(p17[arch]["k3"][n])
                                   for n in ("decode", "prefill")}
    log(f"[17] phase 17's launches: {p17_totals}")

    # ---- 18. training through launch/train, after phase 17's models are
    # freed; K8's launches there join its entry, K8b joins the kernels
    log(f"[18] {stamp()}")
    p18 = run_phase18(dev, stamp, gen)
    for k in kernels:
        if k["name"] == "wkv":
            k["launches"] += p18["k8_launches"]
    kernels.append(p18["k8b"])

    # ---- 19. the autotuner and the control plane, from phase 18's
    # checkpoint; K1's and K4's launches there join their entries
    log(f"[19] {stamp()}")
    p19 = run_phase19(dev, stamp, p18["ckpt_dir"])
    for k in kernels:
        k["launches"] += p19["launches"].get(k["name"], 0)

    # ---- 20. telemetry on the served path (the launcher with --obs-log,
    # the batcher under the drift monitor, the control plane's timeline);
    # K1's, K3's and K4's launches there join their entries
    log(f"[20] {stamp()}")
    p20 = run_phase20(dev, stamp, p19["tuned_path"])
    for k in kernels:
        k["launches"] += p20["launches"].get(k["name"], 0)

    # ---- 21. the paper's sweeps at the paper's scale (repro_torch.bench);
    # then K5-K7's times at the toolflow's and the sweeps' shapes, their
    # launches phase 8's and phase 21's
    log(f"[21] {stamp()}")
    p21 = run_phase21(dev, stamp)

    # ---- 22. sharded serving on a mesh of ranks sharing cuda:0 (the
    # parent built the kernels in phase 2, before any rank starts); the
    # ranks' K1 / K2 launches join their entries
    log(f"[22] {stamp()}")
    p22 = run_phase22(dev, stamp)
    for k in kernels:
        k["launches"] += p22["launches"].get(k["name"], 0)

    # ---- 23. sharded training on meshes of ranks sharing cuda:0; the
    # ranks' K8 / K8b launches (rwkv6-3b's, part (e)) join their entries
    log(f"[23] {stamp()}")
    p23 = run_phase23(dev, stamp)
    for k in kernels:
        k["launches"] += p23["launches"].get(k["name"], 0)

    # ---- 24 (b)-(d). the dry run against the card: training steps; the
    # counted steps' K8 / K8b launches join their entries
    t24 = time.perf_counter()
    log(f"[24] {stamp()}")
    p24.update(run_phase24_train(dev, stamp, p18))
    for part in ("b", "c"):
        for k in kernels:
            k["launches"] += p24[part]["launches"].get(f"cuda:{k['name']}",
                                                       0)
    log(f"[24] {stamp()} (b)-(d) in {time.perf_counter() - t24:.0f}s")
    log(f"[11] {stamp()} K5-K7")
    kernels += time_toolflow_kernels(dev, flow, errors, p21)

    summary = {"card": smi, "seconds": time.perf_counter() - t_start,
               "exact": exact, "steps": steps, "logit_drift": drift,
               "batcher": batcher, "moe": moe, "families": fam,
               "phase17": p17, "phase18": p18["runs"], "phase19": p19,
               "phase20": p20, "phase22": p22["out"],
               "phase23": p23["out"], "phase24": p24,
               "phase21": dict(p21, k7_calls={
                   m: [[*k, c] for k, (_, c) in sorted(v.items())]
                   for m, v in p21["k7_calls"].items()}),
               "forms": {
                   f: {k: v for k, v in r.items() if k != "plans"}
                   for f, r in results.items()}, "kernels": kernels,
               "toolflow": dict(flow, flows={
                   m: dict({k: v for k, v in f.items()
                            if k not in ("plan_list", "k7_calls")},
                           k7_calls=[[*k, c] for k, (_, c) in sorted(
                               f["k7_calls"].items())])
                   for m, f in flow["flows"].items()})}
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(summary, indent=1))
    log(f"done in {time.perf_counter() - t_start:.0f}s")
    # four significant digits, no spaces and compact() entries for the
    # served and timed shapes keep this line short (about 18 KB; the tool
    # that runs the script returns the last 24 KB of its output);
    # chip_smoke.json keeps every digit and field
    line_kernels = [dict(k, shapes={n: compact(t)
                                    for n, t in k["shapes"].items()})
                    if "shapes" in k else k for k in kernels]
    line = json.dumps({"kernels": sig4(line_kernels)}, separators=(",", ":"))
    log(f"the kernel JSON line below: {len(line)} bytes")
    print(line, flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
