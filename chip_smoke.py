#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py            # needs one CUDA card and nvcc

Phases, one line per result:

1. device: ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build: nvcc builds every ``src/repro_torch/csrc/*.cu`` (one nvcc per
   source, started together) into one library in ``build/`` (seconds,
   ptxas registers / shared memory / spills per kernel).
3. sparse kernels vs plain versions on the card: the probe, then both
   sparse block steps (one cooperative launch per row tile: launch A's
   rows, a grid barrier, launch B's columns) against their plain PyTorch
   versions on the same inputs for six (loss, reg) pairs x row_batches
   {1, 3}, bound 1e-5 (rtol and atol; atomics reorder the scatter's sum),
   on seven grids: power-law columns, the same with column 0 in every row
   (a hot column), three wide ones (db 62,500: past the shared budget, the
   hot route): power-law columns, the same columns under a random
   permutation (the hot columns scattered over the block), and more
   distinct columns in a block than the hot route has slots (its cold
   global atomics run); and two for the block-ELL kernel's edges: uniform
   columns (most slots padding), and rows of 0, 1, 16, 17 and K = 32 live
   slots beside empty active tiles.  After every step the pooled
   accumulator must be zero again.  The bucketed route is picked by db and
   the card's shared-memory limit; each route's launch count must equal
   the cases routed to it, and no step may launch launch B alone.  A
   folded step with more processors than the card holds CTAs must be
   refused by the cooperative launch and raise.
3s. the paper-exact serial solver: ``solve_serial`` on the card for the
   six (loss, reg) pairs x use_adagrad on ``make_classification(m=2000,
   d=500, density=0.05)`` (~50 K nonzeros), 3 epochs, each epoch one
   launch of the serial epoch kernel (``csrc/dso_serial.cu``; it replaces
   no pallas_call) and nothing else; w, alpha and the history against
   the plain version on a CPU copy with the same visit orders, bound
   1e-5; then the kernel's ms per epoch (CUDA events) and its device ms
   per epoch (profiler) beside the plain version's on the card, its bound
   (bytes) and the depth of the epoch's dependency graph.
3d. dense kernel vs plain versions on the card: the dense launch A + B
   through ``ops.dso_block_step`` for row_batches {1, 2, 3} x the six
   pairs on a narrow grid (db 289, rows and columns padded, a trailing row
   group at every row_batches; the block permutation puts the four
   processors' blocks at all four 16-byte misalignments b*289 mod 4), on
   grids of db 1, 3 and 5, and for row_batches {1, 3} on wider ones
   (db 1,000: several sweeps; db 12,375: past the shared column
   partial), and
   through ``ops.dso_tile_step`` at M 999, D 1,155 (contiguous: a row
   stride that is not a multiple of 4, the 4-byte path; and a row-strided
   view at misalignment 1); bound 1e-5; after every block step the pooled
   accumulator must be zero again (launch B's contract).
4. main path, block-ELL: ``solve(grid, backend="auto")`` on the
   svm-real-sim configuration (hinge, l2, lam 1e-4, eta0 0.5, p 4; phases
   4-5d take these settings from ``repro_torch.configs.dso_problems``) at
   LIBSVM real-sim's size (m 72,309, d 20,958, ~51 nnz per row), 10
   epochs with the device CSR primal every 2; the launch counts must equal
   the design's (one folded launch per row tile, launch B alone never),
   the primal must be finite and fall at every evaluation,
   and the plain twin run on the card must agree at every evaluation to
   1e-5 relative.  Then s/epoch of ``run_epochs`` alone (median, min, max
   over 5 repeats) for the kernel backend and its plain twin, and a
   profiled 2-epoch ``run_epochs`` for the device's busy and idle time.
4i. the block-ELL main path from a libsvm file: phase 4's CSR and labels
   written float32-exactly (``%.9g``) to a temporary file, read back by
   ``ingest_libsvm(n_features=d, p=4, normalize_labels=True)`` bit for
   bit; the tile-K skew of pass 1's ``ScanStats.k_per_tile`` under 4
   picks block-ELL; ``sparse_grid_from_csr`` must equal phase 4's grid;
   ``run_dso_grid_from_data(impl="auto")`` with the device CSR primal
   every 2 epochs, 10 epochs: phase 4's launch design, the primal falling
   at every evaluation, w within 1e-5 of phase 4's, and
   ``csr_primal_objective`` on the card equal to the hook's last primal
   (1e-6: atomics); the file's bytes and the passes' host times.  4i
   also reads the file once more with ``obs=RunRecorder()``: the
   ``ingest.rows`` / ``ingest.nnz`` counters must equal ``ScanStats``
   and both pass spans (``ingest_pass1``, ``ingest_pass2``) be there.
5. main path, K-bucketed: the logistic-real-sim configuration (logistic,
   l2, lam 1e-4, alpha0 5e-4) on power-law columns (alpha 1.3); same
   checks, and every bucketed launch A must take the shared route.
5n. main path, K-bucketed at news20's size: the logistic-news20
   configuration (dso_problems.py:29; the same loss and steps) on m
   19,996 rows and d 1,355,191 columns, 455 power-law draws per row; its
   db 338,798 is past the shared budget, so every bucketed launch A must
   take the hot route (its table's bytes and the share of live columns,
   those the folded primal phase steps, printed); same checks.
5i. phase 4i on phase 5n's news20-shaped CSR: the skew from
   ``ScanStats.k_per_tile`` alone must be at least 4, the grid comes from
   ``bucketed_grid_from_csr`` and must equal phase 5n's, every bucketed
   launch A takes the hot route, and w is held against phase 5n's run.
5d. main path, dense: ``solve(problem, backend="auto")`` on the svm-ocr
   configuration (hinge, l2, lam 1e-4, eta0 0.5, p 4) at ocr's width
   (d 1,156) with m 1,000,000 rows drawn on the card; ``auto`` must pick
   ``dense_pallas_block``; then the same run on ``dense_pallas_fused``
   (the per-tile path, ``ops.dso_tile_step``), each in its own launch
   count window; same checks against ``dense_jnp``, plus the peak device
   memory.
8r. the elastic runtime (``repro_torch.runtime``) on phase 4's
   (svm-real-sim, block-ELL), phase 5n's (logistic-news20, hot route) and
   phase 5d's (svm-ocr, dense) grids: 10 epochs with
   ``checkpoint_every=2`` into ``SnapshotStore(async_writes=True)`` (every
   file passes ``verify_pytree``); a run stopped at epoch 6 and continued
   by ``runtime.resume``, w and alpha within 1e-5 of the uninterrupted
   run's, printed beside two uninterrupted runs' max|d| (the atomics'
   own noise); the snapshot's bytes and the host seconds of ``save()``
   with and without ``async_writes``.
8h. health on svm-real-sim, 20 epochs: a ``NaNInjector`` poisons w at
   epoch 4, the ``HealthGuard`` rolls back to the snapshot at 4 with eta
   backed off by 0.9 (and, measured only, 0.7), and the final primal
   lands within 1e-3 relative of the clean run's (the ledger printed); ``max_retries=0`` with
   ``on_exhausted="serial"`` on phase 3s's problem degrades to
   ``solve_serial`` and its kernel.
8s. reshard on svm-real-sim: p 4 -> 4 leaves the grid and the state as
   they are; p 4 -> 2 from phase 8r's last snapshot (``reshard``: the
   grid re-tiled on the host, its seconds printed), then 4 epochs on the
   card with the primal falling.
8o. obs and telemetry on logistic-real-sim (shared route): a
   ``RunRecorder``'s spans (epoch_chunk, eval per chunk) and its nnz/s
   and eval.primal gauges; a ``TelemetrySpec``'s rows and nnz equal to
   the tile statistics, nonfinite 0, the update norms within 1e-5 of the
   plain twin's on a CPU copy; obs and telemetry on against off, w
   within 1e-5; ``solve``'s s/epoch with each on and off.
8w. the legacy switch on logistic-real-sim:
   ``sparse_bucketed_pallas_switch`` (the block-ELL kernel on each active
   tile's bucket rectangle, p launches per inner iteration) against
   ``sparse_bucketed_pallas`` and ``sparse_bucketed_jnp_switch`` on the
   card, w within 1e-5; launches per epoch and s/epoch of each.
8c. ``solve(init=)`` on phases 4's, 5's and 5n's grids (block-ELL, the
   shared and the hot routes) from a state whose w lies at twice its
   box's upper edge, 3 epochs, against the plain twin on the card, w
   within 1e-5, alpha within max(1e-5, 3x the float32 plain twin's
   distance) of a float64 plain twin's (the kernels' alpha from w at the
   box's edge printed beside it): the first epoch's block steps take launch A alone
   and launch B on every column (``TileBackend.clamp_step``; one each a
   row tile and inner iteration), the later ones the folded step; the
   folded step from the start, the route before the entering state was
   checked, is printed beside it.  Then (in 9r's pool, whose workers it
   needs) the ring on the same three grids: ``ShardedDSO.restore`` of the
   same state, 3 epochs, every worker's first epoch through
   ``clamp_step`` (its launches per worker as above), w within 1e-5 of
   ``solve(init=)``'s, alpha too on block-ELL and within the limit above
   of the float64 plain twin on the bucketed routes.
   Phases 8r-8c run right after 5d, each run in its own launch-count
   window, which must hold the design's launches.
3b. the baselines' epoch kernels (``csrc/baselines.cu``; they replace no
   pallas_call; one thread-block cluster per worker, the plan of
   ``ops.sgd_epoch_route`` / ``dcd_epoch_route`` printed with each shape
   and its shared memory held against the C entry's count):
   ``ops.sgd_epoch`` at batch 1 and 8 for the six pairs, at p 4 (PSGD) on
   a ragged m, and ``ops.dcd_epoch`` (hinge, and with ids that come
   back), one epoch from a seeded state against the plain versions on
   the same orders, bit for bit (max|d| 0.0, inside the 1e-5 gate), at
   the reference tests' shape (m 400, d 150) and at real-sim's width
   (phase 4's first 4,096 rows, d 20,958, densified on the card); SGD
   past the staged limit (m 256 x d 600,000 drawn on the card: the
   global-w body); SGD, PSGD and DCD at real-sim's full size (phase 4's
   CSR as a dense X of 6.06 GB built on the card); two kernel runs
   bitwise equal, each one launch.  Then ms per epoch (CUDA events),
   device ms (profiler, and CUDA events queued behind a spin) and the
   plain version's ms at the 4,096-row shape beside the bound; at full
   size the A/B against the one-block kernels in turns (new, old,
   old, new), each cluster size of ``BASE_AB_CLUSTERS`` (4, 8, 16) and
   the exchange-only floor per step, beside the bytes bound.
10. the paper's Sec.-5 comparison at that full size, lam 1e-4, hinge and
   logistic: DSO (``run_dso_grid(impl="auto")``, p 4: row 1's kernel),
   SGD, PSGD (p 4), BMRM and DCD (hinge), cut to ``SEC5_EPOCHS``, each in
   its own launch-count window (one ``sgd_epoch`` / ``dcd_epoch`` per
   epoch and nothing else); every method's primal finite and falling from
   its first evaluation to its last; per method the final primal, s per
   epoch (or BMRM iteration) and the gap to DCD's hinge primal; BMRM's
   kernel launches per iteration (profiler).  X is freed before 9r.
9r. the sharded ring (``core.dso_dist.ShardedDSO``) with 4 worker
   processes sharing the card (gloo, blocks staged through pinned host
   memory; the library built in phase 2, the workers only load it) on
   phase 4's, 5n's and 5d's data at full width, 10 epochs: cyclic and
   lpt against the grid ``solve`` (w and alpha within 1e-5), the
   overlapped ring against the serial one and p2p against all-gather
   (within 1e-5, beside two ring runs' atomics noise), the main ring run
   in its own launch-count window on every worker (40 block steps each);
   s/epoch beside the grid's, the transport's share of the epoch, bytes
   moved per epoch.  Then a ``Supervisor`` run with a crash at epoch 3
   (checkpoint every 2) within 1e-5 of the uninterrupted ring, and a
   live reshard 4 -> 2 on svm-ocr continuing with the duality gap
   falling.  The NCCL route runs only with a card per worker (else the
   phase says so).  The ring's launches count in rows 1, 2g and 4.
3t. the two-pass tile step (``ops.dso_tile_step(twopass=True)``) against
   its plain version and against the fused ``ops.dso_tile_step`` on the
   same inputs, six pairs at M 999, D 1,155, contiguous (row kernels) and
   row-strided (span kernels): one processor's block at each of the four
   16-byte misalignments, and blocks of db 1, 3 and 5, and an empty block
   (db 0, row kernels); each case must take the kernels its row stride and
   width call for; bound 1e-5.
3l. ``ops.swa_attention`` and ``ops.ssd_scan`` against their plain
   versions in float32 and bf16: the shapes of the reference's kernel
   tests, decode offsets (Tq 8, Tk 4,096), ``causal=False`` (ragged Tq
   and Tk too), Tq and Tk ragged to the 128-query and 64-key tiles,
   windows 1, 63, 65, 127 and past T, GQA Hq/Hkv = 4, rows with no key in
   their window, Dh 36, 40, 64, 112 and 128; in float32 also the split-
   TF32 kernel's edges (a ragged 16-row warp slice, Dh 8, 30 and 128,
   window 1, a decode row at q_offset 4,088, GQA 4); in both dtypes q, k,
   v not 16-byte aligned; in bf16 also Dh 1, 30, 33 and 127 and a
   misaligned Dh 36 (the packed route); SSD with n 128, dh 112-256,
   n = dh = 128, 32 and 64 chunks, b 2 with a ragged t, chunk 100, total
   decay; a phase-9t rank's heads: attention 8 heads of Dh 112, SSD 28
   heads (zamba2-7b's 112 over 4: the chunk gradients' groups of 8 and a
   tail of 4) and 8 heads at n 128 (mamba2-370m's 32 over 4), B and C
   in the inputs' type; a phase-9e rank's: 8 query and 2 KV heads of Dh
   128 at T 4,096, causal;
   float32 runs the split-TF32 tensor-core kernel, bf16 with Dh a
   multiple of 8 (aligned) the bf16 tensor-core one in place, other bf16
   the same kernel on a packed copy, and each route's launch
   count must equal the cases routed to it; shapes past the kernels'
   limits must raise.  Bounds: float32 as the
   reference's tests (swa rtol = atol = 2e-5; ssd rtol 2e-4, atol 2e-5);
   bf16 one bf16 ulp (2^-7 relative) more, since kernel and plain version
   each round float32 sums that differ in order to bf16.  Then the
   backward at the same attention and SSD cases, both dtypes: each
   route's forward that saves the rows' logsumexp (SSD: its chunk states
   and decays) against the plain version's (1e-5 relative; -1e30 on rows
   with no key), and its backward kernels against the plain backward on
   the same saved tensors (``BWD_TOL``: one bf16 ulp of the largest
   element for a bf16 gradient, 2e-5 x max(1, max|g|) for a float32
   one); each backward route's count (``swa_attention_bwd``,
   ``swa_attention_bwd_packed``, ``swa_attention_bwd_f32``,
   ``ssd_scan_bwd``, and ``ssd_scan_bwd_fma`` for the SSD chunk gradients
   on the CUDA-core kernel: chunk 256, n 256, and float32 B and C at n
   128, ``SSD_BWD_FMA_CASES``) must equal the cases routed to it.
6. times at the phase-4/5/5n/5d shapes with CUDA events: each kernel's ms
   per call beside its bound (bytes over 3.35 TB/s, operations over 67
   TFLOP/s float32; the sparse steps' bytes are the live slots' and the
   live columns'), its plain version's ms and the library calls computing
   the same two products (``torch.mv``, never called by the port): cuBLAS
   for the dense kernel, cuSPARSE on CSR copies of the active tiles and
   their transposes for the sparse ones; the probe's device time.  Each
   sparse folded step in turns with the step as it was before the fold
   (folded, baseline, baseline, folded; block-ELL: the one-warp-per-row
   launch A, the bucketed cells: the global route's, each then launch B
   alone); the block-ELL launch A alone in turns with the one-warp-per-row
   kernel (live, warp, warp, live), beside its live-slot and padded-slot
   bounds; launch B's share of each folded step (its device time less
   launch A's alone) beside its bound; launch B alone against its plain
   version with a random acc on every column and w outside the box.  Then
   the bucketed launch A alone: at the
   logistic-real-sim shape the shared and global routes in turn (global,
   shared, shared, global) on its power-law grid and on a K-bucketed grid
   of the uniform svm-real-sim CSR; at news20's shape the hot and global
   routes in turn (global, hot, hot, global), and the hot route with its
   slots per CTA the SM's shared memory split 1 to 8 ways, the
   measurement behind ``dso_sparse.HOT_SMEM_SHARE``.
7. the LM kernels at zamba2-7b's widths (bf16, 32 heads of 112, SSD 112
   heads of 64 with state 64, chunk 128), each case driven once through
   ``ops`` with the counts set to 0 just before and read just after:
   attention at T 16,384 with a window past T (full causal; beside
   ``F.scaled_dot_product_attention(is_causal=True)``, never called by
   the port, whose device kernel's name is printed) and at T 73,728 with
   the 8,192 sliding window (beside SDPA's efficient-attention backend
   given the window as a T x T boolean mask), both bf16 and
   counted on the tensor-core kernel, at T 16,384 in float32 on the
   split-TF32 kernel (beside SDPA in float32; bound at 3 TF32 products
   per float32 product, the float32 FMA bound beside it; also at T 73,728
   with the 8,192 window), and at T 16,384
   in bf16 on a misaligned copy, counted on the packed route (beside SDPA
   on an aligned copy); device
   times per launch from a trace of 3 calls, over the launches it holds;
   the SSD scan
   at t 16,384, and at mamba2-370m's 32 heads with state 128 (timed in
   the order kernel, plain, plain, kernel, 5 calls each; the device time
   of each of its three launches, and the chunked form's operations
   beside the exact recurrence's bound).  Then the backward kernels, each
   driven once with the counts around it and held against the plain
   backward (``BWD_TOL``): attention at phase 7t's shapes (B 2 x T 4,096
   bf16, in place and on a misaligned copy (the packed route); B 1 in
   float32) and at T 16,384 with a 4,096 window, SSD at zamba2-7b's group
   (b 2 x t 4,096) and mamba2-370m's (b 4 x t 2,048, state 128); each
   timed by CUDA events behind a spin beside its bound (float32
   attention: split TF32's, 3 TF32 products per float32 product, with the
   float32 FMA rate's beside it), the plain backward, the old recompute
   (autograd through the plain forward; "not measured" where its graph
   does not fit) and, for attention, the backward of
   ``F.scaled_dot_product_attention(is_causal=True)``.  Then
   the two-pass tile step at svm-ocr's tile (processor 0's active block of
   phase 5d, 250,000 x 289, the span route) beside the fused step and the
   cuBLAS mat-vec pair.  Each: ms per call (CUDA events), bound, plain ms,
   max|d| against the plain version.
7m. the LM models through the kernels (``repro_torch.models``,
   ``repro_torch.serving``), after phase 7, random weights from seeded
   generators on the card, each run in its own launch-count window:
   zamba2-7b at its full published config in bf16 (81 Mamba2 layers, d
   3,584, the shared attention block every 6 layers: 32 heads of 112; SSD
   112 heads of 64, state 64; vocab 32,000; 6.75 B parameters) prefills B
   1 x T 16,384 through ``forward(last_only=True)``: exactly 13
   ``swa_attention_tc`` and 81 ``ssd_scan`` launches; ms per prefill
   (median of 3, CUDA events behind a spin), tokens/s, peak memory, the
   SWA and SSD kernels' device ms beside all kernels' (profiler); the
   same prefill with the model modules' two kernel names bound to the
   plain versions: finite logits of shape (1, 1, 32,000), the plain
   argmax within the kernel run's top 5, the relative L2 distance of the
   logits printed.  ``DecodeEngine`` at that config (batch 4, seq_len
   256; prompts of 8-16 tokens, 16 new tokens each, two greedy and two at
   temperature 0.8; decode is plain PyTorch, no kernel launch), run
   twice: the greedy tokens repeat; tokens/s (host clock) and ms per
   decode step.  zamba2-7b's first group at full width (6 Mamba2 layers
   and the shared block) in float32 at T 4,096: 1 ``swa_attention_tf32x3``
   and 6 ``ssd_scan`` launches, the logits within rtol = atol = 2e-3 (the
   reference's decode-vs-forward bound) of the plain forward and of its
   own token-by-token ``decode_step`` over the first 64 tokens.
   mamba2-370m at its full config, bf16, T 16,384: 48 ``ssd_scan``
   launches, finite logits.  granite-3-8b's first 2 layers at full width
   (GQA 32/8, Dh 128), bf16, T 4,096: 2 ``swa_attention_tc`` launches,
   the top-5 gate.  The launches add to the LM rows of the table.
7t. LM training on the card (``repro_torch.training``; after 7m): the
   SWA and SSD wrappers under autograd run inside ``ops.SWAAttention``
   and ``ops.SSDScan``: the kernel forward also saves the logsumexp or
   the chunk states, and the backward runs the backward kernels.
   (a) At the shapes of zamba2-7b's first group (B 2 x T 4,096; SWA 32
   heads of 112 in bf16, SSD 112 heads of 64, state 64): each Function's
   input gradients against a float64 autograd of the plain version from
   the same inputs and upstream gradient, at most twice as far from it
   (max|d|) as autograd of the plain version in the inputs' own types,
   plus one ulp of the gradient's type at its largest element (both
   distances printed); one launch of each forward and backward; the
   forwards to phase 3l's bounds.
   (b) The group in float32, B 1 x T 4,096: one step's loss (1e-4
   relative) and every gradient leaf (1e-3 relative L2) through the
   kernels against the plain versions.  (c) The group in bf16: the first
   step's gradients per leaf group (embedding, Mamba2 layers, shared
   block, head), kernel against plain, within the plain run's own change
   under one bf16 rounding of input noise.  Then 20 AdamW steps (bf16
   parameters, float32 moments, lr 3e-4, B 2 x T 4,096 of the Markov
   pipeline, ``remat=False``) from each of ``LEARN_SEEDS``: each step
   exactly 1 ``swa_attention_tc``, 1 ``swa_attention_bwd``, 6
   ``ssd_scan`` and 6 ``ssd_scan_bwd`` launches, and no call of a plain
   version on a CUDA tensor in the steps; (d) over the seeds, the loss
   falls by at least ``LEARN_MARGIN`` on the mean, and the losses stay
   within ``TRACK_TOL`` of the plain versions' run from the same seed
   (the mean over the seeds of the mean |difference| over the steps);
   (e) at step 10 of the first seed's run a ``training.checkpoint`` round
   trip
   restores the state bit for bit, and step 11 from it equals the
   uninterrupted step 11 (or lies within two uninterrupted runs' max|d|).
   ms per step (host clock), tokens/s, peak memory, one step's device
   time behind a spin (CUDA events) with the backward kernels' share,
   and a profiled step's busy and wall time.  mamba2-370m at its full
   config, bf16, B 4 x T 2,048, 5 steps of 48 ``ssd_scan`` and 48
   ``ssd_scan_bwd`` launches, the same numbers.  ``examples.lm_train`` (granite-3-8b's smoke config,
   float32) for 200 steps on the card must print ``LEARNED``.  The
   launches add to the LM rows of the table.
9t. tensor parallelism over ``model``: ``make_sharded_train_step`` on a
   (1, 4) mesh, 4 worker processes on the one card over gloo (staged
   through pinned host memory; the library built before they start),
   zamba2-7b's first group at full width (depth cut), each rank holding
   its shards by the reference's fitted specs and running the SWA and
   SSD kernels on its 8 attention and 28 SSD heads.  The one-process
   runs come first, in this process, and free the card.  (t1) float32
   B 1 x T 4,096: the loss within 1e-5 relative of the one-process
   step's, every gradient leaf (the sums over its slices) within 1e-3
   relative L2 (gate (b)'s bound), grad_norm within 1e-5.  (t2) 3 bf16
   steps of seed 82 at lr 3e-4, B 2 x T 4,096: the mean |loss - the
   one-process run's| within gate (d)'s 0.007, and the first step's
   gradient leaves (gathered) within 0.05 relative L2 of the one-process
   run's.  On every rank: the
   kernels' launches per step equal the design and no plain version is
   called on the card; the parameter and moment bytes held equal 1/4 of
   the split leaves' plus the whole leaves'; the peak, ms per step (host
   clock) and each kind of collective's calls, bytes and host-clock
   share are printed, with the batch's memory reckoning.  The ranks'
   launches add to the LM rows of the table.
9e. expert parallelism and the vlm's cross-attention under 9t's
   layout, 4 ranks on the one card as 9t's: phi3.5-moe at full width,
   one layer (16 experts, 4 a rank), and llama-3.2-vision's first five
   layers (a cross layer among them; 1,600 image tokens drawn from the
   seed).  The one-process runs (the bf16 steps' update applied a leaf
   at a time, ``lean_step``) come first and free the card; then one
   spawn runs both models.  (t1) float32 B 1 x T 4,096 through
   ``loss_and_grads``: the loss and the clip's norm within 1e-5, every
   gradient leaf within 1e-3 relative L2; (t2) 3 bf16 steps (phi3.5 B
   2, llama-vision B 1: at B 2 four ranks do not fit the card) within
   0.007 mean |d| and the first step's leaves within 0.05; phi3.5's
   routing (slots per expert, dropped slots) in float32 equal on every
   rank and to the one-process run's; phi3.5 on a (2, 2) mesh (8
   experts a rank, the routing over the data group) against the
   one-process bf16 step on the whole batch within 0.007 and 0.05.  On
   every rank the SWA forward and backward kernels launched, no plain
   version called on the card and the collectives counted equal to
   ``launch.dryrun.tp_collectives``.  The launches add to the LM rows.
9s. serving under 9t's layout, 4 ranks on the one card as 9t's:
   zamba2-7b's first group at full width on (1, 4), float32 and bf16
   (one-process runs first).  (s1) ``make_sharded_prefill`` at B 1 x T
   4,096 (the SWA and SSD kernels on each rank's heads): the last
   position's logits, float32 and bf16, within 1e-5 relative L2 of the
   one-process ``forward(last_only=True)`` made in the ranks' blocks
   (``rank_blocked``: the same products and kernel calls, so the same
   cuBLAS kernels), printed beside the plain one-process forward's
   distance, that run's own spread (input noise, the row twice, the
   plain versions) and, in float32, both runs' distances to a float64
   forward.  (s2) ``DecodeEngine(mesh=)`` at phase 7m's requests: every
   rank the same tokens and cache bits, float32's greedy tokens the
   one-process engine's.  (s3) on every rank the SWA and SSD forward
   kernels launched in the prefill, no plain version called on the
   card, and the prefill's and a decode step's collectives equal
   ``launch.dryrun.serve_collectives``; ms per decode step and the
   collectives' host share printed.  Every gate
   is printed before the phase fails on any.  phi3.5-moe's layer in float32 on a
   (2, 2) mesh decodes the requests greedily: tokens and routing equal
   on every rank and to the one-process engine's.  The prefills'
   launches add to the LM rows.

Prints the kernel table as one JSON line (the LM backward kernels' rows
``swa_attention_bwd``, ``swa_attention_bwd_packed``,
``swa_attention_bwd_f32`` and ``ssd_scan_bwd`` at phase 7's first shape of
each, with ``replaces`` null, the old recompute's ms as
``recompute_ms`` and the rate of the bound as ``bound_rate``; the serial
epoch kernel's row, then the baselines' ``sgd_epoch`` and ``dcd_epoch``
rows, at phase 3b's 4,096-row shape, with
``replaces`` null), the card's ``nvidia-smi`` line,
and last ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; without a CUDA card it exits 2 before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_S = 3.35e12      # H100 SXM device memory rate (data sheet)
F32_OPS_S = 67e12          # H100 SXM float32 outside the tensor cores
TF32_OPS_S = 495e12        # H100 SXM TF32 tensor cores, dense
BF16_OPS_S = 989e12        # H100 SXM bf16 tensor cores, dense
BF16_ULP = 2.0 ** -7       # bf16 spacing relative to the value
TOL = 1e-5
P = 4
LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
REALSIM_M, REALSIM_D, REALSIM_K = 72309, 20958, 51
NEWS20_M, NEWS20_D, NEWS20_K = 19996, 1355191, 455   # LIBSVM news20.binary
OCR_M, OCR_D = 1_000_000, 1156   # ocr's published width; rows cut
EPOCHS, EVAL_EVERY = 10, 2
EPOCH_REPS = 5             # timed repeats of run_epochs(EPOCHS) per backend


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_rel_err(got, want):
    import torch
    d = (got - want).abs()
    return (float(d.max()) if d.numel() else 0.0,
            bool(torch.all(d <= TOL + TOL * want.abs())))


def cuda_ms(fn, n, warm=3):
    """Mean ms per call of ``fn`` over ``n`` calls, CUDA events around the
    run, after ``warm`` calls."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_split(fn, tries=3):
    """Wall seconds of ``fn()`` (synchronised) and the device time of every
    kernel it ran, from a ``torch.profiler`` trace: (wall_s, busy_s,
    [(kernel, us, count), ...] largest first).  A trace that holds no
    device event at all is taken again, up to ``tries`` times, and said
    so.  Traces lose single kernel records too (see
    ``device_ms_per_call``), so busy_s can fall short."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        kernels = [(e.key, e.self_device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        if kernels:
            break
        say("prof", f"trace {attempt} of {tries} holds no device event")
    kernels.sort(key=lambda kv: -kv[1])
    return wall, sum(us for _, us, _ in kernels) / 1e6, kernels


def device_ms_per_call(fn, n):
    """Device ms per call of ``fn`` and per kernel, [(kernel, ms), ...],
    from one profiled window of ``n`` calls.  A trace can lack some of
    the window's kernel records (a record of a launch in the middle of
    the window as well as at either end; once, all of them), so each
    kernel's time is its device time over the launches of it that the
    trace holds, times its launches per call: the launches held, rounded
    up to a multiple of ``n``.  Missing records are said so."""
    _, _, kernels = device_split(lambda: [fn() for _ in range(n)])
    per = []
    for name, us, count in kernels:
        calls = -(-count // n)
        if count != calls * n:
            say("prof", f"the trace holds {count} of {calls * n} launches "
                        f"of {name[:60]}")
        per.append((name, us / count * calls / 1e3))
    return sum(ms for _, ms in per), per


def epoch_runner(grid, backend, *, loss, lam, m, alpha0, eta0):
    """``(fresh, run)`` for timing ``run_epochs`` alone: ``fresh()`` makes
    a new state, ``run(state, n)`` runs ``n`` <= EPOCHS epochs on it with
    the cyclic schedule and step sizes made here, once."""
    import numpy as np
    import torch
    from repro_torch.core.losses import w_bounds
    from repro_torch.engine import (eta_schedule, get_schedule,
                                    init_state_data, run_epochs)
    _, perms = get_schedule("cyclic").draw(torch.Generator().manual_seed(0),
                                           0, EPOCHS, P)
    perms = torch.as_tensor(perms).to(device=grid.yg.device,
                                      dtype=torch.int32)
    etas = eta_schedule(eta0, 0, EPOCHS, True)
    lo, hi = w_bounds(loss, lam)
    args = (float(np.float32(lam)), float(np.float32(m)), lo, hi)

    def fresh():
        return init_state_data(loss, grid, alpha0)

    def run(state, n):
        run_epochs(grid, state, perms[:n], etas[:n], *args, backend=backend,
                   loss_name=loss, reg_name="l2")

    return fresh, run


def epoch_seconds(fresh, run):
    """s/epoch of ``run_epochs`` alone, sorted over ``EPOCH_REPS`` repeats
    of EPOCHS epochs from a fresh state, host clock around the
    synchronised call (state set-up, schedule draw, evaluation and gathers
    excluded), after one unrecorded warm-up epoch."""
    import torch
    run(fresh(), 1)
    out = []
    for _ in range(EPOCH_REPS):
        st = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        run(st, EPOCHS)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) / EPOCHS)
    return sorted(out)


# ------------------------------------------------------------------ data --


def realsim_csr(m, d, k, alpha, seed):
    """real-sim-shaped CSR by the ``make_classification`` recipe, drawn
    vectorised: one ``rng.choice`` of shape (m, k) (power-law column
    popularity when ``alpha``), sorted and deduplicated per row, normal
    values on unit-norm rows, labels from a planted w* with noise 0.1.
    Never densified."""
    import numpy as np
    from repro_torch.sparse import CSRMatrix
    rng = np.random.default_rng(seed)
    pop = None
    if alpha:
        pop = np.arange(1, d + 1, dtype=np.float64) ** (-alpha)
        pop /= pop.sum()
    cols = np.sort(rng.choice(d, size=(m, k), replace=True, p=pop), axis=1)
    keep = np.ones((m, k), bool)
    keep[:, 1:] = cols[:, 1:] != cols[:, :-1]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    indices = cols[keep].astype(np.int32)
    vals = rng.normal(0, 1, indices.size).astype(np.float32)
    rows = np.repeat(np.arange(m), np.diff(indptr))
    norms = np.sqrt(np.bincount(rows, weights=vals.astype(np.float64) ** 2,
                                minlength=m))
    vals = (vals / np.maximum(norms, 1e-8)[rows]).astype(np.float32)
    csr = CSRMatrix(indptr, indices, vals, (m, d))
    w_star = rng.normal(0, 1, d).astype(np.float32)
    margin = csr.matvec(w_star) + 0.1 * rng.normal(0, 1, m).astype(np.float32)
    y = np.where(margin >= 0, 1.0, -1.0).astype(np.float32)
    return csr, y


def ocr_problem(m, d, lam, seed, dev):
    """svm-ocr-shaped dense ``Problem`` by the ``make_dense_classification``
    recipe (features N(0, 1/sqrt(d)), labels from a planted w* with noise
    0.1), drawn on the card with a CUDA ``torch.Generator`` in chunks of
    rows; X never exists on the host."""
    import torch
    from repro_torch.core.saddle import Problem
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.empty((m, d), dtype=torch.float32, device=dev)
    for r in range(0, m, 1 << 16):
        X[r:r + (1 << 16)].normal_(0.0, 1.0 / d ** 0.5, generator=g)
    w_star = torch.randn(d, generator=g, device=dev)
    noise = torch.randn(m, generator=g, device=dev)
    y = torch.where(X @ w_star + 0.1 * noise >= 0, 1.0, -1.0)
    row_nnz = torch.zeros(m, dtype=torch.float32, device=dev)
    col_nnz = torch.zeros(d, dtype=torch.float32, device=dev)
    for r in range(0, m, 1 << 16):
        nz = X[r:r + (1 << 16)] != 0
        row_nnz[r:r + (1 << 16)] = nz.sum(dim=1).float()
        col_nnz += nz.sum(dim=0).float()
    return Problem(X=X, y=y, lam=lam, row_nnz=row_nnz.clamp(min=1.0),
                   col_nnz=col_nnz.clamp(min=1.0), nnz=float(row_nnz.sum()),
                   loss_name="hinge", reg_name="l2")


def random_state(grid, loss, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dev = grid.yg.device
    p, mb, db = grid.p, grid.mb, grid.db
    y = grid.yg.cpu().numpy()
    alpha = y * rng.uniform(0.05, 0.95, (p, mb))
    if loss == "square":
        alpha = rng.normal(0, 0.5, (p, mb))
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa
    return dict(w_grid=t(rng.normal(0, 0.1, (p, db))),
                gw_grid=t(np.abs(rng.normal(0, 0.01, (p, db)))),
                alpha=t(alpha), ga=t(np.abs(rng.normal(0, 0.01, (p, mb)))))


def step_args(grid, st):
    return (grid.yg, st["w_grid"], st["alpha"], st["gw_grid"], st["ga"],
            grid.tile_row_nnz_g, grid.tile_col_nnz_g, grid.row_nnz_g,
            grid.col_nnz)


def scalars(loss, lam, m):
    import numpy as np
    from repro_torch.core.losses import w_bounds
    lo, hi = w_bounds(loss, lam)
    return (0.5, float(np.float32(lam)), float(np.float32(m)), lo, hi)


def run_step(kind, grid, st, blk, scal, rb, loss, reg, plain):
    """One block step of every processor, in place on ``st``: the kernel
    wrapper, or (``plain``) the kernel's plain version."""
    from repro_torch.kernels import dso_sparse, dso_update, ops
    if kind == "dense":
        fn = dso_update.dso_block_step_plain if plain else ops.dso_block_step
        fn(grid.Xg, blk, *step_args(grid, st), scal, row_batches=rb,
           loss_name=loss, reg_name=reg)
    elif kind == "sparse":
        fn = dso_sparse.dso_sparse_block_step_plain if plain \
            else ops.dso_sparse_block_step
        fn(grid.cols_g, grid.vals_g, blk, *step_args(grid, st), scal,
           row_batches=rb, loss_name=loss, reg_name=reg)
    else:
        fn = dso_sparse.dso_bucketed_block_step_plain if plain \
            else ops.dso_bucketed_block_step
        fn(grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt, blk,
           *step_args(grid, st), scal, row_batches=rb, loss_name=loss,
           reg_name=reg)


def compare_step(kind, grid, st, blk, scal, rb, loss, reg, step=None):
    """Kernel vs plain version on clones of the same state: max|d| and
    whether every field is within the bound.  ``step(st)`` replaces the
    kernel wrapper's block step."""
    import torch
    a = {k: v.clone() for k, v in st.items()}
    b = {k: v.clone() for k, v in st.items()}
    if step is None:
        run_step(kind, grid, a, blk, scal, rb, loss, reg, plain=False)
    else:
        step(a)
    run_step(kind, grid, b, blk, scal, rb, loss, reg, plain=True)
    torch.cuda.synchronize()
    errs = [max_rel_err(a[k], b[k]) for k in st]
    return max(e for e, _ in errs), all(ok for _, ok in errs)


def launch_a_step(ctx, blk, scal, kernel):
    """``(step(st), acc)``: launch A alone at the main path's grid (all
    rows, row_batches 1) by the launchers (uncounted), into ``acc``, which
    keeps growing (no launch B; that changes no work).  Block-ELL by
    ``kernel``: "live", the main path's kernel without its primal phase,
    into ``ELL_ACC_COPIES`` copies of the sums as there, or "warp", PR
    11's; bucketed by the route ``kernel`` (the hot route with the grid's
    table)."""
    import torch
    from repro_torch.kernels import dso_sparse, ops
    grid, loss = ctx["grid"], ctx["loss"]
    copies = dso_sparse.ELL_ACC_COPIES if kernel == "live" else 1
    acc = torch.zeros(copies * grid.p, grid.db, device=grid.yg.device)
    hot = ops.grid_hot_table(grid.col_nnz, grid.p, grid.db) \
        if kernel == "hot" else None

    def step(st):
        if ctx["layout"] == "sparse":
            dso_sparse.launch_sparse_dual_scatter(
                grid.cols_g, grid.vals_g, blk, grid.yg, st["w_grid"],
                st["alpha"], st["ga"], grid.tile_row_nnz_g, grid.row_nnz_g,
                acc, 0, grid.mb, scal[0], scal[2], loss, kernel=kernel)
        else:
            dso_sparse.launch_bucketed_dual_scatter(
                grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt,
                blk, grid.yg, st["w_grid"], st["alpha"], st["ga"],
                grid.tile_row_nnz_g, grid.row_nnz_g, acc, 0, grid.mb,
                scal[0], scal[2], loss, route=kernel, hot=hot)
    return step, acc


def baseline_step(ctx, blk, scal):
    """``step(st)``: one block step (row_batches 1) of the main path's grid
    as it was made before launch B was folded in, by the launchers
    (uncounted): the layout's baseline launch A (block-ELL: the first
    kernel, one warp per row over all K slots; bucketed: the global
    route), then launch B alone.  No wrapper takes it."""
    from repro_torch.kernels import dso_sparse
    grid = ctx["grid"]
    launch_a, acc = launch_a_step(
        ctx, blk, scal, "warp" if ctx["layout"] == "sparse" else "global")

    def step(st):
        launch_a(st)
        dso_sparse.launch_primal_update(blk, st["w_grid"], st["gw_grid"],
                                        acc, grid.tile_col_nnz_g,
                                        grid.col_nnz, 0, scal, "l2")
    return step


# ---------------------------------------------------------------- phases --


def phase3_csr(m, d, alpha, hot, seed):
    """A CSR of ``m`` rows over ``d`` columns for phase 3: 2-59 power-law
    (``alpha``) columns per row, so its tiles fall in several K buckets;
    ``hot``: column 0 in every row besides."""
    import numpy as np
    from repro_torch.sparse import CSRMatrix
    rng = np.random.default_rng(seed)
    pop = np.arange(1, d + 1, dtype=np.float64) ** -alpha
    pop /= pop.sum()
    rows = [np.sort(rng.choice(d, size=k, replace=False, p=pop))
            for k in rng.integers(2, 60, m)]
    if hot:
        rows = [np.union1d(r, [0]) for r in rows]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=indptr[1:])
    csr = CSRMatrix(indptr, np.concatenate(rows).astype(np.int32),
                    rng.normal(0, 1, indptr[-1]).astype(np.float32), (m, d))
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    return csr, y


def wide_csr(m, d, alpha, permute, seed):
    """A CSR of ``m`` rows over ``d`` columns for phase 3's wide grids,
    drawn vectorised: 2-59 power-law (``alpha``) draws per row with
    replacement, sorted and deduplicated per row; ``permute``: the columns
    of each of the P column blocks under a random permutation of the block,
    so the popular columns lie anywhere in their blocks (each block keeps
    its share of the draws, so the tiles still fall in several K
    buckets)."""
    import numpy as np
    from repro_torch.sparse import CSRMatrix
    rng = np.random.default_rng(seed)
    pop = np.arange(1, d + 1, dtype=np.float64) ** -alpha
    pop /= pop.sum()
    ks = rng.integers(2, 60, m)
    cols = rng.choice(d, size=(m, 59), replace=True, p=pop)
    if permute:
        db = -(-d // P)
        perm = np.concatenate([b * db + rng.permutation(min(db, d - b * db))
                               for b in range(P)])
        cols = perm[cols]
    cols = np.where(np.arange(59) < ks[:, None], cols, d)
    cols.sort(axis=1)
    keep = cols < d
    keep[:, 1:] &= cols[:, 1:] != cols[:, :-1]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=indptr[1:])
    csr = CSRMatrix(indptr, cols[keep].astype(np.int32),
                    rng.normal(0, 1, indptr[-1]).astype(np.float32), (m, d))
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    return csr, y


def uniform_csr(m, d, alpha, flag, seed):
    """A CSR of ``m`` rows over ``d`` columns by phase 4's recipe
    (``realsim_csr``: 51 uniform draws per row; ``alpha`` and ``flag``
    unused): the block-ELL grid's rows hold ~12.7 of its K slots."""
    return realsim_csr(m, d, REALSIM_K, None, seed)


# a row's live slots in a block of ``edge_csr`` cycle through these
EDGE_ROW_NNZ = (0, 1, 16, 17, 32)


def edge_csr(m, d, alpha, flag, seed):
    """A CSR of ``m`` rows over ``d`` columns whose block-ELL tiles hold
    rows of 0, 1, 16, 17 and 32 entries (32 = K: rows whose every slot is
    live; ``EDGE_ROW_NNZ``, by (row + block) mod 5) and empty tiles: the
    rows of processor q hold nothing in block (q + 2) mod P, so at phase
    3's blocks [1, 3, 0, 2] processors 1 and 2 step an empty tile
    (``alpha`` and ``flag`` unused).  ``d // P`` must be at least 32."""
    import numpy as np
    from repro_torch.sparse import CSRMatrix
    rng = np.random.default_rng(seed)
    mb, db = -(-m // P), -(-d // P)
    rows = []
    for r in range(m):
        cols = [b * db + np.sort(rng.choice(min(db, d - b * db), k,
                                            replace=False))
                for b in range(P) if b != (r // mb + 2) % P
                for k in [EDGE_ROW_NNZ[(r + b) % len(EDGE_ROW_NNZ)]]]
        rows.append(np.concatenate(cols))
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=indptr[1:])
    csr = CSRMatrix(indptr, np.concatenate(rows).astype(np.int32),
                    rng.normal(0, 1, indptr[-1]).astype(np.float32), (m, d))
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    return csr, y


# phase 3's CSRs: (name, m, d, alpha, seed, bucketed route expected, the
# fewest K buckets its bucketed grid must have, generator, its flag:
# phase3_csr's hot column or wide_csr's permutation)
PHASE3_CSRS = [("power-law", 1000, 512, 1.3, 5, "shared", 3, phase3_csr,
                False),
               ("hot column", 1000, 512, 1.3, 7, "shared", 3, phase3_csr,
                True),
               # db 62,500 at p 4: 250,000 B of sums, past the shared
               # budget; alpha 0.9 spreads its tiles over 4 K buckets
               ("wide", 400, 250000, 0.9, 9, "hot", 3, phase3_csr, False),
               # the same kind of columns, permuted within each block:
               # the hot columns scattered
               ("wide, permuted", 400, 250000, 0.9, 10, "hot", 3, wide_csr,
                True),
               # ~180 K draws: block 0 holds more distinct columns than
               # the hot route has slots, so some go to global atomics
               ("wide, cold", 6000, 250000, 0.9, 11, "hot", 3, wide_csr,
                False),
               # the block-ELL launch's edges: uniform columns (most
               # slots padding), and rows of 0, 1, 16, 17 and K live slots
               # beside empty tiles
               ("uniform", 1000, 512, None, 12, "shared", 1, uniform_csr,
                False),
               ("edges", 1000, 512, None, 13, "shared", 1, edge_csr,
                False)]


def block_distinct(grid):
    """The most distinct columns of one block that the grid's tiles hold,
    over the blocks, from its flat chunk view."""
    import torch
    p, db = grid.p, grid.db
    cols, vals = grid.cols_fl, grid.vals_fl
    blk_of_chunk = torch.full((p, cols.shape[1]), -1, dtype=torch.long,
                              device=cols.device)
    for q in range(p):
        for b in range(p):
            n = int(grid.chunk_cnt[q, b])
            blk_of_chunk[q, grid.chunk_lut[q, b, :n].long()] = b
    live = vals != 0
    b = blk_of_chunk[:, :, None, None].expand_as(cols)[live]
    return int(max(torch.unique(cols[live][b == k]).numel()
                   for k in range(p)))


def phase_kernels(dev):
    """Phase 3: probe, then both block steps against their plain versions
    at small shapes with trailing rows (mb = 250, 250 % 3 = 1) on the
    grids of ``PHASE3_CSRS``; the bucketed launches must take the route
    each grid expects, as often as the cases there ask for."""
    import torch
    from repro_torch.kernels import dso_sparse, ops
    from repro_torch.sparse import bucketed_grid_from_csr, sparse_grid_from_csr
    err = ops.sparse_kernel_error(dev)
    check(err is None, f"probe failed: {err}")
    say(3, "probe: gather + atomicAdd scatter matches its plain version")
    limit = ops.shared_memory_limit(dev)
    slots = ops.hot_slots(dev)
    _, reached = dso_sparse.hot_slots()
    say(3, f"hot route: {slots} slots per CTA (the SM's shared memory split "
           f"{dso_sparse.HOT_SMEM_SHARE} ways), {reached} CTAs per SM")
    blk = torch.tensor([1, 3, 0, 2], dtype=torch.int32, device=dev)
    worst = 0.0
    want = {r: 0 for r in ROUTE_COUNTERS}
    ops.reset_launch_counts()
    for name, m, d, alpha, seed, route, n_b, draw, flag in PHASE3_CSRS:
        csr, y = draw(m, d, alpha, flag, seed)
        for rb in (1, 3):
            grids = {"sparse": sparse_grid_from_csr(csr, y, P, rb,
                                                    device=dev),
                     "bucketed": bucketed_grid_from_csr(csr, y, P, rb,
                                                        device=dev)}
            bgrid = grids["bucketed"]
            got = dso_sparse.bucketed_route(bgrid.db, limit)
            check(got == route, f"{name}: db {bgrid.db} routes {got} on a "
                                f"{limit} B limit, expected {route}")
            check(len(bgrid.bucket_ks) >= n_b,
                  f"{name}: bucketed case has {bgrid.bucket_ks}")
            if draw is edge_csr:
                edge_tiles(name, grids["sparse"], blk)
            if name == "wide, cold":
                most = block_distinct(bgrid)
                say(3, f"{name}: up to {most} distinct columns in a block "
                       f"against {slots} hot slots")
                check(most > slots, f"{name}: {most} distinct columns in a "
                                    f"block fit the {slots} hot slots")
            for loss, reg in LOSS_REG_PAIRS:
                for kind, grid in grids.items():
                    st = random_state(grid, loss, seed=rb)
                    e, ok = compare_step(kind, grid, st, blk,
                                         scalars(loss, 1e-3, m), rb, loss,
                                         reg)
                    worst = max(worst, e)
                    zeroed = all(bool((a == 0).all())
                                 for a in ops._ACC.values())
                    if kind == "bucketed":
                        want[route] += rb
                    via = f"route={route} " if kind == "bucketed" else ""
                    say(3, f"{name} {kind:8s} {loss}/{reg} row_batches={rb} "
                           f"mb={grid.mb} db={grid.db} "
                           f"K={getattr(grid, 'K', '-')} "
                           f"buckets={getattr(grid, 'bucket_ks', '-')} "
                           f"{via}max|d|={e:.3e} {'ok' if ok else 'FAIL'}")
                    check(ok, f"{name} {kind} {loss}/{reg} rb={rb}: kernel "
                              f"disagrees with its plain version (max|d| "
                              f"{e:.3e})")
                    check(zeroed, f"{name} {kind} {loss}/{reg} rb={rb}: the "
                                  f"folded step left the accumulator "
                                  f"nonzero")
    counts = ops.launch_counts()
    got = {r: counts[c] for r, c in ROUTE_COUNTERS.items()}
    say(3, f"bucketed launch A by route {got} (cases routed: {want}; "
           f"shared-memory limit {limit} B, hot slots {slots})")
    check(got == want, f"bucketed routes {got} != {want}")
    check(counts["dso_primal_update"] == 0,
          f"the sparse steps launched launch B alone "
          f"{counts['dso_primal_update']} times")
    too_large(dev)
    return worst


def edge_tiles(name, grid, blk):
    """Check that ``edge_csr``'s block-ELL grid has what it is for: rows
    whose every slot is live (trn = K), rows of 0, 1, 16 and 17 live
    slots, and empty active tiles at ``blk``; say how many of each."""
    import torch
    trn = grid.tile_row_nnz_g.long()
    q = torch.arange(grid.p, device=trn.device)
    active = trn[q, blk.long()]                        # (p, mb)
    counts = {k: int((active == k).sum()) for k in (0, 1, 16, 17, grid.K)}
    empty = [int(x) for x in q[(active == 0).all(dim=1)]]
    say(3, f"{name}: K {grid.K}; active tile rows by live slots {counts}; "
           f"empty active tiles of processors {empty}")
    check(grid.K == max(EDGE_ROW_NNZ) and all(counts.values()) and empty,
          f"{name}: the grid lacks an edge: K {grid.K}, {counts}, {empty}")


def too_large(dev):
    """A folded block step whose grid the card cannot hold resident (more
    processors, each at least one CTA, than the card holds CTAs of its
    kernel: 4 * SMs + 1 at 512 threads a CTA) must be refused by the
    cooperative launch and raise, not hang."""
    import torch
    from repro_torch.kernels import dso_sparse
    p = 4 * torch.cuda.get_device_properties(dev).multi_processor_count + 1
    z = lambda *shape: torch.zeros(shape, device=dev)  # noqa: E731
    ones = lambda *shape: torch.ones(shape, device=dev)  # noqa: E731
    blk = torch.arange(p, dtype=torch.int32, device=dev)
    try:
        dso_sparse.launch_sparse_block_step(
            torch.zeros(p, p, 1, 8, dtype=torch.int32, device=dev),
            z(p, p, 1, 8), blk, ones(p, 1), z(p, 1), z(p, 1), z(p, 1),
            z(p, 1), z(p, p, 1), ones(p, 1), z(p, 1, p), ones(p), z(p, 1),
            0, 1, (0.5, 1e-4, float(p), -1.0, 1.0), "hinge", "l2")
        torch.cuda.synchronize()
    except RuntimeError as e:
        say(3, f"a folded step of {p} processors (one CTA each at least) is "
               f"refused: {e}")
        return
    raise SmokeFailure(f"a folded step of {p} processors was not refused")


# the launch count of each route of the bucketed launch A that
# ``bucketed_route`` picks (the global route is its baseline, never picked)
ROUTE_COUNTERS = {"shared": "dso_bucketed_block_step_shared",
                  "hot": "dso_bucketed_block_step"}


def phase_main(phase, dev, cfg, *, powerlaw, expect, seed,
               shape=(REALSIM_M, REALSIM_D, REALSIM_K), route=None):
    """Phases 4/5/5n: the main path through ``solve`` on a CSR of
    ``shape`` (rows, columns, draws per row) drawn from ``seed``, with the
    settings (loss, lam, eta0, p, alpha0) of the ``DSOProblemConfig``
    ``cfg``; ``route``: the route every bucketed launch A must take."""
    import numpy as np
    import torch
    from repro_torch.engine import (make_csr_primal_eval, resolve_backend,
                                    resolve_backend_for_layout, solve)
    from repro_torch.kernels import dso_sparse, ops
    from repro_torch.sparse import (bucketed_grid_from_csr, csr_k_per_tile,
                                    grid_nbytes, sparse_grid_from_csr,
                                    tile_k_skew)
    loss, lam, alpha0 = cfg.loss, cfg.lam, cfg.alpha0
    check(cfg.p == P, f"{cfg} is for p={cfg.p}, the phases run p={P}")
    t0 = time.perf_counter()
    csr, y = realsim_csr(*shape, powerlaw, seed=seed)
    skew = tile_k_skew(csr_k_per_tile(csr, P))
    be = resolve_backend("auto", csr.density, k_skew=skew,
                         device_type=dev.type)
    say(phase, f"data m={csr.m} d={csr.d} nnz={csr.nnz} "
               f"nnz/row={csr.nnz / csr.m:.2f} density={csr.density:.3e} "
               f"tile-K skew={skew:.2f} -> auto resolves {be.name}")
    check(be.name == expect, f"auto picked {be.name}, expected {expect}")
    build = {"sparse": sparse_grid_from_csr,
             "bucketed": bucketed_grid_from_csr}[be.layout]
    grid = build(csr, y, P, 1, device=dev)
    check(resolve_backend_for_layout("auto", be.layout,
                                     device_type=dev.type).name == expect,
          "auto on the pre-built grid resolves another backend")
    hook = make_csr_primal_eval(csr, y, lam, loss, "l2", device=dev)
    torch.cuda.synchronize()
    say(phase, f"layout {be.layout}: grid_nbytes={grid_nbytes(grid)} "
               f"K={getattr(grid, 'K', getattr(grid, 'bucket_ks', None))} "
               f"mb={grid.mb} db={grid.db} "
               f"set-up {time.perf_counter() - t0:.1f} s")
    kw = dict(p=P, epochs=EPOCHS, eta0=cfg.eta0, eval_every=EVAL_EVERY,
              eval_hook=hook, loss_name=loss, reg_name="l2", lam=lam,
              m=csr.m, d=csr.d, alpha0=alpha0, device=dev)

    # the main path: counts set to 0 just before, read just after
    ops.sparse_kernel_error.cache_clear()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    res = solve(grid, backend="auto", **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_step = EPOCHS * P * 1          # epochs x inner iterations x row tiles
    counter = "dso_sparse_block_step"
    if be.layout == "bucketed":
        got = dso_sparse.bucketed_route(grid.db, ops.shared_memory_limit(dev))
        check(got == route, f"db {grid.db} routes {got}, expected {route}")
        counter = ROUTE_COUNTERS[route]
    if route == "hot":
        hot, hot_cols = ops.grid_hot_table(grid.col_nnz, P, grid.db)
        say(phase, f"hot table: {hot.nbytes + hot_cols.nbytes} B on the card "
                   f"(column -> slot {tuple(hot.shape)}, slot -> column "
                   f"{tuple(hot_cols.shape)}), built once for the grid")
        cnt = np.bincount(csr.indices, minlength=P * grid.db).reshape(
            P, grid.db)
        hc = hot_cols.cpu().numpy()
        say(phase, "nonzeros by block (share of all; share in the block's "
                   "hot columns): " + ", ".join(
                       f"{b}: {cnt[b].sum() / cnt.sum():.4f}; "
                       f"{cnt[b, hc[b]].sum() / max(cnt[b].sum(), 1):.4f}"
                       for b in range(P)))
    if route == "hot":
        say(phase, "live columns per block step (tcn > 0 in the row tile: "
                   "the columns the folded primal phase steps) by inner "
                   "iteration of the cyclic schedule: " + ", ".join(
                       f"r{r} {share:.4f}"
                       for r, share in enumerate(live_column_shares(grid))))
    # one folded launch per row tile; launch B alone never runs
    want = dict({k: 0 for k in counts}, sparse_probe=1, **{counter: n_step})
    say(phase, f"launch counts {counts} (design: {want}"
               + (f"; every bucketed launch A on the {route} route)"
                  if route else ")"))
    check(counts == want, f"launch counts {counts} != design {want}")
    primal = [h["primal"] for h in res.history]
    say(phase, "primal per eval " + " ".join(
        f"e{h['epoch']}={h['primal']:.6f}" for h in res.history))
    check(all(np.isfinite(primal)), "non-finite primal")
    check(all(b < a for a, b in zip(primal, primal[1:])),
          f"primal did not fall at every evaluation: {primal}")
    say(phase, f"primal falls at every evaluation; "
               f"max_memory_allocated={peak} B")

    plain_name = {"sparse": "sparse_jnp",
                  "bucketed": "sparse_bucketed_jnp"}[be.layout]
    twin = solve(grid, backend=plain_name, **kw)
    rel = [abs(a["primal"] - b["primal"]) / abs(b["primal"])
           for a, b in zip(res.history, twin.history)]
    say(phase, f"plain twin {plain_name} on the card: max rel primal "
               f"diff {max(rel):.3e} over {len(rel)} evals")
    check(len(rel) == len(primal) and max(rel) <= TOL,
          f"kernel and plain twin disagree: {rel}")

    runners = {name: epoch_runner(grid, name, loss=loss, lam=lam,
                                  m=csr.m, alpha0=alpha0, eta0=cfg.eta0)
               for name in (be.name, plain_name)}
    for name, (fresh, run) in runners.items():
        t = epoch_seconds(fresh, run)
        med = t[len(t) // 2]
        say(phase, f"run_epochs s/epoch {name}: median {med:.6f} min "
                   f"{t[0]:.6f} max {t[-1]:.6f} over {len(t)} x {EPOCHS} "
                   f"epochs; nnz/s at the median {csr.nnz / med:.4e}")
    fresh, run = runners[be.name]
    st = fresh()
    wall, busy, kernels = device_split(lambda: run(st, 2))
    say(phase, f"profiled run_epochs(2) of {be.name}: wall {wall:.6f} s, "
               f"device busy {busy:.6f} s, idle share "
               f"{1 - busy / wall:.3f}; top kernels (us): "
               + ", ".join(f"{k[:48]}={us:.1f}" for k, us, _ in kernels[:6]))
    return dict(grid=grid, layout=be.layout, counts=counts, loss=loss,
                lam=lam, m=csr.m, state=res.state, counter=counter,
                route=route, csr=csr, y=y, w=res.w.clone(), expect=expect,
                phase=phase)


def write_libsvm(path, csr, y) -> int:
    """Write ``csr`` and its labels as a libsvm file that reads back bit for
    bit (``%.9g`` holds every float32; ``dump_libsvm`` writes ``%.6g`` and
    densifies X, 6.06 GB at real-sim's size); returns the file's bytes."""
    import os
    with open(path, "w") as f:
        for i in range(csr.m):
            lo, hi = int(csr.indptr[i]), int(csr.indptr[i + 1])
            f.write(f"{y[i]:g} " + " ".join(
                f"{j + 1}:{v:.9g}" for j, v in zip(
                    csr.indices[lo:hi].tolist(),
                    csr.values[lo:hi].tolist())) + "\n")
    return os.path.getsize(path)


def grids_equal(a, b) -> bool:
    """Two grids of one layout hold equal arrays, field by field (tensors
    by ``torch.equal``, host arrays by ``np.array_equal``, dtypes too)."""
    import numpy as np
    import torch
    if type(a) is not type(b):
        return False
    for x, z in zip(a, b):
        if isinstance(x, tuple):
            if len(x) != len(z) or not all(grids_equal((u,), (v,))
                                           for u, v in zip(x, z)):
                return False
        elif isinstance(x, torch.Tensor):
            if not (isinstance(z, torch.Tensor) and x.dtype == z.dtype
                    and torch.equal(x, z)):
                return False
        elif isinstance(x, np.ndarray):
            if not (x.dtype == z.dtype and np.array_equal(x, z)):
                return False
        elif x != z:
            return False
    return True


def phase_ingest_obs(phase, path, d, stats):
    """``ingest_libsvm(obs=RunRecorder())`` on the phase's file: the
    ``ingest.rows`` / ``ingest.nnz`` counters equal ``stats`` (no malformed
    or quarantined line), and the two pass spans are there."""
    from repro_torch.obs import RunRecorder
    from repro_torch.sparse import ingest_libsvm
    rec = RunRecorder()
    t0 = time.perf_counter()
    ingest_libsvm(path, n_features=d, p=P, normalize_labels=True, obs=rec)
    wall = time.perf_counter() - t0
    counters = {k: v["value"] for k, v in rec.metrics.snapshot().items()}
    spans = {e["name"]: e["dur_s"] for e in rec.events
             if e["type"] == "span"}
    say(phase, f"ingest_libsvm(obs=RunRecorder()) {wall:.2f} s: counters "
               f"{counters}, spans " + ", ".join(
                   f"{k} {v:.2f} s" for k, v in spans.items()))
    check(counters == {"ingest.rows": stats.n_rows,
                       "ingest.nnz": stats.nnz}
          and set(spans) == {"ingest_pass1", "ingest_pass2"},
          f"obs recorded {counters} and spans {sorted(spans)}, expected "
          f"rows {stats.n_rows}, nnz {stats.nnz} and both passes")


def phase_ingest(phase, dev, ctx, cfg, obs=False):
    """Phases 4i/5i: the main path from a libsvm file.  Phase 4's (5n's)
    CSR and labels go to a file float32-exactly; ``ingest_libsvm`` reads it
    back (pass 1 also timed alone, ``scan_libsvm``), bit for bit; with
    ``obs``, once more with a ``RunRecorder``, whose counters must equal
    ``ScanStats`` and which must hold both pass spans; the layout follows
    ``tile_k_skew`` of pass 1's ``k_per_tile``; the grid must equal that
    phase's; ``run_dso_grid_from_data(impl="auto")`` then runs the
    configuration with the device CSR primal every 2 epochs, with the
    counts set to 0 just before and read just after, and must agree with
    that phase's run."""
    import os
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.dso import run_dso_grid_from_data
    from repro_torch.engine import make_csr_primal_eval, resolve_backend
    from repro_torch.kernels import dso_sparse, ops
    from repro_torch.sparse import (BUCKET_SKEW_THRESHOLD,
                                    bucketed_grid_from_csr, csr_k_per_tile,
                                    csr_primal_objective, ingest_libsvm,
                                    scan_libsvm, sparse_grid_from_csr,
                                    tile_k_skew)
    csr, y = ctx["csr"], ctx["y"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "data.libsvm")
        t0 = time.perf_counter()
        nbytes = write_libsvm(path, csr, y)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        scanned = scan_libsvm(path, n_features=csr.d, p=P)
        t_pass1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, y_in, stats = ingest_libsvm(path, n_features=csr.d, p=P,
                                         return_stats=True,
                                         normalize_labels=True)
        t_both = time.perf_counter() - t0
        if obs:
            phase_ingest_obs(phase, path, csr.d, stats)
    say(phase, f"libsvm file {nbytes} B ({csr.m} rows, {csr.nnz} nnz) "
               f"written in {t_write:.2f} s; pass 1 (scan_libsvm alone) "
               f"{t_pass1:.2f} s; ingest_libsvm (both passes) {t_both:.2f} "
               f"s, so pass 2 ~{t_both - t_pass1:.2f} s; "
               f"{nbytes / t_both / 1e6:.1f} MB/s, "
               f"{csr.nnz / t_both:.4e} nnz/s through both passes "
               f"(host clock)")
    same = (got.shape == csr.shape and all(
        a.dtype == b.dtype and np.array_equal(a.view(np.uint8),
                                              b.view(np.uint8))
        for a, b in ((got.indptr, csr.indptr), (got.indices, csr.indices),
                     (got.values, csr.values), (y_in, y))))
    check(same, "the ingested CSR or labels differ from those written")
    check(all(np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
              for a, b in zip(scanned, stats)),
          "scan_libsvm alone and ingest_libsvm's pass 1 disagree")
    check(stats.malformed == 0 and np.array_equal(
        stats.k_per_tile, csr_k_per_tile(got, P)),
          "pass 1's k_per_tile differs from the CSR's")
    skew = tile_k_skew(stats.k_per_tile)
    layout = "bucketed" if skew >= BUCKET_SKEW_THRESHOLD else "sparse"
    be = resolve_backend("auto", got.density, k_skew=skew,
                         device_type=dev.type)
    say(phase, f"ingested CSR and labels equal the written ones bit for "
               f"bit; tile-K skew from ScanStats.k_per_tile {skew:.2f} -> "
               f"{layout}, auto resolves {be.name}")
    check(layout == ctx["layout"] and be.name == ctx["expect"],
          f"skew {skew:.2f} picks {layout} / {be.name}, phase expects "
          f"{ctx['layout']} / {ctx['expect']}")
    build = {"sparse": sparse_grid_from_csr,
             "bucketed": bucketed_grid_from_csr}[layout]
    grid = build(got, y_in, P, 1, device=dev)
    check(grids_equal(grid, ctx["grid"]),
          "the grid of the ingested CSR differs from the phase's grid")
    if layout == "bucketed":
        route = dso_sparse.bucketed_route(grid.db,
                                          ops.shared_memory_limit(dev))
        check(route == ctx["route"], f"db {grid.db} routes {route}")
    hook = make_csr_primal_eval(got, y_in, cfg.lam, cfg.loss, "l2",
                                device=dev)
    ops.sparse_kernel_error.cache_clear()
    ops.reset_launch_counts()
    w, alpha, hist = run_dso_grid_from_data(
        grid, loss_name=cfg.loss, reg_name="l2", lam=cfg.lam, m=got.m,
        d=got.d, epochs=EPOCHS, eta0=cfg.eta0, alpha0=cfg.alpha0,
        impl="auto", eval_every=EVAL_EVERY, eval_hook=hook, device=dev)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = dict({k: 0 for k in counts}, sparse_probe=1,
                **{ctx["counter"]: EPOCHS * P})
    say(phase, f"launch counts {counts} (design: {want})")
    check(counts == want, f"launch counts {counts} != design {want}")
    primal = [h["primal"] for h in hist]
    say(phase, "primal per eval " + " ".join(
        f"e{h['epoch']}={h['primal']:.6f}" for h in hist))
    check(all(np.isfinite(primal)) and all(
        b < a for a, b in zip(primal, primal[1:])),
          f"primal did not fall at every evaluation: {primal}")
    err, ok = max_rel_err(w, ctx["w"])
    say(phase, f"w against phase {ctx['phase']}'s run: max|d| {err:.3e}")
    check(ok, f"w differs from phase {ctx['phase']}'s run by {err:.3e}")
    # index_add_ on the card sums by atomics, so two evaluations of one w
    # may differ in the last bits
    p_obj = csr_primal_objective(got, y_in, w, cfg.lam, cfg.loss, "l2",
                                 device=dev)
    rel = abs(p_obj - primal[-1]) / abs(primal[-1])
    say(phase, f"csr_primal_objective {p_obj:.8f} against the hook's last "
               f"primal {primal[-1]:.8f}: rel {rel:.2e}")
    check(rel <= 1e-6, f"csr_primal_objective disagrees: rel {rel:.2e}")
    return dict(bytes=nbytes, rows=csr.m, nnz=csr.nnz, write_s=t_write,
                pass1_s=t_pass1, both_s=t_both)


SERIAL_SHAPE = dict(m=2000, d=500, density=0.05)   # ~50 K nonzeros
SERIAL_EPOCHS = 3
#: the plans phase 3s times beside the route's: (threads, slots, cluster,
#: staged) at its own shape, and (threads, slots, cluster) at real-sim's
SERIAL_SWEEP = ((1024, 1, 1, True), (1024, 2, 1, True), (1024, 4, 1, True),
                (512, 4, 1, True), (512, 8, 1, True), (256, 16, 1, True),
                (1024, 1, 4, False), (1024, 1, 16, False))
SERIAL_SWEEP_GLOBAL = ((1024, 2, 1), (1024, 2, 4), (1024, 2, 8),
                       (1024, 1, 16), (1024, 2, 16), (1024, 4, 16),
                       (512, 2, 16))
#: the pairs (with AdaGrad) held bit for bit at real-sim's full size
SERIAL_REALSIM_PAIRS = (("hinge", "l2"), ("logistic", "l1"))
SERIAL_CHAIN = 10_000         # chained Eq.-8 steps of the latency kernel
#: steps on one coordinate, one round each: past the 65,536 rounds after
#: which the kernel's 16-bit round stamp wraps and its tags are cleared
SERIAL_WRAP_STEPS = 70_000


def serial_state(m, d, loss, lo, hi, seed, dev):
    """A mid-run serial state (w, alpha, gw, ga) drawn with numpy: w in
    its box, alpha projected, AdaGrad sums in [0, 1)."""
    import numpy as np
    import torch
    from repro_torch.core.losses import get_loss
    rng = np.random.default_rng(seed)
    w = np.clip(rng.uniform(-0.5, 0.5, d), lo, hi).astype(np.float32)
    a = torch.tensor(rng.uniform(-1, 1, m).astype(np.float32))
    return [torch.tensor(w, device=dev),
            a.to(dev), torch.tensor(rng.uniform(0, 1, d).astype(np.float32),
                                    device=dev),
            torch.tensor(rng.uniform(0, 1, m).astype(np.float32),
                         device=dev)], get_loss(loss)


def serial_case(coords, y, rn, cn, order, scal, pair, ada, seed, plan,
                plain=True):
    """One epoch from a seeded mid-run state by the rounds kernel (``plan``,
    its rounds read back), the one-thread kernel and, when ``plain``, the
    plain version on a CPU copy (on the card its ``torch.rsqrt`` is not
    the correctly rounded 1 / sqrt the kernels and the CPU take): (rounds,
    max|d| to the one-thread kernel, max|d| to the plain version or None,
    all bitwise equal)."""
    import torch
    from repro_torch.kernels import dso_serial
    loss, reg = pair
    dev = y.device
    st, lf = serial_state(y.numel(), cn.numel(), loss, scal[3], scal[4],
                          seed, dev)
    st[1] = lf.project_alpha(st[1], y)
    runs = [[t.clone() for t in st] for _ in range(2)]
    rounds = torch.zeros(1, dtype=torch.int32, device=dev)
    rest = (y, rn, cn, scal, loss, reg, ada)
    dso_serial.launch_serial_epoch(*coords, order, *runs[0], *rest,
                                   plan=plan, rounds=rounds)
    dso_serial.launch_serial_epoch_one_thread(*coords, order, *runs[1],
                                              *rest)
    torch.cuda.synchronize()
    new = [t.cpu() for t in runs[0]]
    outs = [[t.cpu() for t in runs[1]]]
    if plain:
        cpu = [t.cpu() for t in st]
        dso_serial.serial_epoch_plain(
            *(t.cpu() for t in (*coords, order)), *cpu, y.cpu(), rn.cpu(),
            cn.cpu(), scal, loss, reg, ada)
        outs.append(cpu)
    diffs = [max(float((a - b).abs().max()) if a.numel() else 0.0
                 for a, b in zip(new, out)) for out in outs]
    same = all(torch.equal(a, b) for out in outs for a, b in zip(new, out))
    return (int(rounds.item()), diffs[0], diffs[1] if plain else None,
            same)


def serial_times(label, coords, y, rn, cn, order, scal, plan, sweep_plans,
                 reps):
    """Phase 3s's A/B at one size (hinge/l2, AdaGrad): the rounds kernel
    on ``plan`` and the one-thread kernel in turns (new, old, old, new),
    ms per epoch by CUDA events behind a spin; the profiler's device ms of
    the rounds kernel; then each plan of ``sweep_plans``.  Returns
    (new ms, one-thread ms, device ms or None)."""
    import torch
    from repro_torch.kernels import dso_serial
    st = [torch.zeros(cn.numel(), device=y.device),
          torch.zeros(y.numel(), device=y.device),
          torch.zeros(cn.numel(), device=y.device),
          torch.zeros(y.numel(), device=y.device)]
    args = (*coords, order, *st, y, rn, cn, scal, "hinge", "l2", True)

    def new(p_):
        return lambda: dso_serial.launch_serial_epoch(*args, plan=p_)

    def old():
        dso_serial.launch_serial_epoch_one_thread(*args)

    turns = [spin_ms(f, n) for f, n in ((new(plan), reps[0]), (old, reps[1]),
                                        (old, reps[1]), (new(plan), reps[0]))]
    t_new, t_old = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    dev_ms, _ = device_ms_per_call(new(plan), 3)
    prof = f"{dev_ms:.4f} ms (profiler)" if dev_ms else \
        "not measured by the profiler (the trace held no kernel record)"
    nnz = order.numel()
    say("3s", f"A/B at {label}, in turns (new, old, old, new): "
              + ", ".join(f"{t:.4f}" for t in turns) + f" ms; rounds "
              f"kernel ({say_serial_plan(plan)}) {t_new:.4f} ms "
              f"per epoch ({t_new * 1e6 / nnz:.2f} ns per nonzero), device "
              f"{prof}; one thread {t_old:.4f} ms ({t_old * 1e6 / nnz:.1f} "
              f"ns per nonzero): {t_old / t_new:.1f}x")
    for p_ in sweep_plans:
        t = spin_ms(new(p_), reps[0])
        say("3s", f"sweep at {label}: {say_serial_plan(p_)}: {t:.4f} ms "
                  f"per epoch")
    return t_new, t_old, dev_ms or None


def say_serial_plan(plan):
    return (f"window {plan.window} = {plan.slots} x {plan.threads} threads "
            f"x {plan.cluster} blocks, "
            f"{'staged' if plan.staged else 'global'}, {plan.smem} B shared "
            f"per block")


def step_latency_ms(scal, pair):
    """ms of one Eq.-8 step (AdaGrad) on one thread, its operands in
    registers: ``SERIAL_CHAIN`` chained steps by CUDA events behind a
    spin."""
    import torch
    from repro_torch.kernels import dso_serial
    out = torch.tensor([0.01, 0.5, 0.25, 0.25], device="cuda")
    return spin_ms(lambda: dso_serial.launch_step_latency(
        SERIAL_CHAIN, (0.3, 1.0, 25.0, 100.0), scal, *pair, True, out),
        3) / SERIAL_CHAIN


def check_serial_plan(label, plan, m, d):
    """Print a serial plan and hold its shared memory against the C
    entry's own count."""
    from repro_torch.kernels import dso_serial
    got = dso_serial.kernel_smem(m, d, plan.slots, plan.threads,
                                 plan.staged)
    say("3s", f"plan at {label}: {say_serial_plan(plan)} (C entry: {got})")
    check(got == plan.smem, f"{label}: the plan's shared memory "
                            f"{plan.smem} != the kernel's {got}")


def serial_coords(csr, dev):
    """(ii, jj, vv) of a CSR and its row and column counts, on ``dev``."""
    import numpy as np
    import torch
    rows = np.repeat(np.arange(csr.m, dtype=np.int32), np.diff(csr.indptr))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa
    rn = np.bincount(rows, minlength=csr.m).astype(np.float32)
    cn = np.bincount(csr.indices, minlength=csr.d).astype(np.float32)
    return (as_t(rows), as_t(csr.indices.astype(np.int32)),
            as_t(csr.values)), as_t(rn), as_t(cn)


def phase_serial(dev):
    """Phase 3s: ``solve_serial`` on the card, the serial epoch kernel
    once per epoch, against the plain version on a CPU copy with the same
    visit orders (the same seed), for the six pairs x use_adagrad; then,
    launched directly (uncounted), one epoch from a seeded mid-run state
    by the rounds kernel, the one-thread kernel and the plain version,
    ``torch.equal``, in the same 12 cases, and by the two kernels at
    real-sim's full size (``realsim_csr``, never densified) for
    ``SERIAL_REALSIM_PAIRS``, the rounds the kernel took against the CPU
    model's (``serial_rounds``), and ``SERIAL_WRAP_STEPS`` steps on one
    coordinate on both layouts (the round stamp wraps); then at both sizes the A/B in turns, the
    plan sweep, the bytes bound and the dependency floor (waves x one
    Eq.-8 step's latency).  Returns the kernel table's row."""
    import numpy as np
    import torch
    from repro_torch.configs.dso_problems import ALL
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import prob_meta, solve_serial
    from repro_torch.engine.data import w_bounds
    from repro_torch.engine.driver import _coords
    from repro_torch.kernels import dso_serial, ops
    worst, launches = 0.0, 0
    for loss, reg in LOSS_REG_PAIRS:
        for ada in (True, False):
            kw = dict(SERIAL_SHAPE, loss=loss, reg=reg, seed=21)
            prob = make_classification(**kw, device=dev)
            cpu = make_classification(**kw, device="cpu")
            skw = dict(epochs=SERIAL_EPOCHS, eta0=0.5, seed=0,
                       use_adagrad=ada)
            ops.reset_launch_counts()
            res = solve_serial(prob, **skw, device=dev)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
            check(counts["dso_serial_epoch"] == SERIAL_EPOCHS
                  and sum(counts.values()) == SERIAL_EPOCHS,
                  f"solve_serial launch counts {counts}, expected "
                  f"{SERIAL_EPOCHS} dso_serial_epoch")
            launches += counts["dso_serial_epoch"]
            ref = solve_serial(cpu, **skw, device="cpu")
            e_w, ok_w = max_rel_err(res.w.cpu(), ref.w)
            e_a, ok_a = max_rel_err(res.alpha.cpu(), ref.alpha)
            rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                      for a, b in zip(res.history, ref.history)
                      for k in ("primal", "gap"))
            worst = max(worst, e_w, e_a)
            say("3s", f"{loss}/{reg} adagrad={ada} nnz={int(prob.nnz)}: "
                      f"max|d| w {e_w:.3e} alpha {e_a:.3e}, history rel "
                      f"{rel:.3e}; primal e{SERIAL_EPOCHS}="
                      f"{res.history[-1]['primal']:.6f}")
            check(ok_w and ok_a and rel <= TOL
                  and len(res.history) == len(ref.history),
                  f"{loss}/{reg} adagrad={ada}: the serial kernel "
                  f"disagrees with its plain version")
    lim = dict(smem_limit=ops.shared_memory_limit(dev),
               max_cluster=ops.serial_max_cluster(dev))
    say("3s", f"card limits for the serial plans: {lim}")
    gen = torch.Generator().manual_seed(0)
    prob = make_classification(**SERIAL_SHAPE, seed=21, device=dev)
    coords = _coords(prob)
    nnz, m, d = coords[0].numel(), prob.m, prob.d
    order = torch.randperm(nnz, generator=gen).to(device=dev,
                                                  dtype=torch.int32)
    plan = ops.serial_epoch_route(m, d, nnz, **lim)
    check_serial_plan(f"m {m}, d {d}, nnz {nnz}", plan, m, d)
    check(plan.staged, f"the plan {plan} is not staged")
    for k, (loss, reg) in enumerate(LOSS_REG_PAIRS):
        for ada in (True, False):
            kw = dict(SERIAL_SHAPE, loss=loss, reg=reg, seed=21)
            p_ = make_classification(**kw, device=dev)
            lam, m_f, _, _, _, lo, hi = prob_meta(p_)
            c_ = _coords(p_)
            o_ = torch.randperm(c_[0].numel(), generator=torch.Generator()
                                .manual_seed(k)).to(dev, torch.int32)
            want = max(dso_serial.serial_rounds(
                c_[0][o_.long()].tolist(), c_[1][o_.long()].tolist(),
                plan.window), default=-1) + 1
            rounds, d_old, d_plain, same = serial_case(
                c_, p_.y, p_.row_nnz, p_.col_nnz, o_,
                (0.5, lam, m_f, lo, hi), (loss, reg), ada, 100 + k, plan)
            say("3s", f"{loss}/{reg} adagrad={ada}: rounds kernel == one "
                      f"thread == plain version (CPU copy): {same} (max|d| "
                      f"{d_old:.3e}, {d_plain:.3e}); {rounds} rounds (CPU "
                      f"model {want})")
            check(same and rounds == want,
                  f"{loss}/{reg} adagrad={ada}: the rounds kernel is not "
                  f"bit for bit the one-thread kernel and the plain "
                  f"version, or took {rounds} rounds, not {want}")
    nw = SERIAL_WRAP_STEPS
    one = (torch.zeros(nw, dtype=torch.int32, device=dev),
           torch.zeros(nw, dtype=torch.int32, device=dev),
           (torch.randn(nw, generator=gen) / 100).to(dev))
    o_w = torch.randperm(nw, generator=gen).to(device=dev, dtype=torch.int32)
    count = torch.full((1,), float(nw), device=dev)
    for staged in (True, False):
        p_w = dso_serial.serial_plan(1, 1, nw, **lim, staged=staged)
        rounds, d_old, _, same = serial_case(
            one, torch.ones(1, device=dev), count, count, o_w,
            (0.5, 1e-3, 1.0, *w_bounds("hinge", 1e-3)), ("hinge", "l2"),
            True, 300, p_w, plain=False)
        say("3s", f"{nw} steps on one coordinate ({say_serial_plan(p_w)}): "
                  f"rounds kernel == one thread: {same} (max|d| "
                  f"{d_old:.3e}); {rounds} rounds")
        check(same and rounds == nw,
              f"{nw} steps on one coordinate, "
              f"{'staged' if staged else 'global'}: the rounds kernel is "
              f"not the one-thread kernel's bit for bit, or took {rounds} "
              f"rounds, not {nw}")
    rows_h = coords[0][order.long()].tolist()
    cols_h = coords[1][order.long()].tolist()
    waves = max(dso_serial.serial_waves(rows_h, cols_h, m, d)) + 1
    model = max(dso_serial.serial_rounds(rows_h, cols_h, plan.window)) + 1
    lam, m_f, _, _, _, lo, hi = prob_meta(prob)
    scal = (0.5, lam, m_f, lo, hi)
    sweep = [dso_serial.serial_plan(m, d, nnz, **lim, threads=t, slots=s_,
                                    cluster=c, staged=sg)
             for t, s_, c, sg in SERIAL_SWEEP if c <= lim["max_cluster"]]
    t_new, t_old, dev_ms = serial_times(
        f"m {m}, d {d}, nnz {nnz}", coords, prob.y, prob.row_nnz,
        prob.col_nnz, order, scal, plan, sweep, (20, 3))
    st = [torch.zeros(d, device=dev), torch.zeros(m, device=dev),
          torch.zeros(d, device=dev), torch.zeros(m, device=dev)]
    args = (prob.y, prob.row_nnz, prob.col_nnz, scal)
    kw = dict(loss_name="hinge", reg_name="l2", use_adagrad=True)
    ms = cuda_ms(lambda: ops.dso_serial_epoch(*coords, order, *st, *args,
                                              **kw), 20, warm=2)
    pst = [t.clone() for t in st]
    plain_ms = cuda_ms(lambda: dso_serial.serial_epoch_plain(
        *coords, order, *pst, *args[:3], scal, "hinge", "l2", True),
        3, warm=1)
    step_ms = {pair: step_latency_ms(scal, pair)
               for pair in (("hinge", "l2"), ("logistic", "l1"))}
    lat = step_ms["hinge", "l2"]
    nbytes = 16 * nnz + 24 * m + 20 * d
    bound_ms = nbytes / HBM_BYTES_S * 1e3
    floor_ms = waves * lat
    say("3s", f"Eq.-8 step latency on one thread, operands in registers "
              f"({SERIAL_CHAIN} chained): "
              + ", ".join(f"{a}/{b} {v * 1e6:.1f} ns"
                          for (a, b), v in step_ms.items()))
    say("3s", f"rounds kernel at m {m}, d {d}, nnz {nnz} (hinge/l2, "
              f"AdaGrad): {ms:.4f} ms per epoch through ops (CUDA events), "
              f"{t_new:.4f} behind a spin; one-thread kernel {t_old:.4f} "
              f"ms; plain version on the card {plain_ms:.4f} ms; bound "
              f"{bound_ms:.2e} ms (bytes: {nbytes} B once); dependency "
              f"floor {floor_ms:.4f} ms ({waves} waves x {lat * 1e6:.1f} "
              f"ns); {model} rounds in windows of {plan.window}")
    # real-sim's full size: bit for bit against the one-thread kernel
    cfg = ALL["svm-real-sim"]
    csr, yv = realsim_csr(REALSIM_M, REALSIM_D, REALSIM_K, None, seed=4)
    big, rn_b, cn_b = serial_coords(csr, dev)
    y_b = torch.from_numpy(yv).to(dev)
    nb, mb, db = csr.nnz, csr.m, csr.d
    order_b = torch.randperm(nb, generator=gen).to(device=dev,
                                                   dtype=torch.int32)
    plan_b = ops.serial_epoch_route(mb, db, nb, **lim)
    check_serial_plan(f"real-sim's full size m {mb}, d {db}, nnz {nb}",
                      plan_b, mb, db)
    check(not plan_b.staged, f"the plan at real-sim's size {plan_b} is "
                             f"staged")
    rows_h = big[0][order_b.long()].tolist()
    cols_h = big[1][order_b.long()].tolist()
    waves_b = max(dso_serial.serial_waves(rows_h, cols_h, mb, db)) + 1
    model_b = max(dso_serial.serial_rounds(rows_h, cols_h,
                                           plan_b.window)) + 1
    del rows_h, cols_h
    m_fb = float(np.float32(mb))
    for k, (loss, reg) in enumerate(SERIAL_REALSIM_PAIRS):
        lo_b, hi_b = w_bounds(loss, cfg.lam)
        scal_b = (0.5, float(np.float32(cfg.lam)), m_fb, lo_b, hi_b)
        rounds, d_old, _, same = serial_case(
            big, y_b, rn_b, cn_b, order_b, scal_b, (loss, reg), True,
            200 + k, plan_b, plain=False)
        say("3s", f"real-sim's full size m {mb}, d {db}, nnz {nb}, "
                  f"{loss}/{reg} AdaGrad: rounds kernel == one thread: "
                  f"{same} (max|d| {d_old:.3e}); {rounds} rounds (CPU model "
                  f"{model_b}; {waves_b} waves)")
        check(same and rounds == model_b,
              f"real-sim {loss}/{reg}: the rounds kernel is not bit for "
              f"bit the one-thread kernel, or took {rounds} rounds, not "
              f"{model_b}")
    scal_b = (0.5, float(np.float32(cfg.lam)), m_fb,
              *w_bounds("hinge", cfg.lam))
    sweep_b = [dso_serial.serial_plan(mb, db, nb, **lim, threads=t,
                                      slots=s_, cluster=c)
               for t, s_, c in SERIAL_SWEEP_GLOBAL
               if c <= lim["max_cluster"]]
    tb_new, tb_old, devb_ms = serial_times(
        f"real-sim's full size m {mb}, d {db}, nnz {nb}", big, y_b, rn_b,
        cn_b, order_b, scal_b, plan_b, sweep_b, (5, 1))
    lat_b = step_latency_ms(scal_b, ("hinge", "l2"))
    nbytes_b = 16 * nb + 24 * mb + 20 * db
    bound_b = nbytes_b / HBM_BYTES_S * 1e3
    floor_b = waves_b * lat_b
    say("3s", f"rounds kernel at real-sim's full size: {tb_new:.4f} ms per "
              f"epoch; one-thread kernel {tb_old:.4f} ms; bound "
              f"{bound_b:.4f} ms (bytes: {nbytes_b} B once); dependency "
              f"floor {floor_b:.4f} ms ({waves_b} waves x "
              f"{lat_b * 1e6:.1f} ns); {model_b} rounds in windows of "
              f"{plan_b.window}")
    return dict(name="serial_epoch", route="cuda",
                source="src/repro_torch/csrc/dso_serial.cu", replaces=None,
                launches=launches, max_abs_err=worst, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                library_ms=None, device_ms=dev_ms, spin_ms=t_new,
                one_thread_ms=t_old, dep_floor_ms=floor_ms, rounds=model,
                realsim_ms=tb_new, realsim_device_ms=devb_ms,
                realsim_one_thread_ms=tb_old, realsim_bound_ms=bound_b,
                realsim_dep_floor_ms=floor_b, realsim_rounds=model_b)


# --------------------------------------------- baselines (phases 3b, 10) --

BASE_SMALL = dict(m=400, d=150, density=0.1, lam=1e-3, seed=1)  # ref tests
BASE_WIDE_M = 4096            # rows of real-sim's width in phase 3b
BASE_ETA0 = 0.3
SEC5_LAM = 1e-4
# phase 10's cuts (the reference example runs 30 DSO epochs, 15 of SGD and
# PSGD and 25 BMRM iterations on a 2,000-row stand-in)
SEC5_EPOCHS = dict(dso=10, sgd=3, psgd=3, dcd=3, bmrm=10)


def realsim_problem(ctx, dev, rows=None):
    """Phase 4's CSR (its first ``rows`` rows) as a dense ``Problem`` built
    on the card (hinge, l2, lam 1e-4): the CSR's arrays go to the device
    and are scattered into X there; X never exists on the host."""
    import torch
    from repro_torch.core.saddle import Problem
    csr = ctx["csr"]
    rows = csr.m if rows is None else rows
    nnz = int(csr.indptr[rows])
    indptr = torch.as_tensor(csr.indptr[:rows + 1], device=dev)
    cols = torch.as_tensor(csr.indices[:nnz], device=dev).long()
    vals = torch.as_tensor(csr.values[:nnz], device=dev)
    row_nnz = torch.diff(indptr)
    r = torch.repeat_interleave(torch.arange(rows, device=dev), row_nnz)
    X = torch.zeros((rows, csr.d), dtype=torch.float32, device=dev)
    X[r, cols] = vals
    col_nnz = torch.bincount(cols, minlength=csr.d).float()
    y = torch.as_tensor(ctx["y"][:rows], device=dev)
    return Problem(X=X, y=y, lam=SEC5_LAM,
                   row_nnz=row_nnz.float().clamp(min=1.0),
                   col_nnz=col_nnz.clamp(min=1.0), nnz=float(nnz),
                   loss_name="hinge", reg_name="l2")


def sgd_bound(X, rows):
    """(bound_ms, bound_by) of one SGD epoch over ``rows``: the visited
    rows of X read once, w and acc read and written once, the row ids and
    labels read; 4 operations per element of a visited row (the margin's
    and X^T lg's products and sums) and ~10 per column per step (the
    AdaGrad update)."""
    n_workers, n = rows.shape
    d = X.shape[1]
    visited = int((rows >= 0).sum())
    nbytes = 4 * visited * d + 16 * n_workers * d + 8 * n_workers * n
    ops_ = 4 * visited * d + 10 * n_workers * n * d
    return max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
               (ops_ / F32_OPS_S * 1e3, "operations"))


def dcd_bound(X, n, changed):
    """(bound_ms, bound_by) of one DCD epoch of ``n`` steps, ``changed`` of
    which moved beta (and so w): each visited row read once, w read and
    written once, perm, y, xnorm2 and beta read, the changed betas written;
    2 operations per element of a row for the margin and 2 for each
    changed step's axpy."""
    d = X.shape[1]
    nbytes = 4 * n * d + 8 * d + 16 * n + 4 * changed
    ops_ = 2 * n * d + 2 * changed * d
    return max((nbytes / HBM_BYTES_S * 1e3, "bytes"),
               (ops_ / F32_OPS_S * 1e3, "operations"))


def baseline_cases(prob, dev, seed):
    """Phase 3b's cases on one Problem: (label, kernel, plain, state) with
    ``kernel(st)`` / ``plain(st)`` one epoch in place on a state dict and
    ``state()`` a fresh seeded state: SGD at batch 1 and 8 for the six
    pairs, PSGD at p 4 on the first m - 2 rows (ragged), DCD (hinge)."""
    import numpy as np
    import torch
    from repro_torch.baselines.dcd import _row_norms2
    from repro_torch.baselines.psgd import shard_rows
    from repro_torch.kernels import baselines as kb
    from repro_torch.kernels import ops
    m, d = prob.m, prob.d
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa

    def sgd_state(n_workers):
        return lambda: dict(w=t(rng.normal(0, 0.05, (n_workers, d))),
                            acc=t(np.abs(rng.normal(0, 0.01,
                                                    (n_workers, d)))))

    cases = []
    for batch in (1, 8):
        n = m // batch * batch
        rows = torch.randperm(m, generator=gen)[:n].to(
            device=dev, dtype=torch.int32).reshape(1, n)
        for loss, reg in LOSS_REG_PAIRS:
            args = (prob.X, prob.y, rows)
            sc = (BASE_ETA0, prob.lam, loss, reg, batch)
            cases.append((f"sgd {loss}/{reg} batch {batch}",
                          lambda st, a=args, s=sc: ops.sgd_epoch(
                              *a, st["w"], st["acc"], *s[:2], loss_name=s[2],
                              reg_name=s[3], batch=s[4]),
                          lambda st, a=args, s=sc: kb.sgd_epoch_plain(
                              *a, st["w"], st["acc"], *s),
                          sgd_state(1), rows))
    mr = m - 2
    mb = -(-mr // P)
    perms = torch.stack([torch.randperm(mb, generator=gen)
                         for _ in range(P)])
    rows = shard_rows(perms.to(dev), mr, 1)
    X, y = prob.X[:mr], prob.y[:mr]
    cases.append((f"psgd p {P} m {mr} logistic/l2",
                  lambda st: ops.sgd_epoch(
                      X, y, rows, st["w"], st["acc"], BASE_ETA0, prob.lam,
                      loss_name="logistic", reg_name="l2"),
                  lambda st: kb.sgd_epoch_plain(
                      X, y, rows, st["w"], st["acc"], BASE_ETA0, prob.lam,
                      "logistic", "l2", 1),
                  sgd_state(P), rows))
    perm = torch.randperm(m, generator=gen).to(device=dev,
                                               dtype=torch.int32)
    xn = _row_norms2(prob.X)
    cases.append(("dcd hinge",
                  lambda st: ops.dcd_epoch(prob.X, prob.y, perm, st["w"],
                                           st["beta"], prob.lam, xn),
                  lambda st: kb.dcd_epoch_plain(prob.X, prob.y, perm,
                                                st["w"], st["beta"],
                                                prob.lam, xn),
                  lambda: dict(w=t(rng.normal(0, 0.05, d)),
                               beta=t(rng.uniform(0, 1, m))),
                  perm))
    return cases


SPIN_CYCLES = 20_000_000     # ~10 ms on an H100: longer than the host
BASE_GLOBAL = (256, 600_000)  # m x d of 3b's global-w case (614 MB of X)
BASE_AB_CLUSTERS = (4, 8, 16)


def spin_ms(fn, n, warm=1):
    """ms per call of ``fn``: CUDA events around ``n`` calls queued behind
    a ``torch.cuda._sleep`` spin of ``SPIN_CYCLES``, so that they run back
    to back on the card whatever the host takes to queue them (as
    ``bench/fold.py`` times): the device's time per call, which needs no
    profiler trace."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def base_limits(dev):
    """The card's limits the epoch plans read: opt-in shared memory per
    block and the largest cluster of the epoch kernels."""
    from repro_torch.kernels import ops
    return dict(smem_limit=ops.shared_memory_limit(dev),
                max_cluster=ops.max_cluster(dev))


def say_plan(label, kind, plan, batch=1):
    """Print an epoch plan and hold its shared memory against the C
    entry's own count."""
    from repro_torch.kernels import baselines as kb
    got = kb.kernel_smem(kind, batch, plan.width, plan.staged)
    say("3b", f"{label}: {kind} plan cluster {plan.cluster} x width "
              f"{plan.width} ({'staged' if plan.staged else 'global'}), "
              f"{plan.smem} B shared per block (C entry: {got})")
    check(got == plan.smem, f"{label}: plan's shared memory {plan.smem} != "
                            f"the kernel's {got}")


def check_epoch_case(label, kern, plain, st0, counter):
    """One epoch case of phase 3b: the kernel twice from ``st0`` (each
    exactly one launch, the two bitwise equal) against the plain version
    bit for bit (max|d| 0.0, which is inside the 1e-5 gate).  Returns
    max|d|."""
    import torch
    runs = []
    for _ in range(2):
        st = {k: v.clone() for k, v in st0.items()}
        _, counts = counted(lambda: kern(st))
        check_counts("3b", counts, {counter: 1})
        runs.append(st)
    ref = {k: v.clone() for k, v in st0.items()}
    plain(ref)
    torch.cuda.synchronize()
    check(all(torch.equal(runs[0][k], runs[1][k]) for k in ref),
          f"{label}: two kernel runs differ")
    errs = {k: max_rel_err(runs[0][k], ref[k]) for k in ref}
    say("3b", f"{label}: max|d| " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + "; two kernel runs bitwise equal; 1 launch")
    check(all(ok for _, ok in errs.values()),
          f"{label}: kernel and plain version disagree")
    check(all(torch.equal(runs[0][k], ref[k]) for k in ref),
          f"{label}: kernel and plain version not bit for bit")
    return max(e for e, _ in errs.values())


def repeated_ids_case(prob, dev, seed):
    """Phase 3b's DCD case with ids that come back (at once and later):
    (label, kernel, plain, state)."""
    import numpy as np
    import torch
    from repro_torch.baselines.dcd import _row_norms2
    from repro_torch.kernels import baselines as kb
    from repro_torch.kernels import ops
    rng = np.random.default_rng(seed)
    perm = rng.integers(0, prob.m, prob.m).astype(np.int32)
    perm[1::5] = perm[0::5][:len(perm[1::5])]
    perm = torch.as_tensor(perm, device=dev)
    xn = _row_norms2(prob.X)
    st0 = dict(w=torch.tensor(rng.normal(0, 0.05, prob.d).astype(np.float32),
                              device=dev),
               beta=torch.tensor(rng.uniform(0, 1, prob.m).astype(np.float32),
                                 device=dev))
    return ("dcd hinge, repeated ids",
            lambda st: ops.dcd_epoch(prob.X, prob.y, perm, st["w"],
                                     st["beta"], prob.lam, xn),
            lambda st: kb.dcd_epoch_plain(prob.X, prob.y, perm, st["w"],
                                          st["beta"], prob.lam, xn), st0)


def global_body_cases(dev):
    """Phase 3b's SGD cases past the staged limit: a dense X of
    ``BASE_GLOBAL`` drawn on the card (unit rows), hinge/l2 at batch 1 and
    logistic/l1 at batch 8: (label, kernel, plain, state, d)."""
    import torch
    m, d = BASE_GLOBAL
    g = torch.Generator(device=dev).manual_seed(7)
    X = torch.randn((m, d), generator=g, device=dev)
    X /= X.norm(dim=1, keepdim=True)
    y = torch.where(torch.randn(m, generator=g, device=dev) >= 0, 1.0, -1.0)
    from repro_torch.kernels import baselines as kb
    from repro_torch.kernels import ops
    rows = torch.randperm(m, generator=g, device=dev).to(torch.int32)
    st0 = dict(w=torch.randn((1, d), generator=g, device=dev) * 0.05,
               acc=torch.rand((1, d), generator=g, device=dev) * 0.01)
    out = []
    for loss, reg, batch in (("hinge", "l2", 1), ("logistic", "l1", 8)):
        r = rows[:m // batch * batch].reshape(1, -1)
        sc = (BASE_ETA0, 1e-3, loss, reg, batch)
        out.append((f"m {m} x d {d} sgd {loss}/{reg} batch {batch}",
                    lambda st, r=r, sc=sc: ops.sgd_epoch(
                        X, y, r, st["w"], st["acc"], *sc[:2],
                        loss_name=sc[2], reg_name=sc[3], batch=sc[4]),
                    lambda st, r=r, sc=sc: kb.sgd_epoch_plain(
                        X, y, r, st["w"], st["acc"], *sc),
                    st0, batch))
    return out, d


def phase_baseline_kernels(dev, full):
    """Phase 3b: ``ops.sgd_epoch`` and ``ops.dcd_epoch`` (one thread-block
    cluster per worker, ``ops.sgd_epoch_route`` / ``dcd_epoch_route``'s
    plan printed) against their plain versions on the card, one epoch from
    the same seeded state on the same orders, bit for bit: at the
    reference tests' shape (m 400, d 150), at real-sim's width (phase 4's
    first 4,096 rows, d 20,958), DCD with repeated ids at both, SGD past
    the staged limit (``BASE_GLOBAL``, the global-w body) and SGD, PSGD and
    DCD at real-sim's full size (``full``: phase 4's CSR, m 72,309, on the
    card); two kernel runs bitwise equal, each exactly one launch.  Then
    at the 4,096-row shape ms per epoch (CUDA events), device ms
    (profiler, and CUDA events behind a spin) beside the plain version's
    and the bound; at full size the A/B against the one-block kernels
    in turns (new, old, old, new), each cluster size of
    ``BASE_AB_CLUSTERS`` and the exchange-only floor per step.  Returns
    the kernel table's two rows and each kernel's worst max|d|."""
    import torch
    from repro_torch.baselines.dcd import _row_norms2
    from repro_torch.baselines.psgd import shard_rows
    from repro_torch.data.synthetic import make_classification
    from repro_torch.kernels import baselines as kb
    from repro_torch.kernels import ops
    lim = base_limits(dev)
    say("3b", f"card limits for the epoch plans: {lim}")
    small = make_classification(**BASE_SMALL, device=dev)
    wide = full._replace(X=full.X[:BASE_WIDE_M], y=full.y[:BASE_WIDE_M])
    worst = {"sgd_epoch": 0.0, "dcd_epoch": 0.0}
    timed = {}
    for label, prob in (("m 400 x d 150", small),
                        (f"m {BASE_WIDE_M} x d {wide.d}", wide)):
        for batch in (1, 8):
            say_plan(label, "sgd", ops.sgd_epoch_route(prob.d, batch, **lim),
                     batch)
        say_plan(label, "dcd", ops.dcd_epoch_route(prob.d, **lim))
        for name, kern, plain, state, order in baseline_cases(prob, dev, 3):
            counter = "dcd_epoch" if name.startswith("dcd") else "sgd_epoch"
            st0 = state()
            err = check_epoch_case(f"{label} {name}", kern, plain, st0,
                                   counter)
            worst[counter] = max(worst[counter], err)
            if prob is wide and name in ("sgd hinge/l2 batch 1",
                                         "dcd hinge"):
                timed[counter] = (kern, plain, st0, order)
        name, kern, plain, st0 = repeated_ids_case(prob, dev, 4)
        worst["dcd_epoch"] = max(worst["dcd_epoch"], check_epoch_case(
            f"{label} {name}", kern, plain, st0, "dcd_epoch"))
    cases, d_g = global_body_cases(dev)
    for name, kern, plain, st0, batch in cases:
        plan = ops.sgd_epoch_route(d_g, batch, **lim)
        say_plan(name, "sgd", plan, batch)
        check(not plan.staged, f"{name}: the plan is not the global body")
        worst["sgd_epoch"] = max(worst["sgd_epoch"], check_epoch_case(
            name, kern, plain, st0, "sgd_epoch"))
    del cases
    torch.cuda.empty_cache()
    rows = {}
    for counter, (kern, plain, st0, order) in timed.items():
        st, pst = ({k: v.clone() for k, v in st0.items()} for _ in range(2))
        ms = cuda_ms(lambda: kern(st), 3, warm=1)
        dev_ms, _ = device_ms_per_call(lambda: kern(st), 2)
        ev_ms = spin_ms(lambda: kern(st), 3)
        plain_ms = cuda_ms(lambda: plain(pst), 1, warm=0)
        if counter == "sgd_epoch":
            bound_ms, by = sgd_bound(wide.X, order)
        else:
            b0 = st["beta"].clone()
            kern(st)
            bound_ms, by = dcd_bound(wide.X, order.numel(),
                                     int((st["beta"] != b0).sum()))
        n = order.numel()
        prof = f"{dev_ms:.4f} ms (profiler)" if dev_ms else \
            "not measured by the profiler (the trace held no kernel record)"
        say("3b", f"{counter} at m {BASE_WIDE_M} x d {wide.d}: {ms:.4f} ms "
                  f"per epoch ({ms * 1e6 / n:.1f} ns per step); device "
                  f"{ev_ms:.4f} ms (CUDA events behind a spin), {prof}; "
                  f"plain version on the card {plain_ms:.4f} ms; bound "
                  f"{bound_ms:.4f} ms ({by})")
        rows[counter] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=by, device_ms=dev_ms or ev_ms)
    # real-sim's full size: bit for bit, then the A/B
    gen = torch.Generator().manual_seed(5)
    m, d = full.m, full.d
    z = lambda *s: torch.zeros(s, device=dev)  # noqa: E731
    order = torch.randperm(m, generator=gen).to(device=dev,
                                                dtype=torch.int32)
    mb = -(-m // P)
    prows = shard_rows(torch.stack([torch.randperm(mb, generator=gen)
                                    for _ in range(P)]).to(dev), m, 1)
    xn = _row_norms2(full.X)
    big = f"real-sim's full size m {m} x d {d}"
    say_plan(big, "sgd", ops.sgd_epoch_route(d, 1, **lim))
    say_plan(big, "dcd", ops.dcd_epoch_route(d, **lim))
    sgd_st = lambda q: dict(w=z(q, d), acc=z(q, d))  # noqa: E731
    full_cases = (
        ("sgd_epoch", "sgd", order.reshape(1, m), sgd_st(1)),
        ("sgd_epoch", f"psgd, {P} workers", prows, sgd_st(P)),
        ("dcd_epoch", "dcd", order, dict(w=z(d), beta=z(m))))
    for counter, label, o, st0 in full_cases:
        if counter == "sgd_epoch":
            kern = lambda st, o=o: ops.sgd_epoch(  # noqa: E731
                full.X, full.y, o, st["w"], st["acc"], BASE_ETA0, SEC5_LAM,
                loss_name="hinge", reg_name="l2")
            plain = lambda st, o=o: kb.sgd_epoch_plain(  # noqa: E731
                full.X, full.y, o, st["w"], st["acc"], BASE_ETA0, SEC5_LAM,
                "hinge", "l2", 1)
        else:
            kern = lambda st: ops.dcd_epoch(  # noqa: E731
                full.X, full.y, order, st["w"], st["beta"], SEC5_LAM, xn)
            plain = lambda st: kb.dcd_epoch_plain(  # noqa: E731
                full.X, full.y, order, st["w"], st["beta"], SEC5_LAM, xn)
        worst[counter] = max(worst[counter], check_epoch_case(
            f"{big} {label}", kern, plain, st0, counter))
    # A/B: the cluster kernels (the plan, then each cluster size) against
    # the one-block kernels, in turns; launched directly, uncounted
    out = z(16 * P)

    def sgd_new(o, q, plan):
        return lambda: kb.launch_sgd_epoch(
            full.X, full.y, o, z(q, d), z(q, d), BASE_ETA0, SEC5_LAM,
            "hinge", "l2", 1, plan=plan)

    def sgd_old(o, q):
        return lambda: kb.launch_sgd_epoch_one_block(
            full.X, full.y, o, z(q, d), z(q, d), BASE_ETA0, SEC5_LAM,
            "hinge", "l2", 1)

    beta = z(m)

    def dcd_new(plan):
        return lambda: kb.launch_dcd_epoch(full.X, full.y, order, z(d),
                                           beta.zero_(), SEC5_LAM, xn,
                                           plan=plan)

    def dcd_old():
        return lambda: kb.launch_dcd_epoch_one_block(
            full.X, full.y, order, z(d), beta.zero_(), SEC5_LAM, xn)

    ab = {}
    for label, new, old, steps in (
            ("sgd", lambda p_: sgd_new(order.reshape(1, m), 1, p_),
             sgd_old(order.reshape(1, m), 1), m),
            (f"psgd, {P} workers", lambda p_: sgd_new(prows, P, p_),
             sgd_old(prows, P), prows.shape[1]),
            ("dcd", dcd_new, dcd_old(), m)):
        kind = "dcd" if label == "dcd" else "sgd"
        plan = kb.epoch_plan(kind, d, 1, **lim)
        turns = [spin_ms(f, 1) for f in (new(plan), old, old, new(plan))]
        t_new, t_old = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        ab[label] = (t_new, t_old)
        say("3b", f"A/B {label} at {big}, in turns (new, old, old, new): "
                  + ", ".join(f"{t:.3f}" for t in turns) + f" ms; cluster "
                  f"plan ({plan.cluster} x {plan.width}) {t_new:.3f} ms "
                  f"per epoch ({t_new * 1e6 / steps:.1f} ns per step), one "
                  f"block {t_old:.3f} ms ({t_old * 1e6 / steps:.1f}): "
                  f"{t_old / t_new:.2f}x")
        for c in BASE_AB_CLUSTERS:
            pc = kb.epoch_plan(kind, d, 1, cluster=c, **lim)
            t = spin_ms(new(pc), 1)
            say("3b", f"A/B {label}: cluster {c} x width {pc.width} "
                      f"{t:.3f} ms per epoch ({t * 1e6 / steps:.1f} ns per "
                      f"step)")
    for c in BASE_AB_CLUSTERS:
        t = spin_ms(lambda: kb.launch_exchange_floor(c, 1, m, out), 1)
        say("3b", f"exchange-only floor, cluster {c}: {t * 1e6 / m:.1f} ns "
                  f"per step ({t:.3f} ms for real-sim's {m} steps)")
    bound_ms, by = sgd_bound(full.X, order.reshape(1, m))
    say("3b", f"bound at {big}: {bound_ms:.4f} ms ({by}; X read once: 4 m d "
              f"/ 3.35 TB/s = {4 * m * d / HBM_BYTES_S * 1e3:.4f} ms)")
    return rows, worst


def sec5_runs(prob, dev, hinge):
    """Phase 10's methods on ``prob``: (name, fn, counter) with ``fn()``
    returning the history; DCD for hinge only."""
    from repro_torch.baselines.bmrm import run_bmrm
    from repro_torch.baselines.dcd import run_dcd
    from repro_torch.baselines.psgd import run_psgd
    from repro_torch.baselines.sgd import run_sgd
    from repro_torch.core.dso import run_dso_grid
    E = SEC5_EPOCHS
    a0 = 0.0 if hinge else 0.0005              # App. B logistic init
    runs = [("dso", lambda: run_dso_grid(
                prob, p=P, epochs=E["dso"], eta0=0.5, alpha0=a0,
                impl="auto", device=dev)[2], "dso_sparse_block_step"),
            ("sgd", lambda: run_sgd(prob, epochs=E["sgd"], eta0=BASE_ETA0,
                                    device=dev)[1], "sgd_epoch"),
            ("psgd", lambda: run_psgd(prob, p=P, epochs=E["psgd"],
                                      eta0=BASE_ETA0, device=dev)[1],
             "sgd_epoch"),
            ("bmrm", lambda: run_bmrm(prob, iters=E["bmrm"],
                                      device=dev)[1], None)]
    if hinge:
        runs.insert(1, ("dcd", lambda: run_dcd(prob, epochs=E["dcd"],
                                               device=dev)[2], "dcd_epoch"))
    return runs


def phase_sec5(dev, full):
    """Phase 10: the paper's Sec.-5 comparison on the card at real-sim's
    full size (phase 4's CSR as a dense Problem, lam 1e-4), hinge and
    logistic: DSO (``run_dso_grid(impl="auto")``, p 4: the block-ELL
    kernel, row 1), SGD, PSGD (p 4), BMRM and DCD (hinge), cut to
    ``SEC5_EPOCHS``; each run in its own launch-count window; every
    method's primal finite and falling from its first evaluation to its
    last.  Returns the launches of the two baseline kernels."""
    import numpy as np
    from repro_torch.baselines.bmrm import run_bmrm
    launches = {"sgd_epoch": 0, "dcd_epoch": 0}
    say(10, f"cuts: {SEC5_EPOCHS} (epochs; BMRM iterations) at m {full.m} "
            f"x d {full.d}, lam {SEC5_LAM}")
    for loss in ("hinge", "logistic"):
        prob = full._replace(loss_name=loss)
        out = {}
        for name, fn, counter in sec5_runs(prob, dev, loss == "hinge"):
            n = SEC5_EPOCHS[name]
            t = time.perf_counter()
            hist, counts = counted(fn)
            wall = time.perf_counter() - t
            want = {counter: n * (P if name == "dso" else 1)} \
                if counter else {}
            check_counts(10, counts, want)
            if counter in launches:
                launches[counter] += counts[counter]
            primal = [h["primal"] for h in hist]
            check(all(np.isfinite(primal)) and primal[-1] < primal[0],
                  f"{loss} {name}: primal not finite or not falling: "
                  f"{primal}")
            out[name] = (primal[-1], wall / n)
            say(10, f"{loss} {name}: primal " + " ".join(
                f"e{h['epoch']}={h['primal']:.9f}" for h in hist)
                + f"; {wall / n:.4f} s per "
                + ("iteration" if name == "bmrm" else "epoch")
                + (" (grid set-up included)" if name == "dso" else ""))
        if loss == "hinge":
            _, _, kernels = device_split(
                lambda: run_bmrm(prob, iters=1, device=dev))
            say(10, f"BMRM launches per iteration (profiler, iters=1: "
                    f"X @ w, X.T @ g, 300 EG steps, the primal): "
                    f"{sum(c for _, _, c in kernels)} kernel launches of "
                    f"{len(kernels)} kinds")
        ref = out.get("dcd", (None,))[0]
        say(10, f"{loss} lam {SEC5_LAM:g}: " + "  ".join(
            f"{k.upper()}={p:.9f} ({s:.4f} s"
            + (f", gap to DCD {p - ref:+.3e})" if ref is not None else ")")
            for k, (p, s) in out.items()))
    return launches


# ------------------------------------------- runtime, health, obs, switch --


def check_counts(phase, counts, want):
    """The launch counts of a run must equal the design ``want`` on the
    counters it names and be 0 on every other counter but the probe's
    (cached per device, so it may or may not run again)."""
    got = {k: v for k, v in counts.items() if v and k != "sparse_probe"}
    want = {k: v for k, v in want.items() if v}
    say(phase, f"launch counts {got} (design {want})")
    check(got == want, f"launch counts {got} != design {want}")


def counted(fn):
    """``fn()`` with the launch counts set to 0 just before it and read
    just after: (result, counts)."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, ops.launch_counts()


def grid_on(grid, dev):
    """A copy of a grid with every tensor field on ``dev`` (host arrays
    and the per-bucket rectangles as they are)."""
    import torch
    return grid._replace(**{k: v.to(dev) for k, v in grid._asdict().items()
                            if isinstance(v, torch.Tensor)})


def grid_kw(ctx, cfg, dev):
    """``solve`` keywords for a phase's pre-built grid."""
    d = OCR_D if ctx["layout"] == "dense" else ctx["csr"].d
    return dict(p=P, eta0=cfg.eta0, loss_name=ctx["loss"], reg_name="l2",
                lam=ctx["lam"], m=ctx["m"], d=d, alpha0=cfg.alpha0,
                device=dev)


def save_seconds(state, key, cfg, tmp, async_writes, reps=3):
    """Host seconds of ``SnapshotStore.save`` (median of ``reps``; async:
    the call alone, then its ``flush``) and the file's bytes."""
    import os
    from repro_torch.runtime import SnapshotStore
    store = SnapshotStore(os.path.join(tmp, f"save_{int(async_writes)}"),
                          async_writes=async_writes)
    calls, flushes = [], []
    for ep in range(1, reps + 1):
        t = time.perf_counter()
        path = store.save(state=state, key=key, epochs_done=ep, history=[],
                          config=cfg)
        calls.append(time.perf_counter() - t)
        t = time.perf_counter()
        store.flush()
        flushes.append(time.perf_counter() - t)
    calls.sort()
    flushes.sort()
    return calls[reps // 2], flushes[reps // 2], os.path.getsize(path)


def phase_runtime(dev, cells):
    """Phase 8r: the elastic runtime on the card.  For each cell (a phase's
    grid and configuration): 10 epochs with ``checkpoint_every=2`` into an
    async ``SnapshotStore`` (every file must pass ``verify_pytree``), a
    second uninterrupted run (their max|d| is the atomics' own noise), a
    run stopped at epoch 6 and continued by ``runtime.resume`` (w and
    alpha within 1e-5 of the uninterrupted run's); each run in its own
    launch-count window.  Then the snapshot's bytes and the host seconds
    of ``save()`` with and without ``async_writes``.  Returns per cell the
    snapshot store and the numbers."""
    import os
    import tempfile
    import torch
    from repro_torch.engine import solve
    from repro_torch.runtime import SnapshotStore, resume, verify_pytree
    out = {}
    for name, (ctx, cfg, counter) in cells.items():
        kw = grid_kw(ctx, cfg, dev)
        n_step = EPOCHS * P
        design = {counter: n_step}
        if counter == "dso_block_step":
            design["dso_primal_update"] = n_step
        tmp = tempfile.mkdtemp(prefix="chip_smoke_8r_")
        store = SnapshotStore(os.path.join(tmp, "run"), async_writes=True)
        full, counts = counted(lambda: solve(
            ctx["grid"], backend="auto", epochs=EPOCHS, checkpoint_every=2,
            store=store, **kw))
        check_counts("8r", counts, design)
        eps = store.epochs()
        check(eps == [2, 4, 6, 8, 10], f"{name}: snapshots at {eps}")
        for ep in eps:
            check(verify_pytree(store.path(ep)) == "verified",
                  f"{name}: snapshot {ep} does not verify")
        again = solve(ctx["grid"], backend="auto", epochs=EPOCHS, **kw)
        noise_w, _ = max_rel_err(again.w, full.w)
        noise_a, _ = max_rel_err(again.alpha, full.alpha)
        stopped = SnapshotStore(os.path.join(tmp, "stopped"))
        solve(ctx["grid"], backend="auto", epochs=6, checkpoint_every=2,
              store=stopped, **kw)
        res, counts = counted(lambda: resume(
            ctx["grid"], stopped, epochs=EPOCHS, device=dev))
        check_counts("8r", counts, {k: v * 4 // EPOCHS
                                    for k, v in design.items()})
        e_w, ok_w = max_rel_err(res.w, full.w)
        e_a, ok_a = max_rel_err(res.alpha, full.alpha)
        say("8r", f"{name}: snapshots at {eps}, every file verified; "
                  f"resumed at 6 -> {EPOCHS} vs uninterrupted: max|d| w "
                  f"{e_w:.3e} alpha {e_a:.3e} (two uninterrupted runs: w "
                  f"{noise_w:.3e} alpha {noise_a:.3e})")
        check(ok_w and ok_a, f"{name}: the resumed run differs from the "
                             f"uninterrupted one by {max(e_w, e_a):.3e}")
        snap = store.load()
        sync_s, _, nbytes = save_seconds(full.state, snap.key, snap.config,
                                         tmp, False)
        call_s, flush_s, _ = save_seconds(full.state, snap.key, snap.config,
                                          tmp, True)
        say("8r", f"{name}: snapshot {nbytes} B; save() host s: sync "
                  f"{sync_s:.4f}, async call {call_s:.4f} (the copy off the "
                  f"card) + flush {flush_s:.4f}")
        out[name] = dict(store=store, full=full, bytes=nbytes,
                         sync_s=sync_s, async_s=call_s, flush_s=flush_s,
                         resume_err=max(e_w, e_a),
                         noise=max(noise_w, noise_a))
    return out


HEALTH_EPOCHS = 20
#: the rollback's eta backoffs: the first is held to 1e-3 of the clean run's
#: final primal; the others are measured (0.7 ends 2.4e-3 off after 20
#: epochs at real-sim's size: AdaGrad is far from converged there)
HEALTH_DECAYS = (0.9, 0.7)


def phase_health(dev, ctx, cfg):
    """Phase 8h: a ``NaNInjector`` poisons w block 1 entering epoch 4 of
    the svm-real-sim run (``HEALTH_EPOCHS`` epochs); the guard must roll
    back to the snapshot at 4 with the step size backed off by each of
    ``HEALTH_DECAYS``, and with the first the final primal land within
    1e-3 relative of the clean run's.  Then ``max_retries=0`` with
    ``on_exhausted="serial"`` on ``make_classification(m 2,000, d 500,
    density 0.05)`` must degrade to ``solve_serial`` and its kernel."""
    import os
    import tempfile
    import torch
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import make_csr_primal_eval, solve
    from repro_torch.runtime import (HealthGuard, NaNInjector,
                                     SnapshotStore, render_ledger)
    kw = grid_kw(ctx, cfg, dev)
    hook = make_csr_primal_eval(ctx["csr"], ctx["y"], ctx["lam"],
                                ctx["loss"], "l2", device=dev)
    kw.update(backend="auto", epochs=HEALTH_EPOCHS, eval_every=EVAL_EVERY,
              eval_hook=hook)
    clean = solve(ctx["grid"], **kw)
    b = clean.history[-1]["primal"]
    rels = {}
    for decay in HEALTH_DECAYS:
        guard = HealthGuard(eta_decay=decay,
                            injector=NaNInjector({4: ("w", 1)}))
        store = SnapshotStore(tempfile.mkdtemp(prefix="chip_smoke_8h_"))
        res, counts = counted(lambda: solve(
            ctx["grid"], checkpoint_every=2, store=store, health=guard,
            **kw))
        # epochs 0-6, the rollback to 4, then 4-20: two epochs run twice
        check_counts("8h", counts,
                     {"dso_sparse_block_step": (HEALTH_EPOCHS + 2) * P})
        say("8h", f"eta_decay {decay} ledger:\n"
                  + render_ledger(guard.ledger))
        ev = guard.ledger
        check(len(ev) == 1 and ev[0]["action"] == "rollback"
              and ev[0]["resumed_from"] == 4 and ev[0]["epochs_lost"] == 2
              and abs(ev[0]["eta0"] - cfg.eta0 * decay) < 1e-12,
              f"unexpected ledger {[e.to_dict() for e in ev]}")
        check(torch.isfinite(res.w).all(), "non-finite w after rollback")
        a = res.history[-1]["primal"]
        rels[decay] = abs(a - b) / abs(b)
        say("8h", f"eta_decay {decay}: final primal after the rollback "
                  f"{a:.8f}, clean run {b:.8f}: rel {rels[decay]:.3e}")
    rel = rels[HEALTH_DECAYS[0]]
    check(rel <= 1e-3, f"the rolled-back run (eta_decay "
                       f"{HEALTH_DECAYS[0]}) ends {rel:.3e} off the clean "
                       f"run (bound 1e-3)")
    prob = make_classification(**SERIAL_SHAPE, seed=22, device=dev)
    guard = HealthGuard(max_retries=0, on_exhausted="serial",
                        injector=NaNInjector({0: ("w", 0)}))
    res, counts = counted(lambda: solve(
        prob, backend="auto", p=P, epochs=SERIAL_EPOCHS, eta0=0.5,
        eval_every=1, checkpoint_every=1,
        store=SnapshotStore(tempfile.mkdtemp(prefix="chip_smoke_8h_")),
        health=guard, device=dev))
    check([e["action"] for e in guard.ledger] == ["degrade_serial"],
          f"ledger {[e.to_dict() for e in guard.ledger]}")
    # the poisoned first epoch on auto's grid kernel, then the serial run
    grid_runs = {k: v for k, v in counts.items()
                 if v and k not in ("dso_serial_epoch", "sparse_probe")}
    check(list(grid_runs.values()) == [P],
          f"the first epoch's launches {grid_runs}, expected {P} of one "
          f"block-step kernel")
    check_counts("8h", counts, dict(grid_runs,
                                    dso_serial_epoch=SERIAL_EPOCHS))
    check(res.state is None and torch.isfinite(res.w).all()
          and len(res.history) == SERIAL_EPOCHS,
          "the degraded run is not solve_serial's")
    say("8h", f"exhausted -> degrade_serial: solve_serial ran "
              f"{counts['dso_serial_epoch']} serial epochs; final primal "
              f"{res.history[-1]['primal']:.6f}")
    return dict(rel=rel)


CLAMP_EPOCHS = 3
# 8c: the kernels' alpha may lie this many times as far from the float64
# plain twin's as the float32 plain twin's does
CLAMP_ALPHA_FACTOR = 3


def phase_clamp(dev, ctx, cfg):
    """Phase 8c: ``solve(init=)`` on a phase's grid from a state whose w
    lies at twice its box's upper edge, ``CLAMP_EPOCHS`` epochs through the
    kernels against the plain twin on the card.  The first epoch's block
    steps must take launch A alone and launch B on every column
    (``TileBackend.clamp_step``: one of each per row tile and inner
    iteration), the later ones the folded step.  w, the solution, must
    lie within 1e-5 (``max_rel_err``) of the plain twin's.  alpha is held
    against a float64 plain twin (``run_epochs`` on a float64 copy of the
    grid and the state, the same visit orders and step sizes): the
    kernels' max|d| from it must be within max(TOL, CLAMP_ALPHA_FACTOR x
    the float32 plain twin's own), since with every margin that large the
    dual step amplifies the order of the sums in the plain version too.
    Beside it, the kernels' alpha from w at the box's edge (the folded
    step throughout) and the folded step from the start (the route
    before the entering state was checked)."""
    import numpy as np
    import torch
    from repro_torch.core.losses import w_bounds
    from repro_torch.engine import get_backend, init_state_data, solve
    from repro_torch.engine.backends import resolve_backend_for_layout
    from repro_torch.engine.data import eta_schedule
    from repro_torch.engine.driver import run_epochs
    from repro_torch.engine.schedules import cyclic_perms
    from repro_torch.runtime.snapshot import DSOSnapshot
    grid, layout = ctx["grid"], ctx["layout"]
    w_lo, w_hi = w_bounds(ctx["loss"], ctx["lam"])
    fresh = init_state_data(ctx["loss"], grid, cfg.alpha0)
    kw = dict(grid_kw(ctx, cfg, dev), epochs=CLAMP_EPOCHS)

    def run(backend, w):
        snap = DSOSnapshot(fresh._replace(w_grid=torch.full_like(
            fresh.w_grid, w)), torch.Generator().manual_seed(0), 0, (), {})
        return counted(lambda: solve(grid, backend=backend, init=snap,
                                     **kw))

    def f64(v):
        if isinstance(v, tuple):
            return tuple(f64(x) for x in v)
        return v.double() if isinstance(v, torch.Tensor) \
            and v.is_floating_point() else v
    kern, counts = run("auto", 2 * w_hi)
    check_counts("8c", counts, {ctx["counter"]: CLAMP_EPOCHS * P,
                                "dso_primal_update": P})
    plain, _ = run("jnp", 2 * w_hi)
    exact = run_epochs(   # solve's cyclic orders and AdaGrad step sizes
        grid._replace(**{k: f64(v) for k, v in grid._asdict().items()}),
        fresh._replace(**{k: f64(v) for k, v in fresh._asdict().items()
                          if k != "w_grid"},
                       w_grid=torch.full_like(fresh.w_grid, 2 * w_hi,
                                              dtype=torch.float64)),
        cyclic_perms(CLAMP_EPOCHS, P),
        eta_schedule(cfg.eta0, 0, CLAMP_EPOCHS, True),
        float(np.float32(ctx["lam"])), float(np.float32(ctx["m"])), w_lo,
        w_hi, backend=resolve_backend_for_layout("jnp", layout,
                                                 device_type="cuda"),
        loss_name=ctx["loss"], reg_name="l2")
    be = resolve_backend_for_layout("auto", layout, device_type="cuda")
    folded, _ = run(get_backend(be)._replace(clamp_step=None), 2 * w_hi)
    edge, counts = run("auto", w_hi)
    check_counts("8c", counts, {ctx["counter"]: CLAMP_EPOCHS * P})
    edge_plain, _ = run("jnp", w_hi)
    e_w, ok_w = max_rel_err(kern.w, plain.w)
    e_a, _ = max_rel_err(kern.alpha, plain.alpha)
    e_f, ok_f = max_rel_err(folded.w, plain.w)
    e_ea, _ = max_rel_err(edge.alpha, edge_plain.alpha)
    e_k64 = float((kern.state.alpha.double() - exact.alpha).abs().max())
    e_p64 = float((plain.state.alpha.double() - exact.alpha).abs().max())
    lim_a = max(TOL, CLAMP_ALPHA_FACTOR * e_p64)
    say("8c", f"{cfg.loss}-{cfg.dataset} ({layout}, {ctx['counter']}): "
              f"solve(init=) from w = 2 w_hi ({2 * w_hi:.4f}), "
              f"{CLAMP_EPOCHS} epochs: kernels vs plain twin max|d| w "
              f"{e_w:.3e} alpha {e_a:.3e}; alpha vs the float64 plain twin: "
              f"kernels {e_k64:.3e}, float32 plain twin {e_p64:.3e} (limit "
              f"{lim_a:.3e}); from w = w_hi (the folded step throughout) "
              f"alpha {e_ea:.3e}; the folded step from 2 w_hi: w {e_f:.3e} "
              f"(within 1e-5: {ok_f}); max w {float(kern.w.max()):.4f}, "
              f"folded {float(folded.w.max()):.4f}")
    check(ok_w, f"8c: solve(init=) from outside the box is off the plain "
                f"twin: w {e_w:.3e}")
    check(e_k64 <= lim_a, f"8c: alpha from outside the box is {e_k64:.3e} "
                          f"off the float64 plain twin (limit {lim_a:.3e})")
    return dict(ctx=ctx, cfg=cfg, state=fresh._replace(
        w_grid=torch.full_like(fresh.w_grid, 2 * w_hi)), kern=kern,
        exact_alpha=exact.alpha, lim_a=lim_a)


def ring_clamp(mesh, clamps, dev):
    """Phase 8c's ring (run in 9r's pool, whose workers it needs): on each
    of 8c's grids, ``ShardedDSO.restore`` of 8c's entering state (w at
    twice its box's upper edge), ``CLAMP_EPOCHS`` epochs.  Every worker's
    first epoch must take ``clamp_step`` (per worker 8c's launches: launch
    A alone and launch B on every column per inner iteration, then the
    folded step).  w must lie within 1e-5 of ``solve(init=)``'s from the
    same state; alpha on the block-ELL route too, on the bucketed routes
    within 8c's limit of the float64 plain twin."""
    from repro_torch.core.dso_dist import ShardedDSO
    for name, c in clamps.items():
        ctx, cfg = c["ctx"], c["cfg"]
        g = grid_kw(ctx, cfg, dev)
        opt = ShardedDSO(ctx["grid"], mesh, impl="auto", alpha0=cfg.alpha0,
                         seed=0, **{k: g[k] for k in ("loss_name", "reg_name",
                                                      "lam", "m", "d")})
        opt.restore(c["state"])
        mesh.reset_launch_counts()
        opt.run_epochs(CLAMP_EPOCHS, cfg.eta0)
        opt.wait()
        ring_counts("8c", mesh.launch_counts(),
                    {ctx["counter"]: CLAMP_EPOCHS * P,
                     "dso_primal_update": P})
        w, alpha = opt.w_full(), opt.alpha_full()
        e_w, ok_w = max_rel_err(w, c["kern"].w)
        e_a, ok_a = max_rel_err(alpha, c["kern"].alpha)
        e_64 = float((alpha.double() - c["exact_alpha"].reshape(-1)[
            :alpha.numel()]).abs().max())
        ell = ctx["layout"] == "sparse"
        say("8c", f"{name} ({ctx['layout']}): the ring restored from w = 2 "
                  f"w_hi, {CLAMP_EPOCHS} epochs, vs solve(init=) from the "
                  f"same state: max|d| w {e_w:.3e} alpha {e_a:.3e}; alpha vs "
                  f"the float64 plain twin {e_64:.3e} (limit "
                  f"{c['lim_a']:.3e}); max w {float(w.max()):.4f}")
        check(ok_w and (ok_a if ell else e_64 <= c["lim_a"]),
              f"8c: the ring from outside the box is off: w {e_w:.3e}, "
              f"alpha {e_a:.3e} (float64 twin {e_64:.3e})")
        del opt


def phase_reshard(dev, ctx, cfg, snap_store):
    """Phase 8s: p 4 -> 4 on svm-real-sim must give the same grid arrays
    and the same state exactly; p 4 -> 2 through ``reshard`` (the grid
    re-tiled on the host: ``regrid_direct`` when the padded sizes agree,
    else ``grid_to_csr`` and the tiler) from phase 8r's last snapshot, then
    4 more epochs on the card, whose primal must fall below the
    snapshot's and at every evaluation."""
    import torch
    from repro_torch.engine import make_csr_primal_eval, solve
    from repro_torch.runtime import reshard, reshard_state, retile
    grid, m, d = ctx["grid"], ctx["m"], ctx["csr"].d
    snap = snap_store.load()
    same = retile(grid, m, d, P)
    st = reshard_state(snap.state, m, d, P)
    check(grids_equal(same, grid), "p 4 -> 4 changed the grid")
    check(all(torch.equal(getattr(st, f), getattr(snap.state, f))
              for f in ("w_grid", "gw_grid", "alpha", "ga")),
          "p 4 -> 4 changed the state")
    t = time.perf_counter()
    snap2, grid2 = reshard(snap, 2, data=grid)
    retile_s = time.perf_counter() - t
    hook = make_csr_primal_eval(ctx["csr"], ctx["y"], ctx["lam"],
                                ctx["loss"], "l2", device=dev)
    start = hook.primal(snap.state.w_grid.reshape(-1)[:d].to(dev))
    kw = grid_kw(ctx, cfg, dev)
    kw.update(p=2, epochs=snap.epochs_done + 4, eval_every=2,
              eval_hook=hook)
    res, counts = counted(lambda: solve(grid2, backend="auto", init=snap2,
                                        **kw))
    check_counts("8s", counts, {"dso_sparse_block_step": 4 * 2})
    primal = [float(start)] + [h["primal"] for h in res.history]
    say("8s", f"p 4 -> 4: grid and state unchanged; p 4 -> 2 at epoch "
              f"{snap.epochs_done}: retile on the host {retile_s:.2f} s "
              f"(mb {grid2.mb}, db {grid2.db}, K {grid2.K}); primal "
              + " ".join(f"{v:.6f}" for v in primal))
    check(all(b < a for a, b in zip(primal, primal[1:])),
          f"the primal did not fall after the reshard: {primal}")
    return dict(retile_s=retile_s)


def timed_solve(fn, reps=3):
    """Median host seconds of ``fn()`` (synchronised) over ``reps``, after
    one unrecorded call."""
    import torch
    fn()
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return sorted(ts)[reps // 2]


def phase_obs(dev, ctx, cfg):
    """Phase 8o: obs and telemetry on logistic-real-sim (the shared
    route).  A ``RunRecorder`` on ``solve`` (span order, the nnz/s and
    eval.primal gauges); a ``TelemetrySpec`` (rows and nnz equal to the
    tile statistics exactly, nonfinite 0, dw_norm and dalpha_norm within
    1e-5 of the same run's plain twin on a CPU copy of the grid, w within
    1e-5 of the run without telemetry); then s/epoch of ``solve`` (10
    epochs, primal every 2) with telemetry and obs each on and off."""
    import numpy as np
    import torch
    from repro_torch.engine import make_csr_primal_eval, solve
    from repro_torch.engine.schedules import cyclic_perms
    from repro_torch.obs import RunRecorder, TelemetrySpec
    grid = ctx["grid"]
    hook = make_csr_primal_eval(ctx["csr"], ctx["y"], ctx["lam"],
                                ctx["loss"], "l2", device=dev)
    kw = grid_kw(ctx, cfg, dev)
    kw.update(backend="auto", epochs=EPOCHS, eval_every=EVAL_EVERY,
              eval_hook=hook)
    rec = RunRecorder(profiler_annotations=True)
    off = solve(grid, **kw)
    on, counts = counted(lambda: solve(grid, obs=rec, **kw))
    check_counts("8o", counts, {ctx["counter"]: EPOCHS * P})
    spans = [e["name"] for e in rec.events if e["type"] == "span"]
    check(spans == ["epoch_chunk", "eval"] * (EPOCHS // EVAL_EVERY),
          f"span order {spans}")
    g = {e["name"]: e["value"] for e in rec.events if e["type"] == "metric"}
    e_w, ok = max_rel_err(on.w, off.w)
    say("8o", f"RunRecorder: {len(rec.events)} events, spans "
              f"{spans[:4]}... x{EPOCHS // EVAL_EVERY}; last nnz_per_s "
              f"{g['nnz_per_s']:.4e}, eval.primal {g['eval.primal']:.6f}; "
              f"obs on vs off: max|d| w {e_w:.3e}")
    check(ok and np.isfinite(g["eval.primal"]), "obs changed the run")
    spec = TelemetrySpec()
    tel, counts = counted(lambda: solve(grid, telemetry=spec, **kw))
    check_counts("8o", counts, {ctx["counter"]: EPOCHS * P})
    buf = np.concatenate([c.buf for c in spec.chunks])   # (E, p, p, F)
    trn = grid.tile_row_nnz_g.cpu().numpy()
    perm = cyclic_perms(1, P)[0].numpy()
    want_rows = np.stack([[(trn[q, perm[r, q]] > 0).sum() for q in range(P)]
                          for r in range(P)])
    want_nnz = np.stack([[trn[q, perm[r, q]].sum() for q in range(P)]
                         for r in range(P)])
    check(np.array_equal(buf[..., 2], np.broadcast_to(want_rows,
                                                      buf.shape[:3]))
          and np.array_equal(buf[..., 3], np.broadcast_to(want_nnz,
                                                          buf.shape[:3])),
          "telemetry rows/nnz differ from the tile statistics")
    check(spec.nonfinite_total() == 0, "telemetry saw a nonfinite value")
    cpu_spec = TelemetrySpec()
    cpu_kw = dict(kw, device="cpu", backend="sparse_bucketed_jnp",
                  eval_hook=None)
    solve(grid_on(grid, torch.device("cpu")), telemetry=cpu_spec, **cpu_kw)
    cbuf = torch.tensor(np.concatenate([c.buf for c in cpu_spec.chunks]))
    e_n, ok_n = max_rel_err(torch.tensor(buf[..., :2]), cbuf[..., :2])
    e_t, ok_t = max_rel_err(tel.w, off.w)
    say("8o", f"TelemetrySpec: {len(spec.chunks)} chunks of {buf.shape[1:]}"
              f"; rows/nnz equal the tile statistics; nonfinite 0; "
              f"dw_norm/dalpha_norm vs the plain twin on a CPU copy: "
              f"max|d| {e_n:.3e} (mean dw_norm {buf[..., 0].mean():.4e}); "
              f"telemetry on vs off: max|d| w {e_t:.3e}")
    check(ok_n and ok_t, "telemetry norms or trajectory off by > 1e-5")
    times = {}
    for label, extra in (("off", {}),
                         ("telemetry", {"telemetry": None}),
                         ("obs", {"obs": None})):
        def run(extra=extra):
            x = dict(extra)
            if "telemetry" in x:
                x["telemetry"] = TelemetrySpec()
            if "obs" in x:
                x["obs"] = RunRecorder()
            solve(grid, **kw, **x)
        times[label] = timed_solve(run) / EPOCHS
    say("8o", "solve s/epoch (10 epochs, primal every 2, median of 3): "
              + ", ".join(f"{k} {v:.6f}" for k, v in times.items()))
    return times


def phase_switch(dev, ctx, cfg):
    """Phase 8w: the legacy bucket switch on logistic-real-sim:
    ``sparse_bucketed_pallas_switch`` (the block-ELL kernel on each active
    tile's bucket rectangle, one launch per processor and inner
    iteration) against ``sparse_bucketed_pallas`` and against
    ``sparse_bucketed_jnp_switch`` on the card, w within 1e-5; launches
    per epoch and s/epoch of each."""
    from repro_torch.engine import solve
    grid = ctx["grid"]
    kw = grid_kw(ctx, cfg, dev)
    kw.update(epochs=EPOCHS, eval_hook=None)
    runs, out = {}, {}
    for name, design in (
            ("sparse_bucketed_pallas_switch",
             {"dso_sparse_block_step": EPOCHS * P * P}),
            ("sparse_bucketed_pallas", {ctx["counter"]: EPOCHS * P}),
            ("sparse_bucketed_jnp_switch", {})):
        res, counts = counted(lambda: solve(grid, backend=name, **kw))
        check_counts("8w", counts, design)
        runs[name] = res
        sec = timed_solve(lambda: solve(grid, backend=name, **kw)) / EPOCHS
        out[name] = dict(launches_per_epoch=sum(design.values()) / EPOCHS,
                         s_per_epoch=sec)
        say("8w", f"{name}: {sum(design.values()) // EPOCHS} launches per "
                  f"epoch, s/epoch {sec:.6f}")
    sw = runs["sparse_bucketed_pallas_switch"]
    for other in ("sparse_bucketed_pallas", "sparse_bucketed_jnp_switch"):
        err, ok = max_rel_err(sw.w, runs[other].w)
        say("8w", f"pallas_switch vs {other}: max|d| w {err:.3e}")
        check(ok, f"the switch differs from {other} by {err:.3e}")
    return out


RING_P = 4          # phase 9r's workers, all on the one card


def ring_counts(phase, per_worker, design):
    """Each ring worker's launch counts must equal ``design`` on the
    counters it names and be 0 on every other but the probe's (each
    worker probes once).  Returns the counts summed over the workers."""
    for q, counts in enumerate(per_worker):
        got = {k: v for k, v in counts.items() if v and k != "sparse_probe"}
        check(got == design, f"ring worker {q}: launch counts {got} != "
                             f"design {design}")
    total = {k: sum(c[k] for c in per_worker) for k in per_worker[0]}
    say(phase, f"block-step launches per worker {design} (x{RING_P} "
               f"workers; probes {total.get('sparse_probe', 0)})")
    return total


def phase_ring(dev, cells, clamps=None):
    """Phase 9r: the sharded ring (``core.dso_dist.ShardedDSO``) with
    ``RING_P`` worker processes on the one card, gloo with host-staged
    blocks, on phase 4's, 5n's and 5d's data at full width, 10 epochs.
    Per cell: cyclic and lpt against the grid ``solve`` (w and alpha
    within 1e-5); the overlapped ring against the serial one and p2p
    against all-gather, held to 1e-5 beside two ring runs' atomics noise;
    the main ring run in its own launch-count window on every worker;
    s/epoch beside the grid's, the transport's share of the epoch and the
    bytes moved per epoch.  Then a supervised run on svm-real-sim with a
    crash at epoch 3 (checkpoint every 2) against the uninterrupted ring,
    and a live reshard 4 -> 2 on svm-ocr with the duality gap falling.
    The kernel library is built (phase 2) before any worker starts; the
    workers load it.  The NCCL route runs only with a card per worker.
    ``clamps`` (phase 8c's records) run ``ring_clamp`` in the same pool.
    Returns per cell the main ring run's launch counts over the
    workers."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core.dso_dist import (ShardedDSO, WorkerPool,
                                           make_dso_mesh)
    from repro_torch.engine import solve
    from repro_torch.engine.schedules import cyclic_perms, lpt_latin_square
    from repro_torch.obs.telemetry import comm_bytes_matrix
    from repro_torch.runtime import FaultEvent, SnapshotStore, Supervisor
    out = {}
    t0 = time.perf_counter()
    with WorkerPool(RING_P, timeout=120) as pool:
        mesh = make_dso_mesh(RING_P, device=dev, transport="gloo", pool=pool)
        say("9r", f"{RING_P} workers joined on {dev} (gloo, blocks staged "
                  f"through pinned host memory) in "
                  f"{time.perf_counter() - t0:.1f} s")
        for name, (ctx, cfg, design, src) in cells.items():
            t_cell = time.perf_counter()
            kw = dict(impl="auto", alpha0=cfg.alpha0, seed=0)
            if src is None:          # a grid source: solve's keywords
                src = ctx["grid"]
                g = grid_kw(ctx, cfg, dev)
                kw.update({k: g[k] for k in ("loss_name", "reg_name",
                                             "lam", "m", "d")})

            def ring(schedule="cyclic", **more):
                opt = ShardedDSO(src, mesh, schedule=schedule, **kw, **more)
                opt.run_epochs(EPOCHS, cfg.eta0)
                return opt.wait()

            def grid(schedule):
                return solve(ctx["grid"], backend="auto", schedule=schedule,
                             epochs=EPOCHS, **grid_kw(ctx, cfg, dev))

            mesh.reset_launch_counts()
            cyc = ring()
            out[name] = ring_counts("9r", mesh.launch_counts(), design)
            cyc_w, cyc_a = cyc.w_full(), cyc.alpha_full()
            cyc2 = ring()
            noise_w, _ = max_rel_err(cyc2.w_full(), cyc_w)
            noise_a, _ = max_rel_err(cyc2.alpha_full(), cyc_a)
            del cyc2
            lines = []
            for schedule, opt_w, opt_a in (("cyclic", cyc_w, cyc_a),
                                           ("lpt", None, None)):
                if opt_w is None:
                    lpt = ring("lpt")
                    check(lpt.mode == "p2p", f"lpt runs {lpt.mode}")
                    opt_w, opt_a = lpt.w_full(), lpt.alpha_full()
                    del lpt
                ref = grid(schedule)
                e_w, ok_w = max_rel_err(opt_w, ref.w)
                e_a, ok_a = max_rel_err(opt_a, ref.alpha)
                lines.append(f"{schedule} w {e_w:.3e} alpha {e_a:.3e}")
                check(ok_w and ok_a, f"{name}: the {schedule} ring is "
                                     f"{max(e_w, e_a):.3e} off the grid")
                if schedule == "lpt":
                    lpt_w = opt_w
            say("9r", f"{name}: ring vs grid solve, max|d|: "
                      + "; ".join(lines))
            ser = ring(overlap=False)
            check(ser.mode == "ring_serial", f"serial ring runs {ser.mode}")
            e_s, ok_s = max_rel_err(ser.w_full(), cyc_w)
            del ser
            ag = ring("lpt", comm="allgather")
            e_g, ok_g = max_rel_err(ag.w_full(), lpt_w)
            del ag
            say("9r", f"{name}: overlapped vs serial ring max|d| w "
                      f"{e_s:.3e}; p2p vs all-gather (lpt) w {e_g:.3e}; "
                      f"two ring runs (the atomics' noise): w "
                      f"{noise_w:.3e} alpha {noise_a:.3e}")
            check(ok_s and ok_g, f"{name}: transports differ by "
                                 f"{max(e_s, e_g):.3e}")
            secs = []
            for _ in range(3):
                t = time.perf_counter()
                cyc.run_epochs(EPOCHS, cfg.eta0)
                cyc.wait()
                secs.append((time.perf_counter() - t) / EPOCHS)
            secs.sort()
            share = float(np.mean([c / s for s, c in cyc.last_run]))
            fresh, run = epoch_runner(
                ctx["grid"], cyc.backend.name, loss=ctx["loss"],
                lam=ctx["lam"], m=ctx["m"], alpha0=cfg.alpha0,
                eta0=cfg.eta0)
            g_secs = epoch_seconds(fresh, run)
            ring_b = comm_bytes_matrix(cyclic_perms(1, RING_P).numpy(),
                                       cyc.db, "ring").sum()
            sq = lpt_latin_square(
                ctx["grid"].tile_row_nnz_g.sum(-1).cpu().numpy())[None]
            p2p_b = comm_bytes_matrix(sq, cyc.db, "p2p").sum()
            say("9r", f"{name}: ring s/epoch median {secs[1]:.6f} (min "
                      f"{secs[0]:.6f} max {secs[2]:.6f}, 3 x {EPOCHS} "
                      f"epochs) vs the grid's run_epochs "
                      f"{g_secs[len(g_secs) // 2]:.6f}; transport share of "
                      f"the ring's epoch {share:.3f} (from the step's end: "
                      f"staging copies and gloo, mean over workers); bytes "
                      f"moved per epoch "
                      f"{int(ring_b)} (ring), {int(p2p_b)} (p2p, lpt); "
                      f"cell {time.perf_counter() - t_cell:.1f} s")
            out[name].update(s_per_epoch=secs[1],
                             grid_s_per_epoch=g_secs[len(g_secs) // 2],
                             share=share, ring_bytes=int(ring_b))
            del cyc

        ctx_r, cfg_r, _, _ = cells["svm-real-sim"]
        g = grid_kw(ctx_r, cfg_r, dev)
        kw = dict(impl="auto", alpha0=cfg_r.alpha0, seed=0,
                  **{k: g[k] for k in ("loss_name", "reg_name", "lam", "m",
                                       "d")})
        ref = ShardedDSO(ctx_r["grid"], mesh, **kw)
        ref.run_epochs(EPOCHS, cfg_r.eta0)
        ref_w = ref.w_full()
        again = ShardedDSO(ctx_r["grid"], mesh, **kw)
        again.run_epochs(EPOCHS, cfg_r.eta0)
        noise, _ = max_rel_err(again.w_full(), ref_w)
        del again, ref
        with tempfile.TemporaryDirectory() as tmp:
            sup = Supervisor(SnapshotStore(tmp), checkpoint_every=2,
                             eta0=cfg_r.eta0,
                             fault_plan=(FaultEvent(3, "crash"),))
            opt, log = sup.run_sharded(ctx_r["grid"], EPOCHS, mesh=mesh,
                                       **kw)
            kinds = [(ev.kind, ev.epochs_lost) for ev in log]
            e_c, ok_c = max_rel_err(opt.w_full(), ref_w)
            say("9r", f"supervised svm-real-sim, crash at 3, checkpoint "
                      f"every 2: ledger {kinds}; vs the uninterrupted ring "
                      f"max|d| w {e_c:.3e} (two uninterrupted runs "
                      f"{noise:.3e})")
            check(kinds == [("crash", 1)] and ok_c,
                  f"crash recovery: ledger {kinds}, max|d| {e_c:.3e}")
            del opt
        ctx, cfg, _, prob = cells["svm-ocr"]
        with tempfile.TemporaryDirectory() as tmp:
            t = time.perf_counter()
            sup = Supervisor(SnapshotStore(tmp), checkpoint_every=2,
                             eta0=cfg.eta0,
                             fault_plan=(FaultEvent(4, "reshard", 2),))
            opt, log = sup.run_sharded(prob, EPOCHS, mesh=mesh, impl="auto",
                                       alpha0=cfg.alpha0, seed=0)
            gaps = [(h["epoch"], h["gap"]) for h in sup.history]
            say("9r", f"supervised svm-ocr, live reshard 4 -> 2 at epoch 4: "
                      f"ledger {[(ev.kind, ev.detail) for ev in log]}; gap "
                      + " ".join(f"e{e}={v:.6f}" for e, v in gaps)
                      + f"; {time.perf_counter() - t:.1f} s")
            at4 = dict(gaps)[4]
            check(opt.p == 2 and opt.epochs_done == EPOCHS
                  and gaps[-1][1] < at4,
                  f"the reshard did not continue with the gap falling: "
                  f"p={opt.p}, gaps {gaps}")
            del opt
        if clamps:
            t = time.perf_counter()
            ring_clamp(mesh, clamps, dev)
            say("8c", f"the ring's restore from outside the box on "
                      f"{len(clamps)} grids: {time.perf_counter() - t:.1f} s")
        n_cards = torch.cuda.device_count()
        if n_cards >= RING_P:
            nccl = make_dso_mesh(RING_P, device=dev, transport="nccl",
                                 pool=pool)
            opt = ShardedDSO(ctx_r["grid"], nccl, **kw)
            opt.run_epochs(EPOCHS, cfg_r.eta0)
            e_n, ok_n = max_rel_err(opt.w_full(), ref_w)
            say("9r", f"nccl route on {n_cards} cards, svm-real-sim: vs the "
                      f"gloo ring max|d| w {e_n:.3e}")
            check(ok_n, f"the nccl ring is {e_n:.3e} off the gloo ring")
            del opt
        else:
            say("9r", f"nccl route: not run ({n_cards} card(s))")
    say("9r", f"phase 9r passed in {time.perf_counter() - t0:.1f} s")
    return out


def live_column_shares(grid):
    """For each inner iteration r of the cyclic schedule (blk[q] = (q + r)
    mod p) the share of the p x db columns whose count in row tile 0 of
    the active tile is nonzero (``live_columns``)."""
    import torch
    q = torch.arange(grid.p, device=grid.yg.device)
    return [live_columns(grid, (q + r) % grid.p) / (grid.p * grid.db)
            for r in range(grid.p)]


def tile_cases(dev):
    """The tile-step cases of phases 3d and 3t: (name, X, y) for an
    M 999 x D 1,155 problem and a row-strided view of one processor's
    block of its p = 4 grid."""
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import make_grid_data
    prob = make_classification(m=999, d=1155, density=0.7, seed=3,
                               device=dev)
    grid = make_grid_data(prob, P, 1)
    return (("contiguous", prob.X, prob.y),
            ("strided", grid.Xg[2, :, grid.db:2 * grid.db], grid.yg[2]))


def tile_step_args(X, y, loss, rng):
    """Random (y, w, alpha, gw, ga, row_nnz, col_nnz, scalars) for a tile
    step over X, drawn from ``rng`` on X's device."""
    import numpy as np
    import torch
    M, D = X.shape
    t = lambda a: torch.tensor(np.asarray(a, np.float32),  # noqa: E731
                               device=X.device)
    alpha = y * t(rng.uniform(0.05, 0.95, M))
    if loss == "square":
        alpha = t(rng.normal(0, 0.5, M))
    return (y, t(rng.normal(0, 0.1, D)), alpha,
            t(np.abs(rng.normal(0, 0.01, D))),
            t(np.abs(rng.normal(0, 0.01, M))),
            t(rng.integers(1, 50, M)), t(rng.integers(1, 50, D)),
            scalars(loss, 1e-3, M))


def phase_dense_kernels(dev):
    """Phase 3d: the dense launch A + B against the plain versions at
    small shapes: ``ops.dso_block_step`` for row_batches {1, 2, 3} on a
    narrow grid (m 999, d 1,155: rows and a column padded, db 289) and
    {1, 3} on a wide one (m 64, d 49,500: db 12,375, past the kernel's
    shared-memory partial), x six pairs; ``ops.dso_tile_step`` at M 999,
    D 1,155 and on a row-strided view of one processor's block."""
    import numpy as np
    import torch
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import make_grid_data
    from repro_torch.kernels import dso_update, ops
    worst = 0.0
    blk = torch.tensor([1, 3, 0, 2], dtype=torch.int32, device=dev)
    # (m, d, density, row_batches): db 289 (blocks at b*289 mod 4 = 1, 3,
    # 0, 2 floats past 16 bytes), db 1, 3, 5, db 1,000 (several sweeps, a
    # shared column partial) and db 12,375 (past it)
    cases = [(999, 1155, 0.7, (1, 2, 3)), (999, 4, 0.9, (1, 2, 3)),
             (999, 12, 0.8, (1, 2, 3)), (999, 20, 0.8, (1, 2, 3)),
             (256, 4000, 0.5, (1, 3)), (64, 49500, 0.5, (1, 3))]
    for m, d, density, rbs in cases:
        prob = make_classification(m=m, d=d, density=density, seed=m + d,
                                   device=dev)
        for rb in rbs:
            grid = make_grid_data(prob, P, rb)
            mis = sorted((grid.Xg.data_ptr() // 4 + b * grid.db) % 4
                         for b in blk.tolist())
            for loss, reg in LOSS_REG_PAIRS:
                st = random_state(grid, loss, seed=rb)
                e, ok = compare_step("dense", grid, st, blk,
                                     scalars(loss, 1e-3, m), rb, loss, reg)
                worst = max(worst, e)
                zeroed = all(bool((a == 0).all()) for a in ops._ACC.values())
                say("3d", f"dense block step {loss}/{reg} row_batches={rb} "
                          f"mb={grid.mb} db={grid.db} misalignments={mis} "
                          f"max|d|={e:.3e} {'ok' if ok else 'FAIL'}")
                check(ok, f"dense {loss}/{reg} rb={rb} db={grid.db}: "
                          f"kernel disagrees with its plain version "
                          f"(max|d| {e:.3e})")
                check(zeroed, f"dense {loss}/{reg} rb={rb} db={grid.db}: "
                              f"launch B left the accumulator nonzero")
    rng = np.random.default_rng(9)
    for name, X, y in tile_cases(dev):
        for loss, reg in LOSS_REG_PAIRS:
            args = tile_step_args(X, y, loss, rng)
            M, D = X.shape
            kw = dict(loss_name=loss, reg_name=reg,
                      tile_row_nnz=(X != 0).sum(1).float(),
                      tile_col_nnz=(X != 0).sum(0).float())
            got = ops.dso_tile_step(X, *args, **kw)
            want = dso_update.dso_tile_step_plain(X, *args, **kw)
            torch.cuda.synchronize()
            errs = [max_rel_err(g, w) for g, w in zip(got, want)]
            e = max(x for x, _ in errs)
            worst = max(worst, e)
            say("3d", f"dense tile step {name} {loss}/{reg} M={M} D={D} "
                      f"row stride {X.stride(0)} misalignment "
                      f"{X.data_ptr() // 4 % 4} max|d|={e:.3e}")
            check(all(ok for _, ok in errs),
                  f"dense tile step {name} {loss}/{reg}: kernel disagrees "
                  f"with its plain version (max|d| {e:.3e})")
    return worst


def compare_tile_steps(got, wants):
    """max|d| of a tile step's four outputs against each of ``wants`` and
    whether all are within the bound."""
    errs = [max_rel_err(g, w) for want in wants for g, w in zip(got, want)]
    return max(e for e, _ in errs), all(ok for _, ok in errs)


def twopass_cases(dev):
    """Phase 3t's cases, (name, X, y, the kernels the card must take X on):
    those of phase 3d, then one processor's block of the same p = 4 grid
    (row stride 1,156) at each of the four 16-byte misalignments (blocks
    b = 0..3: b*289 mod 4 = 0, 1, 2, 3), blocks of db 1, 3 and 5 (row
    strides 4, 12 and 20), and an empty block (db 0, row stride 1,156)."""
    from repro_torch.data.synthetic import make_classification
    from repro_torch.engine import make_grid_data
    contiguous, strided = tile_cases(dev)
    cases = [(*contiguous, "rows"), (*strided, "span")]
    prob = make_classification(m=999, d=1155, density=0.7, seed=3,
                               device=dev)
    grid = make_grid_data(prob, P, 1)
    db = grid.db
    cases += [(f"block {b}", grid.Xg[2, :, b * db:(b + 1) * db], grid.yg[2],
               "span") for b in range(P)]
    cases.append(("db 0", grid.Xg[2, :, db:db], grid.yg[2], "rows"))
    for d in (4, 12, 20):
        prob = make_classification(m=999, d=d, density=0.8, seed=d,
                                   device=dev)
        grid = make_grid_data(prob, P, 1)
        cases.append((f"db {grid.db}",
                      grid.Xg[1, :, grid.db:2 * grid.db], grid.yg[1],
                      "span"))
    return cases


def phase_twopass_kernels(dev):
    """Phase 3t: the two-pass tile step against its plain version and the
    fused step on the same inputs, six pairs on ``twopass_cases``, each
    case on the kernels it must take."""
    import numpy as np
    import torch
    from repro_torch.kernels import dso_update, ops
    worst = 0.0
    rng = np.random.default_rng(11)
    for name, X, y, want_route in twopass_cases(dev):
        M, D = X.shape
        route = dso_update.twopass_route(X)
        check(route == (want_route if dev.type == "cuda" else "plain"),
              f"two-pass tile step {name}: takes the {route} kernels, "
              f"expected {want_route}")
        for loss, reg in LOSS_REG_PAIRS:
            args = tile_step_args(X, y, loss, rng)
            kw = dict(loss_name=loss, reg_name=reg)
            got = ops.dso_tile_step(X, *args, twopass=True, **kw)
            plain = dso_update.dso_tile_step_twopass_plain(X, *args, **kw)
            fused = ops.dso_tile_step(X, *args, **kw)
            torch.cuda.synchronize()
            e, ok = compare_tile_steps(got, (plain, fused))
            worst = max(worst, e)
            say("3t", f"two-pass tile step {name} ({route}) {loss}/{reg} "
                      f"M={M} D={D} row stride {X.stride(0)} misalignment "
                      f"{X.data_ptr() // 4 % 4} max|d| vs plain and fused "
                      f"{e:.3e}")
            check(ok, f"two-pass tile step {name} {loss}/{reg}: disagrees "
                      f"with its plain version or the fused step "
                      f"(max|d| {e:.3e})")
    return worst


# (B, Hq, Hkv, Tq, Tk, Dh, window, causal, q_offset)
SWA_CASES = [(1, 2, 2, 256, 256, 64, 128, True, 0),
             (2, 4, 2, 256, 256, 64, 64, True, 0),
             (1, 8, 1, 128, 128, 32, 1024, True, 0),
             (1, 2, 1, 100, 100, 64, 50, True, 0),
             (2, 4, 2, 8, 4096, 64, 256, True, 4088),     # decode offset
             (1, 2, 2, 256, 256, 64, 100, False, 0),
             (1, 2, 1, 100, 100, 64, 50, False, 0),       # ragged Tk
             (1, 4, 2, 300, 300, 112, 128, True, 0),      # ragged, Dh 112
             (1, 2, 2, 130, 130, 40, 64, True, 0),        # Dh 40: not x16
             (1, 2, 1, 200, 200, 128, 100, True, 0),      # Dh at the limit
             # ragged to the 128-query and 64-key tiles, GQA 4, windows
             # narrower and wider than a kv tile
             (1, 8, 2, 200, 200, 112, 1, True, 0),
             (1, 4, 1, 200, 200, 64, 63, True, 0),
             (1, 4, 1, 200, 200, 112, 65, True, 0),
             (1, 4, 1, 300, 300, 128, 127, True, 0),
             (1, 4, 1, 257, 321, 40, 1000, True, 64),     # window past T
             (2, 8, 2, 8, 4096, 112, 4096, True, 4088),   # decode, Dh 112
             (1, 4, 1, 130, 190, 112, 50, False, 0),      # ragged Tq != Tk
             (1, 4, 1, 16, 32, 64, 4, True, 30),          # rows 5.. see no key
             (1, 2, 1, 77, 77, 36, 20, True, 0),          # Dh 36: packed
             (1, 8, 8, 1024, 1024, 112, 1024, True, 0),   # a 9t rank's heads
             (1, 8, 2, 4096, 4096, 128, 4096, True, 0)]   # a 9e rank's heads
# float32 only: the edges of the split-TF32 kernel's tiling (128 queries
# per CTA in warps of 16 rows, kv tiles of 32, depth padded to 16)
SWA_F32_CASES = [(1, 2, 1, 141, 141, 112, 1000, True, 0),  # ragged warp
                 (1, 2, 2, 7, 7, 64, 16, True, 0),         # part of a warp
                 (1, 2, 2, 100, 100, 8, 40, True, 0),      # Dh 8
                 (1, 2, 1, 260, 260, 128, 300, True, 0),   # Dh 128
                 (1, 4, 4, 70, 70, 64, 1, True, 0),        # window 1
                 (1, 4, 1, 1, 4089, 112, 4096, True, 4088),  # decode row
                 (2, 8, 2, 200, 200, 112, 150, True, 0),   # GQA 4
                 (1, 2, 1, 90, 90, 30, 45, True, 0)]       # Dh 30: 4-byte
# bf16 only: head sizes off a multiple of 8, packed into rows of
# roundup(Dh, 8) (an odd Dh stores its output one bf16 at a time)
SWA_BF16_CASES = [(1, 4, 1, 200, 200, 30, 100, True, 0),     # Dh 30
                  (1, 2, 2, 130, 130, 33, 1000, True, 0),    # Dh 33, odd
                  (1, 4, 2, 150, 150, 1, 64, True, 0),       # Dh 1
                  (1, 2, 1, 260, 260, 127, 130, True, 0),    # Dh 127
                  (2, 4, 2, 8, 1024, 33, 512, True, 1016)]   # decode, odd
# both dtypes, q, k, v one element into a larger buffer (not 16-byte
# aligned): float32 stays on split TF32 (4-byte copies), bf16 takes the
# packed route
SWA_MISALIGNED_CASES = [(1, 4, 2, 150, 150, 112, 64, True, 0),
                        (1, 2, 2, 100, 100, 64, 100, False, 0),
                        (1, 4, 2, 140, 140, 36, 70, True, 0)]     # Dh 36
# (b, t, h, dh, n, chunk, A fill or None)
SSD_CASES = [(1, 128, 2, 32, 16, 64, None),
             (2, 256, 3, 32, 16, 64, None),
             (1, 100, 2, 16, 8, 32, None),
             (1, 512, 1, 64, 32, 128, None),
             (1, 1000, 4, 64, 64, 128, None),     # ragged t, zamba2 n, dh
             (1, 300, 2, 64, 128, 128, None),     # mamba2-370m's n = 128
             (1, 260, 2, 128, 64, 128, None),     # dh 128
             (1, 128, 1, 16, 8, 64, -1e4),        # total decay
             (1, 4096, 2, 64, 64, 64, None),      # 64 chunks
             (2, 4000, 3, 64, 64, 128, None),     # b 2, ragged t, 32 chunks
             (2, 2100, 2, 112, 48, 64, None),     # b 2, ragged, dh 112
             (1, 256, 2, 128, 128, 128, None),    # n = dh = 128
             (1, 250, 2, 48, 24, 100, None),      # chunk 100: a part tile
             (2, 130, 2, 160, 16, 64, None),      # dh 160 (3 tiles)
             (1, 70, 1, 256, 8, 64, None),        # dh 256, the widest
             (1, 200, 2, 64, 64, 128, -1e4)]      # total decay, 2 chunks
# phase 3l's backward adds shapes past the tensor-core chunk gradients
# (ssd_chunk_grad_tc), which take the CUDA-core kernel as the float32 B
# and C at n 128 above do
SSD_BWD_FMA_CASES = [(1, 600, 2, 64, 32, 256, None),   # chunk 256, ragged
                     (1, 300, 2, 64, 256, 128, None)]  # n 256
# a tensor-parallel rank's SSD heads (phase 9t), B and C in the inputs'
# type as the model gives them: zamba2-7b's 112 / 4 = 28 (the chunk
# gradients' groups of 8 with a tail of 4) and mamba2-370m's 32 / 4 = 8
# at n 128 (bf16 B, C: the tensor-core chunk gradients)
SSD_RANK_CASES = [(2, 1024, 28, 64, 64, 128, None),
                  (2, 1024, 8, 64, 128, 128, None)]
SWA_TOL = (2e-5, 2e-5)       # (rtol, atol) of the reference's swa tests
SSD_TOL = (2e-4, 2e-5)       # ... and of its ssd tests


def within(got, want, tol, bf16):
    """max|d| and whether |got - want| <= atol + rtol |want| everywhere,
    with one bf16 ulp more rtol when the outputs are bf16."""
    import torch
    rtol, atol = tol
    if bf16:
        rtol += BF16_ULP
    g, w = got.float(), want.float()
    d = (g - w).abs()
    return float(d.max()), bool(torch.all(d <= atol + rtol * w.abs()))


def misaligned_copy(a):
    """A contiguous copy of ``a`` that starts one element into a larger
    buffer, so its data is not 16-byte aligned."""
    import torch
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    return out


def ssd_inputs(b, t, h, dh, n, gen, dtype):
    """x (in ``dtype``), dt, A, B, C on ``gen``'s device, drawn as the
    reference's kernel tests draw them."""
    import torch
    dev = gen.device
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    x = r(b, t, h, dh).to(dtype)
    dt = r(b, t, h).abs() * 0.1 + 0.01
    A = -(r(h) * 0.3 + 1.0).abs()
    return x, dt, A, r(b, t, n) / n ** 0.5, r(b, t, n) / n ** 0.5


def phase_lm_kernels(dev):
    """Phase 3l: ``ops.swa_attention`` and ``ops.ssd_scan`` against their
    plain versions on the card, float32 and bf16."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(3)
    worst = {}
    want_routes = {r: 0 for r in swa.QUERY_TILES}
    ops.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        cases = [(c, True) for c in SWA_CASES] \
            + [(c, True) for c in (SWA_BF16_CASES if bf16
                                   else SWA_F32_CASES)] \
            + [(c, False) for c in SWA_MISALIGNED_CASES]
        for (B, Hq, Hkv, Tq, Tk, Dh, window, causal, off), aligned in cases:
            route = swa.swa_route(dtype, Dh, aligned)
            want_routes[route] += 1
            q = torch.randn(B, Hq, Tq, Dh, generator=gen, device=dev)
            k, v = (torch.randn(B, Hkv, Tk, Dh, generator=gen, device=dev)
                    for _ in range(2))
            q, k, v = (a.to(dtype) for a in (q, k, v))
            if not aligned:
                q, k, v = (misaligned_copy(a) for a in (q, k, v))
            kw = dict(window=window, causal=causal, q_offset=off)
            got = ops.swa_attention(q, k, v, **kw)
            want = swa.swa_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            e, ok = within(got, want, SWA_TOL, bf16)
            worst["swa", bf16] = max(worst.get(("swa", bf16), 0.0), e)
            say("3l", f"swa_attention {str(dtype)[6:]} ({route}) B={B} "
                      f"Hq={Hq} Hkv={Hkv} Tq={Tq} Tk={Tk} Dh={Dh} "
                      f"window={window} causal={causal} q_offset={off} "
                      f"{'' if aligned else 'misaligned '}max|d|={e:.3e}")
            check(ok and got.dtype == dtype,
                  f"swa_attention disagrees with its plain version "
                  f"(max|d| {e:.3e})")
        for case in SSD_CASES + SSD_RANK_CASES:
            b, t, h, dh, n, chunk, fill = case
            x, dt, A, Bm, Cm = ssd_inputs(b, t, h, dh, n, gen, dtype)
            if case in SSD_RANK_CASES:
                Bm, Cm = Bm.to(dtype), Cm.to(dtype)
            if fill is not None:
                A = torch.full_like(A, fill)
            got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
            want = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk)
            torch.cuda.synchronize()
            e, ok = within(got, want, SSD_TOL, bf16)
            worst["ssd", bf16] = max(worst.get(("ssd", bf16), 0.0), e)
            say("3l", f"ssd_scan {str(dtype)[6:]} b={b} t={t} h={h} dh={dh} "
                      f"n={n} chunk={chunk} A={'-1e4' if fill else 'drawn'} "
                      f"max|d|={e:.3e}")
            check(ok and got.dtype == dtype,
                  f"ssd_scan disagrees with its plain version "
                  f"(max|d| {e:.3e})")
    counts = ops.launch_counts()
    got_routes = {"tf32x3": counts["swa_attention_tf32x3"],
                  "tensor_cores": counts["swa_attention_tc"],
                  "packed": counts["swa_attention"]}
    say("3l", f"swa_attention launches by route {got_routes} (cases routed: "
              f"{want_routes})")
    check(got_routes == want_routes,
          f"swa_attention routes {got_routes} != {want_routes}")
    # shapes the kernels do not take raise on the card, with no fallback
    q = torch.zeros(1, 1, 8, 144, device=dev)
    refused = []
    try:
        ops.swa_attention(q, q, q, window=4)
    except ValueError as e:
        refused.append(str(e))
    x, dt, A, Bm, Cm = ssd_inputs(1, 8, 1, 64, 512, gen, torch.float32)
    try:            # n 512: 314,368 B of shared memory, the launch refuses
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=128)
    except RuntimeError as e:
        refused.append(str(e))
    x, dt, A, Bm, Cm = ssd_inputs(1, 8, 1, 264, 8, gen, torch.float32)
    try:            # dh past the kernels' four tiles of 64
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    except ValueError as e:
        refused.append(str(e))
    say("3l", f"refused on the card: {refused}")
    check(len(refused) == 3, "a shape the kernels do not take was not "
                             "refused")
    return worst


# the backward kernels against the plain backward on the same saved tensors:
# max|d| <= BWD_TOL x max(1, max|plain|), one bf16 ulp (relative to the
# largest element) for a bf16 gradient, the SWA forward tolerance for a
# float32 one
BWD_TOL = {True: BF16_ULP, False: 2e-5}
LSE_TOL = 1e-5             # the saved logsumexp against the plain one
SWA_BWD_COUNTERS = {"tf32x3": "swa_attention_bwd_f32",
                    "tensor_cores": "swa_attention_bwd",
                    "packed": "swa_attention_bwd_packed"}


def bwd_within(got, want):
    """(max|d| over the gradients, whether each is finite, of its plain
    counterpart's type and within ``BWD_TOL`` of it)."""
    import torch
    worst, ok = 0.0, True
    for g, w in zip(got, want):
        e = float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
        top = float(w.float().abs().max()) if w.numel() else 0.0
        worst = max(worst, e)
        ok &= (e <= BWD_TOL[w.dtype == torch.bfloat16] * max(1.0, top)
               and g.dtype == w.dtype and bool(torch.isfinite(g).all()))
    return worst, ok


def swa_bwd_case(q, k, v, do, kw):
    """The attention's forward that saves the logsumexp and its backward,
    both through ``ops`` (the kernels), against the plain versions on the
    same tensors: (max|d| of the logsumexp, max|d| of the gradients,
    whether all are within bounds)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as swa
    o, lse = ops._swa_launch(q, k, v, **kw, lse=True)
    grads = ops._swa_bwd_launch(q, k, v, o, lse, do, **kw)
    _, plse = swa.swa_attention_plain(q, k, v, **kw, return_lse=True)
    want = swa.swa_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    live = plse > swa.NEG_INF / 2
    e_lse = float((lse - plse).abs()[live].max()) if live.any() else 0.0
    ok_lse = e_lse <= LSE_TOL * max(1.0, float(plse[live].abs().max())
                                    if live.any() else 0.0) \
        and bool((lse[~live] == swa.NEG_INF).all())
    e, ok = bwd_within(grads, want)
    return e_lse, e, ok and ok_lse


def ssd_bwd_case(x, dt, A, Bm, Cm, dy, chunk):
    """The SSD forward that keeps its chunk states and its backward, both
    through ``ops`` (the kernels), against the plain versions on the same
    tensors: (max|d| of the states, max|d| of the gradients, ok)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    _, states, decay = ops._ssd_launch(x, dt, A, Bm, Cm, chunk=chunk,
                                       save=True)
    grads = ops._ssd_scan_bwd(x, dt, A, Bm, Cm, states, decay, dy,
                              chunk=chunk)
    _, pst, pdec = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=chunk,
                                      return_states=True)
    want = ssd.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, decay, dy,
                                  chunk=chunk)
    e_st = max(float((states - pst).abs().max()),
               float((decay - pdec).abs().max()))
    ok_st = e_st <= SSD_TOL[1] + SSD_TOL[0] * float(pst.abs().max())
    # in the inputs' types, as ops.SSDScan returns them
    grads = [g.to(t.dtype) for g, t in zip(grads, (x, dt, A, Bm, Cm))]
    e, ok = bwd_within(grads, want)
    return e_st, e, ok and ok_st


def phase_lm_bwd_kernels(dev):
    """Phase 3l, the backward: at phase 3l's shapes, in float32 and bf16,
    each route's forward that saves the logsumexp (the SSD: its chunk
    states) and its backward kernels against the plain versions on the
    same tensors; every backward route's launch count must equal the
    cases routed to it."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(33)
    worst = {}
    want = {c: 0 for c in SWA_BWD_COUNTERS.values()}
    want["ssd_scan_bwd"] = want["ssd_scan_bwd_fma"] = 0
    ops.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        cases = [(c, True) for c in SWA_CASES] \
            + [(c, True) for c in (SWA_BF16_CASES if bf16
                                   else SWA_F32_CASES)] \
            + [(c, False) for c in SWA_MISALIGNED_CASES]
        for (B, Hq, Hkv, Tq, Tk, Dh, window, causal, off), aligned in cases:
            route = swa.swa_route(dtype, Dh, aligned)
            want[SWA_BWD_COUNTERS[route]] += 1
            q = torch.randn(B, Hq, Tq, Dh, generator=gen, device=dev)
            do = torch.randn(B, Hq, Tq, Dh, generator=gen, device=dev)
            k, v = (torch.randn(B, Hkv, Tk, Dh, generator=gen, device=dev)
                    for _ in range(2))
            q, k, v, do = (a.to(dtype) for a in (q, k, v, do))
            if not aligned:
                q, k, v, do = (misaligned_copy(a) for a in (q, k, v, do))
            kw = dict(window=window, causal=causal, q_offset=off)
            e_lse, e, ok = swa_bwd_case(q, k, v, do, kw)
            worst["swa_bwd", bf16] = max(worst.get(("swa_bwd", bf16), 0.0),
                                         e)
            say("3l", f"swa_attention backward {str(dtype)[6:]} ({route}) "
                      f"B={B} Hq={Hq} Hkv={Hkv} Tq={Tq} Tk={Tk} Dh={Dh} "
                      f"window={window} causal={causal} q_offset={off} "
                      f"{'' if aligned else 'misaligned '}lse max|d|="
                      f"{e_lse:.3e} gradients max|d|={e:.3e}")
            check(ok, f"swa_attention's backward disagrees with its plain "
                      f"version (lse {e_lse:.3e}, gradients {e:.3e})")
        for case in SSD_CASES + SSD_BWD_FMA_CASES + SSD_RANK_CASES:
            b, t, h, dh, n, chunk, fill = case
            x, dt, A, Bm, Cm = ssd_inputs(b, t, h, dh, n, gen, dtype)
            if case in SSD_RANK_CASES:
                Bm, Cm = Bm.to(dtype), Cm.to(dtype)
            if fill is not None:
                A = torch.full_like(A, fill)
            dy = torch.randn(b, t, h, dh, generator=gen,
                             device=dev).to(dtype)
            plan = ops._ssd_grad_plan(x, Bm, Cm, chunk=chunk)
            want["ssd_scan_bwd"] += 1
            want["ssd_scan_bwd_fma"] += not plan.tc
            e_st, e, ok = ssd_bwd_case(x, dt, A, Bm, Cm, dy, chunk)
            worst["ssd_bwd", bf16] = max(worst.get(("ssd_bwd", bf16), 0.0),
                                         e)
            route = f"tc g={plan.g}" if plan.tc else "fma"
            say("3l", f"ssd_scan backward {str(dtype)[6:]} ({route}) b={b} "
                      f"t={t} h={h} dh={dh} n={n} chunk={chunk} A="
                      f"{'-1e4' if fill else 'drawn'} states max|d|="
                      f"{e_st:.3e} gradients max|d|={e:.3e}")
            check(ok, f"ssd_scan's backward disagrees with its plain "
                      f"version (states {e_st:.3e}, gradients {e:.3e})")
    torch.cuda.synchronize()
    got = {k: ops.launch_counts()[k] for k in want}
    say("3l", f"backward launches by route {got} (cases routed: {want})")
    check(got == want, f"backward routes {got} != {want}")
    check(want["ssd_scan_bwd_fma"] > 0 and
          want["ssd_scan_bwd_fma"] < want["ssd_scan_bwd"],
          "phase 3l's SSD cases do not take both chunk-gradient routes")
    return worst


# zamba2-7b (configs/zamba2_7b.py): 32 attention heads of 112 over d_model
# 3,584; SSD 112 heads of 64 (expand 2), state 64; sliding window 8,192
# above full_attn_max 65,536; bf16.  mamba2-370m: 32 SSD heads, state 128.
ZAMBA_HEADS, ZAMBA_HEAD_DIM = 32, 112
# (label, T, window, dtype name, launch counter, misaligned): the
# misaligned bf16 case times the packed route at this shape
SWA_FULL = [("causal, window >= T", 16384, 16384, "bfloat16",
             "swa_attention_tc", False),
            ("sliding window", 73728, 8192, "bfloat16", "swa_attention_tc",
             False),
            ("causal, window >= T, float32", 16384, 16384, "float32",
             "swa_attention_tf32x3", False),
            ("sliding window, float32", 73728, 8192, "float32",
             "swa_attention_tf32x3", False),
            ("causal, window >= T, bf16 misaligned", 16384, 16384,
             "bfloat16", "swa_attention", True)]
SSD_FULL = [("zamba2-7b", 16384, 112, 64, 64),
            ("mamba2-370m", 16384, 32, 64, 128)]
SSD_CHUNK = 128


def swa_bound(B, Hq, Hkv, Tq, Tk, Dh, window, q_offset, elem,
              split_tf32=False):
    """(bound ms, bound_by) of causal sliding-window attention: q, k, v
    read once and the output written once; 4 Dh operations per attended
    (query, key) pair at the bf16 tensor-core rate (float32 for 4-byte
    inputs; with ``split_tf32``, 3 TF32 products per float32 product at
    the TF32 tensor-core rate, the arithmetic the float32 kernel does)."""
    import torch
    pos = torch.arange(Tq, dtype=torch.float64) + q_offset
    lo = (pos - window + 1).clamp(min=0)
    hi = pos.clamp(max=Tk - 1)
    pairs = float((hi - lo + 1).clamp(min=0).sum()) * B * Hq
    nbytes = elem * (2 * B * Hq * Tq * Dh + 2 * B * Hkv * Tk * Dh)
    if split_tf32:
        ops_s = 3 * 4 * Dh * pairs / TF32_OPS_S
    else:
        ops_s = 4 * Dh * pairs / (BF16_OPS_S if elem == 2 else F32_OPS_S)
    by = "bytes" if nbytes / HBM_BYTES_S >= ops_s else "operations"
    return max(nbytes / HBM_BYTES_S, ops_s) * 1e3, by


def ssd_bound(x, n):
    """(bound ms, bound_by) of the SSD scan: x, dt, A, B, C read once and y
    written once; ~5 n dh float32 operations per (step, head) of the exact
    recurrence (decay, input outer product, output contraction)."""
    b, t, h, dh = x.shape
    nbytes = 2 * x.numel() * x.element_size() + 4 * (b * t * h + h
                                                       + 2 * b * t * n)
    ops_s = 5 * n * dh * b * t * h / F32_OPS_S
    by = "bytes" if nbytes / HBM_BYTES_S >= ops_s else "operations"
    return max(nbytes / HBM_BYTES_S, ops_s) * 1e3, by


def ssd_chunked_flops(x, n, chunk):
    """float32 operations of the chunked form the kernels compute (a note
    beside the bound, not a bound): per (batch, head, chunk) of L steps,
    the chunk state (n dh L multiply-adds), the causal C B^T and M x
    (L^2 (n + dh) / 2) and the carried-state term (L n dh)."""
    b, t, h, dh = x.shape
    macs = 2 * chunk * n * dh + chunk * chunk * (n + dh) / 2
    return 2 * macs * b * h * -(-t // chunk)


def sdpa_ms(q, k, v, window):
    """ms per call of the PyTorch call that computes the same attention,
    never called by the port, and what it was: with the window past T,
    ``F.scaled_dot_product_attention(is_causal=True)`` (its device
    kernel's name printed from one profiled call); with a sliding window,
    the same call given the window as a T x T boolean ``attn_mask`` under
    ``sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION)`` (the mask, 5.4 GB at T
    73,728, is built before the timing), or (None, its error) when the
    backend refuses it."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    T = q.shape[2]
    if window >= T:
        call = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True)
        _, _, kern = device_split(call)
        say(7, f"SDPA(is_causal) {q.dtype} T={T}: device kernels "
               + ", ".join(f"{name} ({us / 1e3:.4f} ms)"
                           for name, us, _ in kern))
        return cuda_ms(call, 5, warm=1), "SDPA(is_causal)"
    pos = torch.arange(T, device=q.device)
    mask = (pos[None, :] <= pos[:, None]) & \
        (pos[None, :] > pos[:, None] - window)
    what = (f"SDPA(EFFICIENT_ATTENTION, bool attn_mask of "
            f"{mask.numel()} B)")
    try:
        with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
            ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), 2, warm=1)
    except RuntimeError as e:
        ms, what = None, f"{what} refused: {str(e).splitlines()[0]}"
    del mask
    torch.cuda.empty_cache()
    return ms, what


def drive_once(name, fn):
    """The main path of one LM case: the counts set to 0 just before one
    call through ``ops``, read just after; the call must have launched
    ``name``'s kernel exactly once."""
    import torch
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts[name] == 1 and sum(counts.values()) == 1,
          f"{name}: launch counts {counts}, expected one {name} launch")
    return out, counts[name]


def phase_lm_full(dev):
    """Phase 7: the LM kernels at zamba2-7b's widths through ``ops``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(17)
    bf = torch.bfloat16
    rows = {}
    B, H, DH = 1, ZAMBA_HEADS, ZAMBA_HEAD_DIM
    for label, T, window, dname, counter, misaligned in SWA_FULL:
        dtype = getattr(torch, dname)
        q, k, v = (torch.randn(B, H, T, DH, generator=gen,
                               device=dev).to(dtype) for _ in range(3))
        if misaligned:
            q, k, v = (misaligned_copy(a) for a in (q, k, v))
        out, n = drive_once(
            counter, lambda: ops.swa_attention(q, k, v, window=window))
        check(out.shape == q.shape and out.dtype == dtype
              and bool(torch.isfinite(out).all()),
              f"swa_attention {label}: bad output")
        want = swa.swa_attention_plain(q, k, v, window=window)
        err, ok = within(out, want, SWA_TOL, dtype == bf)
        check(ok, f"swa_attention {label}: max|d| {err:.3e} against the "
                  f"plain version")
        del out, want
        ms = cuda_ms(lambda: ops.swa_attention(q, k, v, window=window), 3,
                     warm=1)
        busy, kern = device_ms_per_call(
            lambda: ops.swa_attention(q, k, v, window=window), 3)
        plain_ms = cuda_ms(lambda: swa.swa_attention_plain(
            q, k, v, window=window), 2, warm=0)
        # SDPA on an aligned copy of a misaligned case's q, k, v
        lib_ms, lib = sdpa_ms(*((a.clone() for a in (q, k, v)) if misaligned
                                else (q, k, v)), window)
        split = counter == "swa_attention_tf32x3"
        bound, by = swa_bound(B, H, H, T, T, DH, window, 0,
                              q.element_size(), split_tf32=split)
        extra = ""
        if split:
            f32_bound, _ = swa_bound(B, H, H, T, T, DH, window, 0, 4)
            extra = (f" (split TF32: 3 products at {TF32_OPS_S:.0e}/s; at "
                     f"the float32 FMA rate {f32_bound:.4f} ms)")
        rows[counter, label] = dict(ms=ms, plain_ms=plain_ms,
                                    bound_ms=bound, bound_by=by,
                                    library_ms=lib_ms, max_abs_err=err,
                                    launches=n, device_ms=busy)
        say(7, f"{counter} {dname} B={B} H={H} T={T} Dh={DH} "
               f"window={window} ({label}): {ms:.4f} ms per call (device "
               f"time {busy:.4f} ms per call under the profiler: "
               + ", ".join(f"{k[:40]}={kms:.4f}" for k, kms in kern[:3])
               + f"), bound "
               f"{bound:.4f} ms ({by}){extra}, plain {plain_ms:.4f} ms, "
               f"{lib} " + (f"{lib_ms:.4f} ms" if lib_ms is not None
                            else "-") + f", max|d| {err:.3e}")
        del q, k, v
        torch.cuda.empty_cache()
    for label, t, h, dh, nst in SSD_FULL:
        x, dt, A, Bm, Cm = ssd_inputs(1, t, h, dh, nst, gen, bf)
        y, n = drive_once("ssd_scan", lambda: ops.ssd_scan(
            x, dt, A, Bm, Cm, chunk=SSD_CHUNK))
        check(y.shape == x.shape and y.dtype == bf
              and bool(torch.isfinite(y).all()),
              f"ssd_scan {label}: bad output")
        want = ssd.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=SSD_CHUNK)
        err, ok = within(y, want, SSD_TOL, True)
        check(ok, f"ssd_scan {label}: max|d| {err:.3e} against the plain "
                  f"version")
        del y, want
        kern = lambda: ops.ssd_scan(x, dt, A, Bm, Cm, chunk=SSD_CHUNK)  # noqa
        plain = lambda: ssd.ssd_scan_plain(  # noqa
            x, dt, A, Bm, Cm, chunk=SSD_CHUNK)
        # kernel, plain, plain, kernel: 5 calls each after one warm call
        ms_a, plain_a = cuda_ms(kern, 5, warm=1), cuda_ms(plain, 5, warm=1)
        plain_b, ms_b = cuda_ms(plain, 5, warm=1), cuda_ms(kern, 5, warm=1)
        ms, plain_ms = (ms_a + ms_b) / 2, (plain_a + plain_b) / 2
        busy, kern_ms = device_ms_per_call(kern, 3)
        bound, by = ssd_bound(x, nst)
        chunked = ssd_chunked_flops(x, nst, SSD_CHUNK)
        rows["ssd_scan", label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None, max_abs_err=err, launches=n,
            device_ms=busy)
        say(7, f"ssd_scan bf16 x ({label}) b=1 t={t} h={h} dh={dh} n={nst} "
               f"chunk={SSD_CHUNK}: {ms:.4f} ms per call ({ms_a:.4f}, "
               f"{ms_b:.4f}; device time {busy:.4f} ms per call under the "
               f"profiler: "
               + ", ".join(f"{k[:40]}={kms:.4f}" for k, kms in kern_ms)
               + f"), bound {bound:.4f} ms ({by}; the chunked form's "
               f"{chunked / 1e9:.2f} GFLOP would take "
               f"{chunked / F32_OPS_S * 1e3:.4f} ms), plain "
               f"{plain_ms:.4f} ms ({plain_a:.4f}, {plain_b:.4f}), no "
               f"single PyTorch call computes it, max|d| {err:.3e}")
        del x, dt, A, Bm, Cm
        torch.cuda.empty_cache()
    return rows


# The backward kernels at phase 7t's shapes (zamba2-7b's first group: B 2 x
# T 4,096, 32 heads of 112; its float32 twin at B 1) and at a sliding
# window (T 16,384, window 4,096, zamba2-7b's heads): (label, B, T, window,
# dtype name, misaligned); the misaligned case takes the packed route
SWA_BWD_FULL = [("7t group, causal", 2, 4096, 4096, "bfloat16", False),
                ("sliding window", 1, 16384, 4096, "bfloat16", False),
                ("7t group, causal, misaligned", 2, 4096, 4096, "bfloat16",
                 True),
                ("7t float32 group, causal", 1, 4096, 4096, "float32",
                 False)]
# (label, b, t, h, dh, n): x and B, C in bf16 as phase 7t's gate (a)
SSD_BWD_FULL = [("zamba2-7b group", 2, 4096, 112, 64, 64),
                ("mamba2-370m", 4, 2048, 32, 64, 128)]


SWA_BWD_RATES = {"bf16": "10 Dh per pair at the bf16 tensor-core rate "
                          "(989 TFLOP/s)",
                  "tf32x3": "3 TF32 products per float32 product, 30 Dh "
                            "per pair at the TF32 tensor-core rate "
                            "(495 TFLOP/s)",
                  "fma": "10 Dh per pair at the float32 FMA rate "
                         "(67 TFLOP/s)"}


def swa_bwd_bound(B, H, T, Dh, window, elem, rate=None):
    """(bound ms, bound_by) of the attention's backward (MHA, causal):
    q, k, v, o, do and lse read once, dq, dk, dv written once; five
    products, 10 Dh operations per attended (query, key) pair, at the rate
    ``rate`` names in ``SWA_BWD_RATES``: by default the bf16 tensor-core
    rate for 2-byte inputs and, for float32 ones, split TF32 as the
    float32 kernels take them (3 TF32 products per float32 product); "fma"
    for the float32 FMA rate."""
    import torch
    rate = rate or ("bf16" if elem == 2 else "tf32x3")
    pos = torch.arange(T, dtype=torch.float64)
    lo = (pos - window + 1).clamp(min=0)
    pairs = float((pos - lo + 1).sum()) * B * H
    nbytes = elem * 8 * B * H * T * Dh + 4 * B * H * T
    ops_s = {"bf16": 10 * Dh * pairs / BF16_OPS_S,
             "tf32x3": 30 * Dh * pairs / TF32_OPS_S,
             "fma": 10 * Dh * pairs / F32_OPS_S}[rate]
    by = "bytes" if nbytes / HBM_BYTES_S >= ops_s else "operations"
    return max(nbytes / HBM_BYTES_S, ops_s) * 1e3, by


def ssd_bwd_bytes(x, n, chunk):
    """Bytes the SSD scan's backward moves at least: x, dy, dt, A, B, C and
    the saved chunk states read once, dx, ddt, dA, dB, dC written once."""
    b, t, h, dh = x.shape
    return 3 * x.numel() * x.element_size() + 4 * (
        2 * b * t * h + 2 * h + 4 * b * t * n
        + b * h * -(-t // chunk) * (n * dh + 1))


def ssd_bwd_bound(x, n, chunk):
    """(bound ms, bound_by) of the SSD scan's backward: ``ssd_bwd_bytes``;
    ~10 n dh float32 operations per (step, head), twice the exact
    recurrence's forward (the state adjoint's recurrence and the
    products that take the gradients from it)."""
    b, t, h, dh = x.shape
    nbytes_s = ssd_bwd_bytes(x, n, chunk) / HBM_BYTES_S
    ops_s = 10 * n * dh * b * t * h / F32_OPS_S
    by = "bytes" if nbytes_s >= ops_s else "operations"
    return max(nbytes_s, ops_s) * 1e3, by


def ssd_bwd_chunked_floor(x, n, chunk, g):
    """(ms, bound_by) the chunked form's backward, the form the kernels
    compute, takes at least (``ssd_bwd_bound`` is the exact
    recurrence's): ``ssd_bwd_bytes``, and the products' float32 FMAs per
    (chunk, head): R and M^T dy over dh and V B, V^T C over n for each of
    the L (L + 1) / 2 causal pairs, C S, dy S^T, B Z and x Z^T (4 L n dh),
    G = C B^T over n once per ``g`` heads; each product as 3 TF32 products
    (split TF32) at the TF32 tensor-core rate."""
    b, t, h, dh = x.shape
    pairs = chunk * (chunk + 1) // 2
    fma = pairs * (2 * dh + 2 * n) + 4 * chunk * n * dh + pairs * n / g
    ops_s = 3 * 2 * fma * b * h * -(-t // chunk) / TF32_OPS_S
    nbytes_s = ssd_bwd_bytes(x, n, chunk) / HBM_BYTES_S
    by = "bytes" if nbytes_s >= ops_s else "operations"
    return max(nbytes_s, ops_s) * 1e3, by


def recompute_ms(plain, inputs, up):
    """ms of the backward that the kernels replaced: autograd through the
    plain forward from fresh leaves (the plain recompute), timed by CUDA
    events behind a spin; None when the card's memory does not hold its
    graph."""
    import torch

    def step():
        xs = [t.detach().requires_grad_() for t in inputs]
        return torch.autograd.grad(plain(*xs), xs, up)
    try:
        return spin_ms(step, 1, warm=1)
    except torch.cuda.OutOfMemoryError:
        return None
    finally:
        torch.cuda.empty_cache()


def sdpa_bwd_ms(q, k, v, do):
    """ms of the backward of ``F.scaled_dot_product_attention(is_causal=
    True)`` (full causal attention, whatever the window) on aligned
    copies, never called by the port: the forward once, then the
    gradients (``retain_graph``) timed behind a spin."""
    import torch
    import torch.nn.functional as F
    xs = [a.detach().clone().requires_grad_() for a in (q, k, v)]
    out = F.scaled_dot_product_attention(*xs, is_causal=True)
    up = do.clone()                 # aligned, as SDPA's backward needs
    ms = spin_ms(lambda: torch.autograd.grad(out, xs, up,
                                             retain_graph=True), 3)
    del out, xs
    torch.cuda.empty_cache()
    return ms


def say_bwd(label, what, ms, busy, kern, bound, by, plain_ms, rec_ms,
            lib, err):
    say(7, f"{what} backward ({label}): {ms:.4f} ms per call (CUDA events "
           f"behind a spin; device {busy:.4f} ms per call under the "
           f"profiler: " + ", ".join(f"{k[:40]}={kms:.4f}"
                                     for k, kms in kern[:4])
           + f"), bound {bound:.4f} ms ({by}), plain backward "
           f"{plain_ms:.4f} ms, the old recompute (autograd through the "
           f"plain forward) " + (f"{rec_ms:.4f} ms" if rec_ms is not None
                                 else "not measured (out of memory)")
           + (f", {lib}" if lib else "") + f", max|d| {err:.3e}")


def phase_lm_bwd_full(dev):
    """Phase 7, the backward: the backward kernels at phase 7t's shapes
    and at a sliding window, each driven once with the counts set to 0
    around it, held against the plain backward on the same saved
    tensors, and timed beside its bound, the plain backward, the old
    recompute and (attention) SDPA's backward."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_attention as swa
    gen = torch.Generator(device=dev).manual_seed(18)
    rows = {}
    H, DH = ZAMBA_HEADS, ZAMBA_HEAD_DIM
    for label, B, T, window, dname, misaligned in SWA_BWD_FULL:
        dtype = getattr(torch, dname)
        q, k, v, do = (torch.randn(B, H, T, DH, generator=gen,
                                   device=dev).to(dtype) for _ in range(4))
        if misaligned:
            q, k, v, do = (misaligned_copy(a) for a in (q, k, v, do))
        kw = dict(window=window, causal=True, q_offset=0)
        o, lse = ops._swa_launch(q, k, v, **kw, lse=True)
        route = swa.swa_route(dtype, DH, not misaligned)
        counter = SWA_BWD_COUNTERS[route]
        call = lambda: ops._swa_bwd_launch(q, k, v, o, lse, do,  # noqa
                                           **kw)
        grads, n = drive_once(counter, call)
        want = swa.swa_attention_bwd_plain(q, k, v, o, lse, do, **kw)
        err, ok = bwd_within(grads, want)
        check(ok, f"{counter} {label}: max|d| {err:.3e} against the plain "
                  f"backward")
        del grads, want
        ms = spin_ms(call, 3)
        busy, kern = device_ms_per_call(call, 3)
        plain_ms = spin_ms(lambda: swa.swa_attention_bwd_plain(
            q, k, v, o, lse, do, **kw), 1, warm=1)
        rec = recompute_ms(lambda *a: swa.swa_attention_plain(*a, **kw),
                           (q, k, v), do)
        lib_ms = sdpa_bwd_ms(q, k, v, do)
        bound, by = swa_bwd_bound(B, H, T, DH, window, q.element_size())
        rate = "bf16" if dtype == torch.bfloat16 else "tf32x3"
        rows[counter, label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=lib_ms, max_abs_err=err, launches=n,
            device_ms=busy, recompute_ms=rec,
            bound_rate=SWA_BWD_RATES[rate])
        also = f"SDPA(is_causal) backward {lib_ms:.4f} ms"
        if rate == "tf32x3":
            fma, _ = swa_bwd_bound(B, H, T, DH, window, 4, "fma")
            rows[counter, label]["fma_bound_ms"] = fma
            also += (f"; bound {SWA_BWD_RATES[rate]}, at "
                     f"{SWA_BWD_RATES['fma']} {fma:.4f} ms")
        say_bwd(label, f"{counter} {dname} B={B} H={H} T={T} Dh={DH} "
                       f"window={window}", ms, busy, kern, bound, by,
                plain_ms, rec, also, err)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    bf = torch.bfloat16
    for label, b, t, h, dh, nst in SSD_BWD_FULL:
        x, dt, A, Bm, Cm = ssd_inputs(b, t, h, dh, nst, gen, bf)
        Bm, Cm = Bm.to(bf), Cm.to(bf)
        dy = torch.randn(b, t, h, dh, generator=gen, device=dev).to(bf)
        _, states, decay = ops._ssd_launch(x, dt, A, Bm, Cm, chunk=SSD_CHUNK,
                                           save=True)
        call = lambda: ops._ssd_scan_bwd(  # noqa: E731
            x, dt, A, Bm, Cm, states, decay, dy, chunk=SSD_CHUNK)
        grads, n = drive_once("ssd_scan_bwd", call)
        want = ssd.ssd_scan_bwd_plain(x, dt, A, Bm, Cm, states, decay, dy,
                                      chunk=SSD_CHUNK)
        err, ok = bwd_within([g.to(t.dtype) for g, t in
                              zip(grads, (x, dt, A, Bm, Cm))], want)
        check(ok, f"ssd_scan_bwd {label}: max|d| {err:.3e} against the "
                  f"plain backward")
        del grads, want
        ms = spin_ms(call, 3)
        busy, kern = device_ms_per_call(call, 3)
        plain_ms = spin_ms(lambda: ssd.ssd_scan_bwd_plain(
            x, dt, A, Bm, Cm, states, decay, dy, chunk=SSD_CHUNK), 1,
            warm=1)
        rec = recompute_ms(lambda *a: ssd.ssd_scan_plain(*a, chunk=SSD_CHUNK),
                           (x, dt, A, Bm, Cm), dy)
        bound, by = ssd_bwd_bound(x, nst, SSD_CHUNK)
        plan = ops._ssd_grad_plan(x, Bm, Cm, chunk=SSD_CHUNK)
        floor, floor_by = ssd_bwd_chunked_floor(x, nst, SSD_CHUNK, plan.g)
        rows["ssd_scan_bwd", label] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
            library_ms=None, max_abs_err=err, launches=n, device_ms=busy,
            recompute_ms=rec)
        say_bwd(label, f"ssd_scan_bwd bf16 x, B, C b={b} t={t} h={h} "
                       f"dh={dh} n={nst} chunk={SSD_CHUNK}", ms, busy, kern,
                bound, by, plain_ms, rec,
                f"chunk gradients {plan}; the chunked form's floor "
                f"{floor:.4f} ms ({floor_by}, split TF32); no single "
                f"PyTorch call computes it", err)
        del x, dt, A, Bm, Cm, dy, states, decay
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------- phase 7m --
# The LM models on the card: zamba2-7b at its full published config
# (bf16), its first group at full width in float32, the decode engine,
# mamba2-370m at its full config and granite-3-8b's first two layers.
MODEL_T = 16384            # prefill length (<= full_attn_max: full causal)
GROUP_T = 4096             # the float32 group and granite-3-8b's layers
DECODE_CHECK = 64          # tokens of the group's decode against forward
MODEL_TOL = (2e-3, 2e-3)   # the reference's decode-vs-forward tolerance
PREFILL_REPS = 3
BLOCK_TOL = 2 * BF16_ULP   # a block's update, kernels vs plain (bf16)
SENS_NOISE = 2.0 ** -8     # relative input noise: about one bf16 rounding
ENGINE_PROMPTS = (8, 11, 13, 16)   # prompt lengths of the 4 requests
ENGINE_SEQ, ENGINE_NEW = 256, 16


def model_config(arch, **over):
    """The port's full config of ``arch`` with ``over`` replaced."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    return dataclasses.replace(get_config(arch), **over)


@contextlib.contextmanager
def plain_kernels():
    """Within the ``with``: the two kernel names the model modules call
    (``attention.swa_attention``, ``mamba2.ssd_scan``) bound to the plain
    versions, so the same forward runs without the kernels."""
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.swa_attention import swa_attention_plain
    from repro_torch.models import attention, mamba2
    saved = attention.swa_attention, mamba2.ssd_scan
    attention.swa_attention = swa_attention_plain
    mamba2.ssd_scan = ssd_scan_plain
    try:
        yield
    finally:
        attention.swa_attention, mamba2.ssd_scan = saved


def prefill_ms(fn):
    """ms per call of ``fn``: the median of ``PREFILL_REPS`` calls, each
    timed by CUDA events behind a spin (and all of them)."""
    ms = sorted(spin_ms(fn, 1, warm=0) for _ in range(PREFILL_REPS))
    return ms[len(ms) // 2], ms


def lm_kernel_share(fn):
    """Device ms of one call of ``fn`` from a profiler trace: every
    kernel's, the SWA and SSD kernels' (``swa_*``, ``ssd_*``), the wall
    ms, and the 6 kernels that took longest as "name ms (launches)"."""
    wall, busy, kernels = device_split(fn)
    lm = sum(us for name, us, _ in kernels
             if "swa_" in name or "ssd_" in name) / 1e3
    top = ", ".join(f"{name[:48]} {us / 1e3:.4f} ({n})"
                    for name, us, n in kernels[:6])
    return busy * 1e3, lm, wall * 1e3, top


def top5_gate(label, got, want, shape, gate=True):
    """Kernel logits against the plain run's: finite, of ``shape``, and
    (``gate``) the plain run's argmax at the last position among the
    kernel run's top 5.  Returns (relative L2 distance of the last
    position, whether the argmax is in the top 5)."""
    import torch
    check(tuple(got.shape) == shape and bool(torch.isfinite(got).all()),
          f"{label}: logits {tuple(got.shape)} (want {shape}) or not "
          f"finite")
    g, w = got[:, -1].float(), want[:, -1].float()
    rel = rel_l2(g, w)
    top5 = g[0].topk(5).indices.tolist()
    hit = int(w[0].argmax()) in top5
    check(hit or not gate,
          f"{label}: the plain argmax {int(w[0].argmax())} is not in the "
          f"kernel run's top 5 {top5} (relative L2 {rel:.3e})")
    return rel, hit


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def hybrid_walk(params, cfg, x, plain=False, local=None):
    """The hybrid forward from the embedded input ``x`` block by block
    (``model.forward``'s order: groups of Mamba2 layers, each followed by
    the shared block, then the remainder), with the kernels or
    (``plain``) the plain versions; returns the last position's logits.
    With ``local`` a list, each block also runs with the plain versions
    on the same input and the relative L2 distance of the two blocks'
    updates (output minus input) is appended."""
    from repro_torch.models import model as M

    def both(block):
        y = block()
        if plain:
            return y
        if local is not None:
            with plain_kernels():
                yp = block()
            local.append(rel_l2(y - x, yp - x))
        return y
    layers = params["layers"]
    with plain_kernels() if plain else contextlib.nullcontext():
        for ids, shared in M._hybrid_groups(cfg):
            for i in ids:
                x = both(lambda: M._mamba_block_apply(M.layer(layers, i), x,
                                                      cfg))
            if shared:
                x = both(lambda: M._attn_block_apply(
                    params["shared_attn"], x, cfg, window=None)[0])
        x = M.rmsnorm(params["final_norm"], x[:, -1:])
        return M.unembed(params["unembed"], x, dtype=cfg.logits_dtype)


def block_gate(label, params, cfg, batch, logits, plain_logits, seed):
    """The gate of a deep bf16 hybrid with random weights, whose logits
    move by more than bf16 rounding between any two orders of rounding:
    (1) every block's update with the kernels within ``BLOCK_TOL`` (two
    bf16 ulps, relative L2) of the plain versions' on the same input;
    (2) the kernel run's logits no farther from the plain run's than the
    plain run's from itself with its embedded input perturbed by about
    one bf16 rounding (relative noise of standard deviation
    ``SENS_NOISE``), the model's own sensitivity.  The walk
    must reproduce ``forward``'s logits bit for bit."""
    import torch
    from repro_torch.models import model as M
    x0 = M.embed(params["embed"], batch["tokens"])
    local = []
    walked = hybrid_walk(params, cfg, x0, local=local)
    check(torch.equal(walked, logits),
          f"{label}: the block walk's logits differ from forward's")
    worst = max(local)
    check(worst <= BLOCK_TOL,
          f"{label}: a block's update differs from the plain version's by "
          f"{worst:.3e} relative L2 (bound {BLOCK_TOL:.3e}): {local}")
    gen = torch.Generator(device=x0.device).manual_seed(seed)
    noise = torch.randn(x0.shape, generator=gen, device=x0.device)
    x1 = (x0.float() * (1 + SENS_NOISE * noise)).to(x0.dtype)
    sens = rel_l2(hybrid_walk(params, cfg, x1, plain=True)[:, -1],
                  plain_logits[:, -1])
    rel = rel_l2(logits[:, -1], plain_logits[:, -1])
    check(rel <= sens,
          f"{label}: kernel vs plain logits {rel:.3e} relative L2, more "
          f"than the plain run's own sensitivity {sens:.3e}")
    return worst, len(local), sens


def model_prefill(label, cfg, T, seed, dev, want, gate="top5"):
    """Random weights of ``cfg`` on the card, one counted prefill
    ``forward(last_only=True)`` of T tokens (B 1) that must launch
    ``want``, its ms, tokens/s, peak memory and the kernels' device ms,
    and the same prefill with the plain versions: finite logits of the
    right shape, and by ``gate``: "top5" the plain argmax in the kernel
    run's top 5, "blocks" ``block_gate``, "finite" nothing more.
    Returns (params, counts)."""
    import torch
    from repro_torch.models import model as M
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(gen, cfg, device=dev)
    n_params = sum(t.numel() for t in _leaves(params))
    batch = {"tokens": torch.randint(0, cfg.vocab, (1, T), generator=gen,
                                     device=dev)}
    prefill = lambda: M.forward(params, batch, cfg,  # noqa: E731
                                last_only=True)[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    logits, counts = counted(prefill)
    peak = torch.cuda.max_memory_allocated()
    check_counts("7m", counts, want)
    ms, all_ms = prefill_ms(prefill)
    busy, lm, _, top = lm_kernel_share(prefill)
    with plain_kernels():
        plain, plain_counts = counted(prefill)
        plain_ms = cuda_ms(prefill, 1, warm=0)
    check_counts("7m", plain_counts, {})
    rel, hit = top5_gate(label, logits, plain, (1, 1, cfg.padded_vocab),
                         gate == "top5")
    extra = ""
    if gate == "blocks":
        worst, n, sens = block_gate(label, params, cfg, batch, logits, plain,
                                    seed + 1)
        extra = (f"; every block's update within {worst:.3e} of the plain "
                 f"version's ({n} blocks, bound {BLOCK_TOL:.3e}), the plain "
                 f"run's sensitivity to one bf16 rounding of input noise "
                 f"{sens:.3e}")
    say("7m", f"{label} ({cfg.name}, {cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.dtype}, {n_params:,} parameters, "
              f"param_count {cfg.param_count():,}) prefill B 1 T {T}: "
              f"{ms:.4f} ms ({', '.join(f'{x:.4f}' for x in all_ms)}; "
              f"CUDA events behind a spin), {T / ms * 1e3:.1f} tokens/s, "
              f"peak {peak / 2**30:.3f} GiB; device {busy:.4f} ms of which "
              f"SWA + SSD kernels {lm:.4f} ms ({lm / busy:.3f}); longest: "
              f"{top}; plain "
              f"versions {plain_ms:.4f} ms; last-position logits: "
              f"relative L2 to the plain run {rel:.3e}, plain argmax in "
              f"the kernel run's top 5: {hit}{extra}")
    return params, counts


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def engine_run(cfg, params, dev, seed=3, mesh=None, sampled=True):
    """Four requests through ``DecodeEngine`` (batch 4, seq_len
    ``ENGINE_SEQ``; over ``mesh`` when given, ``params`` then this rank's
    shards), two greedy and two at temperature 0.8 (all greedy without
    ``sampled``): (requests, host s, the recorder, the engine)."""
    import torch
    from repro_torch.obs import RunRecorder
    from repro_torch.serving.engine import DecodeEngine, Request
    g = torch.Generator().manual_seed(5)
    rec = RunRecorder()
    eng = DecodeEngine(cfg, params, batch=len(ENGINE_PROMPTS),
                       seq_len=ENGINE_SEQ, seed=seed, obs=rec, device=dev,
                       mesh=mesh)
    reqs = [Request(prompt=torch.randint(0, cfg.vocab, (n,),
                                         generator=g).tolist(),
                    max_new=ENGINE_NEW,
                    temperature=0.8 * (i % 2) if sampled else 0.0)
            for i, n in enumerate(ENGINE_PROMPTS)]
    t = time.perf_counter()
    done = eng.run(reqs)
    return done, time.perf_counter() - t, rec, eng


def phase_engine(cfg, params, dev):
    """Phase 7m, item 3: the decode engine at ``cfg`` twice; the greedy
    requests' tokens must repeat (decode is plain PyTorch: no kernel)."""
    import torch
    (first, s1, _, _), counts = counted(lambda: engine_run(cfg, params, dev))
    check_counts("7m", counts, {})
    second, s2, rec, eng = engine_run(cfg, params, dev)
    steps = max(ENGINE_PROMPTS) - 1 + ENGINE_NEW
    tok = torch.zeros((len(ENGINE_PROMPTS), 1), dtype=torch.long, device=dev)
    busy, _, wall, top = lm_kernel_share(lambda: eng._step(tok, steps))
    for r in first + second:
        check(len(r.out) == ENGINE_NEW and r.done
              and all(0 <= t < cfg.vocab for t in r.out),
              f"engine: request {r.prompt[:3]}... gave {r.out}")
    for i in (0, 2):
        check(first[i].out == second[i].out,
              f"engine: greedy request {i} gave {first[i].out} then "
              f"{second[i].out}")
    toks = sum(len(r.out) for r in second)
    say("7m", f"DecodeEngine {cfg.name} batch {len(ENGINE_PROMPTS)} "
              f"seq_len {ENGINE_SEQ}, prompts {ENGINE_PROMPTS}, max_new "
              f"{ENGINE_NEW}: {toks} tokens in {s2:.4f} s "
              f"({toks / s2:.2f} tokens/s, {s2 / steps * 1e3:.4f} ms per "
              f"decode step over {steps} steps; first run {s1:.4f} s), "
              f"gauge serve.tokens_per_s "
              f"{rec.metrics.gauge('serve.tokens_per_s').value:.2f}; greedy "
              f"tokens repeat: {first[0].out[:6]}...; sampled requests "
              f"equal across runs: "
              f"{[first[i].out == second[i].out for i in (1, 3)]}; one "
              f"profiled decode step: wall {wall:.4f} ms, device "
              f"{busy:.4f} ms, longest: {top}")


def phase_group_f32(dev, seed=72):
    """Phase 7m, item 2: zamba2-7b at full width, one group (6 Mamba2
    layers and the shared block), float32, T ``GROUP_T``: the kernel
    forward within ``MODEL_TOL`` of the plain forward and of its own
    token-by-token decode over the first ``DECODE_CHECK`` tokens."""
    import torch
    from repro_torch.models import model as M
    cfg = model_config("zamba2-7b", n_layers=6, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(gen, cfg, device=dev)
    tok = torch.randint(0, cfg.vocab, (1, GROUP_T), generator=gen,
                        device=dev)
    fwd = lambda: M.forward(params, {"tokens": tok}, cfg)[0]  # noqa: E731
    logits, counts = counted(fwd)
    check_counts("7m", counts, {"swa_attention_tf32x3": 1, "ssd_scan": 6})
    ms, _ = prefill_ms(fwd)
    with plain_kernels():
        plain = fwd()
    err, ok = within(logits, plain, MODEL_TOL, False)
    check(ok and bool(torch.isfinite(logits).all()),
          f"group float32: max|d| {err:.3e} against the plain forward")
    del plain
    st = M.init_decode_state(cfg, 1, DECODE_CHECK, device=dev)
    dec = []
    for t in range(DECODE_CHECK):
        lg, st = M.decode_step(params, st, tok[:, t: t + 1], t, cfg,
                               seq_len=DECODE_CHECK)
        dec.append(lg)
    dec = torch.cat(dec, dim=1)
    err_d, ok_d = within(dec, logits[:, :DECODE_CHECK], MODEL_TOL, False)
    check(ok_d, f"group float32: decode max|d| {err_d:.3e} against the "
                f"kernel forward")
    say("7m", f"zamba2-7b one group (6 Mamba2 layers + the shared block, d "
              f"{cfg.d_model}, float32) T {GROUP_T}: {ms:.4f} ms per "
              f"forward (full logits); kernel vs plain forward max|d| "
              f"{err:.3e}, decode of the first {DECODE_CHECK} tokens vs "
              f"the kernel forward max|d| {err_d:.3e} (bound rtol = atol "
              f"= {MODEL_TOL[0]})")
    return counts


def phase_lm_model(dev):
    """Phase 7m: the LM models through the kernels; returns the launches
    of the counted runs by counter."""
    import torch
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    cfg = model_config("zamba2-7b")
    check((cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
           cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
           cfg.shared_attn_every, cfg.vocab, cfg.dtype)
          == (81, 3584, 32, 112, 112, 64, 64, 6, 32000, "bfloat16"),
          f"zamba2-7b's config changed: {cfg}")
    n_shared = cfg.n_layers // cfg.shared_attn_every
    params, counts = model_prefill(
        "zamba2-7b full config", cfg, MODEL_T, 71, dev,
        {"swa_attention_tc": n_shared, "ssd_scan": cfg.n_layers},
        gate="blocks")
    add(counts)
    phase_engine(cfg, params, dev)
    del params
    torch.cuda.empty_cache()
    add(phase_group_f32(dev))
    cfg = model_config("mamba2-370m")
    params, counts = model_prefill("mamba2-370m full config", cfg,
                                   MODEL_T, 73, dev,
                                   {"ssd_scan": cfg.n_layers}, gate="finite")
    add(counts)
    del params
    cfg = model_config("granite-3-8b", n_layers=2)
    params, counts = model_prefill("granite-3-8b depth 2", cfg, GROUP_T,
                                   74, dev, {"swa_attention_tc": 2})
    add(counts)
    del params
    torch.cuda.empty_cache()
    say("7m", f"model launches by counter: {total}")
    return total


TRAIN_B, TRAIN_T = 2, 4096   # phase 7t: zamba2-7b's first group, bf16
TRAIN_STEPS, RESUME_AT = 20, 10
TRAIN_LR = 1e-3              # mamba2-370m's steps
# gate (d), set from runs of the plain versions and of the kernels before
# the split-TF32 SSD chunk gradients (bench/learn_gate.py; PERF.md): the
# group's 20 steps at LEARN_LR (no spike there, where 1e-3 spikes at
# steps 6-8 and its fall is a coin flip on the gradients' last bits) from
# each of LEARN_SEEDS; the mean over the seeds of the fall (the mean of
# the first 3 losses less the mean of the last 3; ~0.50 plain and
# kernels) must reach LEARN_MARGIN, and the mean over the seeds of the
# mean |loss - the plain versions' loss| over the steps (0.0034 for
# those kernels; 0.0149 with the SSD backward's dx zeroed, 0.0300
# negated) must stay within TRACK_TOL
LEARN_LR = 3e-4
LEARN_SEEDS = (82, 83, 84)
GROUP_STEP_LAUNCHES = {"swa_attention_tc": 1, "ssd_scan": 6,
                       "swa_attention_bwd": 1, "ssd_scan_bwd": 6}
LEARN_MARGIN = 0.25
TRACK_TOL = 0.007
F32_LOSS_TOL, F32_GRAD_TOL = 1e-4, 1e-3   # phase 7t (b): relative
M370_B, M370_T, M370_STEPS = 4, 2048, 5
EXAMPLE_STEPS = 200


@contextlib.contextmanager
def backward_timer():
    """Within the ``with``: the backward of ``ops.SWAAttention`` and
    ``ops.SSDScan`` (the backward kernels' launches) between two CUDA
    events; yields the list of event pairs, one per backward."""
    import torch
    from repro_torch.kernels import ops
    fns = (ops.SWAAttention, ops.SSDScan)
    origs = [f.backward for f in fns]
    pairs = []

    def timer(orig):
        def timed(ctx, grad):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = orig(ctx, grad)
            b.record()
            pairs.append((a, b))
            return out
        return staticmethod(timed)
    for f, orig in zip(fns, origs):
        f.backward = timer(orig)
    try:
        yield pairs
    finally:
        for f, orig in zip(fns, origs):
            f.backward = staticmethod(orig)


@contextlib.contextmanager
def plain_calls_on_card():
    """Within the ``with``: every call of the LM kernels' plain versions
    (forward and backward) on CUDA tensors is counted; yields the counts
    by name.  On the card's path nothing may call them."""
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import swa_attention as swa
    names = [(swa, "swa_attention_plain"), (swa, "swa_attention_bwd_plain"),
             (ssd, "ssd_scan_plain"), (ssd, "ssd_scan_bwd_plain")]
    counts = {name: 0 for _, name in names}
    saved = [(mod, name, getattr(mod, name)) for mod, name in names]

    def counting(name, fn):
        def call(*args, **kw):
            if any(getattr(a, "is_cuda", False) for a in args):
                counts[name] += 1
            return fn(*args, **kw)
        return call
    for mod, name, fn in saved:
        setattr(mod, name, counting(name, fn))
    try:
        yield counts
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def step_profile(fn):
    """One call of ``fn`` (a train step): (device ms by CUDA events around
    it, the backward kernels' share of them, profiler wall ms, profiler
    busy ms, longest kernels).  The events are queued behind a spin, so
    the step's launches run back to back whatever the host takes."""
    import torch
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with backward_timer() as pairs:
        torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
    ms = a.elapsed_time(b)
    rec = sum(x.elapsed_time(y) for x, y in pairs)
    wall, busy, kernels = device_split(fn)
    top = ", ".join(f"{name[:40]} {us / 1e3:.4f} ({n})"
                    for name, us, n in kernels[:5])
    return ms, rec / ms, wall * 1e3, busy * 1e3, top


def markov_batches(cfg, b, t, n, seed, dev):
    """``n`` batches of the Markov pipeline (tokens = targets), drawn
    before any step is timed."""
    from repro_torch.data.lm_pipeline import batches
    it = batches(cfg.vocab, b, t, seed=seed, device=dev)
    out = []
    for _ in range(n):
        x = next(it)
        out.append({"tokens": x["targets"], "targets": x["targets"]})
    return out


def _tree_max_diff(a, b):
    from repro_torch.training import optimizer as opt
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(opt.tree_leaves(a), opt.tree_leaves(b)))


def _state_max_diff(a, b):
    return max(_tree_max_diff(a.params, b.params),
               _tree_max_diff(a.opt.mu, b.opt.mu),
               _tree_max_diff(a.opt.nu, b.opt.nu),
               float((a.opt.step - b.opt.step).abs()))


def ulp(dtype, mag):
    """One ulp of ``dtype`` at magnitude ``mag``."""
    import math
    import torch
    if mag <= 0:
        return 0.0
    return torch.finfo(dtype).eps * 2.0 ** math.floor(math.log2(mag))


def swa_f64_grads(q, k, v, up, kw, heads=8):
    """float64 autograd of the plain attention (the reference of gate
    (a)), one batch row and ``heads`` query heads (their kv heads) at a
    time so that its graph fits beside the rest."""
    import torch
    from repro_torch.kernels.swa_attention import swa_attention_plain
    f64 = torch.float64
    B, Hq = q.shape[:2]
    Hkv = k.shape[1]
    rep = Hq // Hkv
    step = max(1, heads // rep)
    out = [torch.empty(t.shape, dtype=f64, device=t.device)
           for t in (q, k, v)]
    for b in range(B):
        for g0 in range(0, Hkv, step):
            g1 = min(Hkv, g0 + step)
            sl = (slice(b, b + 1), slice(g0 * rep, g1 * rep))
            slk = (slice(b, b + 1), slice(g0, g1))
            xs = [q[sl].to(f64).requires_grad_(),
                  k[slk].to(f64).requires_grad_(),
                  v[slk].to(f64).requires_grad_()]
            g = torch.autograd.grad(swa_attention_plain(*xs, **kw), xs,
                                    up[sl].to(f64))
            out[0][sl], out[1][slk], out[2][slk] = g
            del xs, g
    torch.cuda.empty_cache()
    return out


def ssd_f64_grads(inputs, up, chunk):
    """float64 autograd of the plain SSD scan (the reference of gate
    (a))."""
    import torch
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    xs = [t.to(torch.float64).requires_grad_() for t in inputs]
    g = torch.autograd.grad(ssd_scan_plain(*xs, chunk=chunk), xs,
                            up.to(torch.float64))
    torch.cuda.empty_cache()
    return g


def kernel_grad_gate(dev, seed=80):
    """Phase 7t (a): at the group's shapes, each kernel's autograd
    Function (the kernel forward that saves its logsumexp or chunk
    states, then the backward kernels) against a float64 autograd of the
    plain version from the same inputs and upstream gradient: each input
    gradient may be at most twice as far from it (max|d|) as autograd of
    the plain version in the inputs' own types is, plus one ulp of the
    gradient's type at its largest element; the gradients in the inputs'
    types; the forward within its phase-3l bound."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    from repro_torch.kernels.swa_attention import swa_attention_plain
    bf16 = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731

    def grads(fn, inputs, up):
        xs = [t.detach().requires_grad_() for t in inputs]
        out = fn(*xs)
        return out.detach(), torch.autograd.grad(out, xs, up)

    B, T = TRAIN_B, TRAIN_T
    qkv = [r(B, 32, T, 112).to(bf16) for _ in range(3)]
    x, dt, A, Bm, Cm = ssd_inputs(B, T, 112, 64, 64, gen, bf16)
    ssd_in = (x, dt, A, Bm.to(bf16), Cm.to(bf16))
    swa_kw = dict(window=T, causal=True, q_offset=0)
    cases = [("swa_attention_tc", "swa_attention_bwd", "qkv", qkv,
              r(B, 32, T, 112).to(bf16),
              lambda *a: ops.swa_attention(*a, window=T),
              lambda *a: swa_attention_plain(*a, window=T),
              lambda ins, up: swa_f64_grads(*ins, up, swa_kw), SWA_TOL),
             ("ssd_scan", "ssd_scan_bwd", ("x", "dt", "A", "B", "C"),
              ssd_in, r(B, T, 112, 64).to(bf16),
              lambda *a: ops.ssd_scan(*a, chunk=SSD_CHUNK),
              lambda *a: ssd_scan_plain(*a, chunk=SSD_CHUNK),
              lambda ins, up: ssd_f64_grads(ins, up, SSD_CHUNK), SSD_TOL)]
    launches = {}
    for name, bwd, names, inputs, up, kern, plain, ref, tol in cases:
        (out, g), counts = counted(lambda: grads(kern, inputs, up))
        check_counts("7t", counts, {name: 1, bwd: 1})
        for k_ in (name, bwd):
            launches[k_] = counts[k_]
        out_p, g_p = grads(plain, inputs, up)
        err, ok = within(out, out_p, tol, True)
        del out, out_p
        g_ref = ref(inputs, up)
        types_ok = all(a.dtype == t.dtype for a, t in zip(g, inputs))
        lines, bad = [], []
        for gname, gk, gp, gr in zip(names, g, g_p, g_ref):
            d_k = float((gk.double() - gr).abs().max())
            d_p = float((gp.double() - gr).abs().max())
            u = ulp(gk.dtype, float(gr.abs().max()))
            lines.append(f"d{gname} ({str(gk.dtype)[6:]}) kernel "
                         f"{d_k:.3e}, plain {d_p:.3e}, bound "
                         f"{2 * d_p + u:.3e}")
            if not d_k <= 2 * d_p + u:
                bad.append(gname)
        del g, g_p, g_ref
        torch.cuda.empty_cache()
        check(not bad and types_ok and ok,
              f"{name}: gradients {bad} farther from the float64 plain "
              f"autograd than twice the plain version's distance plus one "
              f"ulp ({'; '.join(lines)}), types {types_ok}, forward max|d| "
              f"{err:.3e} (ok {ok})")
        say("7t", f"(a) {name} + {bwd} at {tuple(inputs[0].shape)}: max|d| "
                  f"from a float64 autograd of the plain version, the "
                  f"Function's (kernel forward and backward) against "
                  f"autograd of the plain version in the inputs' types "
                  f"(bound: twice the latter plus one ulp of the gradient "
                  f"at its largest element): " + "; ".join(lines)
                  + f"; forward max|d| {err:.3e} (bound rtol {tol[0]} + 1 "
                  f"bf16 ulp, atol {tol[1]})")
    return launches


def f32_group_gate(dev, seed=81):
    """Phase 7t (b): the group in float32, B 1 x T ``TRAIN_T``: the loss
    and gradients of one step through the kernels against the same step
    through the plain versions."""
    import torch
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    cfg = model_config("zamba2-7b", n_layers=6, dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = M.init_params(gen, cfg, device=dev)
    batch = markov_batches(cfg, 1, TRAIN_T, 1, seed, dev)[0]
    step = lambda: T.loss_and_grads(params, batch, cfg,  # noqa: E731
                                    remat=False)
    (total, _, grads), counts = counted(step)
    check_counts("7t", counts, {"swa_attention_tf32x3": 1, "ssd_scan": 6,
                                "swa_attention_bwd_f32": 1,
                                "ssd_scan_bwd": 6})
    with plain_kernels():
        p_total, _, p_grads = step()
    d_loss = abs(float(total) - float(p_total)) / abs(float(p_total))
    rels = {}
    for (path, g), gp in zip(leaves_with_paths(grads),
                             opt.tree_leaves(p_grads)):
        rels[path] = rel_l2(g, gp) if float(gp.norm()) > 0 else \
            float(g.norm())
    worst = max(rels, key=rels.get)
    check(d_loss <= F32_LOSS_TOL and rels[worst] <= F32_GRAD_TOL,
          f"(b) float32 group: loss {float(total):.6f} vs plain "
          f"{float(p_total):.6f} ({d_loss:.3e} relative), worst gradient "
          f"{worst} {rels[worst]:.3e} relative L2")
    say("7t", f"(b) zamba2-7b group float32 B 1 x T {TRAIN_T}: loss "
              f"{float(total):.6f} vs plain {float(p_total):.6f} "
              f"({d_loss:.3e} relative, bound {F32_LOSS_TOL}); worst "
              f"gradient leaf {worst} {rels[worst]:.3e} relative L2 "
              f"(bound {F32_GRAD_TOL}) over {len(rels)} leaves")
    return counts


GRAD_GROUPS = (("embed", ("embed",)), ("mamba layers", ("layers",)),
               ("shared block", ("shared_attn",)),
               ("head", ("final_norm", "unembed")))


def _group_rel(a, b):
    """{group: relative L2 of a's gradients against b's over the group's
    leaves}."""
    import torch
    from repro_torch.dist.sharding import leaves_with_paths
    out = {}
    pa, pb = leaves_with_paths(a), leaves_with_paths(b)
    for name, tops in GRAD_GROUPS:
        x = [g.float().reshape(-1) for p, g in pa if p.split("/")[0] in tops]
        y = [g.float().reshape(-1) for p, g in pb if p.split("/")[0] in tops]
        out[name] = rel_l2(torch.cat(x), torch.cat(y))
    return out


def bf16_grad_gate(cfg, dev, seed):
    """Phase 7t (c): the first step's gradients in bf16 (``train_run``'s
    initial parameters and first batch at ``seed``), kernels against plain
    versions, per leaf group, held to the plain run's own sensitivity:
    its gradients with the embedded input perturbed by about one bf16
    rounding (relative noise ``SENS_NOISE``)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.training import train as T
    params = M.init_params(torch.Generator(device=dev).manual_seed(seed),
                           cfg, device=dev)
    batch = markov_batches(cfg, TRAIN_B, TRAIN_T, 1, seed, dev)[0]
    step = lambda: T.loss_and_grads(params, batch, cfg,  # noqa: E731
                                    remat=False)[2]
    kern = step()
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    noise = torch.randn(tuple(batch["tokens"].shape) + (cfg.d_model,),
                        generator=gen, device=dev)
    orig = M.embed

    def noisy(p, tok):
        x = orig(p, tok)
        return (x.float() * (1 + SENS_NOISE * noise)).to(x.dtype)
    with plain_kernels():
        plain = step()
        M.embed = noisy
        try:
            moved = step()
        finally:
            M.embed = orig
    rel, sens = _group_rel(kern, plain), _group_rel(moved, plain)
    bad = [g for g in rel if rel[g] > sens[g]]
    check(not bad, f"(c) bf16 gradients: kernel vs plain {rel} beyond the "
                   f"plain run's sensitivity {sens} in {bad}")
    say("7t", "(c) bf16 first-step gradients, relative L2 kernel vs plain "
              "(the plain run under one bf16 rounding of input noise): "
              + ", ".join(f"{g} {rel[g]:.3e} ({sens[g]:.3e})" for g in rel))


def train_run(label, cfg, ocfg, dev, b, t, steps, want, seed, resume_at=None):
    """``steps`` train steps of ``cfg`` on Markov batches (B ``b`` x T
    ``t``), each in its own launch-count window holding ``want``; at
    ``resume_at`` the checkpoint round trip (phase 7t (e)); no plain
    version of the LM kernels may be called on a CUDA tensor in them.
    Returns (losses, step ms, peak bytes, launches, the state, the step
    and the batches)."""
    import tempfile
    import torch
    from repro_torch.training import train as T
    batches = markov_batches(cfg, b, t, steps + 1, seed, dev)
    state = T.init_state(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    step = T.make_train_step(cfg, ocfg, remat=False)
    launches = {}
    losses, ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    peak = 0
    with plain_calls_on_card() as plain:
        for i in range(steps):
            if i == resume_at:          # the steps' peak, not the gate's
                peak = max(peak, torch.cuda.max_memory_allocated())
                with tempfile.TemporaryDirectory() as d:
                    state = resume_gate(label, cfg, ocfg, state, batches[i],
                                        d, seed, dev)
                torch.cuda.reset_peak_memory_stats()
                losses.append(None)
                continue
            t0 = time.perf_counter()
            (state, m), counts = counted(lambda: step(state, batches[i]))
            ms.append((time.perf_counter() - t0) * 1e3)
            got = {k: v for k, v in counts.items()
                   if v and k != "sparse_probe"}
            check(got == want, f"{label} step {i}: launch counts {got} != "
                               f"{want}")
            for k, v in want.items():
                launches[k] = launches.get(k, 0) + v
            losses.append(float(m["loss"]))
            check(all(torch.isfinite(x).all() for x in
                      (m["loss"], m["grad_norm"])),
                  f"{label} step {i}: loss {losses[-1]}, grad_norm "
                  f"{float(m['grad_norm'])}")
    say("7t", f"{label}: plain versions called on CUDA tensors in the "
              f"{steps} steps: {plain}")
    check(not any(plain.values()), f"{label}: a plain version ran on the "
                                   f"card: {plain}")
    peak = max(peak, torch.cuda.max_memory_allocated())
    return losses, ms, peak, launches, state, step, batches


def resume_gate(label, cfg, ocfg, state, batch, d, seed, dev):
    """Phase 7t (e): ``state`` saved by ``training.checkpoint`` and
    restored into a fresh state bit for bit; the next step from the
    restored state against the next step from ``state`` (bit for bit, or
    within two uninterrupted runs' max|d|).  Returns the uninterrupted
    run's next state."""
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import train as T
    step = T.make_train_step(cfg, ocfg, remat=False)
    t0 = time.perf_counter()
    path = ckpt.save(d, state, RESUME_AT)
    t_save = time.perf_counter() - t0
    fresh = T.init_state(seed + 1, cfg, device=dev)
    t0 = time.perf_counter()
    restored, at = ckpt.restore(d, fresh)
    t_load = time.perf_counter() - t0
    del fresh
    exact = _state_max_diff(restored, state)
    check(at == RESUME_AT and exact == 0.0,
          f"{label}: restored step {at}, state max|d| {exact:.3e}")
    r_next, _ = step(restored, batch)
    del restored
    s_next, _ = step(state, batch)
    d_resume = _state_max_diff(r_next, s_next)
    del r_next
    s_again, _ = step(state, batch)
    noise = _state_max_diff(s_next, s_again)
    del s_again
    check(d_resume <= noise,
          f"{label}: step {RESUME_AT + 1} after resume max|d| "
          f"{d_resume:.3e}, two uninterrupted runs {noise:.3e}")
    say("7t", f"(e) {label}: checkpoint at step {RESUME_AT} "
              f"({os.path.getsize(path) / 2**30:.3f} GiB, save "
              f"{t_save:.2f} s, restore {t_load:.2f} s host) restored bit "
              f"for bit; step {RESUME_AT + 1} from it vs the uninterrupted "
              f"run max|d| {d_resume:.3e} (two uninterrupted runs "
              f"{noise:.3e})")
    return s_next


def plain_losses(cfg, ocfg, dev, seed):
    """The group's ``TRAIN_STEPS`` losses from ``seed`` (``train_run``'s
    draws) with the plain versions in place of the kernels."""
    import torch
    from repro_torch.training import train as T
    batches = markov_batches(cfg, TRAIN_B, TRAIN_T, TRAIN_STEPS, seed, dev)
    state = T.init_state(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    step = T.make_train_step(cfg, ocfg, remat=False)
    out = []
    with plain_kernels():
        for batch in batches:
            state, m = step(state, batch)
            out.append(float(m["loss"]))
    del state, step, batches
    torch.cuda.empty_cache()
    return out


def learn_stats(got, plain):
    """Gate (d)'s two numbers for one seed: the fall of the losses ``got``
    (None at the resume step; the mean of the first 3 less the mean of
    the last 3) and their mean |loss - the plain versions' loss|."""
    live = [x for x in got if x is not None]
    d = [abs(a - b) for a, b in zip(got, plain) if a is not None]
    return sum(live[:3]) / 3 - sum(live[-3:]) / 3, sum(d) / len(d)


def learn_gate(cfg, ocfg, dev, runs):
    """Phase 7t (d) on the group's runs {seed: losses} through the
    kernels (None at the resume step): the mean fall over the seeds (the
    mean of the first 3 losses less the mean of the last 3) at least
    ``LEARN_MARGIN``, and the mean over the seeds of the mean |loss - the
    plain versions' loss| over the steps within ``TRACK_TOL``.  The fall
    alone does not tell a wrong gradient: with the SSD backward's dx
    zeroed the loss falls as far (PERF.md)."""
    falls, track = [], []
    for seed in LEARN_SEEDS:
        got = runs[seed]
        plain = plain_losses(cfg, ocfg, dev, seed)
        fall, dist = learn_stats(got, plain)
        falls.append(fall)
        track.append(dist)
        shown = [round(x, 4) if x is not None else "resume" for x in got]
        say("7t", f"(d) seed {seed}: losses {shown}, plain "
                  f"{[round(x, 4) for x in plain]}; fell "
                  f"{falls[-1]:.4f}, mean |loss - plain| {track[-1]:.4f}")
    fall, dist = sum(falls) / len(falls), sum(track) / len(track)
    say("7t", f"(d) lr {LEARN_LR:g}, seeds {list(LEARN_SEEDS)}: mean fall "
              f"{fall:.4f} (gate >= {LEARN_MARGIN}), mean |loss - plain| "
              f"{dist:.4f} (gate <= {TRACK_TOL})")
    check(fall >= LEARN_MARGIN, f"(d) the loss fell by {fall:.4f} on the "
                                f"mean of seeds {LEARN_SEEDS}, less than "
                                f"{LEARN_MARGIN}")
    check(dist <= TRACK_TOL, f"(d) the losses part from the plain "
                             f"versions' by {dist:.4f} on the mean, past "
                             f"{TRACK_TOL}")


def say_train(label, cfg, b, t, losses, ms, peak, prof, smi):
    step_ms, share, wall, busy, top = prof
    med = sorted(ms)[len(ms) // 2]
    say("7t", f"{label} ({cfg.n_layers} layers, d {cfg.d_model}, "
              f"{cfg.dtype}) B {b} x T {t}: {med:.4f} ms per train step "
              f"(host clock, median of {len(ms)}; "
              f"{', '.join(f'{x:.1f}' for x in ms)}), "
              f"{b * t / med * 1e3:.1f} tokens/s, peak "
              f"{peak / 2**30:.3f} GiB; one step behind a spin "
              f"{step_ms:.4f} ms (CUDA events), of which the backward "
              f"kernels' Functions {share:.3f}; profiled step: wall "
              f"{wall:.4f} ms, device busy {busy:.4f} ms "
              f"({busy / wall:.3f}); longest: {top}; losses "
              f"{[round(x, 4) if x is not None else 'resume' for x in losses]}"
              f"; {smi}")


def phase_lm_train(dev, smi):
    """Phase 7t: LM training on the card through the SWA and SSD kernels;
    returns the launches of the counted runs by counter."""
    import io
    import math
    import tempfile
    import torch
    from repro_torch.examples import lm_train
    from repro_torch.training import optimizer as opt
    total = {}

    def add(counts):
        for k, v in counts.items():
            if v:
                total[k] = total.get(k, 0) + v

    add(kernel_grad_gate(dev))
    add(f32_group_gate(dev))
    torch.cuda.empty_cache()
    cfg = model_config("zamba2-7b", n_layers=6)
    bf16_grad_gate(cfg, dev, 82)
    torch.cuda.empty_cache()
    ocfg = opt.AdamWConfig(lr=LEARN_LR, warmup_steps=5,
                           total_steps=TRAIN_STEPS)
    want = GROUP_STEP_LAUNCHES
    say("7t", f"zamba2-7b first group: launches per train step {want}")
    losses, ms, peak, launches, state, step, batches = train_run(
        "zamba2-7b group", cfg, ocfg, dev, TRAIN_B, TRAIN_T, TRAIN_STEPS,
        want, LEARN_SEEDS[0], resume_at=RESUME_AT)
    add(launches)
    prof = step_profile(lambda: step(state, batches[-1]))
    say_train("zamba2-7b first group", cfg, TRAIN_B, TRAIN_T, losses, ms,
              peak, prof, smi)
    del state, step, batches
    torch.cuda.empty_cache()
    runs = {LEARN_SEEDS[0]: losses}
    for seed in LEARN_SEEDS[1:]:
        runs[seed], _, _, launches, *rest = train_run(
            f"zamba2-7b group, seed {seed}", cfg, ocfg, dev, TRAIN_B,
            TRAIN_T, TRAIN_STEPS, want, seed)
        add(launches)
        del rest
        torch.cuda.empty_cache()
    learn_gate(cfg, ocfg, dev, runs)

    cfg = model_config("mamba2-370m")
    want = {"ssd_scan": cfg.n_layers, "ssd_scan_bwd": cfg.n_layers}
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=2,
                           total_steps=M370_STEPS)
    losses, ms, peak, launches, state, step, batches = train_run(
        "mamba2-370m", cfg, ocfg, dev, M370_B, M370_T, M370_STEPS, want, 84)
    add(launches)
    prof = step_profile(lambda: step(state, batches[-1]))
    say_train("mamba2-370m full config", cfg, M370_B, M370_T, losses, ms,
              peak, prof, smi)
    del state, step, batches
    torch.cuda.empty_cache()

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as d, \
            contextlib.redirect_stdout(buf):
        hist, counts = counted(lambda: lm_train.main(
            ["--steps", str(EXAMPLE_STEPS), "--ckpt-dir", d]))
    add(counts)
    text = buf.getvalue().strip().splitlines()
    check("LEARNED" in text[-1] and hist[-1]["loss"] < math.log(512) - 0.3,
          f"examples.lm_train: {text[-3:]}")
    say("7t", f"examples.lm_train granite-3-8b smoke, {EXAMPLE_STEPS} steps "
              f"on the card: {' | '.join(text[-3:])}; launches "
              f"{ {k: v for k, v in counts.items() if v} }")
    say("7t", f"train launches by counter: {total}")
    return total


# phase 9t: tensor parallelism over model, TP_RANKS worker processes on the
# one card (gloo, staged through pinned host memory), zamba2-7b's first
# group at full width: (t1) one float32 step at gate (b)'s shape against
# the one-process step, (t2) TP_STEPS bf16 steps against the one-process
# kernel run at the same seed, batch and lr (gate (d)'s distance)
TP_RANKS = 4
TP_GROUP = dict(n_layers=6)          # zamba2-7b's first group: depth cut
TP_T = 4096
TP_F32_B, TP_F32_SEED = 1, 81
TP_BF16_B, TP_STEPS, TP_SEED = 2, 3, 82    # (t2)
TP_LOSS_TOL, TP_NORM_TOL = 1e-5, 1e-5    # (t1), relative
# (t2): each first-step bf16 gradient leaf, gathered, against the one-process
# bf16 step's (relative L2)
TP_BF16_GRAD_TOL = 0.05
TP_TIMEOUT = 600                     # seconds a rank may take
TP_STEP_LAUNCHES = {"f32": {"swa_attention_tf32x3": 1, "ssd_scan": 6,
                            "swa_attention_bwd_f32": 1, "ssd_scan_bwd": 6},
                    "bf16": GROUP_STEP_LAUNCHES}


def tp_shapes(b, t):
    import torch
    meta = torch.empty((b, t), dtype=torch.int64, device="meta")
    return {"tokens": meta, "targets": meta}


def tp_worker(rank, init, job, out):
    """One rank of phase 9t (a process of its own on the card named by
    ``job["device"]``): puts ``(rank, results)`` on ``out``, or
    ``(rank, the error)``."""
    import datetime
    import torch
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        res = _tp_rank(rank, init, job, dist, datetime, torch)
    except BaseException as e:           # the parent fails the phase
        out.put((rank, f"{type(e).__name__}: {e}"))
        raise
    out.put((rank, res))


def _tp_rank(rank, init, job, dist, datetime, torch):
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    dev = torch.device(job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.library()                  # built by the parent: loaded
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group("gloo", init_method=init, world_size=TP_RANKS,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    mesh = make_host_mesh(1, TP_RANKS)
    res = {}

    def setup(cfg, b, seed):
        fn, ssh, _ = T.make_sharded_train_step(cfg, ocfg, mesh,
                                               tp_shapes(b, job["t"]),
                                               remat=False)
        whole = M.init_params(torch.Generator(device=dev).manual_seed(seed),
                              cfg, device=dev)
        params = tpm.shard_tree(whole, mesh, rank)
        del whole
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        state = T.TrainState(params, opt.init(params))
        specs = dict(leaves_with_paths(ssh.params))
        held = sum(t.numel() * t.element_size()
                   for tree in (state.params, state.opt.mu, state.opt.nu)
                   for _, t in leaves_with_paths(tree))
        return fn, specs, state, dict(held=held)

    def run(fn):
        """(fn's result, its launches, plain calls on the card,
        collectives and host ms)."""
        ops.reset_launch_counts()
        tpm.reset_counts()
        sync()
        t0 = time.perf_counter()
        with plain_calls_on_card() as plain:
            got = fn()
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        return got, dict(launches={k: v for k, v in ops.launch_counts()
                                   .items() if v},
                         plain=dict(plain), collectives=tpm.counts(), ms=ms)

    # (t1) float32, one step against the one-process step's loss, norm and
    # gradients (read through a memory map, this rank's slices)
    ocfg = opt.AdamWConfig(lr=LEARN_LR, warmup_steps=5,
                           total_steps=TRAIN_STEPS)
    cfg = model_config("zamba2-7b", dtype="float32", **job["group"])
    fn, specs, state, held = setup(cfg, TP_F32_B, TP_F32_SEED)
    batch = markov_batches(cfg, TP_F32_B, job["t"], 1, TP_F32_SEED, dev)[0]
    (total, met, grads), rec = run(lambda: fn.loss_and_grads(state.params,
                                                             batch))
    rel = rank_rel_l2(grads, job["ref"], specs, mesh, rank)
    del grads
    (_, m), step = run(lambda: fn(state, batch))
    res["f32"] = dict(rec, loss=float(met["loss"]),
                      grad_norm=float(m["grad_norm"]), rel=rel,
                      step_ms=step["ms"], **held,
                      peak=torch.cuda.max_memory_allocated(dev) if cuda
                      else 0)
    del fn, state, batch, m
    if cuda:
        torch.cuda.empty_cache()

    # (t2) bf16, TP_STEPS steps
    cfg = model_config("zamba2-7b", **job["group"])
    fn, specs, state, held = setup(cfg, TP_BF16_B, TP_SEED)
    batches = markov_batches(cfg, TP_BF16_B, job["t"], TP_STEPS, TP_SEED,
                             dev)
    (_, _, grads), first = run(lambda: fn.loss_and_grads(state.params,
                                                         batches[0]))
    first["rel"] = rank_rel_l2(grads, job["ref2"], specs, mesh, rank)
    del grads
    steps = []
    for batch in batches:
        (state, m), rec = run(lambda: fn(state, batch))
        steps.append(dict(rec, loss=float(m["loss"])))
    res["bf16"] = dict(steps=steps, grads=first, **held,
                       peak=torch.cuda.max_memory_allocated(dev) if cuda
                       else 0)
    dist.destroy_process_group()
    return res


def rank_rel_l2(grads, file, specs, mesh, rank):
    """Each gradient leaf's relative L2 distance from the one-process
    gradients in ``file`` (read through a memory map, this rank's slices
    by ``specs``, the fitted spec of each leaf path, on ``mesh``; a split
    leaf's sums taken over every rank of the default group: the data
    ranks hold the same averaged gradients, so the ratio is the model
    group's)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.dist.sharding import leaves_with_paths
    ref = torch.load(file, mmap=True, weights_only=True)["grads"]
    n, c = mesh.shape["model"], mesh.coords(rank)["model"]
    d2, r2, split = [], [], []
    for path, g in leaves_with_paths(grads):
        r = ref[path]
        i = tpm.model_dim(specs[path]) if n > 1 else None
        if i is not None:
            s = r.shape[i] // n
            r = r.narrow(i, c * s, s)
        r = r.to(g.device).float()
        d2.append(((g.float() - r) ** 2).sum())
        r2.append((r ** 2).sum())
        split.append(i is not None)
    sums = torch.stack([torch.stack(d2), torch.stack(r2)], dim=1).cpu()
    split = torch.tensor(split)[:, None]
    part = sums * split              # the slices' sums over the ranks
    dist.all_reduce(part)
    sums = torch.where(split, part, sums)
    return {p: float((d / r) ** 0.5) if r > 0 else float(d ** 0.5)
            for (p, _), (d, r) in zip(leaves_with_paths(grads),
                                      sums.tolist())}


def tp_reference(cfg, b, seed, dev, path):
    """(t1)'s one-process float32 step in this process: its loss, norm and
    gradients written to ``path`` (host tensors by leaf path)."""
    import torch
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    params = M.init_params(torch.Generator(device=dev).manual_seed(seed),
                           cfg, device=dev)
    batch = markov_batches(cfg, b, TP_T, 1, seed, dev)[0]
    (total, met, grads), counts = counted(
        lambda: T.loss_and_grads(params, batch, cfg, remat=False))
    gnorm = float(opt.global_norm(grads))
    torch.save({"loss": float(met["loss"]), "grad_norm": gnorm,
                "grads": {p: g.detach().cpu()
                          for p, g in leaves_with_paths(grads)}}, path)
    del params, grads, batch
    torch.cuda.empty_cache()
    return float(met["loss"]), gnorm, counts


def tp_losses(cfg, ocfg, b, dev, path):
    """(t2)'s one-process kernel run: TP_STEPS bf16 losses from TP_SEED,
    and the first step's gradients written to ``path`` (host tensors by
    leaf path)."""
    import torch
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.training import train as T
    batches = markov_batches(cfg, b, TP_T, TP_STEPS, TP_SEED, dev)
    state = T.init_state(torch.Generator(device=dev).manual_seed(TP_SEED),
                         cfg, device=dev)
    (_, _, grads), c0 = counted(lambda: T.loss_and_grads(
        state.params, batches[0], cfg, remat=False))
    torch.save({"grads": {p: g.detach().cpu()
                          for p, g in leaves_with_paths(grads)}}, path)
    del grads
    step = T.make_train_step(cfg, ocfg, remat=False)
    out, counts = [], [c0]
    for batch in batches:
        (state, m), c = counted(lambda: step(state, batch))
        out.append(float(m["loss"]))
        counts.append(c)
    del state, step, batches
    torch.cuda.empty_cache()
    return out, counts


def tp_spawn(job, tmp, worker=None, phase="9t"):
    """Runs TP_RANKS ``worker`` processes (``tp_worker``); returns their
    results by rank.  Any rank's error, or one past TP_TIMEOUT, stops
    every rank and fails the phase."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.SimpleQueue()
    init = "file://" + os.path.join(tmp, f"{phase}_store")
    procs = [ctx.Process(target=worker or tp_worker, args=(r, init, job, q))
             for r in range(TP_RANKS)]
    for p in procs:
        p.start()
    got, t0 = {}, time.perf_counter()
    try:
        while len(got) < TP_RANKS:
            if not q.empty():
                rank, res = q.get()
                check(isinstance(res, dict), f"{phase} rank {rank}: {res}")
                got[rank] = res
                continue
            dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            check(not dead, f"{phase}: a rank exited with {dead}")
            check(time.perf_counter() - t0 < TP_TIMEOUT + 60,
                  f"{phase}: the ranks did not finish in time")
            time.sleep(0.2)
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return got


def phase_tp(dev, smi):
    """Phase 9t: the tensor-parallel train step (``make_sharded_train_step``
    on a (1, TP_RANKS) mesh) with TP_RANKS worker processes on the one
    card over gloo, zamba2-7b's first group at full width (depth cut).
    The one-process runs come first, in this process, and free the card;
    the kernel library is built before any rank starts (phase 2).  Gates:
    (t1) float32 B 1 x T 4,096, the loss within 1e-5 relative of the
    one-process step's, every gradient leaf (its slices' sums over the
    ranks) within gate (b)'s 1e-3 relative L2, the step's grad_norm
    within 1e-5; (t2) TP_STEPS bf16 steps at B TP_BF16_B within gate
    (d)'s mean loss distance of the one-process kernel run, the first
    step's gradient leaves within TP_BF16_GRAD_TOL relative L2 of its
    (an out-of-memory error fails the phase; the largest B that fits is
    reckoned from the measured peak); on every rank the SWA and SSD
    forward and backward kernels launched and no plain version called on
    the card.  Returns the launches by counter, the ranks' and the
    one-process runs'."""
    import tempfile
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.training import optimizer as opt
    t0 = time.perf_counter()
    cfg32 = model_config("zamba2-7b", dtype="float32", **TP_GROUP)
    cfg16 = model_config("zamba2-7b", **TP_GROUP)
    ocfg = opt.AdamWConfig(lr=LEARN_LR, warmup_steps=5,
                           total_steps=TRAIN_STEPS)
    fitted = dict(leaves_with_paths(shd.param_shardings(
        make_host_mesh(1, TP_RANKS), M.param_specs(cfg16))))
    want_held = {}
    for kind, cfg in (("bf16", cfg16), ("f32", cfg32)):
        # each leaf in its type and two float32 moments, its slice if split
        want_held[kind] = sum(
            x.numel() // (TP_RANKS if tpm.model_dim(fitted[p]) is not None
                          else 1) * (x.element_size() + 8)
            for p, x in leaves_with_paths(M.param_specs(cfg)))
    n_split = sum(x.numel() for p, x in leaves_with_paths(
        M.param_specs(cfg16)) if tpm.model_dim(fitted[p]) is not None)
    n_whole = sum(x.numel() for _, x in leaves_with_paths(
        M.param_specs(cfg16))) - n_split
    say("9t", f"zamba2-7b first group ({cfg16.n_layers} layers, d "
              f"{cfg16.d_model}): {n_split:,} parameters in leaves split over "
              f"model, {n_whole:,} in whole leaves; each of {TP_RANKS} ranks "
              f"holds {n_split // TP_RANKS + n_whole:,} (parameters and "
              f"moments {want_held['bf16'] / 2**30:.3f} GiB bf16, "
              f"{want_held['f32'] / 2**30:.3f} GiB float32)")
    with tempfile.TemporaryDirectory() as tmp:
        ref = os.path.join(tmp, "t1_reference.pt")
        loss1, norm1, c1 = tp_reference(cfg32, TP_F32_B, TP_F32_SEED, dev,
                                        ref)
        check_counts("9t", c1, TP_STEP_LAUNCHES["f32"])
        ref2 = os.path.join(tmp, "t2_reference.pt")
        plain2, c2 = tp_losses(cfg16, ocfg, TP_BF16_B, dev, ref2)
        for c in c2:
            check_counts("9t", c, TP_STEP_LAUNCHES["bf16"])
        torch.cuda.synchronize()
        say("9t", f"one-process runs: (t1) loss {loss1:.6f}, grad_norm "
                  f"{norm1:.6f}; (t2) losses {plain2}; "
                  f"{time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t_spawn = time.perf_counter()
        got = tp_spawn(dict(device=str(dev), ref=ref, group=TP_GROUP,
                            ref2=ref2, t=TP_T), tmp)
    say("9t", f"{TP_RANKS} ranks ran in {time.perf_counter() - t_spawn:.1f} "
              f"s (start-up included)")
    total = {}
    for c in [c1] + c2:             # the one-process runs' launches too
        for k, v in c.items():
            if v and k != "sparse_probe":
                total[k] = total.get(k, 0) + v
    for rank in range(TP_RANKS):
        r = got[rank]
        f32, bf = r["f32"], r["bf16"]
        runs = [("f32", f32), ("bf16 gradients", bf["grads"])] + [
            (f"bf16 step {i}", s) for i, s in enumerate(bf["steps"])]
        for label, rec in runs:
            kind = "f32" if label == "f32" else "bf16"
            check(rec["launches"] == TP_STEP_LAUNCHES[kind]
                  and not any(rec["plain"].values()),
                  f"9t rank {rank} {label}: launches {rec['launches']} != "
                  f"{TP_STEP_LAUNCHES[kind]}, plain calls on the card "
                  f"{rec['plain']}")
            for k, v in rec["launches"].items():
                total[k] = total.get(k, 0) + v
        check(bf["held"] == want_held["bf16"]
              and f32["held"] == want_held["f32"],
              f"9t rank {rank}: holds {bf['held']} / {f32['held']} bytes of "
              f"parameters and moments, not {want_held}")
        coll = bf["steps"][-1]["collectives"]
        ms = [s["ms"] for s in bf["steps"]]
        share = sum(c["seconds"] for c in coll.values()) * 1e3 / ms[-1]
        say("9t", f"rank {rank}: launches per bf16 step "
                  f"{bf['steps'][-1]['launches']}, float32 "
                  f"{f32['launches']}; plain calls on the card "
                  f"{bf['steps'][-1]['plain']}; parameters and moments held "
                  f"{bf['held'] / 2**30:.3f} GiB (bf16), "
                  f"{f32['held'] / 2**30:.3f} GiB (float32); peak "
                  f"{bf['peak'] / 2**30:.3f} GiB (bf16, B {TP_BF16_B}), "
                  f"{f32['peak'] / 2**30:.3f} GiB (float32, B {TP_F32_B}); "
                  f"ms per bf16 step (host clock) "
                  f"{', '.join(f'{x:.1f}' for x in ms)}, float32 "
                  f"gradients {f32['ms']:.1f}, step {f32['step_ms']:.1f}; "
                  f"collectives of the last bf16 step: "
                  + ", ".join(f"{k} {v['calls']} calls {v['bytes']:,} B "
                              f"{v['seconds'] * 1e3:.1f} ms"
                              for k, v in coll.items())
                  + f" (host-clock share {share:.3f}); {smi}")
    peak = max(got[r]["bf16"]["peak"] for r in range(TP_RANKS))
    card = torch.cuda.get_device_properties(dev).total_memory if \
        dev.type == "cuda" else 0
    act = max(peak - want_held["bf16"], 1)
    fits = int(TP_BF16_B * (card / TP_RANKS - want_held["bf16"]) / act)
    say("9t", f"(t2) the batch's reckoning: {TP_RANKS} ranks x peak "
              f"{peak / 2**30:.3f} GiB = {TP_RANKS * peak / 2**30:.3f} GiB "
              f"of the card's {card / 2**30:.3f} GiB; at "
              f"{(peak - want_held['bf16']) / 2**30:.3f} GiB a rank above "
              f"its parameters and moments for B {TP_BF16_B} (activations, "
              f"gradients and the update's new trees), the largest B that "
              f"fits is about {fits}")
    f32 = got[0]["f32"]
    d_loss = abs(f32["loss"] - loss1) / abs(loss1)
    d_norm = abs(f32["grad_norm"] - norm1) / norm1
    worst = max(f32["rel"], key=f32["rel"].get)
    say("9t", f"(t1) float32 B {TP_F32_B} x T {TP_T}: loss {f32['loss']:.6f} "
              f"vs one process {loss1:.6f} ({d_loss:.3e} relative, bound "
              f"{TP_LOSS_TOL}); grad_norm {f32['grad_norm']:.6f} vs "
              f"{norm1:.6f} ({d_norm:.3e}, bound {TP_NORM_TOL}); worst "
              f"gradient leaf {worst} {f32['rel'][worst]:.3e} relative L2 "
              f"(bound {F32_GRAD_TOL}) over {len(f32['rel'])} leaves")
    check(d_loss <= TP_LOSS_TOL and d_norm <= TP_NORM_TOL
          and f32["rel"][worst] <= F32_GRAD_TOL,
          f"(t1) the float32 TP step is off the one-process step: loss "
          f"{d_loss:.3e}, grad_norm {d_norm:.3e}, {worst} "
          f"{f32['rel'][worst]:.3e}")
    losses = [[s["loss"] for s in got[r]["bf16"]["steps"]]
              for r in range(TP_RANKS)]
    check(all(x == losses[0] for x in losses),
          f"(t2) the ranks' losses differ: {losses}")
    dist = sum(abs(a - b) for a, b in zip(losses[0], plain2)) / TP_STEPS
    say("9t", f"(t2) bf16 B {TP_BF16_B} x T {TP_T}, {TP_STEPS} steps of seed "
              f"{TP_SEED} at lr {LEARN_LR:g}: losses {losses[0]}, one "
              f"process {plain2}; mean |d| {dist:.4f} (gate <= {TRACK_TOL})")
    check(dist <= TRACK_TOL, f"(t2) the TP losses part from the one-process "
                             f"run's by {dist:.4f}")
    rel2 = got[0]["bf16"]["grads"]["rel"]
    order = sorted(rel2, key=rel2.get, reverse=True)
    say("9t", f"(t2) the first step's bf16 gradients against the one-process "
              f"run's, relative L2 over {len(rel2)} leaves: worst "
              + ", ".join(f"{p} {rel2[p]:.3e}" for p in order[:3])
              + f"; median {rel2[order[len(order) // 2]]:.3e} (bound "
              f"{TP_BF16_GRAD_TOL})")
    check(rel2[order[0]] <= TP_BF16_GRAD_TOL,
          f"(t2) the bf16 TP gradient of {order[0]} is {rel2[order[0]]:.3e} "
          f"off the one-process step's")
    say("9t", f"phase 9t passed in {time.perf_counter() - t0:.1f} s; "
              f"launches (the ranks' and the one-process runs') {total}")
    return total


# phase 9e: expert parallelism and the vlm's cross-attention under tensor
# parallelism over model, TP_RANKS ranks on the one card as 9t's; the
# models at full width, depth cut: phi3.5-moe's one layer (16 experts, 4 a
# rank) and llama-3.2-vision's first group (4 self layers and a cross
# layer; the image tokens drawn from the seed)
EP_MODELS = {"phi3.5": ("phi3.5-moe-42b-a6.6b", dict(n_layers=1)),
             "vision": ("llama-3.2-vision-11b", dict(n_layers=5))}
# SWA launches of one loss_and_grads (remat off): one forward and one
# backward per self-attention layer
EP_SELF_LAYERS = {"phi3.5": 1, "vision": 4}
EP_DP = (2, 2)                       # phi3.5's step with routing over data
# (t2)'s batch: llama-vision's at B 2 does not fit four ranks on one card
# (a rank's forward reached 17.28 GiB, its vocabulary slice's float32
# logits and their exponentials ~4 GiB of it, beside 5 GiB of parameters
# and moments)
EP_BF16_B = {"phi3.5": TP_BF16_B, "vision": 1}


def ep_launches(model, kind):
    n = EP_SELF_LAYERS[model]
    if kind == "f32":
        return {"swa_attention_tf32x3": n, "swa_attention_bwd_f32": n}
    return {"swa_attention_tc": n, "swa_attention_bwd": n}


def ep_batches(cfg, b, t, n, seed, dev):
    """``markov_batches`` and, for the vlm, image tokens (B, n_image_tokens,
    d) drawn from ``seed`` on the card in the model's type."""
    import torch
    from repro_torch.models.layers import torch_dtype
    out = markov_batches(cfg, b, t, n, seed, dev)
    if cfg.arch_type == "vlm":
        gen = torch.Generator(device=dev).manual_seed(seed)
        for batch in out:
            batch["image_embeds"] = torch.randn(
                (b, cfg.n_image_tokens, cfg.d_model), generator=gen,
                device=dev).to(torch_dtype(cfg.dtype))
    return out


def ep_worker(rank, init, job, out):
    """One rank of phase 9e (as ``tp_worker``; its allocator with
    expandable segments, since four ranks share the card)."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import datetime
    import torch
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        res = _ep_rank(rank, init, job, dist, datetime, torch)
    except BaseException as e:           # the parent fails the phase
        out.put((rank, f"{type(e).__name__}: {e}"))
        raise
    out.put((rank, res))


def _ep_rank(rank, init, job, dist, datetime, torch):
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.kernels import build, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    dev = torch.device(job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.library()                  # built by the parent: loaded
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group("gloo", init_method=init, world_size=TP_RANKS,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    t, res = job["t"], {}
    ocfg = opt.AdamWConfig(lr=LEARN_LR, warmup_steps=5,
                           total_steps=TRAIN_STEPS)

    def setup(cfg, dims, b, seed, moments):
        mesh = make_host_mesh(*dims)
        shapes = tp_shapes(b, t)
        if cfg.arch_type == "vlm":
            shapes["image_embeds"] = torch.empty(
                (b, cfg.n_image_tokens, cfg.d_model), device="meta")
        fn, ssh, _ = T.make_sharded_train_step(cfg, ocfg, mesh, shapes,
                                               remat=False)
        # the ranks draw the whole model in turns, each keeping its shards,
        # so that one whole copy is on the card at a time
        for r in range(TP_RANKS):
            if r == rank:
                whole = M.init_params(torch.Generator(
                    device=dev).manual_seed(seed), cfg, device=dev)
                params = tpm.shard_tree(whole, mesh, rank)
                del whole
                if cuda:
                    torch.cuda.empty_cache()
            dist.barrier()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        state = T.TrainState(params, opt.init(params)) if moments else \
            T.TrainState(params, None)
        held = sum(x.numel() * x.element_size()
                   for tree in (state.params,) + ((state.opt.mu, state.opt.nu)
                                                  if moments else ())
                   for _, x in leaves_with_paths(tree))
        want = dryrun.tp_collectives(cfg, mesh, ssh.params, b // dims[0], t,
                                     remat=False)
        return mesh, fn, dict(leaves_with_paths(ssh.params)), state, held, \
            want

    def run(fn):
        """(fn's result, its launches, plain calls on the card, collectives,
        the routing recorded, host ms)."""
        ops.reset_launch_counts()
        tpm.reset_counts()
        sync()
        t0 = time.perf_counter()
        with plain_calls_on_card() as plain, moe.recording() as routes:
            got = fn()
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        coll = {k: dict(count=v["calls"], result_bytes=v["bytes"])
                for k, v in tpm.counts().items()}
        return got, dict(launches={k: v for k, v in ops.launch_counts()
                                   .items() if v},
                         plain=dict(plain), collectives=coll,
                         seconds={k: v["seconds"] for k, v in
                                  tpm.counts().items()},
                         routes=[(c.tolist(), d) for c, d in routes], ms=ms)

    def grads_and_norm(fn, params, batch):
        _, met, grads = fn.loss_and_grads(params, batch)
        return met, grads, float(fn.grad_norm(grads))

    def peak():
        return torch.cuda.max_memory_allocated(dev) if cuda else 0

    def model_runs(name, arch, over, ref, ref2, b):
        out = {}
        # (t1) float32, loss_and_grads (and the clip's norm) only
        cfg = model_config(arch, dtype="float32", **over)
        mesh, fn, specs, state, held, want = setup(
            cfg, (1, TP_RANKS), TP_F32_B, TP_F32_SEED, False)
        batch = ep_batches(cfg, TP_F32_B, t, 1, TP_F32_SEED, dev)[0]
        (met, grads, gnorm), rec = run(
            lambda: grads_and_norm(fn, state.params, batch))
        out["f32"] = dict(rec, loss=float(met["loss"]), grad_norm=gnorm,
                          rel=rank_rel_l2(grads, ref, specs, mesh, rank),
                          held=held, want=want, peak=peak())
        del fn, state, batch, grads
        if cuda:
            torch.cuda.empty_cache()

        # (t2) bf16, TP_STEPS steps
        cfg = model_config(arch, **over)
        mesh, fn, specs, state, held, want = setup(cfg, (1, TP_RANKS),
                                                   b, TP_SEED, True)
        batches = ep_batches(cfg, b, t, TP_STEPS, TP_SEED, dev)
        (met, grads, _), first = run(
            lambda: grads_and_norm(fn, state.params, batches[0]))
        first["rel"] = rank_rel_l2(grads, ref2, specs, mesh, rank)
        del grads
        steps = []
        for batch in batches:
            (state, m), rec = run(lambda: fn(state, batch))
            steps.append(dict(rec, loss=float(m["loss"])))
        out["bf16"] = dict(steps=steps, grads=first, held=held, want=want,
                           peak=peak())
        del fn, state
        if cuda:
            torch.cuda.empty_cache()
        if name == "phi3.5":
            # the whole batch over EP_DP: each data rank its row, E/2 experts
            mesh, fn, specs, state, held, want = setup(cfg, EP_DP, b,
                                                       TP_SEED, False)
            (met, grads, _), rec = run(
                lambda: grads_and_norm(fn, state.params, batches[0]))
            out["dp"] = dict(rec, loss=float(met["loss"]), held=held,
                             want=want, peak=peak(),
                             rel=rank_rel_l2(grads, ref2, specs, mesh,
                                             rank))
            del fn, state, grads
        del batches
        return out

    for name, arch, over, ref, ref2, b in job["models"]:
        res[name] = model_runs(name, arch, over, ref, ref2, b)
    dist.destroy_process_group()
    return res


def lean_step(cfg, ocfg, state, batch):
    """``make_train_step``'s step (remat off) with the update applied a
    leaf at a time: ``optimizer.apply`` on each leaf alone, with the whole
    gradient's clip norm, so the arithmetic is the same, and each old leaf,
    its moments and its gradient dropped as soon as its new ones exist.
    The step then holds one leaf's temporaries in place of a second copy of
    the state (a 2.1 B-parameter bf16 model with float32 moments does not
    fit one card twice).  Takes over ``state``'s dicts; returns (state,
    metrics)."""
    import torch
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    _, met, grads = T.loss_and_grads(state.params, batch, cfg, remat=False)
    params, mu, nu = state.params, state.opt.mu, state.opt.nu
    with torch.no_grad():
        gnorm = opt.global_norm(grads)
        for path, _ in leaves_with_paths(params):
            *up, k = path.split("/")
            trees = [params, mu, nu, grads]
            for key in up:
                trees = [t[key] for t in trees]
            p, m, v, g = trees
            new_p, new_o, om = opt.apply(ocfg, {k: p[k]}, {k: g[k]},
                                         opt.OptState({k: m[k]}, {k: v[k]},
                                                      state.opt.step),
                                         gnorm=gnorm)
            p[k], m[k], v[k], g[k] = new_p[k], new_o.mu[k], new_o.nu[k], None
    return T.TrainState(params, opt.OptState(mu, nu, new_o.step)), dict(
        met, **om)


def ep_one_process(cfg, b, dev, tmp):
    """The one-process runs of one 9e model in this process: (t1) the
    float32 loss_and_grads, its gradients written to a file; (t2) the first
    bf16 step's gradients written to a file and TP_STEPS bf16 losses at
    batch ``b`` (``lean_step``).
    Returns a record of each (loss, norm, launch counts, routing) and the
    files."""
    import dataclasses
    import torch
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train as T
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    ocfg = opt.AdamWConfig(lr=LEARN_LR, warmup_steps=5,
                           total_steps=TRAIN_STEPS)
    ref, ref2 = (os.path.join(tmp, f"{cfg.name}_{k}.pt")
                 for k in ("t1", "t2"))
    params = M.init_params(torch.Generator(device=dev).manual_seed(
        TP_F32_SEED), cfg32, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    batch = ep_batches(cfg32, TP_F32_B, TP_T, 1, TP_F32_SEED, dev)[0]
    with moe.recording() as routes:
        (_, met, grads), c1 = counted(
            lambda: T.loss_and_grads(params, batch, cfg32, remat=False))
    f32 = dict(loss=float(met["loss"]),
               grad_norm=float(opt.global_norm(grads)), counts=c1,
               routes=[(c.tolist(), d) for c, d in routes])
    torch.save({"grads": {p: g.detach().cpu()
                          for p, g in leaves_with_paths(grads)}}, ref)
    f32["peak"] = torch.cuda.max_memory_allocated(dev)
    del params, grads, batch
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    batches = ep_batches(cfg, b, TP_T, TP_STEPS, TP_SEED, dev)
    state = T.init_state(torch.Generator(device=dev).manual_seed(TP_SEED),
                         cfg, device=dev)
    with moe.recording() as routes:
        (_, met, grads), c0 = counted(lambda: T.loss_and_grads(
            state.params, batches[0], cfg, remat=False))
    torch.save({"grads": {p: g.detach().cpu()
                          for p, g in leaves_with_paths(grads)}}, ref2)
    del grads
    losses, counts = [], [c0]
    for b in batches:
        (state, m), c = counted(lambda: lean_step(cfg, ocfg, state, b))
        losses.append(float(m["loss"]))
        counts.append(c)
    peak = torch.cuda.max_memory_allocated(dev)
    del state, batches, m
    gc.collect()
    torch.cuda.empty_cache()
    return f32, dict(losses=losses, counts=counts, first_loss=float(
        met["loss"]), routes=[(c.tolist(), d) for c, d in routes],
        peak=peak), ref, ref2


def phase_ep(dev, smi):
    """Phase 9e: expert parallelism and the vlm's cross-attention in the
    tensor-parallel train step (``make_sharded_train_step`` on a (1,
    TP_RANKS) mesh; phi3.5 also on EP_DP with the routing over the data
    group), TP_RANKS processes on the one card over gloo as 9t's, for
    each of ``EP_MODELS`` at full width (depth cut).  The one-process
    runs come first, in this process, and free the card.  Gates, as 9t's:
    (t1) float32 B 1 x T 4,096 through ``loss_and_grads``: the loss within
    1e-5 relative, every gradient leaf within gate (b)'s 1e-3 relative
    L2, the clip's norm within 1e-5; (t2) bf16 at ``EP_BF16_B`` (phi3.5 B
    2, llama-vision B 1), TP_STEPS steps within gate (d)'s mean loss
    distance, the first step's gradient leaves within TP_BF16_GRAD_TOL;
    phi3.5's routing (each layer's slots per expert and
    dropped slots) in float32 equal on every rank and to the one-process
    run's; phi3.5 on EP_DP, B 2 (a row a data rank, E/2 experts a rank),
    the loss and gradients against the one-process bf16 step's on the
    whole batch within gate (d)'s and TP_BF16_GRAD_TOL; on every rank the
    SWA forward and backward kernels launched, no plain version called on
    the card, and the collectives counted equal to
    ``dryrun.tp_collectives``.  An out-of-memory error fails the phase.
    Returns the launches by counter, the ranks' and the one-process
    runs'."""
    import tempfile
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    t0 = time.perf_counter()
    total = {}

    def add(counts):
        for k, v in counts.items():
            if v and k != "sparse_probe":
                total[k] = total.get(k, 0) + v

    one, jobs = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for name, (arch, over) in EP_MODELS.items():
            t_model = time.perf_counter()
            cfg16 = model_config(arch, **over)
            tree = M.param_specs(cfg16)
            fitted = dict(leaves_with_paths(shd.param_shardings(
                make_host_mesh(1, TP_RANKS), tree)))
            n_all = sum(x.numel() for _, x in leaves_with_paths(tree))
            n_rank = sum(x.numel() // (TP_RANKS if tpm.model_dim(fitted[p])
                                       is not None else 1)
                         for p, x in leaves_with_paths(tree))
            say("9e", f"{arch} ({cfg16.n_layers} layers, d {cfg16.d_model}"
                      + (f", {cfg16.n_experts} experts top {cfg16.top_k}"
                         if cfg16.is_moe else
                         f", {cfg16.n_image_tokens} image tokens")
                      + f"): {n_all:,} parameters, {n_rank:,} a rank of "
                        f"{TP_RANKS}")
            b16 = EP_BF16_B[name]
            f32, bf, ref, ref2 = ep_one_process(cfg16, b16, dev, tmp)
            check_counts("9e", f32["counts"], ep_launches(name, "f32"))
            for c in bf["counts"]:
                check_counts("9e", c, ep_launches(name, "bf16"))
                add(c)
            add(f32["counts"])
            say("9e", f"{name} one-process runs: (t1) loss "
                      f"{f32['loss']:.6f}, grad_norm {f32['grad_norm']:.6f}, "
                      f"routing {f32['routes']}; (t2) losses "
                      f"{bf['losses']}, the first step's routing "
                      f"{bf['routes']}; peak {f32['peak'] / 2**30:.3f} GiB "
                      f"(float32), {bf['peak'] / 2**30:.3f} GiB (bf16 "
                      f"steps); {time.perf_counter() - t_model:.1f} s")
            one[name] = (cfg16, b16, f32, bf)
            jobs.append((name, arch, over, ref, ref2, b16))
        say("9e", f"this process holds "
                  f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB "
                  f"({torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB "
                  f"reserved) as the ranks start")
        t_spawn = time.perf_counter()
        every = tp_spawn(dict(device=str(dev), models=jobs, t=TP_T), tmp,
                         ep_worker, "9e")
    say("9e", f"{TP_RANKS} ranks ran both models in "
              f"{time.perf_counter() - t_spawn:.1f} s (start-up included)")
    for name, (cfg16, b16, f32, bf) in one.items():
        got = {rank: every[rank][name] for rank in range(TP_RANKS)}
        for rank in range(TP_RANKS):
            r = got[rank]
            runs = [("f32", r["f32"]), ("bf16 gradients", r["bf16"]["grads"])]
            runs += [(f"bf16 step {i}", s)
                     for i, s in enumerate(r["bf16"]["steps"])]
            if "dp" in r:
                runs.append((f"{EP_DP} gradients", r["dp"]))
            for label, rec in runs:
                kind = "f32" if label == "f32" else "bf16"
                # a step, or loss_and_grads and the clip's norm: the same
                want = r[label if label == "f32" else "bf16"
                         if label.startswith("bf16") else "dp"]["want"]
                check(rec["launches"] == ep_launches(name, kind)
                      and not any(rec["plain"].values()),
                      f"9e {name} rank {rank} {label}: launches "
                      f"{rec['launches']} != {ep_launches(name, kind)}, "
                      f"plain calls on the card {rec['plain']}")
                check(rec["collectives"] == want,
                      f"9e {name} rank {rank} {label}: collectives "
                      f"{rec['collectives']} != the dry run's {want}")
                add(rec["launches"])
            bfs = r["bf16"]["steps"]
            ms = [x["ms"] for x in bfs]
            coll = bfs[-1]["collectives"]
            share = sum(bfs[-1]["seconds"].values()) * 1e3 / ms[-1]
            say("9e", f"{name} rank {rank}: launches per bf16 step "
                      f"{bfs[-1]['launches']}, float32 {r['f32']['launches']};"
                      f" plain calls on the card {bfs[-1]['plain']}; held "
                      f"{r['bf16']['held'] / 2**30:.3f} GiB (bf16 parameters "
                      f"and moments), {r['f32']['held'] / 2**30:.3f} GiB "
                      f"(float32 parameters); peak "
                      f"{r['bf16']['peak'] / 2**30:.3f} GiB (bf16, B "
                      f"{b16}), {r['f32']['peak'] / 2**30:.3f} GiB "
                      f"(float32, B {TP_F32_B}); ms per bf16 step (host "
                      f"clock) {', '.join(f'{x:.1f}' for x in ms)}, float32 "
                      f"gradients {r['f32']['ms']:.1f}; collectives of the "
                      f"last bf16 step (= the dry run's): "
                      + ", ".join(f"{k} {v['count']} calls "
                                  f"{v['result_bytes']:,} B "
                                  f"{bfs[-1]['seconds'][k] * 1e3:.1f} ms"
                                  for k, v in coll.items())
                      + f" (host-clock share {share:.3f}); {smi}")
            if "dp" in r:
                say("9e", f"{name} rank {rank} on {EP_DP}: held "
                          f"{r['dp']['held'] / 2**30:.3f} GiB, peak "
                          f"{r['dp']['peak'] / 2**30:.3f} GiB, "
                          f"{r['dp']['ms']:.1f} ms, collectives "
                          f"{r['dp']['collectives']}, routing "
                          f"{r['dp']['routes']}")
        one = got[0]["f32"]
        d_loss = abs(one["loss"] - f32["loss"]) / abs(f32["loss"])
        d_norm = abs(one["grad_norm"] - f32["grad_norm"]) / f32["grad_norm"]
        worst = max(one["rel"], key=one["rel"].get)
        say("9e", f"{name} (t1) float32 B {TP_F32_B} x T {TP_T}: loss "
                  f"{one['loss']:.6f} vs one process {f32['loss']:.6f} "
                  f"({d_loss:.3e} relative, bound {TP_LOSS_TOL}); grad_norm "
                  f"{one['grad_norm']:.6f} vs {f32['grad_norm']:.6f} "
                  f"({d_norm:.3e}, bound {TP_NORM_TOL}); worst gradient leaf "
                  f"{worst} {one['rel'][worst]:.3e} relative L2 (bound "
                  f"{F32_GRAD_TOL}) over {len(one['rel'])} leaves")
        check(d_loss <= TP_LOSS_TOL and d_norm <= TP_NORM_TOL
              and one["rel"][worst] <= F32_GRAD_TOL,
              f"9e {name} (t1): the float32 TP step is off the one-process "
              f"step: loss {d_loss:.3e}, grad_norm {d_norm:.3e}, {worst} "
              f"{one['rel'][worst]:.3e}")
        if cfg16.is_moe:
            routes = [got[r]["f32"]["routes"] for r in range(TP_RANKS)]
            dropped = [d for _, d in f32["routes"]]
            say("9e", f"{name} routing, float32: slots per expert and "
                      f"dropped per layer {f32['routes']} (one process); "
                      f"equal on every rank: "
                      f"{all(x == f32['routes'] for x in routes)}; bf16 "
                      f"first step: one process {bf['routes']}, rank 0 "
                      f"{got[0]['bf16']['grads']['routes']}")
            check(all(x == f32["routes"] for x in routes),
                  f"9e {name}: the ranks' routing {routes} is not the "
                  f"one-process run's {f32['routes']}")
        losses = [[s["loss"] for s in got[r]["bf16"]["steps"]]
                  for r in range(TP_RANKS)]
        check(all(x == losses[0] for x in losses),
              f"9e {name} (t2): the ranks' losses differ: {losses}")
        dist = sum(abs(a - b) for a, b in zip(losses[0], bf["losses"])) \
            / TP_STEPS
        rel2 = got[0]["bf16"]["grads"]["rel"]
        order = sorted(rel2, key=rel2.get, reverse=True)
        say("9e", f"{name} (t2) bf16 B {b16} x T {TP_T}, {TP_STEPS} "
                  f"steps of seed {TP_SEED} at lr {LEARN_LR:g}: losses "
                  f"{losses[0]}, one process {bf['losses']}; mean |d| "
                  f"{dist:.4f} (gate <= {TRACK_TOL}); the first step's "
                  f"gradients, relative L2 over {len(rel2)} leaves: worst "
                  + ", ".join(f"{p} {rel2[p]:.3e}" for p in order[:3])
                  + f"; median {rel2[order[len(order) // 2]]:.3e} (bound "
                  f"{TP_BF16_GRAD_TOL})")
        check(dist <= TRACK_TOL and rel2[order[0]] <= TP_BF16_GRAD_TOL,
              f"9e {name} (t2): losses {dist:.4f} apart, the gradient of "
              f"{order[0]} {rel2[order[0]]:.3e} off the one-process step's")
        if "dp" in got[0]:
            dp = got[0]["dp"]
            rel = dp["rel"]
            w = max(rel, key=rel.get)
            d_dp = abs(dp["loss"] - bf["first_loss"])
            say("9e", f"{name} on {EP_DP}, bf16 B {b16}: loss "
                      f"{dp['loss']:.6f} vs the one-process step on the "
                      f"whole batch {bf['first_loss']:.6f} (|d| {d_dp:.4f}, "
                      f"gate {TRACK_TOL}); worst gradient leaf {w} "
                      f"{rel[w]:.3e} (bound {TP_BF16_GRAD_TOL}); routing "
                      f"{dp['routes']} vs one process {bf['routes']}")
            check(d_dp <= TRACK_TOL and rel[w] <= TP_BF16_GRAD_TOL,
                  f"9e {name} on {EP_DP}: loss {d_dp:.4f} apart, {w} "
                  f"{rel[w]:.3e}")
    say("9e", f"phase 9e passed in {time.perf_counter() - t0:.1f} s; "
              f"launches (the ranks' and the one-process runs') {total}")
    return total


# phase 9s: serving under tensor parallelism over model (the sharded prefill,
# the sharded serve step and DecodeEngine over a mesh), TP_RANKS ranks on
# the one card as 9t's: zamba2-7b's first group at full width on (1, 4),
# phi3.5-moe's one layer (9e's) on SERVE_DP
SERVE_SEED = 91
# (s1) last-position logits in either type, relative L2 to the
# one-process forward with its products and kernels in the ranks' blocks
# (``rank_blocked``); printed beside the plain one-process forward's
# distance, that run's own spread and (float32) both runs' distances to
# a float64 forward
SERVE_TOL = 1e-5
SERVE_DP = (2, 2)          # phi3.5's decode: routing over the data group
# relative input noise of the printed spread: about one rounding
SERVE_NOISE = {"float32": 2.0 ** -24, "bfloat16": SENS_NOISE}
SERVE_DTYPES = ("float32", "bfloat16")
SERVE_LAUNCHES = {"float32": {"swa_attention_tf32x3": 1, "ssd_scan": 6},
                  "bfloat16": {"swa_attention_tc": 1, "ssd_scan": 6}}


@contextlib.contextmanager
def float64_kept():
    """Within the ``with``: ``Tensor.float()`` leaves a float64 tensor as
    it is, so the model's float32 casts keep a float64 forward float64
    (phase 9s's witness)."""
    import torch
    orig = torch.Tensor.float

    def keep(self, *a, **k):
        return self if self.dtype == torch.float64 else orig(self, *a, **k)
    torch.Tensor.float = keep
    try:
        yield
    finally:
        torch.Tensor.float = orig


@contextlib.contextmanager
def rank_blocked(params, mesh):
    """Within the ``with``: a one-process forward of ``params`` makes its
    products and kernel calls in the blocks that the ranks of ``mesh``'s
    ``model`` group make them in: each product with a weight whose
    columns the ranks split (``tensor_parallel.shard_tree``), block by
    block, each block of the weight a contiguous copy as a rank's shard
    is; the SWA and SSD kernels head block by head block where the ranks
    take their heads; the blocks concatenated.  The same sums, in the
    same order and through the same cuBLAS kernels (chosen by shape), as
    the sharded prefill's ranks make."""
    import torch
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.dist.sharding import leaves_with_paths
    from repro_torch.models import attention, mamba2
    n = tpm.model_size(mesh)
    mine = dict(leaves_with_paths(tpm.shard_tree(params, mesh, 0)))
    split = set()
    for path, w in leaves_with_paths(params):
        if w.dim() in (2, 3) and mine[path].shape[:-1] == w.shape[:-1] \
                and mine[path].shape[-1] != w.shape[-1]:
            for i in range(w.shape[0] if w.dim() == 3 else 1):
                v = w[i] if w.dim() == 3 else w
                split.add((v.data_ptr(), tuple(v.shape)))
    del mine
    matmul, swa, ssd = (torch.Tensor.__matmul__, attention.swa_attention,
                        mamba2.ssd_scan)

    def blocks(t, dim, k):
        c = t.shape[dim] // k
        return [t.narrow(dim, r * c, c).contiguous() for r in range(k)]

    def blocked_matmul(a, b):
        if not (isinstance(b, torch.Tensor) and b.dim() == 2
                and (b.data_ptr(), tuple(b.shape)) in split):
            return matmul(a, b)
        return torch.cat([matmul(a, w) for w in blocks(b, 1, n)], dim=-1)

    def blocked_swa(q, k, v, **kw):
        if not tpm.heads_split(n, q.shape[1], k.shape[1]):
            return swa(q, k, v, **kw)
        return torch.cat([swa(*qkv, **kw) for qkv in zip(
            blocks(q, 1, n), blocks(k, 1, n), blocks(v, 1, n))], dim=1)

    def blocked_ssd(x, dt, A, B, C, **kw):
        if not tpm.heads_split(n, x.shape[2]):
            return ssd(x, dt, A, B, C, **kw)
        return torch.cat([ssd(xr, dr, ar, B, C, **kw) for xr, dr, ar in zip(
            blocks(x, 2, n), blocks(dt, 2, n), blocks(A, 0, n))], dim=2)
    torch.Tensor.__matmul__ = blocked_matmul
    attention.swa_attention, mamba2.ssd_scan = blocked_swa, blocked_ssd
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = matmul
        attention.swa_attention, mamba2.ssd_scan = swa, ssd


def cache_digest(state):
    """sha256 of a decode state's bytes, leaf by leaf in order."""
    import hashlib
    import torch
    from repro_torch.training import optimizer as opt
    h = hashlib.sha256()
    for t in opt.tree_leaves(state):
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def serve_worker(rank, init, job, out):
    """One rank of phase 9s (as ``ep_worker``)."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import datetime
    import torch
    import torch.distributed as dist
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        res = _serve_rank(rank, init, job, dist, datetime, torch)
    except BaseException as e:           # the parent fails the phase
        out.put((rank, f"{type(e).__name__}: {e}"))
        raise
    out.put((rank, res))


def _serve_rank(rank, init, job, dist, datetime, torch):
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import tensor_parallel as tpm
    from repro_torch.kernels import build, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serving.engine import make_sharded_prefill
    dev = torch.device(job["device"])
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        build.library()                  # built by the parent: loaded
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group("gloo", init_method=init, world_size=TP_RANKS,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    res = {}

    def shards(cfg, mesh, seed):
        whole = M.init_params(torch.Generator(device=dev).manual_seed(seed),
                              cfg, device=dev)
        local = tpm.shard_tree(whole, mesh, rank)
        del whole
        if cuda:
            torch.cuda.empty_cache()
        return local

    def run(fn):
        """(fn's result, its launches, plain calls on the card, collectives
        and their host seconds, the routing recorded, host ms)."""
        ops.reset_launch_counts()
        tpm.reset_counts()
        sync()
        t0 = time.perf_counter()
        with plain_calls_on_card() as plain, moe.recording() as routes:
            got = fn()
            sync()
        ms = (time.perf_counter() - t0) * 1e3
        return got, dict(launches={k: v for k, v in ops.launch_counts()
                                   .items() if v},
                         plain=dict(plain),
                         collectives={k: dict(count=v["calls"],
                                              result_bytes=v["bytes"])
                                      for k, v in tpm.counts().items()},
                         seconds=sum(v["seconds"] for v in
                                     tpm.counts().values()),
                         routes=[(c.tolist(), d) for c, d in routes], ms=ms)

    def engine(cfg, local, mesh, sampled):
        """(s2): the engine over ``mesh``, then one counted serve step."""
        (done, secs, _, eng), rec = run(lambda: engine_run(
            cfg, local, dev, mesh=mesh, sampled=sampled))
        rec.update(tokens=[r.out for r in done], secs=secs,
                   digest=cache_digest(eng.state), obs=eng.obs is not None)
        tok = torch.zeros((len(ENGINE_PROMPTS), 1), dtype=torch.int64,
                          device=dev)
        steps = max(ENGINE_PROMPTS) - 1 + ENGINE_NEW
        _, one = run(lambda: eng.step_fn(eng.params, eng.state, tok, steps))
        p_sh = shd.param_shardings(mesh, M.param_specs(cfg))
        rows = len(ENGINE_PROMPTS) // eng.dp.n
        rec.update(step=one, step_want=dryrun.serve_collectives(
            cfg, mesh, p_sh, rows, ENGINE_SEQ, decode=True))
        return rec

    mesh = make_host_mesh(1, TP_RANKS)
    for dt in SERVE_DTYPES:
        cfg = model_config("zamba2-7b", dtype=dt, **job["group"])
        local = shards(cfg, mesh, SERVE_SEED)
        tokens = markov_batches(cfg, 1, job["t"], 1, SERVE_SEED,
                                dev)[0]["tokens"]
        pre, p_sh, _ = make_sharded_prefill(cfg, mesh, {"tokens": tokens})
        lg, rec = run(lambda: pre(local, {"tokens": tokens}))
        rec.update(logits=lg.float().cpu().numpy(),
                   want=dryrun.serve_collectives(
            cfg, mesh, p_sh, 1, job["t"], decode=False))
        res[dt] = dict(prefill=rec, engine=engine(cfg, local, mesh, True))
        del local, pre
        if cuda:
            torch.cuda.empty_cache()
    arch, over = job["phi3.5"]
    cfg = model_config(arch, dtype="float32", **over)
    mesh = make_host_mesh(*SERVE_DP)
    res["phi3.5"] = engine(cfg, shards(cfg, mesh, SERVE_SEED + 1), mesh,
                           False)
    dist.destroy_process_group()
    return res


def serve_one_process(dev):
    """The one-process runs of phase 9s in this process: per dtype the
    zamba2-7b group's counted prefill ``forward(last_only=True)`` (its
    logits), the same forward in the ranks' blocks (``rank_blocked``,
    not counted), the spread (the same prefill with its embedded input
    perturbed by about one rounding, ``block_gate``'s noise), and the
    engine's tokens; in float32 the witness: the same forward in float64
    (every parameter widened, the plain versions, ``float64_kept``);
    phi3.5's greedy engine and its routing."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.training import optimizer as opt
    out = {}
    for dt in SERVE_DTYPES:
        cfg = model_config("zamba2-7b", dtype=dt, **TP_GROUP)
        params = M.init_params(torch.Generator(device=dev).manual_seed(
            SERVE_SEED), cfg, device=dev)
        tokens = markov_batches(cfg, 1, TP_T, 1, SERVE_SEED,
                                dev)[0]["tokens"]
        with torch.no_grad():
            logits, counts = counted(lambda: M.forward(
                params, {"tokens": tokens}, cfg, remat=False,
                last_only=True)[0])
            check_counts("9s", counts, SERVE_LAUNCHES[dt])
            x0 = M.embed(params["embed"], tokens)
            gen = torch.Generator(device=dev).manual_seed(SERVE_SEED + 2)
            noise = torch.randn(x0.shape, generator=gen, device=dev)
            x1 = (x0.float() * (1 + SERVE_NOISE[dt] * noise)).to(x0.dtype)
            spread = rel_l2(hybrid_walk(params, cfg, x1)[:, -1],
                            logits[:, -1])
            # the same function in another order of sums: the row twice
            # (B 2: other GEMM shapes), and the plain versions
            twice = rel_l2(M.forward(params, {"tokens": tokens.repeat(
                2, 1)}, cfg, remat=False, last_only=True)[0][:1, -1],
                logits[:, -1])
            with plain_kernels():
                plain = rel_l2(M.forward(params, {"tokens": tokens}, cfg,
                                         remat=False,
                                         last_only=True)[0][:, -1],
                               logits[:, -1])
            with rank_blocked(params, make_host_mesh(1, TP_RANKS)):
                blocked = M.forward(params, {"tokens": tokens}, cfg,
                                    remat=False, last_only=True)[0]
            exact = None
            if dt == "float32":
                p64 = opt.tree_map(lambda t: t.double()
                                   if t.is_floating_point() else t, params)
                cfg64 = model_config("zamba2-7b", dtype="float64",
                                     logits_dtype="float64", **TP_GROUP)
                with plain_kernels(), float64_kept():
                    exact = M.forward(p64, {"tokens": tokens}, cfg64,
                                      remat=False, last_only=True)[0].cpu()
                del p64
        (done, secs, _, _), c = counted(lambda: engine_run(cfg, params,
                                                           dev))
        check_counts("9s", c, {})
        out[dt] = dict(logits=logits.float().cpu(), counts=counts,
                       blocked=blocked.float().cpu(), exact=exact,
                       spread=spread, twice=twice, plain=plain,
                       tokens=[r.out for r in done], secs=secs)
        del params
        torch.cuda.empty_cache()
    arch, over = EP_MODELS["phi3.5"]
    cfg = model_config(arch, dtype="float32", **over)
    params = M.init_params(torch.Generator(device=dev).manual_seed(
        SERVE_SEED + 1), cfg, device=dev)
    with moe.recording() as routes:
        done, secs, _, _ = engine_run(cfg, params, dev, sampled=False)
    out["phi3.5"] = dict(tokens=[r.out for r in done], secs=secs,
                         routes=[(c.tolist(), d) for c, d in routes])
    del params
    torch.cuda.empty_cache()
    return out


def phase_serve(dev, smi):
    """Phase 9s: serving under tensor parallelism over ``model``
    (``serving.engine.make_sharded_prefill``, ``make_sharded_serve_step``
    through ``DecodeEngine(mesh=)``), TP_RANKS processes on the one card
    over gloo as 9t's, after the one-process runs in this process.
    zamba2-7b's first group at full width on (1, TP_RANKS), float32 and
    bf16: (s1) the prefill B 1 x T 4,096 (the SWA and SSD kernels on each
    rank's heads), its last position's logits within SERVE_TOL
    relative L2 of the one-process ``forward(last_only=True)``'s made in
    the ranks' blocks (``rank_blocked``), beside the plain one-process
    forward's distance and its own spread; (s2) ``DecodeEngine`` over the mesh (ENGINE_PROMPTS,
    ENGINE_SEQ, ENGINE_NEW): every rank the same tokens and the same
    cache bits after the run, the greedy tokens in float32 the
    one-process engine's, ``obs`` on rank 0 only; (s3) on every rank
    the prefill launched the SWA and SSD forward kernels, no plain
    version was called on the card, and the prefill's and a decode
    step's collectives equal ``launch.dryrun.serve_collectives``.
    phi3.5-moe's one layer in float32 on SERVE_DP decodes
    ENGINE_PROMPTS greedily: its tokens and its routing (slots per
    expert and dropped, each step's) equal on every rank and to the
    one-process engine's.  Beside (s1) the one-process run's own spread
    is printed: under one rounding of input noise, with the row twice
    (B 2: other GEMM shapes) and with the plain versions.  Every gate is
    evaluated and printed before the phase fails on any.  Returns the
    launches by counter, the ranks' and the one-process runs'."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    failures = []

    def gate(cond, msg):
        """Every gate is evaluated and printed; the phase fails after."""
        if not cond:
            failures.append(msg)
            say("9s", f"FAILED: {msg}")

    one = serve_one_process(dev)
    total = {}
    for dt in SERVE_DTYPES:
        for k, v in one[dt]["counts"].items():
            if v and k != "sparse_probe":
                total[k] = total.get(k, 0) + v
    say("9s", f"one-process runs: zamba2-7b group engine "
              f"{one['float32']['secs']:.2f} s (float32), "
              f"{one['bfloat16']['secs']:.2f} s (bf16); phi3.5 routing "
              f"{one['phi3.5']['routes'][:2]}...; "
              f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t_spawn = time.perf_counter()
        got = tp_spawn(dict(device=str(dev), group=TP_GROUP, t=TP_T,
                            **{"phi3.5": EP_MODELS["phi3.5"]}), tmp,
                       serve_worker, "9s")
    say("9s", f"{TP_RANKS} ranks ran in {time.perf_counter() - t_spawn:.1f} "
              f"s (start-up included)")
    steps = max(ENGINE_PROMPTS) - 1 + ENGINE_NEW
    for dt in SERVE_DTYPES:
        want = one[dt]
        for rank in range(TP_RANKS):
            pre, eng = got[rank][dt]["prefill"], got[rank][dt]["engine"]
            gate(pre["launches"] == SERVE_LAUNCHES[dt]
                  and not any(pre["plain"].values()),
                  f"(s3) 9s rank {rank} {dt} prefill: launches "
                  f"{pre['launches']} != {SERVE_LAUNCHES[dt]}, plain calls "
                  f"on the card {pre['plain']}")
            gate(not eng["launches"] and not any(eng["plain"].values()),
                  f"9s rank {rank} {dt} engine: launches {eng['launches']}"
                  f", plain calls on the card {eng['plain']}")
            gate(pre["collectives"] == pre["want"]
                  and eng["step"]["collectives"] == eng["step_want"],
                  f"(s3) 9s rank {rank} {dt}: collectives "
                  f"{pre['collectives']} / {eng['step']['collectives']} != "
                  f"the dry run's {pre['want']} / {eng['step_want']}")
            for k, v in pre["launches"].items():
                total[k] = total.get(k, 0) + v
            mine = torch.from_numpy(pre["logits"])
            rel = rel_l2(mine, want["logits"])
            rel_b = rel_l2(mine, want["blocked"])
            witness = ""
            if want["exact"] is not None:
                witness = (f"; against the float64 forward: this rank "
                           f"{rel_l2(mine, want['exact']):.3e}, the "
                           f"one-process forward "
                           f"{rel_l2(want['logits'], want['exact']):.3e}")
            coll = ", ".join(f"{k} {v['count']} calls {v['result_bytes']:,}"
                             f" B" for k, v in pre["collectives"].items()
                             if v["count"])
            step_coll = ", ".join(
                f"{k} {v['count']} calls {v['result_bytes']:,} B"
                for k, v in eng["step"]["collectives"].items() if v["count"])
            say("9s", f"rank {rank} {dt} (s1) prefill B 1 x T {TP_T}: "
                      f"{pre['ms']:.1f} ms (host clock), launches "
                      f"{pre['launches']}, plain calls on the card "
                      f"{pre['plain']}; collectives (= the dry run's) "
                      f"{coll}, host share "
                      f"{pre['seconds'] * 1e3 / pre['ms']:.3f}; last "
                      f"position's logits, relative L2: from the "
                      f"one-process prefill in the ranks' blocks "
                      f"{rel_b:.3e}, from the one-process prefill "
                      f"{rel:.3e} (bound {SERVE_TOL} on the first; the "
                      f"one-process run's own spread: under one rounding "
                      f"of input noise {want['spread']:.3e}, the same row "
                      f"twice (B 2) {want['twice']:.3e}, the plain "
                      f"versions {want['plain']:.3e}){witness}; {smi}")
            gate(rel_b <= SERVE_TOL, f"(s1) 9s rank {rank} {dt}: the "
                                     f"sharded prefill's logits are "
                                     f"{rel_b:.3e} off")
            say("9s", f"rank {rank} {dt} (s2) DecodeEngine on (1, "
                      f"{TP_RANKS}): {eng['secs'] / steps * 1e3:.1f} ms per "
                      f"decode step over {steps} steps (host clock; one "
                      f"process {want['secs'] / steps * 1e3:.1f}); "
                      f"collectives' host share "
                      f"{eng['seconds'] * 1e3 / eng['ms']:.3f}; a step's "
                      f"collectives (= the dry run's) {step_coll}; tokens "
                      f"{[t[:4] for t in eng['tokens']]}...; {smi}")
            gate(eng["tokens"] == got[0][dt]["engine"]["tokens"]
                  and eng["digest"] == got[0][dt]["engine"]["digest"],
                  f"(s2) 9s {dt}: rank {rank}'s tokens or cache bits differ "
                  f"from rank 0's")
            gate(eng["obs"] == (rank == 0),
                  f"(s2) 9s rank {rank}: obs recorded {eng['obs']}")
        if dt == "float32":
            mine = got[0][dt]["engine"]["tokens"]
            gate(all(mine[i] == want["tokens"][i] for i in (0, 2)),
                  f"(s2) 9s float32: the greedy tokens {mine} are not the "
                  f"one-process engine's {want['tokens']}")
    p35 = one["phi3.5"]
    for rank in range(TP_RANKS):
        eng = got[rank]["phi3.5"]
        gate(eng["tokens"] == p35["tokens"]
              and eng["routes"] == p35["routes"],
              f"9s phi3.5 on {SERVE_DP} rank {rank}: tokens {eng['tokens']}"
              f" or routing differ from the one-process engine's")
        gate(eng["step"]["collectives"] == eng["step_want"]
              and not eng["launches"] and not any(eng["plain"].values()),
              f"9s phi3.5 rank {rank}: collectives "
              f"{eng['step']['collectives']} != {eng['step_want']}, or "
              f"launches {eng['launches']}, plain {eng['plain']}")
    eng = got[0]["phi3.5"]
    dropped = sum(d for _, d in p35["routes"])
    say("9s", f"phi3.5-moe one layer float32 on {SERVE_DP}: "
              f"{eng['secs'] / steps * 1e3:.1f} ms per decode step (one "
              f"process {p35['secs'] / steps * 1e3:.1f}), a step's "
              f"collectives (= the dry run's) {eng['step']['collectives']};"
              f" greedy tokens and routing equal on every rank and to one "
              f"process ({len(p35['routes'])} steps, {dropped} slots "
              f"dropped); {smi}")
    say("9s", f"phase 9s took {time.perf_counter() - t0:.1f} s; launches "
              f"(the ranks' and the one-process runs') {total}; "
              f"{len(failures)} gates failed")
    for msg in failures:
        check(False, msg)
    return total


def phase_twopass_times(ctx):
    """Phase 7, row 6: the two-pass tile step at svm-ocr's tile (processor
    0's active block of phase 5d, row-strided), driven once with the
    counts set to 0 around it, then held against its plain version and
    the fused step and timed beside the fused step and the cuBLAS mat-vec
    pair."""
    import torch
    from repro_torch.kernels import dso_update, ops
    grid, loss = ctx["grid"], ctx["loss"]
    st0 = ctx["state"]
    db = grid.db
    q, b = 0, 1
    X = grid.Xg[q, :, b * db:(b + 1) * db]
    cols = slice(b * db, (b + 1) * db)
    vec = (grid.yg[q], st0.w_grid[b].clone(), st0.alpha[q].clone(),
           st0.gw_grid[b].clone(), st0.ga[q].clone(), grid.row_nnz_g[q],
           grid.col_nnz[cols], scalars(loss, ctx["lam"], ctx["m"]))
    kw = dict(loss_name=loss, reg_name="l2")
    route = dso_update.twopass_route(X)
    check(route == "span", f"svm-ocr's tile routes {route}, expected span")
    ops.reset_launch_counts()
    got = ops.dso_tile_step(X, *vec, twopass=True, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    check(counts["dso_tile_step_twopass"] == 2
          and counts["dso_primal_update"] == 1
          and sum(counts.values()) == 3,
          f"two-pass tile step: launch counts {counts}, expected 2 passes "
          f"and one launch B")
    # the fused step as the main path runs it: the grid's tile statistics
    stats = dict(tile_row_nnz=grid.tile_row_nnz_g[q, b],
                 tile_col_nnz=grid.tile_col_nnz_g[q, 0, cols])
    plain = dso_update.dso_tile_step_twopass_plain(X, *vec, **kw)
    fused = ops.dso_tile_step(X, *vec, **kw, **stats)
    torch.cuda.synchronize()
    err, ok = compare_tile_steps(got, (plain, fused))
    check(ok, f"two-pass tile step at svm-ocr's tile: max|d| {err:.3e}")
    two = lambda: ops.dso_tile_step(X, *vec, twopass=True, **kw)  # noqa
    one = lambda: ops.dso_tile_step(X, *vec, **kw, **stats)       # noqa
    ms_a, fused_a = cuda_ms(two, 50), cuda_ms(one, 50)
    fused_b, ms_b = cuda_ms(one, 50), cuda_ms(two, 50)
    busy, kern = device_ms_per_call(two, 20)
    plain_ms = cuda_ms(lambda: dso_update.dso_tile_step_twopass_plain(
        X, *vec, **kw), 20)
    lib_ms = cuda_ms(lambda: (torch.mv(X, vec[1]), torch.mv(X.t(), vec[2])),
                     50)
    bound, by = dense_bound(grid.mb, db, 1)
    ms, fused_ms = (ms_a + ms_b) / 2, (fused_a + fused_b) / 2
    say(7, f"dso_tile_step_twopass at svm-ocr's tile ({grid.mb}x{db}, "
           f"row-strided): {ms:.4f} ms per call ({ms_a:.4f}, {ms_b:.4f}; "
           f"device time {busy:.4f} ms per call: "
           + ", ".join(f"{k[:40]}={kms * 1e3:.1f}us" for k, kms in kern[:4])
           + ") "
           f"beside the fused step {fused_ms:.4f} ms ({fused_a:.4f}, "
           f"{fused_b:.4f}); bound {bound:.4f} ms ({by}, one read of X; the "
           f"two passes read it twice), plain {plain_ms:.4f} ms, cuBLAS mv "
           f"pair {lib_ms:.4f} ms, max|d| {err:.3e}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=lib_ms, max_abs_err=err,
                launches=counts["dso_tile_step_twopass"], device_ms=busy)


def phase_dense_main(dev):
    """Phase 5d: svm-ocr through ``solve`` on a Problem drawn on the card:
    ``auto`` (must be ``dense_pallas_block``), then ``dense_pallas_fused``,
    each in its own launch-count window, both against ``dense_jnp``."""
    import numpy as np
    import torch
    from repro_torch.engine import make_grid_data, resolve_backend, solve
    from repro_torch.kernels import ops
    from repro_torch.sparse import density
    from repro_torch.configs.dso_problems import SVM_OCR as cfg
    check(cfg.p == P and cfg.loss == "hinge",
          f"{cfg}: phase 5d draws hinge labels for p={P}")
    t0 = time.perf_counter()
    lam = cfg.lam
    prob = ocr_problem(OCR_M, OCR_D, lam, seed=13, dev=dev)
    be = resolve_backend("auto", density(prob), device_type=dev.type)
    torch.cuda.synchronize()
    say("5d", f"data m={prob.m} d={prob.d} nnz={prob.nnz:.0f} density="
              f"{density(prob):.4f} X={prob.X.numel() * 4} B on the card "
              f"-> auto resolves {be.name}; set-up "
              f"{time.perf_counter() - t0:.1f} s")
    check(be.name == "dense_pallas_block",
          f"auto picked {be.name}, expected dense_pallas_block")
    kw = dict(p=P, epochs=EPOCHS, eta0=cfg.eta0, eval_every=EVAL_EVERY,
              alpha0=cfg.alpha0, device=dev)
    n_step = EPOCHS * P * 1          # epochs x inner iterations x row tiles
    zero = {k: 0 for k in ops.launch_counts()}
    runs = {}
    for backend, want in (
            ("auto", dict(zero, dso_block_step=n_step,
                          dso_primal_update=n_step)),
            ("dense_pallas_fused", dict(zero, dso_tile_step=n_step * P,
                                        dso_primal_update=n_step * P))):
        torch.cuda.reset_peak_memory_stats(dev)
        ops.reset_launch_counts()
        res = solve(prob, backend=backend, **kw)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        say("5d", f"{backend}: launch counts {counts} (design: {want})")
        check(counts == want, f"launch counts {counts} != design {want}")
        primal = [h["primal"] for h in res.history]
        say("5d", f"{backend}: primal per eval " + " ".join(
            f"e{h['epoch']}={h['primal']:.6f}" for h in res.history)
            + f"; gap at the end {res.history[-1]['gap']:.6f}")
        check(all(np.isfinite(primal)), "non-finite primal")
        check(all(b < a for a, b in zip(primal, primal[1:])),
              f"primal did not fall at every evaluation: {primal}")
        say("5d", f"{backend}: primal falls at every evaluation; "
                  f"max_memory_allocated={peak} B")
        runs[backend] = (res, counts)
    twin = solve(prob, backend="dense_jnp", **kw)
    for backend, (res, _) in runs.items():
        rel = [abs(a["primal"] - b["primal"]) / abs(b["primal"])
               for a, b in zip(res.history, twin.history)]
        say("5d", f"{backend} vs plain twin dense_jnp on the card: max rel "
                  f"primal diff {max(rel):.3e} over {len(rel)} evals")
        check(len(rel) == len(res.history) and max(rel) <= TOL,
              f"{backend} and the plain twin disagree: {rel}")

    grid = make_grid_data(prob, P, 1)
    runners = {name: epoch_runner(grid, name, loss="hinge", lam=lam,
                                  m=prob.m, alpha0=cfg.alpha0,
                                  eta0=cfg.eta0)
               for name in ("dense_pallas_block", "dense_jnp")}
    for name, (fresh, run) in runners.items():
        ts = epoch_seconds(fresh, run)
        med = ts[len(ts) // 2]
        say("5d", f"run_epochs s/epoch {name}: median {med:.6f} min "
                  f"{ts[0]:.6f} max {ts[-1]:.6f} over {len(ts)} x {EPOCHS} "
                  f"epochs; X bytes/s at the median "
                  f"{prob.X.numel() * 4 / med:.4e}")
    fresh, run = runners["dense_pallas_block"]
    st = fresh()
    wall, busy, kernels = device_split(lambda: run(st, 2))
    say("5d", f"profiled run_epochs(2) of dense_pallas_block: wall "
              f"{wall:.6f} s, device busy {busy:.6f} s, idle share "
              f"{1 - busy / wall:.3f}; top kernels (us): "
              + ", ".join(f"{k[:48]}={us:.1f}" for k, us, _ in kernels[:6]))
    return dict(grid=grid, layout="dense", loss="hinge", lam=lam, m=prob.m,
                prob=prob, state=runs["auto"][0].state,
                counts={k: runs["auto"][1][k] + runs["dense_pallas_fused"][1]
                        [k] for k in zero})


def dense_bound(rows, cols, procs):
    """(bound ms, bound_by) of a dense tile step: X read once, the row and
    column vectors read and written once, 4 flops per element."""
    nbytes = 4 * procs * rows * cols + 28 * procs * rows + 24 * procs * cols
    ops_n = 4 * procs * rows * cols + 20 * procs * rows + 12 * procs * cols
    by = "bytes" if nbytes / HBM_BYTES_S >= ops_n / F32_OPS_S \
        else "operations"
    return max(nbytes / HBM_BYTES_S, ops_n / F32_OPS_S) * 1e3, by


def phase_dense_times(ctx):
    """Phase 6 at the svm-ocr shape: the dense block step (row 4, p = 4
    active blocks) and the tile step on one processor's block (row 5),
    each beside its bound, its plain version and the cuBLAS mat-vecs of
    the same two products."""
    import torch
    from repro_torch.kernels import dso_update, ops
    grid, loss = ctx["grid"], ctx["loss"]
    dev = grid.yg.device
    p, mb, db = grid.p, grid.mb, grid.db
    st0 = {k: getattr(ctx["state"], k).clone()
           for k in ("w_grid", "gw_grid", "alpha", "ga")}
    blk_list = [1, 2, 3, 0]
    blk = torch.tensor(blk_list, dtype=torch.int32, device=dev)
    scal = scalars(loss, ctx["lam"], ctx["m"])
    slabs = [grid.Xg[q, :, b * db:(b + 1) * db]
             for q, b in enumerate(blk_list)]
    rows = {}

    err, ok = compare_step("dense", grid, st0, blk, scal, 1, loss, "l2")
    check(ok, f"dense block step disagrees at the svm-ocr shape: {err}")
    st = {k: v.clone() for k, v in st0.items()}
    ms = cuda_ms(lambda: run_step("dense", grid, st, blk, scal, 1, loss,
                                  "l2", plain=False), 50)
    busy, kern = device_ms_per_call(lambda: run_step(
        "dense", grid, st, blk, scal, 1, loss, "l2", plain=False), 20)
    st = {k: v.clone() for k, v in st0.items()}
    plain_ms = cuda_ms(lambda: run_step("dense", grid, st, blk, scal, 1,
                                        loss, "l2", plain=True), 5, warm=1)
    lib_ms = cuda_ms(lambda: [(torch.mv(x, st0["w_grid"][b]),
                               torch.mv(x.t(), st0["alpha"][q]))
                              for q, (x, b) in enumerate(zip(slabs,
                                                             blk_list))], 50)
    bound, by = dense_bound(mb, db, p)
    rows["block"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=lib_ms, max_abs_err=err,
                         device_ms=busy)
    say(6, f"dso_block_step: {ms:.4f} ms per call (A+B, {p} processors, "
           f"{p * mb * db * 4} B of X; device time {busy:.4f}"
           f" ms per call under the profiler: "
           + ", ".join(f"{k[:40]}={kms * 1e3:.1f}us" for k, kms in kern[:3])
           + f") bound {bound:.4f} ms ({by}) plain {plain_ms:.4f} ms "
             f"cuBLAS mv pair {lib_ms:.4f} ms max|d| {err:.3e}")

    q, b = 0, blk_list[0]
    X = slabs[q]
    cols = slice(b * db, (b + 1) * db)
    vec = (grid.yg[q], st0["w_grid"][b], st0["alpha"][q], st0["gw_grid"][b],
           st0["ga"][q], grid.row_nnz_g[q], grid.col_nnz[cols], scal)
    kw = dict(loss_name=loss, reg_name="l2",
              tile_row_nnz=grid.tile_row_nnz_g[q, b],
              tile_col_nnz=grid.tile_col_nnz_g[q, 0, cols])
    got = ops.dso_tile_step(X, *vec, **kw)
    want = dso_update.dso_tile_step_plain(X, *vec, **kw)
    torch.cuda.synchronize()
    errs = [max_rel_err(g, w) for g, w in zip(got, want)]
    t_err = max(e for e, _ in errs)
    check(all(ok for _, ok in errs),
          f"dense tile step disagrees at the svm-ocr shape: {t_err}")
    t_ms = cuda_ms(lambda: ops.dso_tile_step(X, *vec, **kw), 50)
    t_busy, _ = device_ms_per_call(lambda: ops.dso_tile_step(X, *vec, **kw),
                                   20)
    t_plain = cuda_ms(lambda: dso_update.dso_tile_step_plain(X, *vec, **kw),
                      20)
    t_lib = cuda_ms(lambda: (torch.mv(X, vec[1]), torch.mv(X.t(), vec[2])),
                    50)
    t_bound, t_by = dense_bound(mb, db, 1)
    rows["tile"] = dict(ms=t_ms, plain_ms=t_plain, bound_ms=t_bound,
                        bound_by=t_by, library_ms=t_lib, max_abs_err=t_err,
                        device_ms=t_busy)
    say(6, f"dso_tile_step: {t_ms:.4f} ms per call (A+B, one processor, "
           f"{mb}x{db} row-strided block; device time "
           f"{t_busy:.4f} ms per call) bound {t_bound:.4f} ms "
           f"({t_by}) plain {t_plain:.4f} ms cuBLAS mv pair {t_lib:.4f} ms "
           f"max|d| {t_err:.3e}")
    return rows


def packed_bytes(ctx, blk):
    """Bytes of the active tiles' live packed slots read by one block step
    (block-ELL: the rows' first tile_row_nnz slots; bucketed: the live
    chunks)."""
    import torch
    grid = ctx["grid"]
    q = torch.arange(grid.p, device=blk.device)
    if ctx["layout"] == "sparse":
        return int(grid.tile_row_nnz_g[q, blk.long()].sum()) * 8
    live = int(grid.chunk_cnt[q, blk.long()].sum())
    return live * grid.mb * 8 * 8


def live_columns(grid, blk, s=0):
    """Columns whose count in row tile ``s`` of the active tile is
    nonzero, over the p processors at ``blk``: the columns the folded
    primal phase steps."""
    import torch
    p, db = grid.p, grid.db
    q = torch.arange(p, device=blk.device)
    tcn = grid.tile_col_nnz_g[:, s].reshape(p, p, db)[q, blk.long()]
    return int((tcn != 0).sum())


def cusparse_pair(ctx, blk, st):
    """The cuSPARSE calls computing a block step's two products: for each
    processor q, X_q w and X_q^T alpha_q by ``torch.mv`` on CSR copies of
    its active tile (q, blk[q]) and of the tile's transpose, made here,
    before any timing.  Never called by the port."""
    import torch
    from repro_torch.kernels import dso_sparse
    grid = ctx["grid"]
    p, mb, db = grid.p, grid.mb, grid.db
    b = blk.long()
    if ctx["layout"] == "sparse":
        qi = torch.arange(p, device=blk.device)
        cols, vals = grid.cols_g[qi, b], grid.vals_g[qi, b]
    else:
        cols, vals = dso_sparse.stage_bucketed(
            grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt, b)
    mats = []
    for q in range(p):
        live = vals[q] != 0
        rows = torch.arange(mb, device=blk.device)[:, None].expand_as(
            live)[live]
        c, v = cols[q][live].long(), vals[q][live]
        a = torch.sparse_coo_tensor(torch.stack([rows, c]), v, (mb, db))
        at = torch.sparse_coo_tensor(torch.stack([c, rows]), v, (db, mb))
        mats.append((a.coalesce().to_sparse_csr(),
                     at.coalesce().to_sparse_csr(), int(b[q]), q))
    return lambda: [(torch.mv(a, st["w_grid"][bb]),
                     torch.mv(at, st["alpha"][q])) for a, at, bb, q in mats]


def phase_times(ctx):
    """Phase 6 for one main-path layout: the folded block step at that
    shape beside its bound, its plain version and the cuSPARSE pair of its
    products; the comparison at this shape gives max_abs_err.  In turns
    with the block step as it was before launch B was folded in
    (``baseline_step``: block-ELL the one-warp-per-row launch A, bucketed
    the global route, then launch B alone): folded, baseline, baseline,
    folded.  Then launch A alone (block-ELL: the main path's kernel and
    the one-warp-per-row one in turns, live, warp, warp, live) and launch
    B's share of the folded step (its
    device time less launch A's alone), each beside its bound; then launch
    B alone (``ops.dso_primal_update``) against its plain version with a
    random acc on every column and w entries outside the box."""
    import math
    import torch
    from repro_torch.kernels import dso_sparse, ops
    grid, layout, loss = ctx["grid"], ctx["layout"], ctx["loss"]
    dev = grid.yg.device
    st0 = {k: getattr(ctx["state"], k).clone()
           for k in ("w_grid", "gw_grid", "alpha", "ga")}
    blk = torch.tensor([1, 2, 3, 0], dtype=torch.int32, device=dev)
    scal = scalars(loss, ctx["lam"], ctx["m"])
    err, ok = compare_step(layout, grid, st0, blk, scal, 1, loss, "l2")
    check(ok, f"{layout} kernel disagrees at the main-path shape: {err}")
    check(all(bool((a == 0).all()) for a in ops._ACC.values()),
          f"{layout}: the folded step left the accumulator nonzero")
    base = baseline_step(ctx, blk, scal)
    b_err, b_ok = compare_step(layout, grid, st0, blk, scal, 1, loss, "l2",
                               step=base)
    check(b_ok, f"the baseline step disagrees at the main-path shape: "
                f"{b_err}")

    def timed(step, label, into):
        st = {k: v.clone() for k, v in st0.items()}
        ms = cuda_ms(lambda: step(st), 200)
        busy, kern = device_ms_per_call(lambda: step(st), 50)
        into.setdefault(label, []).append((ms, busy, kern))

    def fold(st):
        run_step(layout, grid, st, blk, scal, 1, loss, "l2", plain=False)

    times = {}
    for label in ("folded", "baseline", "baseline", "folded"):
        timed(fold if label == "folded" else base, label, times)
    mean = lambda label, i: sum(  # noqa: E731
        t[i] for t in times[label]) / len(times[label])
    ms, busy = mean("folded", 0), mean("folded", 1)
    st = {k: v.clone() for k, v in st0.items()}
    plain_ms = cuda_ms(lambda: run_step(layout, grid, st, blk, scal, 1,
                                        loss, "l2", plain=True), 20)
    lib_ms = cuda_ms(cusparse_pair(ctx, blk, st0), 200)
    p, mb, db = grid.p, grid.mb, grid.db
    slots = packed_bytes(ctx, blk) // 8
    cols = live_columns(grid, blk)
    rows_b = slots * 8 + 28 * p * mb             # launch A: slots, rows
    cols_b = 4 * p * db + 28 * cols              # launch B: tcn, live cols
    nbytes = rows_b + cols_b
    ops_n = 4 * slots + 20 * p * mb + 12 * cols
    bound = max(nbytes / HBM_BYTES_S, ops_n / F32_OPS_S) * 1e3
    name = ctx["counter"]
    row = name + "_hot" if ctx.get("route") == "hot" else name
    step = dict(name=row, route="cuda",
                source="src/repro_torch/csrc/dso_sparse.cu",
                replaces={"sparse": "src/repro/kernels/dso_sparse.py:116",
                          "bucketed": "src/repro/kernels/dso_sparse.py:304"}
                [layout],
                launches=ctx["counts"][name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes" if nbytes / HBM_BYTES_S
                >= ops_n / F32_OPS_S else "operations", library_ms=lib_ms)
    turns = ", ".join(f"{label} {t[0]:.4f}/{t[1]:.4f}"
                      for label in ("folded", "baseline")
                      for t in times[label])
    say(6, f"{row}: {ms:.4f} ms per call (one folded launch, {p} "
           f"processors, {slots} live packed slots, {cols} live columns of "
           f"{p * db}; device time {busy:.4f} ms per call under the "
           f"profiler: "
           + ", ".join(f"{k[:44]}={kms * 1e3:.1f}us"
                       for k, kms in times["folded"][0][2][:3])
           + f") bound {bound:.4f} ms plain {plain_ms:.4f} ms cuSPARSE mv "
             f"pair {lib_ms:.4f} ms max|d| {err:.3e}")
    say(6, f"{row} in turns with the baseline step ("
           + ("the one-warp-per-row launch A" if layout == "sparse"
              else "the global route's launch A")
           + f" + launch B alone; max|d| "
           f"{b_err:.3e}), ms/device ms per block step: {turns}; baseline "
           f"{mean('baseline', 0):.4f} ms, device "
           f"{mean('baseline', 1):.4f} ms ("
           + ", ".join(f"{k[:44]}={kms * 1e3:.1f}us"
                       for k, kms in times["baseline"][0][2][:3]) + ")")

    padded = p * mb * getattr(grid, "K", 0) * 8 + 28 * p * mb   # all slots
    kernels = ("live", "warp", "warp", "live") if layout == "sparse" \
        else (ctx["route"], ctx["route"])
    alone = {}
    for kernel in kernels:
        timed(launch_a_step(ctx, blk, scal, kernel)[0], kernel, alone)
    a_bound = rows_b / HBM_BYTES_S * 1e3
    a_dev = sum(t[1] for t in alone[kernels[0]]) / len(alone[kernels[0]])
    line = ", ".join(f"{k} {t[0]:.4f}/{t[1]:.4f}" for k in dict.fromkeys(
        kernels) for t in alone[k])
    say(6, f"{row}: launch A alone (ms/device ms per launch, in turns): "
           f"{line}; bytes bound of the live slots {a_bound:.4f} ms"
           + (f", of all K slots (the one-warp-per-row kernel reads them) "
              f"{padded / HBM_BYTES_S * 1e3:.4f} ms; the padded-slot bound "
              f"of the block step, as rows 1 and 2 had it before: "
              f"{(padded + 24 * p * db) / HBM_BYTES_S * 1e3:.4f} ms"
              if layout == "sparse" else ""))
    b_share = busy - a_dev
    say(6, f"{row}: launch B's share of the folded step (its device time "
           f"less launch A's alone): {b_share * 1e3:.2f} us; bound "
           f"{cols_b / HBM_BYTES_S * 1e6:.2f} us (4 B of tcn per column, "
           f"28 B per live column: {cols} of {p * db}, "
           f"{cols / (p * db):.4f}); every column's 32 B: "
           f"{32 * p * db / HBM_BYTES_S * 1e6:.2f} us")

    acc = torch.randn(p, db, device=dev, generator=torch.Generator(
        device=dev).manual_seed(1)) * 1e-2
    stp = {k: v.clone() for k, v in st0.items()}
    w_hi = scal[4]
    if math.isfinite(w_hi):            # entries the step must clamp back
        stp["w_grid"][:, ::7] = 2.0 * w_hi
        stp["w_grid"][:, 3::7] = -2.0 * w_hi
    a = {k: v.clone() for k, v in stp.items()}
    b = {k: v.clone() for k, v in stp.items()}
    ops.dso_primal_update(blk, a["w_grid"], a["gw_grid"], acc.clone(),
                          grid.tile_col_nnz_g, grid.col_nnz, 0, scal,
                          reg_name="l2")
    dso_sparse.primal_update_plain(blk, b["w_grid"], b["gw_grid"],
                                   acc.clone(), grid.tile_col_nnz_g,
                                   grid.col_nnz, 0, scal, "l2")
    torch.cuda.synchronize()
    errs = [max_rel_err(a[k], b[k]) for k in ("w_grid", "gw_grid")]
    p_err, p_ok = max(e for e, _ in errs), all(ok for _, ok in errs)
    check(p_ok, f"primal kernel disagrees: {p_err}")
    acc_t = acc.clone()
    p_ms = cuda_ms(lambda: ops.dso_primal_update(
        blk, a["w_grid"], a["gw_grid"], acc_t, grid.tile_col_nnz_g,
        grid.col_nnz, 0, scal, reg_name="l2"), 200)
    p_plain = cuda_ms(lambda: dso_sparse.primal_update_plain(
        blk, b["w_grid"], b["gw_grid"], acc_t, grid.tile_col_nnz_g,
        grid.col_nnz, 0, scal, "l2"), 50)
    p_bytes = 32 * p * db
    p_bound = max(p_bytes / HBM_BYTES_S, 12 * p * db / F32_OPS_S) * 1e3
    say(6, f"dso_primal_update ({layout} shape, random acc on every column, "
           f"w outside the box on 2 of 7 columns): {p_ms:.4f} ms bound "
           f"{p_bound:.5f} ms plain {p_plain:.4f} ms max|d| {p_err:.3e}")
    primal = dict(ms=p_ms, plain_ms=p_plain, bound_ms=p_bound,
                  max_abs_err=p_err)
    return step, primal


def launch_a_time(label, grid, route, hot, lam, m):
    """The bucketed launch A alone on ``grid`` (blocks [1, 2, 3, 0]) by
    ``route`` (the hot route with the table ``hot``): ms per launch by
    CUDA events over 200 back-to-back launches and the device ms per
    launch under the profiler over 50, beside the bytes bound of its live
    slots.  Launch A is called directly (no launch B, so the accumulator
    keeps growing, which changes no work), and these launches are not
    counted."""
    import torch
    from repro_torch.kernels import dso_sparse
    dev = grid.yg.device
    blk = torch.tensor([1, 2, 3, 0], dtype=torch.int32, device=dev)
    eta, _, m, _, _ = scalars("logistic", lam, m)
    st = random_state(grid, "logistic", seed=6)
    acc = torch.zeros_like(st["w_grid"])
    slots = packed_bytes(dict(grid=grid, layout="bucketed"), blk) // 8
    nbytes = slots * 8 + 28 * grid.p * grid.mb

    def launch():
        dso_sparse.launch_bucketed_dual_scatter(
            grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt, blk,
            grid.yg, st["w_grid"], st["alpha"], st["ga"],
            grid.tile_row_nnz_g, grid.row_nnz_g, acc, 0, grid.mb, eta, m,
            "logistic", route=route, hot=hot)
    ms = cuda_ms(launch, 200)
    dev_ms, _ = device_ms_per_call(launch, 50)
    say(6, f"bucketed launch A alone, {label} (buckets {grid.bucket_ks}, "
           f"{slots} live slots), route {route}: {ms:.4f} ms per launch "
           f"(events), device {dev_ms:.4f} ms per launch under the "
           f"profiler; bytes bound {nbytes / HBM_BYTES_S * 1e3:.4f} ms")
    return dict(ms=ms, device_ms=dev_ms, slots=slots)


def bucketed_launch_a_times(buck, news):
    """Phase 6, the bucketed launch A alone: at the logistic-real-sim
    shape (p 4, mb 18,078, db 5,240) the global and shared routes in turns
    on the power-law grid of phase 5 and on a K-bucketed grid of phase 4's
    uniform svm-real-sim CSR; at news20's shape (db 338,798) the global
    and hot routes in turns, then the hot route with its slots per CTA the
    SM's shared memory split 1 to 8 ways (``dso_sparse.hot_slots``)."""
    from repro_torch.kernels import dso_sparse, ops
    from repro_torch.sparse import bucketed_grid_from_csr
    dev = buck["grid"].yg.device
    csr, y = realsim_csr(REALSIM_M, REALSIM_D, REALSIM_K, None, seed=4)
    grids = {"power-law grid": buck["grid"],
             "uniform grid": bucketed_grid_from_csr(csr, y, P, 1,
                                                    device=dev)}
    out = {}
    for gname, grid in grids.items():
        for route in ("global", "shared", "shared", "global"):
            out.setdefault((gname, route), []).append(launch_a_time(
                gname, grid, route, None, buck["lam"], buck["m"]))
    grid = news["grid"]
    table = ops.grid_hot_table(grid.col_nnz, grid.p, grid.db)
    for route in ("global", "hot", "hot", "global"):
        out.setdefault(("news20", route), []).append(launch_a_time(
            "news20 grid", grid, route, table if route == "hot" else None,
            news["lam"], news["m"]))
    for share in range(1, 9):
        n, reached = dso_sparse.hot_slots(share)
        hot = dso_sparse.hot_table(grid.col_nnz, grid.p, grid.db, n)
        out["news20", f"hot, shared memory split {share} ways"] = [
            launch_a_time(f"news20 grid, {n} hot slots (the SM's shared "
                          f"memory split {share} ways; {reached} CTAs per "
                          f"SM)", grid, "hot", hot, news["lam"], news["m"])]
    return out


def probe_times(dev):
    import torch
    from repro_torch.kernels import dso_sparse, ops
    cols, w = ops._probe_inputs(dev)
    err = float((ops.sparse_probe(cols, w)
                 - dso_sparse.probe_plain(cols, w)).abs().max())
    ms = cuda_ms(lambda: ops.sparse_probe(cols, w), 200)
    busy, _ = device_ms_per_call(lambda: ops.sparse_probe(cols, w), 50)
    plain_ms = cuda_ms(lambda: dso_sparse.probe_plain(cols, w), 200)
    nbytes = cols.numel() * 4 + 2 * w.numel() * 4
    torch.cuda.synchronize()
    say(6, f"sparse_probe: {ms:.4f} ms per call (device time {busy:.4f} ms "
           f"per call under the profiler) bound "
           f"{nbytes / HBM_BYTES_S * 1e3:.2e} ms plain {plain_ms:.4f} ms")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                bound_ms=nbytes / HBM_BYTES_S * 1e3)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    smi = smi_line()
    say(1, f"nvidia-smi: {smi}")
    say(1, f"torch {torch.__version__} cuda {torch.version.cuda} "
           f"device {torch.cuda.get_device_name(0)} "
           f"count {torch.cuda.device_count()} "
           f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lib = build.library()
    say(2, f"built {lib.path} from {[f.name for f in build.sources()]} in "
           f"{lib.build_s:.2f} s")
    injected = 0
    for line in lib.log.splitlines():
        if "(C7519)" in line:           # ptxas's wgmma register fences
            injected += 1
        elif any(w in line for w in ("registers", "Compiling entry", "smem",
                                     "spill", "warning", "error")):
            say(2, line.strip())
    say(2, f"ptxas notes C7519 (warpgroup.arrive injected before a wgmma "
           f"that uses registers) {injected} times")

    worst = phase_kernels(dev)
    say(3, f"all block-step cases within {TOL}: worst max|d| {worst:.3e}")
    worst_d = phase_dense_kernels(dev)
    say("3d", f"all dense cases within {TOL}: worst max|d| {worst_d:.3e}")
    worst_t = phase_twopass_kernels(dev)
    say("3t", f"all two-pass cases within {TOL}: worst max|d| "
              f"{worst_t:.3e}")
    worst_l = phase_lm_kernels(dev)
    worst_l.update(phase_lm_bwd_kernels(dev))
    say("3l", "all LM kernel cases within their bounds: worst max|d| "
              + ", ".join(f"{k} {'bf16' if bf else 'float32'} {e:.3e}"
                          for (k, bf), e in worst_l.items()))

    from repro_torch.configs.dso_problems import ALL as CONFIGS
    serial = phase_serial(dev)

    uni = phase_main(4, dev, CONFIGS["svm-real-sim"], powerlaw=None,
                     expect="sparse_pallas", seed=4)
    ingest = {"4i": phase_ingest("4i", dev, uni, CONFIGS["svm-real-sim"],
                                 obs=True)}
    buck = phase_main(5, dev, CONFIGS["logistic-real-sim"], powerlaw=1.3,
                      expect="sparse_bucketed_pallas", seed=5,
                      route="shared")
    news = phase_main("5n", dev, CONFIGS["logistic-news20"], powerlaw=1.3,
                      expect="sparse_bucketed_pallas", seed=6,
                      shape=(NEWS20_M, NEWS20_D, NEWS20_K), route="hot")
    ingest["5i"] = phase_ingest("5i", dev, news, CONFIGS["logistic-news20"])
    dense = phase_dense_main(dev)

    t8 = time.perf_counter()
    runtime = phase_runtime(dev, {
        "svm-real-sim": (uni, CONFIGS["svm-real-sim"], uni["counter"]),
        "logistic-news20": (news, CONFIGS["logistic-news20"],
                            news["counter"]),
        "svm-ocr": (dense, CONFIGS["svm-ocr"], "dso_block_step")})
    phase_health(dev, uni, CONFIGS["svm-real-sim"])
    phase_reshard(dev, uni, CONFIGS["svm-real-sim"],
                  runtime["svm-real-sim"]["store"])
    phase_obs(dev, buck, CONFIGS["logistic-real-sim"])
    phase_switch(dev, buck, CONFIGS["logistic-real-sim"])
    clamps = {name: phase_clamp(dev, ctx, CONFIGS[name])
              for ctx, name in ((uni, "svm-real-sim"),
                                (buck, "logistic-real-sim"),
                                (news, "logistic-news20"))}
    say(8, f"phases 8r, 8h, 8s, 8o, 8w, 8c passed in "
           f"{time.perf_counter() - t8:.1f} s")
    t10 = time.perf_counter()
    full = realsim_problem(uni, dev)
    base_rows, base_err = phase_baseline_kernels(dev, full)
    base_launches = phase_sec5(dev, full)
    del full                        # 6.06 GB, freed before 9r's workers
    torch.cuda.empty_cache()
    say(10, f"phases 3b and 10 passed in {time.perf_counter() - t10:.1f} s")
    per_worker = EPOCHS * P          # epochs x inner iterations x row tiles
    ring = phase_ring(dev, {
        "svm-real-sim": (uni, CONFIGS["svm-real-sim"],
                         {uni["counter"]: per_worker}, None),
        "logistic-news20": (news, CONFIGS["logistic-news20"],
                            {news["counter"]: per_worker}, None),
        "svm-ocr": (dense, CONFIGS["svm-ocr"],
                    {"dso_block_step": per_worker,
                     "dso_primal_update": per_worker}, dense["prob"])},
        clamps)
    del clamps

    s_step, s_primal = phase_times(uni)
    b_step, b_primal = phase_times(buck)
    n_step, _ = phase_times(news)
    bucketed_launch_a_times(buck, news)
    d_rows = phase_dense_times(dense)
    t_row = phase_twopass_times(dense)
    lm = phase_lm_full(dev)
    lm.update(phase_lm_bwd_full(dev))
    t7m = time.perf_counter()
    model = phase_lm_model(dev)
    say("7m", f"phase 7m passed in {time.perf_counter() - t7m:.1f} s")
    t7t = time.perf_counter()
    train = phase_lm_train(dev, smi)
    say("7t", f"phase 7t passed in {time.perf_counter() - t7t:.1f} s")
    # the phases' grids and states are done with (their launch counts
    # stay): the card is 9t's ranks'
    for ctx in (uni, buck, news, dense):
        for k in [k for k in ctx if k not in ("counts", "counter")]:
            del ctx[k]
    torch.cuda.empty_cache()
    tp = phase_tp(dev, smi)
    ep = phase_ep(dev, smi)
    serve = phase_serve(dev, smi)
    probe = probe_times(dev)
    primal = dict(name="dso_primal_update", route="cuda",
                  source="src/repro_torch/csrc/dso_sparse.cu",
                  replaces="src/repro/kernels/dso_sparse.py:116",
                  launches=sum(ctx["counts"]["dso_primal_update"]
                               for ctx in (uni, buck, news, dense)),
                  max_abs_err=max(s_primal["max_abs_err"],
                                  b_primal["max_abs_err"]),
                  ms=s_primal["ms"], plain_ms=s_primal["plain_ms"],
                  bound_ms=s_primal["bound_ms"], bound_by="bytes",
                  library_ms=None)
    say(6, f"dso_primal_update at the bucketed shape: {b_primal}")
    # the ring's main-path launches (phase 9r, every worker) count too
    s_step["launches"] += ring["svm-real-sim"][uni["counter"]]
    n_step["launches"] += ring["logistic-news20"][news["counter"]]
    primal["launches"] += ring["svm-ocr"]["dso_primal_update"]
    probe_row = dict(name="sparse_probe", route="cuda",
                     source="src/repro_torch/csrc/dso_sparse.cu",
                     replaces="src/repro/kernels/ops.py:223",
                     launches=sum(ctx["counts"]["sparse_probe"]
                                  for ctx in (uni, buck, news)),
                     bound_by="bytes", library_ms=None, **probe)
    dense_rows = []
    for key, name, line in (("block", "dso_block_step", 354),
                            ("tile", "dso_tile_step", 314)):
        r = dict(d_rows[key])
        r.pop("device_ms")
        dense_rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/dso_update.cu",
            replaces=f"src/repro/kernels/dso_update.py:{line}",
            launches=dense["counts"][name]
            + ring["svm-ocr"].get(name, 0), **r))
    t_row.pop("device_ms")
    lm_rows = [
        dict(name="dso_tile_step_twopass", route="cuda",
             source="src/repro_torch/csrc/dso_twopass.cu",
             replaces="src/repro/kernels/dso_update.py:440", **t_row)]
    # (row name, launch counter, phase-7 case, source, reference call);
    # the packed route's row: its pack kernel and entry point (the
    # attention is row 7's kernel)
    for name, counter, label, src, ref in (
            ("swa_attention_tc", "swa_attention_tc", SWA_FULL[0][0],
             "swa_attention_tc.cu", "swa_attention.py:81"),
            ("swa_attention_tf32x3", "swa_attention_tf32x3", SWA_FULL[2][0],
             "swa_attention_tf32x3.cu", "swa_attention.py:81"),
            ("swa_attention_packed", "swa_attention", SWA_FULL[4][0],
             "swa_attention.cu", "swa_attention.py:81"),
            ("ssd_scan", "ssd_scan", SSD_FULL[0][0], "ssd_scan.cu",
             "ssd_scan.py:70")):
        r = dict(lm[counter, label])
        r.pop("device_ms")
        r["launches"] = sum(v["launches"] for (k, _), v in lm.items()
                            if k == counter) + model.get(counter, 0) \
            + train.get(counter, 0) + tp.get(counter, 0) \
            + ep.get(counter, 0) + serve.get(counter, 0)
        lm_rows.append(dict(name=name, route="cuda",
                            source=f"src/repro_torch/csrc/{src}",
                            replaces=f"src/repro/kernels/{ref}", **r))
    # the backward kernels replace no pallas_call: the reference's gradient
    # is XLA's of its jnp paths (models/attention.py:90 _attend,
    # models/mamba2.py:106 ssd_chunked); their rows carry the old
    # recompute's ms beside the plain backward's
    for counter, label, src in (
            ("swa_attention_bwd", SWA_BWD_FULL[0][0],
             "swa_attention_bwd.cu"),
            ("swa_attention_bwd_packed", SWA_BWD_FULL[2][0],
             "swa_attention.cu"),
            ("swa_attention_bwd_f32", SWA_BWD_FULL[3][0],
             "swa_attention_bwd_tf32x3.cu"),
            ("ssd_scan_bwd", SSD_BWD_FULL[0][0], "ssd_chunk_grad.cu")):
        r = dict(lm[counter, label])
        r.pop("device_ms")
        r["launches"] = sum(v["launches"] for (k, _), v in lm.items()
                            if k == counter) + train.get(counter, 0) \
            + tp.get(counter, 0) + ep.get(counter, 0)
        lm_rows.append(dict(name=counter, route="cuda",
                            source=f"src/repro_torch/csrc/{src}",
                            replaces=None, **r))
    say("3s", f"serial_epoch row: {serial}; ingest: {ingest}")
    baseline_rows = []
    for name in ("sgd_epoch", "dcd_epoch"):
        r = dict(base_rows[name])
        r.pop("device_ms")
        baseline_rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/baselines.cu", replaces=None,
            launches=base_launches[name], max_abs_err=base_err[name],
            library_ms=None, **r))
    print(json.dumps({"kernels": [s_step, b_step, n_step, primal, probe_row]
                      + dense_rows + lm_rows + [serial] + baseline_rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
