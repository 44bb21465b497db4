#!/usr/bin/env python3
"""Proof on one NVIDIA H100 that the PyTorch port builds, is right and trains.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

  1. the card: CUDA present, its name and power limit (nvidia-smi);
  2. build every kernel from src/repro_torch/kernels/csrc (one nvcc per
     source, all at once) and print the compiler's register/spill report,
     with a summary of each K1/K2 instantiation (a spill fails);
  3. each kernel against its plain PyTorch version on the card, in fp32 and
     bf16, at the shapes the main paths give it and at ragged ones, with the
     reference's tolerances on results of unit scale (see ``check``); the
     sign and coupled sqrt families of K3, K6 and K7 also on non-symmetric,
     independent X and Y, at the Shampoo bias shapes and at the largest
     coupled slice the fused tier admits in each dtype (one just above it
     must take the grid tier); K5 (one thread-block cluster a slice) at
     every main-path shape, at n below its cluster size and at p = 1 and
     16, with two launches bitwise equal, and two K6 launches bitwise
     equal in every family; K4 at the same shapes and at [4, 4096, 4096]
     (which only K4 takes), two powers, each launch made twice and
     bitwise equal (its arrival counters are zero after every launch),
     and at n = 1024, p = 8 the K4 loop's traces bitwise K5's;
     every main-path K1/K2 shape must take the kernels' aligned
     instantiation; at every main-path shape, in fp32 (K1
     and K2 also in bf16), the kernel, the plain version and one PyTorch
     library call (where one computes the same function) are timed with
     CUDA events (median of 20 launches; K3, K6 and K7, shorter than the
     host's time to launch them, also as the median of 20 runs of 10
     launches back to back and as the mean device time of 20 launches in
     a profiler trace; K4 too, with R's streamed rate); K1 and K2 also
     at the lowrank tier's shapes (``LOWRANK_SHAPES``: the vocab bucket
     through l = 136, contractions up to K = 50272) in fp32 and bf16,
     checked, timed beside ``torch.bmm``/``baddbmm`` and their bound, and
     at one ragged l = 21 case on the element-by-element instantiation;
     and at granite-moe's Muon buckets (``GRANITE_SHAPES``: [588, 1024,
     512], [12, 1024, 1024], [6, 1024, 32]), the recurrent families'
     (``RECURRENT_SHAPES``, phase 13) and phase 15's (``P15_SHAPES``:
     (a)'s shares [20, 1024, 1024] and [10, 4096, 1024] of gpt2-paper's
     buckets, and (b)'s row blocks [20, 512, 1024] and [10, 2048, 1024],
     on which K2 forms the partial Gram -X^T X with alpha = 0; and
     (c)/(d)'s share of Shampoo's factor bucket, ``P15_SHAMPOO_SHAPES``,
     [50, 1024, 1024]) and phase 16's (``P16_SHAPES``: each data rank's
     half of granite's buckets at 2 layers, [98, 1024, 512], [2, 1024,
     1024], [1, 1024, 32]) and phase 17's (``P17_SHAPES``: each data
     rank's half of falcon-mamba-7b's buckets at 2 layers, [1, 16384,
     4096], [1, 8192, 4096], [1, 8192, 288], [1, 8192, 256], [1, 8192,
     16], of recurrentgemma-2b's at one period, [5, 2560, 2560], [3,
     7680, 2560], [1, 4096, 2560], [1, 2560, 256], and of
     musicgen-medium's at 2 layers, [4, 2048, 1536], [2, 6144, 1536]; a
     median of RECURRENT_REPS launches) in fp32, the same way; K3 (polar
     ``[15, 64, 16]``,
     sqrt), K5 (``[50, 1024, 1024]`` x 10), K6 and K7 (sqrt, coupled) also
     at phase 15's shares ``[15, 16, 16]`` and ``[15, 64, 64]``;
  4. the PRISM-5 path: the gpt2-paper Muon/PRISM-5 training step at full
     width (seq 512, batch 4, random weights from seed 0), STEPS steps
     through the launcher's configuration (``build_path``); the launch
     counts are zeroed just before and read just after (no K1/K2 launch
     may take the unaligned instantiation on any path), and must be 19 a
     step (matmul_add 12, gram_upper 6, warm_tail 1); the losses must be
     finite and start near ln(50257); one Muon update through the kernels
     must agree with the same update through the plain versions
     (``use_kernels=False``); the Muon step and the forward+backward pass
     are timed on their own;
  5. the PRISM-3 path: the same step with PRISM-3 (degree 1, 3 warm then 2
     fitted iterations), which runs the fitted-iteration kernels: 29
     launches a step (matmul_add 10, gram_upper 10, warm_tail 1,
     sketch_chain 4, residual_chain 2, apply_g 2), the same loss and update
     gates; the route (``ops.chain_route``: K5 or K4) of each grid
     bucket with the card's budget and with a forced one, beside the
     card's resident K5 clusters; the fallback path: one PRISM-3 Muon step
     with the shared-memory budget forced below sketch_chain's footprint,
     so that the chain runs as sketch_step launches (24), within the same
     bound of the step through sketch_chain; the synchronizing calls of
     one Muon step of each configuration (the fit must add none); a
     profiler trace of one PRISM-3 Muon step; an adaptive run (``tol``) on
     a grid-tier and a fused-tier bucket whose launches must match the
     iterations it ran;
  6. the Shampoo PRISM-5 path: the gpt2-paper step with Shampoo and its
     default PRISM (degree 2, 3 warm iterations), ``precondition_every=1``
     so that every step computes the inverse roots: 17 launches a step
     (matmul_add 15 on the [100, 1024, 1024] factor bucket, warm_tail 2 on
     the bias buckets [30, 16, 16] and [30, 64, 64], sqrt family), the
     same loss and update gates, a profiler trace of one Shampoo step;
  7. the Shampoo fitted path (benchmarks/fig5_shampoo.py's PrismConfig:
     degree 2, 5 fitted iterations, sketch 8; lr 3e-3): 50 launches a step
     (matmul_add 25, sketch_chain 5, residual_chain 10, apply_g 10), the
     same loss gates, the update gate with the kernel run's fitted alphas
     (``PINNED_ALPHA``); with ``precondition_every=2`` the second step
     launches nothing; the synchronizing calls of one Muon and one
     Shampoo step (no more than the one K3's alpha copy made before it
     became a kernel argument; the fit adds none); a profiler trace of
     one step; adaptive ``matfn.sqrtm`` runs whose launches must match
     their iterations; the Shampoo step with ``matfn_method="eigh"``
     timed beside it;
  8. the main example through the ``Trainer`` (gpt2-paper at full width,
     Muon PRISM-5, ``precond_every=5``) in a temporary checkpoint
     directory under ``build/``, removed at the end: run A, 7 steps with
     a checkpoint every 3 (2 kept), must launch 19 a step (K1 12, K2 6,
     K3 1) at steps 0 and 5 and nothing at the others, leave HEARTBEAT at
     step 6 and steps 3 and 6 that verify; run B, a fresh Trainer with
     another model seed over a copy of step 3 alone, must restore the
     parameters, the optimizer state and its count bitwise as run A held
     them after step 2, launch 0, 0, 19, 0 at steps 3 to 6, and keep its
     losses within RESUME_LOSS_TOL of run A's; per-step times, each
     checkpoint's bytes and write time and the restore time are logged;
     then two steps each of ``--method polar_express`` and ``--optimizer
     adamw`` (finite losses, no port kernel launched; their optimizer ms
     beside PRISM-5's from phase 4), one Muon step with
     ``matfn_method="svd"`` (timed, a finite update), and the
     ``skip_nonfinite`` guard on a NaN gradient: parameters, state and
     count bitwise unchanged, ``bad_steps`` 1, the launches of a good
     step, no more synchronizing calls than phase 4's step;
  9. Shampoo's other inverse roots and Muon's lowrank tier, PHASE9_STEPS
     full-width steps each with phase 4's gates (launches, losses,
     kernels-vs-plain update, unaligned instantiation, synchronizing
     calls): (a) Shampoo with ``p_root=4`` (PRISM coupled inverse Newton,
     plain PyTorch products as in the reference: 0 port kernels), its step
     beside phase 6's, a profile with the whole alpha fit's host time, and
     ``matfn.inv_proot(p=4)`` / ``matfn.inv("prism_chebyshev")`` on a
     full-rank [16, 1024, 1024] bucket against ``eigh`` / ``solve``; (b)
     ``matfn_method="newton"`` (DB-Newton, cuSOLVER's Cholesky; 0 port
     kernels); (c) ``bucketed=False`` (the per-leaf loop: K1/K3 launches
     derived from the leaves; one step's inverse roots within
     PER_LEAF_REL_TOL of the bucketed engine's and its parameter change
     within UPDATE_REL_TOL, each said bitwise or not); (d) Muon with the
     lowrank tier (``LOWRANK``): each bucket's tier (and the default
     aspect's, not run), 42 launches a step (K1 29, K2 12, K3 1), a
     profile listing each K1/K2 launch by shape with its device time;
 10. the §12 async refresh plane at full width, through the ``Trainer``
     (``precond_async``, swap delay 1), with deterministic algorithms on
     for the phase (the embedding gradient's atomic adds would otherwise
     make any two runs differ): (a) Muon PRISM-5, ``precond_every`` 5, 7
     steps: the launches of each ``step_begin`` (the refresh, on a side
     CUDA stream) and of each step apart: 19 (K1 12, K2 6, K3 1) at the
     bootstrap (step 0) and the clock (step 5), none at the others, and no
     step launches one of its own; telemetry refreshes 2, bootstrap 1,
     clock 1, discarded 0; finite losses starting near ln(50257); the
     dispatch, swap and steady step times beside phase 8's; the
     synchronizing calls a step (a steady step no more than phase 8's
     steady step, the swap step one more at most: the verdict read); a
     profiler trace of a dispatch step (the streams of the refresh's and
     the step's kernels and their overlap, logged); the same run with
     ``torch.cuda.synchronize()`` after each ``step_begin`` must end in a
     state bitwise the async run's; (b) fitted Shampoo (phase 7's
     PrismConfig), ``precond_every`` 3, 5 steps: 50 launches (K1 25, K5 5,
     K6 10, K7 10) at each refresh, none a step, async and blocking runs
     bitwise equal; (c) a refresh that writes a NaN into a pending twin
     before its verdict: discarded at once (pending_at cleared, every
     active buffer finite) and retried past the swap window; (d) a
     checkpoint written while a refresh is in flight holds ``pending_at``
     and no pending twin, and a fresh Trainer restoring it bootstraps (19
     refresh launches at its first step, finite losses);
 11. serving gpt2-paper at full width in bf16 (``launch/serve.py``,
     ``serving/``), no PRISM kernel launched from (a) to (d): first the
     train -> serve handoff, two Trainer steps of Muon PRISM-5 with a
     checkpoint each, in a temporary ``build/phase11_*`` directory removed
     at the end: a fresh Model (seed 1) through ``restore_params`` holds
     the Trainer's parameters bitwise, and with a byte of step 2's payload
     flipped ``restore_params`` falls back to step 1; (a) batch mode
     (``SERVE_ARGS``: batch 4, prompt 1536, so the prefill crosses two KV
     blocks, gen 32, cache_len 1568, greedy): tokens in the vocab, every
     logit finite, prefill ms and prompt tokens/s, decode ms a step and
     tokens/s, the KV cache bytes; ``prefill_cache`` at lengths 96, 61, 17
     against a streamed active-masked decode loop (kpos bitwise, logits
     within 5e-2 + 5e-2|x|); (b) the Engine (slots 16, cache_len 64, EOS
     0, greedy) over the launcher's trace (seed 0) cut to 20 requests: on
     the virtual clock (a STEP_DT = 35 ms tick, the card's own) one
     decode shape, every request done, a tick with every
     other lane inactive leaving their k, v and kpos rows bitwise, two
     runs equal, continuous admission in fewer decode steps than static
     with as many tokens; on the wall clock at qps 20 and 1e6, tokens/s,
     p50/p99 latency, decode ms a tick and prefill calls; a profiler trace
     of full-table ticks (host against device time); (c) 8 requests
     through a batch-1 loop against their slot-table tokens: a divergence
     only where the batch-1 top-2 logit gap is under 1e-2 of the largest
     |logit| (the count of bitwise-equal sequences logged); (d)
     ``top_k=1`` at temperature 0.7 gives the greedy tokens, and a sampled
     run (temperature 0.8, top_k 50) replays bitwise; the phase's
     ``max_memory_allocated``;
 12. the moe family (the registry, ``launch/train.py``, ``models/moe.py``):
     (a) granite-moe-1b-a400m at its published widths (32 experts top-8),
     depth cut to GRANITE_LAYERS (6 of 24; 421,770,240 parameters), seq
     GRANITE_SEQ, batch 8, bf16 compute and fp32 masters, STEPS Trainer
     steps of
     Muon PRISM-5 through ``launch/train.py``'s configuration
     (``cut_trainer``) with a checkpoint at the last: Muon's views 588 x
     [1024, 512], 12 x [1024, 1024], 6 x [1024, 32]; 27 launches a step
     (K1 18, K2 9: three grid-tier buckets, three warm iterations each);
     the step-0 CE within 1.5 of ln(V) and the aux loss within a factor 2
     of a balanced router's, coef x K summed over the layers (6 x 0.08 =
     0.48); one Muon update
     through the kernels against ``use_kernels=False`` within 1e-3,
     repeated bitwise, with no synchronizing call; a train step repeated
     from the same state bitwise (deterministic algorithms on; with them
     off, printed); step ms,
     tokens/s, the data stream, forward+backward alone, the optimizer
     through the kernels and through torch.matmul, max_memory_allocated,
     a profile of the Muon step by K1/K2 shape and of a whole train step
     (device busy, idle share, top kernels); (b) that checkpoint served in
     bf16 through ``restore_params`` (bitwise the trained parameters),
     phase 11's (a) and (b) on it, the KV cache of batch mode exactly
     77,095,424 bytes, prefill against the streamed decode at drop-free
     capacity gated in fp32 (within 2e-2 + 2e-2|x|, the reference's fp32
     moe decode test; in bf16 a rounding difference can flip a near-tie
     at the top-k boundary, so the bf16 gap is printed), and (c) printed,
     not gated: global dispatch couples the Engine's lanes by design; (c)
     mixtral-8x7b (forward+backward, prefill against a streamed decode
     drop-free, as in (b)), musicgen-medium
     (forward+backward, one Muon step, one decode step) and llava-next-34b
     (2880 patches: forward, loss and ``prefill_cache``) at their
     published widths, 2 layers each, finite results;
 13. the recurrent families (``models/ssm.py``, ``models/rglru.py``, the
     ssm and hybrid stacks of ``models/transformer.py``): (a)
     recurrentgemma-2b at its published widths (d 2560, vocab 256000),
     depth cut to RGEMMA_LAYERS (5 of 26: one (rec, rec, attn) period
     and the two tail layers; 1,005,432,320 parameters) through
     ``launch/train.py``'s configuration (``cut_trainer``; seq
     RECURRENT_SEQ, batch 8, Muon PRISM-5), STEPS Trainer steps: Muon's
     views 20 x [2560, 2560], 10 x [2560, 7680], 2 x [2560, 4096], 2 x
     [2560, 256]; the launches of each step
     equal to those derived from the port's bucket plan and tiers
     (``plan_launches``: 4 grid buckets, K1 24, K2 12); the step-0 CE
     within 1.5 of ln(V); the Muon update through the kernels against
     ``use_kernels=False`` within 1e-3, repeated bitwise, with no
     synchronizing call; a train step repeated bitwise under deterministic
     algorithms; step ms, tokens/s, forward+backward alone, a profiled
     train step, max_memory_allocated; its compute-dtype parameters
     checkpointed under a temporary ``build/phase13_*``; (b)
     falcon-mamba-7b at every published width (d 4096, d_inner 8192,
     state 16, dt_rank 256, vocab 65024), depth cut to FALCON_LAYERS (2
     of 64; 743,305,216 parameters), the same gates (5 grid buckets: K1 30, K2
     15), and the selective scan of one layer timed forward and backward
     and profiled (device busy, device kernels); (c) each checkpoint
     through ``restore_params`` into a fresh model (bitwise), served in
     bf16 by ``launch/serve.batch_loop`` at batch 4, prompt 128, gen 32
     (tokens in the vocab, logits finite, the decode state's bytes those
     of ``init_cache``'s shapes, exactly 1,067,520 and 4,587,520), a
     profiled decode step, ``prefill_cache`` of ragged lengths 96, 61, 17
     bitwise a streamed active-masked decode loop in the logits and every
     cache leaf, a step with one lane inactive leaving its leaves bitwise,
     no PRISM kernel; (d) both at full width in fp32 (recurrentgemma 5
     layers: one period and the two tail layers; falcon 2), 32 greedy
     decode steps against the forward logits within 2e-2 + 2e-2|x|; K1/K2
     at these buckets' shapes (``RECURRENT_SHAPES``) are checked and timed
     in phase 3 (median of RECURRENT_REPS launches);
 14. data parallelism (``phase14``): a world of P14_WORLD = 2 ranks that
     share the card, spawned, joined by ``launch/mesh.init_world`` on
     gloo (printed; NCCL refuses two ranks on one device) through a file
     store under a temporary ``build/phase14_*`` removed at the end,
     with a P14_TIMEOUT_S timeout on every collective and P14_DEADLINE_S
     on the world (a rank that raises fails the phase); the kernels are
     built before the ranks start.  First the single-process Trainer
     (gpt2-paper, Muon PRISM-5, seq 512, global batch 4, P14_STEPS steps,
     seed 0) for (b)'s losses and step-0 update, and one step of it at
     fp32 compute for its update.  On each rank, under
     ``make_debug_mesh(data=2, model=1)``: (a) gpt2-paper Muon's buckets
     (random views of its 9 matrix shapes) through ``polar_bucketed``,
     fp32, PRISM-5 and PRISM-3, single and sharded: each rank launches
     the single process's count (19: K1 12, K2 6, K3 1; 29: K1 10, K2 10,
     K3 1, K5 4, K6 2, K7 2), the gathered polars within P14_POLAR_TOL
     (2e-5) of the single process's (bitwise or not printed), the
     engine's and the all-gathers' time and bytes; (b) the Trainer on the
     mesh, 2 rows a rank, P14_STEPS steps with a checkpoint at the last
     (rank 0 writes, every rank waits): every parameter's crc32 equal on
     both ranks after every step, 19 launches a step, losses finite, the
     first within 1.5 of ln(V), all within RESUME_LOSS_TOL of the single
     process's, step 0's Muon update's gap to the single process's
     printed (bf16 activations round differently at 2 rows than at 4),
     and one step at fp32 compute whose Muon update is within
     UPDATE_REL_TOL of the single process's; the step time, tokens/s
     over both ranks, the gradient all-reduce's calls, bytes and times,
     the synchronizing calls of one step; (c) ``grads_dtype="bfloat16"``
     and ``gradient_compression="int8"``, P14_EXTRA_STEPS steps each,
     losses finite and within P14_EXTRA_LOSS_TOL of (b)'s while the
     same steps' losses with no update lie beyond it (the control), the
     parameters' crc32 equal on both ranks, the reduced dtypes printed,
     and ``int8_psum`` on the card: one fp32 MAX and one int32 SUM,
     within P14_PSUM_STEPS int8 steps of the exact sum; (e) Muon
     PRISM-5 with ``precond_async`` and ``precond_every`` P14_ASYNC_K,
     P14_ASYNC_STEPS steps beside a ``Shadow`` (one process's async Muon
     on the same gradients): dispatches at 0 and P14_ASYNC_K on both
     ranks and in the shadow, 19 launches in each dispatching
     ``step_begin`` and none in the steps, the final parameters and
     caches within 2e-5 + 2e-5|x| of the shadow's; each rank's
     max_memory_allocated.  Then (d): one
     process restores (b)'s checkpoint, its state bitwise the ranks'
     (crc32 of every leaf) and its next step 19 launches;
 15. the model axis (``phase15``, ``python3 tools/tp_probe.py`` alone): a
     world of P15_WORLD = 4 ranks that share the card on gloo, spawned as
     in phase 14, on a ``make_debug_mesh(2, 2)`` (data, model) mesh;
     gpt2-paper at full width, seq 512, global batch 4, Muon PRISM-5, at
     fp32 compute (the gates against one process).  Beside the ranks'
     start, one process's Trainer, P15_STEPS steps (its losses and its
     step-0 Muon update, handed to the ranks through files).
     (a) "tp" (FSDP over data, tensor parallelism over model,
     ``Model.shard``), P15_STEPS steps with a checkpoint at the last:
     losses within P15_LOSS_TOL (1e-4) of one process's, the step-0 Muon
     update gathered whole within UPDATE_REL_TOL (1e-3), the leaves
     replicated over data crc32-equal on both data ranks after every
     step, each rank the single process's 19 launches a step (K1/K2/K3
     wrapper calls printed by shape: each rank's share of every bucket),
     the step time, tokens/s over the world and the collectives a step by
     kind (calls, bytes, host ms); (b) a new Trainer resumes the
     checkpoint under "zero" (every leaf flat-sharded over (data, model))
     with ``muon_local_reshard``, P15_RESUME_STEPS steps: every restored
     leaf, gathered whole, has the crc32 the checkpoint's MANIFEST recorded,
     19 launches a step, K2 on (a)'s shapes with the rows halved (the
     [B/2, m/2, n] row blocks), one Gram all-reduce a K2 call (a
     grid-tier iteration and bucket; bytes printed), and the losses
     within P15_LOSS_TOL of one process that resumes the same
     checkpoint (run after the world).  Then, on the same world, with
     one process's Shampoo Trainers (c)'s and (d)'s references beside
     the ranks' start: (c) Shampoo PRISM-5 (phase 6's) under "tp",
     P15_SHAMPOO_STEPS steps: each rank phase 6's 17 launches a step on
     its data share of every bucket (``shampoo_calls``: K1 on
     ``[50, 1024, 1024]``, K3 on ``[15, 16, 16]`` and ``[15, 64, 64]``),
     losses within P15_LOSS_TOL of one process's Trainer, the step-0
     update gathered whole within UPDATE_REL_TOL of one process's
     optimizer stepped on the world's gathered step-0 gradients on whole
     buckets, with each slice's Frobenius norm taken on the data ranks'
     shares as they take it (``ShareNorms``: on the card a [B, n, n]
     batch's norms sum in an order that depends on B; the slices whose
     norm differs, the gap with the process's own norms and the gap to
     one process's Trainer printed: the last bit, amplified by the
     inverse roots of rank-deficient factors); (d) fitted Shampoo (phase
     7's) under "zero", P15_FITTED_STEPS steps, 50 launches a step on the
     shares, the same update gate with the world's fitted alphas
     gathered over data and replayed (``PINNED_ALPHA``'s reason); (e)
     async Muon PRISM-5 under "tp" with ``precond_every`` P15_ASYNC_K,
     P15_ASYNC_STEPS steps, deterministic algorithms on, a checkpoint at
     the last: 19 launches in ``step_begin`` at steps 0 and P15_ASYNC_K
     and none in any step, the same telemetry (2 refreshes: bootstrap,
     clock) and the same drift at every step on every rank, every state
     leaf bitwise the same world synchronized after each
     ``step_begin``, the host time of each ``step_begin`` printed (gloo
     holds the host through the refresh's collectives); a one-step run
     whose bootstrap refresh
     carries a NaN in rank P15_NAN_RANK's pending block discards it on
     every rank (pending cleared, the active blocks bitwise unchanged);
     (f) a Trainer under "zero" restores (e)'s checkpoint, every leaf
     gathered whole at its MANIFEST crc32 and each cache block bitwise
     its block of the file's whole cache, and one process restores it at
     the MANIFEST's crc32s.  Every sub-run prints its step time, tokens/s
     over the world, collectives a step by kind, a rank's peak memory and
     its cache bytes against the whole caches', which must be the blocks
     the ``precond_cache_sharding`` layout gives;
 16. the moe family on the mesh (``phase16``, ``python3 tools/moe_probe.py
     --mesh`` alone): phase 15's world of four ranks on gloo and (2, 2)
     mesh, granite-moe-1b-a400m at its published widths with the depth
     cut to P16_LAYERS = 2 of 24 (207,721,472 parameters), launch/
     train.py's Muon PRISM-5, seq 512, global batch 8, fp32 compute.
     Beside the ranks' start, one process's Trainer, P16_STEPS steps
     (its losses and its launches a step, 27: K1 18, K2 9, the same
     every step, handed to the ranks through a file).  (a) "tp" with
     expert parallelism (``layers.moe.w_up`` split over model on its
     experts dim, 16 experts a rank), P16_STEPS steps with a checkpoint
     at the last; (b) "zero" resumed from it, P16_RESUME_STEPS steps,
     every restored leaf gathered whole at the MANIFEST's crc32, the
     losses within P15_LOSS_TOL of one process resuming the same
     checkpoint (after the world); (c) "tp" with ``moe.sharding=
     "tensor"`` (mixtral's rule at granite's widths: each rank every
     expert's 256 of 512 ``expert_mlp`` columns), P16_TENSOR_STEPS steps.
     (a) and (c): losses within P15_LOSS_TOL of one process's Trainer,
     the step-0 Muon update gathered whole within UPDATE_REL_TOL of one
     process's optimizer stepped on the world's gathered step-0
     gradients with the shares' norms (``ShareNorms``); every sub-run:
     each rank one process's launches at every step on its shares of
     the buckets (K1/K2 at ``P16_SHAPES``, held in phase 3), the aux in
     phase 12's band, its step ms, tokens/s over the world, collectives
     a step by kind and its peak memory.  (d) the drop control at
     ``capacity_factor`` P16_DROP_CAPACITY under "tp": the world's
     step-0 loss within P15_LOSS_TOL of one process's, the dropped
     assignments equal on every rank and to one process's (printed),
     and a rank-local dispatch (each data rank's rows routed alone) must
     lie beyond the bound;
 17. the ssm, hybrid and audio families on the mesh (``phase17``,
     ``python3 tools/recurrent_probe.py --mesh`` alone): phase 15's world
     of four ranks on gloo and (2, 2) mesh, launch/train.py's Muon
     PRISM-5, seq 512, global batch 8, fp32 compute, every published
     width, the depth cut (``P17_RUNS``).  First one process's Trainer of
     each of (a)-(c), P17_STEPS steps (its losses and its launches a
     step, the same every step and the bucket plan's, handed to the
     ranks through a file, which they wait for before they build a
     model).  (a) falcon-mamba-7b at 2 of 64 layers (743,305,216
     parameters) under "tp": each model rank 4,096 of the 8,192
     ``d_inner`` channels, ``in_proj`` gathered over the model axis
     (kind "tp_gather"), ``x_proj``'s partial sum summed forward and
     backward (kind "tp_sum"); (b) recurrentgemma-2b at one (rec, rec,
     attn) period, 3 of 26 layers (861,201,920 parameters), under "tp":
     1,280 of the 2,560 LRU channels a rank, the gates reduce-scattered
     onto them (kind "tp_scatter"), 8 of the 16 padded heads, the mlp's
     columns; (c) musicgen-medium at 2 of 48 layers (88,088,064
     parameters) under "tp", each codebook's table and head split over
     the model axis on its vocab dim, P17_STEPS steps with a checkpoint
     at the last; (d) (c)'s checkpoint resumed under "zero",
     P17_RESUME_STEPS step, every restored leaf gathered whole at the
     MANIFEST's crc32 and the loss within P15_LOSS_TOL of one process
     resuming the same checkpoint (after the world).  (a)-(c): losses
     within P15_LOSS_TOL of one process's, the step-0 Muon update
     gathered whole within UPDATE_REL_TOL of one process's optimizer
     stepped on the world's gathered step-0 gradients with the shares'
     norms (``ShareNorms``); every sub-run: each rank one process's
     launches at every step, each K1/K2 call at its ``P17_SHAPES``
     share, its step ms, tokens/s over the world, collectives a step by
     kind (the families' own kinds apart) and its peak memory;
 18. serving on the mesh (``phase18``, ``python3 tools/serve_probe.py
     --mesh`` alone): phase 15's world of four ranks on gloo and (2, 2)
     mesh, fp32 compute, every width kept, the depth cut as phases 16 and
     17 cut it (``P18_RUNS``).  One process serves every run first
     through the same entry points (``prefill_cache`` over the whole
     prompt batch, greedy ``make_serve_step`` steps, one ``decode_step``
     with the odd lanes inactive, or the one lane at batch 1) and saves
     its logits, tokens and final cache; the ranks wait for it, then
     serve each run on the sharded model: (a) gpt2-paper, all 10 layers,
     "serve", batch 4, prompt 512, 16 steps (cache 528, the slots over
     model); (b) the same under "tp" (FSDP gathers over data every
     call), 4 steps; (c) batch 1, prompt 2048, 16 steps (cache 2064,
     the slots over data x model, every rank the one lane); (d)
     granite-moe-1b-a400m at 2 of 24 layers, "serve", prompt 512, 8
     steps (global dispatch over the data ranks); (e1) falcon-mamba-7b at
     2 of 64 layers and (e2) recurrentgemma-2b at one period (3 of 26),
     "serve", prompt 64, 8 steps (the prefill one decode step a
     position).  Gates on every rank: its lanes' logits within
     P18_LOGIT_TOL of one process's, the greedy tokens equal, every
     cache leaf within P18_CACHE_TOL of its block of one process's
     (``sharding.cache_blocks``) and the blocks gathered whole of one
     process's cache (``sharding.gather_cache``; kpos equal), the
     inactive lanes' leaves bitwise frozen, no port kernel launched.
     Printed: each run's prefill and per-token decode ms on every rank,
     rank 0's collectives a decode token by kind (serving's own apart)
     and the prefill's, and (a) again at bf16 compute
     for P18_BF16 steps with its logits' gap to one process's bf16 (not
     gated);
 19. the ``kernels`` JSON line, and last the ``ok`` JSON line.

It imports nothing of JAX or of the reference package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
STEPS = 4                 # full-width training steps; the first warms up
TIMED_REPS = 20           # launches per CUDA-event median
BACK_TO_BACK = 10         # launches a run of the back-to-back timing
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py
WARM_TOL = {"float32": 2e-4, "bfloat16": 5e-2}     # tests/test_fused_iter.py
# K4/K5 traces (tests/test_kernels.py) and K6/K7 (tests/test_fused_iter.py)
FIT_TOL = {"float32": 2e-4, "bfloat16": 5e-2}
DTYPES = ("float32", "bfloat16")  # dtypes of the phase 3 checks
KERNEL_NAMES = ("matmul_add", "gram_upper", "warm_tail", "sketch_step",
                "sketch_chain", "residual_chain", "apply_g")
# launches a training step, per path (optimizer and PRISM configuration)
PER_STEP = {
    "prism5": dict(matmul_add=12, gram_upper=6, warm_tail=1),
    "prism3": dict(matmul_add=10, gram_upper=10, warm_tail=1,
                   sketch_chain=4, residual_chain=2, apply_g=2),
    "shampoo_prism5": dict(matmul_add=15, warm_tail=2),
    "shampoo_fig5": dict(matmul_add=25, sketch_chain=5, residual_chain=10,
                         apply_g=10),
    # phase 9: inverse Newton and DB-Newton run outside the kernels, as in
    # the reference; the lowrank vocab bucket [2, 1024, 50272] adds K1 17
    # and K2 6 to PRISM-5's 19 (1 + 2 + 3 x 2 + 1 + 3 x 2 + 1 K1: sketch,
    # power iteration, the rangefinder's warm polar, B = Q^T X, B's polar,
    # lift; one K2 an iteration of each polar).  The per-leaf loop's
    # launches come from its leaves (``per_leaf_launches``).
    "shampoo_p4": {},
    "shampoo_newton": {},
    "muon_lowrank": dict(matmul_add=29, gram_upper=12, warm_tail=1),
}
# Paths whose update gate replays the kernel run's fitted alphas into the
# run through torch.matmul.  Shampoo's factors are rank-deficient (a bias
# gradient [16, 64] gives R = G^T G of rank 16 a step) and their fitted
# alpha, the argmin of a nearly flat sketched objective, moves with the
# last bits of the traces, so the kernels' summation order alone moves
# the fitted Shampoo update by about 1e-3 of its largest entry.  The gate
# holds the update with the kernel run's alphas; the unpinned gap and the
# alpha gap are printed beside it (PERF.md).
PINNED_ALPHA = {"shampoo_fig5"}
# Muon's lowrank tier (DESIGN.md §14) at gpt2-paper width: l = 128 + 8.
# Aspect 8: only the vocab tables [1024, 50272] take the tier; at the
# default 4.0 the [4096, 1024] MLP views sit on the threshold and would be
# approximated at rank 136 too.
LOWRANK = dict(lowrank_rank=128, lowrank_oversample=8, lowrank_max_dim=4096,
               lowrank_aspect=8.0)
# (optimizer, PRISM configuration of launch/train_lm.py[, OptimizerConfig
# changes, Shampoo's inverse-root power]) of each path
PATHS = {"prism5": ("muon", "prism5"), "prism3": ("muon", "prism3"),
         "shampoo_prism5": ("shampoo", "prism5"),
         "shampoo_fig5": ("shampoo", "fig5"),
         "shampoo_p4": ("shampoo", "prism5", {}, 4),
         "shampoo_newton": ("shampoo", "prism5",
                            {"matfn_method": "newton"}),
         "shampoo_per_leaf": ("shampoo", "prism5", {"bucketed": False}),
         "muon_lowrank": ("muon", "prism5", LOWRANK)}
# synchronizing calls of one Muon step while K3 copied its alpha vector
# from the host (PERF.md); no optimizer step may make more
SYNCS_BOUND = 1

# Muon update through the kernels vs through torch.matmul (fp32 matfn): the
# two differ only in fp32 summation order, which three quintic iterations
# amplify by at most ~30x; 1e-3 of the largest update entry is far above
# that and far below any real fault (a wrong tile or epilogue moves whole
# entries).
UPDATE_REL_TOL = 1e-3
# phase 8: run B resumes run A bitwise, so the losses of steps 3..6 differ
# only by what cuBLAS and the backward pass (atomic adds into the
# embedding gradient) leave nondeterministic, ~1e-6 of a loss near 11; a
# lost count or sketch key moves them by far more (AdamW's bias
# correction alone triples the embedding update at step 3)
RESUME_LOSS_TOL = 1e-3
# phase 8: Muon PRISM-5 through the Trainer refreshes every TRAINER_K steps
TRAINER_K = 5
TRAINER_STEPS = 7
TRAINER_EVERY = 3
DEVICE = "cuda"
# H100 SXM peaks (NVIDIA's data sheet: dense rates, 700 W)
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
ALLOC_CONF = "expandable_segments:True"  # PyTorch's caching allocator


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg`` after the script's clock (seconds since it started)."""
    print(f"[{time.perf_counter() - _T0:6.1f}] {msg}", flush=True)


# --------------------------------------------------------------- timing

def time_ms(torch, fn, reps: int = TIMED_REPS, warmup: int = 3,
            batch: int = 1) -> float:
    """Median time of one call of ``fn`` over ``reps`` runs of ``batch``
    calls back to back between two CUDA events: with ``batch`` 1 the host's
    launch time is inside; with more, the device's time of a kernel that
    runs longer than the host takes to launch it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def device_ms(torch, fn, kernel: str, reps: int = TIMED_REPS):
    """Mean device time of one launch of ``kernel`` (the CUDA kernels whose
    name holds ``<kernel>_kernel``) over ``reps`` calls of ``fn``, from a
    torch.profiler trace: the card's time, whatever the host's.  None when
    the trace holds none of its launches (the profiler drops a trace now
    and then); it is a measurement, not a gate."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and f"{kernel}_kernel" in e.key:
            total += e.self_device_time_total
            count += e.count
    if not count:
        log(f"  {kernel}: the profile holds none of its {reps} launches")
        return None
    return total / 1e3 / count


def small_times(torch, fn, kernel: str) -> dict:
    """A fused-tier kernel (K3, K6, K7) runs for less than the host takes
    to launch it, so a single launch between two events times the host:
    its back-to-back time (``BACK_TO_BACK`` launches between two events,
    still host-bound below ~30 us) and its profiled device time."""
    return dict(b2b_ms=time_ms(torch, fn, batch=BACK_TO_BACK),
                device_ms=device_ms(torch, fn, kernel))


def small_note(t: dict) -> str:
    if "b2b_ms" not in t:
        return ""
    dev = t["device_ms"]
    dev = "not measured" if dev is None else f"{dev:.4f} ms"
    return f" (back to back {t['b2b_ms']:.4f} ms, device {dev})"


def bound_ms(flops: float, nbytes: float, dtype: str):
    """(least time in ms, what bounds it): the larger of flops over the
    card's peak for the operand type and bytes over its memory rate."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / PEAK_BYTES
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem
                                     else "bytes")


# --------------------------------------------------------------- inputs

def randn(torch, shape, gen, scale=1.0):
    return scale * torch.randn(shape, generator=gen, device="cuda")


def normalized(torch, shape, gen):
    """X / ||X||_F per slice: what newton_schulz.polar feeds the chain."""
    x = randn(torch, shape, gen)
    return x / torch.linalg.matrix_norm(x, keepdim=True)


def poison(torch, shape, dtype, count: int = 1) -> None:
    """Free ``count`` NaN-filled blocks of this size just before a kernel
    call: the caching allocator hands them to the kernel's outputs, so an
    output the kernel fails to write reads as NaN instead of stale,
    plausible data."""
    ts = [torch.full(tuple(shape), float("nan"), dtype=dtype, device="cuda")
          for _ in range(count)]
    del ts


def same_twice(torch, name, shape, dtype, first, again) -> None:
    """A second launch on the same inputs gives bitwise the same outputs:
    every sum of the kernel runs in a fixed order."""
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, again)):
        fail(f"{name} {shape} {dtype}: two launches are not bitwise equal")


def max_err(torch, got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def check(torch, name, shape, dtype, got, want, tol) -> float:
    """|got - want| <= tol + tol * |want| entrywise: the reference tests'
    atol = rtol = tol, which they apply to results of unit scale.  Where a
    slice's largest |want| is below 1 (K3's orthonormalized output, entries
    ~0.1), the absolute term shrinks with it, so that a small result is
    not passed by the absolute term alone."""
    torch.cuda.synchronize()
    if tuple(got.shape) != tuple(want.shape) or got.dtype != want.dtype:
        fail(f"{name} {shape} {dtype}: got {tuple(got.shape)} {got.dtype}, "
             f"want {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{name} {shape} {dtype}: non-finite output")
    err = max_err(torch, got, want)
    want32 = want.float().abs()
    scale = want32.amax(dim=(-2, -1), keepdim=True).clamp(max=1.0)
    ok = bool(torch.all((got.float() - want.float()).abs()
                        <= tol * scale + tol * want32))
    log(f"  {name:10s} {str(shape):22s} {dtype:8s} max_abs_err {err:.3e} "
        f"(tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} {shape} {dtype} disagrees with its plain version")
    return err


# --------------------------------------------------------------- phase 3

def unaligned_launches() -> int:
    """Launches of K1's and K2's element-by-element instantiation so far."""
    from repro_torch.kernels import gram, matmul_add

    return matmul_add.unaligned_launches + gram.unaligned_launches


def kernel_checks(torch):
    from repro_torch.kernels import fused_iter, gram, matmul_add, ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    coeffs = ops._gd_coeffs(2)
    rows = {}

    # O(1) operands, scaled so that the entries of each result are of unit
    # size or more: A, B ~ N(0, 1/sqrt(k)) make A @ B ~ N(0, 1), beside
    # C ~ N(0, 1); X ~ N(0, 1/sqrt(m)) makes the off-diagonal of X^T X
    # ~ N(0, 1) and its diagonal ~sqrt(m).  The Gram runs with the main
    # path's alpha = 1, beta = -1, and again with alpha = sqrt(m) / 2 and
    # beta = 1/2, where alpha I is as large as the diagonal it lands on and
    # the sign of beta shows.  B is not symmetric, so a transposed operand
    # shows.
    gemm_shapes = [(40, 1024, 1024), (20, 4096, 1024),      # main paths
                   (100, 1024, 1024),
                   (1, 55, 55), (2, 96, 64), (1, 1000, 300)]
    for shape in gemm_shapes:
        B, m, n = shape
        a32 = randn(torch, shape, gen, n ** -0.25)
        b32 = randn(torch, (B, n, n), gen, n ** -0.25)
        c32 = randn(torch, shape, gen)
        x32 = randn(torch, shape, gen, m ** -0.25)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            a, b, c, x = (t.to(dt) for t in (a32, b32, c32, x32))
            fast = matmul_add.aligned(a, b, c) and matmul_add.aligned(x)
            before = unaligned_launches()
            want = matmul_add.plain(a, b, c, alpha=1.0, beta=0.5)
            poison(torch, shape, dt)
            got = matmul_add.matmul_add(a, b, c, alpha=1.0, beta=0.5)
            err_mm = check(torch, "matmul_add", shape, dtype, got, want,
                           KERNEL_TOL[dtype])
            want = matmul_add.plain(a, b, alpha=-0.75)
            poison(torch, shape, dt)
            got = matmul_add.matmul_add(a, b, alpha=-0.75)
            check(torch, "matmul_add", shape, dtype, got, want,
                  KERNEL_TOL[dtype])
            for alpha, beta in ((1.0, -1.0), (0.5 * m ** 0.5, 0.5)):
                poison(torch, (B, n, n), dt)
                got = gram.gram_upper(x, alpha=alpha, beta=beta)
                want = gram.plain(x, alpha=alpha, beta=beta)
                err = check(torch, "gram_upper", shape, dtype, got, want,
                            KERNEL_TOL[dtype])
                if not torch.equal(got, got.transpose(-1, -2)):
                    fail(f"gram_upper {shape} {dtype}: result not "
                         f"symmetric")
                if beta == -1.0:
                    err_g = err
            took = unaligned_launches() - before
            log(f"  matmul_add/gram_upper {shape} {dtype}: "
                f"{'aligned' if fast else 'unaligned'} instantiation "
                f"({took} of 4 launches unaligned)")
            if took != (0 if fast else 4):
                fail(f"{shape} {dtype}: {took} unaligned launches, "
                     f"predicate says {'aligned' if fast else 'unaligned'}")
            if B in (20, 40, 100):
                if not fast:
                    fail(f"main-path shape {shape} {dtype} takes K1/K2's "
                         f"unaligned instantiation")
                key = (shape,) if dtype == "float32" else (shape, dtype)
                rows[("matmul_add",) + key] = dict(
                    shape=[list(shape), [B, n, n]], max_abs_err=err_mm)
                rows[("gram_upper",) + key] = dict(shape=[list(shape)],
                                                   max_abs_err=err_g)

    # K3 on the bias bucket (3 warm iterations of alpha = u = 1.45)
    for shape in [(30, 64, 16), (15, 64, 16), (5, 55, 23)]:
        x32 = normalized(torch, shape, gen)
        for dtype in DTYPES:
            x = x32.to(getattr(torch, dtype))
            alphas = (1.45, 1.45, 1.45)
            want = fused_iter.plain(x, alphas, coeffs=coeffs)
            poison(torch, shape, x.dtype)
            got = fused_iter.warm_tail(x, alphas, coeffs=coeffs)
            err = check(torch, "warm_tail", shape, dtype, got, want,
                        WARM_TOL[dtype])
            want = fused_iter.plain(x, alphas[:1], coeffs=coeffs)
            poison(torch, shape, x.dtype)
            got = fused_iter.warm_tail(x, alphas[:1], coeffs=coeffs)
            check(torch, "warm_tail", shape, dtype, got, want,
                  WARM_TOL[dtype])
            if shape[1:] == (64, 16) and dtype == "float32":
                rows[("warm_tail", shape)] = dict(
                    shape=[list(shape)], operands=(x,), max_abs_err=err)
    return rows


def spectrum_r(torch, B, n, gen, radius=0.95):
    """Symmetric [B, n, n] with eigenvalues +-radius in random directions
    (Q diag(+-radius) Q^T): every power keeps unit size, and consecutive
    powers differ (odd ones change sign), so the traces of a chain that
    mixes up its powers or buffers come out wrong by O(1)."""
    q, _ = torch.linalg.qr(randn(torch, (B, n, n), gen))
    d = radius * torch.sign(randn(torch, (B, 1, n), gen))
    return (q * d) @ q.transpose(-1, -2)


# K5's checks: the grid-tier residual buckets of the main paths (fp32 and
# bf16) and ragged cases (n below the cluster size, n not a multiple of
# the vector width, p = 1 and p = 16): (shape, p, chain lengths)
CHAIN_CASES = [((40, 1024, 1024), 8, (6, 10)),
               ((20, 1024, 1024), 8, (6,)),
               ((100, 1024, 1024), 8, (6, 10)),
               ((50, 1024, 1024), 8, (10,)),     # phase 15 (d)'s share
               ((3, 300, 300), 5, (6, 10)),
               ((2, 37, 37), 12, (6, 10)),
               ((1, 5, 5), 1, (1,)),
               ((1, 1024, 1024), 16, (6, 10))]


def chain_case(torch, r, st, powers, rows):
    """K5 against its plain version on R [B, n, n] and St [n, p] for each
    chain length in ``powers`` (traces checked per slice as [B, 1, powers]
    so that ``check`` scales per slice); at [40, 1024, 1024] x 6 two
    launches must agree bit for bit."""
    from repro_torch.kernels import sketch_traces

    B, n, _ = r.shape
    p = st.shape[1]
    dtype = str(r.dtype).replace("torch.", "")
    for maxp in powers:
        want = sketch_traces.plain_chain(r, st, maxp)
        poison(torch, (B, maxp), torch.float32)
        got = sketch_traces.sketch_chain(r, st, maxp)
        err = check(torch, "sketch_chain", (B, n, p, maxp), dtype,
                    got.reshape(B, 1, maxp), want.reshape(B, 1, maxp),
                    FIT_TOL[dtype])
        if (B, maxp) == (40, 6):
            # every trace has a fixed order of summation
            poison(torch, (B, maxp), torch.float32)
            again = sketch_traces.sketch_chain(r, st, maxp)
            torch.cuda.synchronize()
            if not torch.equal(again, got):
                fail(f"sketch_chain {tuple(r.shape)} {dtype}: two launches "
                     f"differ (worst {max_err(torch, again, got):.3e})")
            log(f"  sketch_chain {tuple(r.shape)} {dtype}: two launches "
                f"bitwise equal")
            if dtype == "float32":
                rows["sketch_chain"] = dict(
                    shape=[[B, n, n], [n, p], maxp], max_abs_err=err,
                    operands=(r, st))
        if B in (20, 40, 50, 100) and dtype == "float32":
            rows[("sketch_chain", (B, n, n, maxp))] = dict(
                shape=[[B, n, n], [n, p], maxp], max_abs_err=err)


def chain_checks(torch):
    """K5 alone on every case of ``CHAIN_CASES``, in each of ``DTYPES``."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    rows = {}
    for shape, p, powers in CHAIN_CASES:
        B, n, _ = shape
        r32 = spectrum_r(torch, B, n, gen)
        s32 = randn(torch, (p, n), gen, p ** -0.5)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            chain_case(torch, r32.to(dt), s32.t().contiguous().to(dt),
                       powers, rows)
    return rows


# K4's timed shapes: the fallback step's buckets (CHAIN_CASES) and one
# that only K4 takes, [4, 4096, 4096] (p = 8)
STEP_SHAPES = [(40, 1024, 1024), (20, 1024, 1024), (4, 4096, 4096)]
STEP_ONLY = STEP_SHAPES[2]


def step_case(torch, r, st, rows):
    """K4 against its plain version on R [B, n, n] and St [n, p]: two
    powers, the second from the first's V', and each launch made twice:
    V' and the trace must come out bitwise equal (the slices' arrival
    counters are zero again after every launch, and the trace partials add
    in tile order).  The trace is checked per slice as [B, 1, 1]."""
    from repro_torch.kernels import sketch_traces

    B, n, _ = r.shape
    p = st.shape[1]
    dtype = str(r.dtype).replace("torch.", "")
    v = st.expand(B, n, p).contiguous()
    err = 0.0
    for _ in range(2):
        want_v, want_t = sketch_traces.plain_step(r, v, st)
        poison(torch, (B, n, p), r.dtype)
        poison(torch, (B,), torch.float32, count=2)
        got_v, got_t = sketch_traces.sketch_step(r, v, st)
        err = max(err,
                  check(torch, "sketch_step", (B, n, p), dtype, got_v,
                        want_v, FIT_TOL[dtype]),
                  check(torch, "sketch_step", (B, n, p), dtype,
                        got_t.reshape(B, 1, 1), want_t.reshape(B, 1, 1),
                        FIT_TOL[dtype]))
        same_twice(torch, "sketch_step", (B, n, p), dtype, (got_v, got_t),
                   sketch_traces.sketch_step(r, v, st))
        v = want_v
    if (B, n, n) in STEP_SHAPES and dtype == "float32" and p == 8:
        rows[("sketch_step", (B, n, n))] = dict(
            shape=[[B, n, n], [B, n, p]], max_abs_err=err, operands=(r, st))


def fit_kernel_checks(torch, rows):
    """K4-K7 against their plain versions, fp32 and bf16, at the PRISM-3
    main-path shapes and at ragged ones (K5 by ``chain_case`` and K4 by
    ``step_case`` on ``CHAIN_CASES``; K4 also at n = 4096, which only it
    takes; at n = 1024, p = 8 the K4 loop's traces must be bitwise K5's).
    Traces are checked per slice as [B, 1, powers] so that ``check``
    scales per slice."""
    from repro_torch.kernels import fused_iter, ops, sketch_traces

    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    # K5 / K4 on the grid-tier residual buckets and at ragged ones
    for shape, p, powers in CHAIN_CASES:
        B, n, _ = shape
        r32 = spectrum_r(torch, B, n, gen)
        s32 = randn(torch, (p, n), gen, p ** -0.5)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            r, st = r32.to(dt), s32.t().contiguous().to(dt)
            chain_case(torch, r, st, powers, rows)
            step_case(torch, r, st, rows)
            # ops.sketch_traces with the budget forced down runs K4's loop
            t_k5 = ops.sketch_traces(r, s32.to(dt), 6)
            t_k4 = ops.sketch_traces(r, s32.to(dt), 6, budget=1024)
            check(torch, "sketch_step", (B, n, p, "chain"), dtype,
                  t_k4.reshape(B, 1, 7), t_k5.reshape(B, 1, 7),
                  FIT_TOL[dtype])
            if n == 1024 and p <= 8:
                # a K4 block holds the rows of a K5 rank here (64, 8 a
                # warp), and K4 sums each V' and trace in K5's order
                if not torch.equal(t_k4, t_k5):
                    fail(f"sketch_step {shape} {dtype}: the K4 loop's traces "
                         f"are not bitwise K5's")
                log(f"  sketch_step {shape} {dtype}: the K4 loop's traces "
                    f"are bitwise K5's")
    # K4 where only K4 runs: n = 4096 (K5's block does not fit in fp32)
    r32 = spectrum_r(torch, *STEP_ONLY[:2], gen)
    s32 = randn(torch, (8, STEP_ONLY[1]), gen, 8 ** -0.5)
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        step_case(torch, r32.to(dt), s32.t().contiguous().to(dt), rows)
    del r32

    # K6 / K7 on the fused-tier bias bucket.  K6: X ~ N(0, 0.9/m), so that
    # X^T X spreads over ~[0.2, 2] and R = I - X^T X over ~[-1, 0.8]
    # (unit-size powers).  K7: X ~ N(0, 1) and R with eigenvalues +-0.95,
    # so that X g(R) is of unit size, and a different alpha in every slice.
    for shape, p in [((30, 64, 16), 8), ((5, 55, 23), 5)]:
        B, m, n = shape
        x_rc = randn(torch, shape, gen, (0.9 / m) ** 0.5)
        s32 = randn(torch, (p, n), gen, p ** -0.5)
        x_ag = randn(torch, shape, gen)
        r_ag = spectrum_r(torch, B, n, gen)
        for dtype in DTYPES:
            dt = getattr(torch, dtype)
            x, S = x_rc.to(dt), s32.to(dt)
            st = S.t().contiguous()
            for maxp in (6, 10):
                want_r, want_t = fused_iter.plain_residual_chain(x, S, maxp)
                poison(torch, (B, n, n), dt)
                got_r, got_t = fused_iter.residual_chain(x, st, maxp)
                err_r = check(torch, "residual_chain", shape, dtype, got_r,
                              want_r, FIT_TOL[dtype])
                err_t = check(torch, "residual_chain", (B, m, n, maxp),
                              dtype, got_t.reshape(B, 1, maxp),
                              want_t.reshape(B, 1, maxp), FIT_TOL[dtype])
                same_twice(torch, "residual_chain", (B, m, n, maxp), dtype,
                           (got_r, got_t),
                           fused_iter.residual_chain(x, st, maxp))
                if shape == (30, 64, 16) and dtype == "float32" and \
                        maxp == 6:
                    rows["residual_chain"] = dict(
                        shape=[list(shape), [n, p], maxp],
                        max_abs_err=max(err_r, err_t), operands=(x, st))
                    rows[("residual_chain", shape + (maxp,))] = \
                        rows["residual_chain"]
            xa, ra = x_ag.to(dt), r_ag.to(dt)
            for degree in (1, 2):
                coeffs = ops._gd_coeffs(degree)
                lo, hi = {1: (0.5, 1.0), 2: (0.375, 1.45)}[degree]
                alpha = torch.linspace(lo, hi, B, device="cuda")
                want = fused_iter.plain_apply_g(xa, ra, alpha, coeffs=coeffs)
                poison(torch, shape, dt)
                got = fused_iter.apply_g(xa, ra, alpha, coeffs=coeffs)
                err = check(torch, "apply_g", (B, m, n, f"d{degree}"),
                            dtype, got, want, FIT_TOL[dtype])
                if shape == (30, 64, 16) and dtype == "float32" and \
                        degree == 1:
                    rows["apply_g"] = dict(shape=[list(shape), [B, n, n]],
                                           max_abs_err=err,
                                           operands=(xa, ra, alpha))
                    rows[("apply_g", shape)] = rows["apply_g"]
    return rows


def coupled_limit(dtype: str) -> int:
    """The largest n whose coupled [n, n] slice the fused tier admits."""
    from repro_torch.kernels import ops

    n = 8
    while ops.fused_fits((n + 1, n + 1), dtype, coupled=True):
        n += 1
    return n


def nonsym(torch, shape, gen):
    """Non-symmetric [B, n, n] with entries N(0, 0.5 / sqrt(n)): spectral
    radius ~0.5, so I - X X, sym(I - Y X) and their powers stay of unit
    size, while X X differs from X^T X and Y X from X Y by O(1)."""
    return randn(torch, shape, gen, 0.5 * shape[-1] ** -0.5)


def spd(torch, B, n, gen, lo=0.05):
    """Symmetric positive definite [B, n, n], ||.||_F = 1, eigenvalues
    spread over [lo, 1] before the scaling: what Shampoo's sqrtm feeds the
    chain (X = A, Y = I)."""
    q, _ = torch.linalg.qr(randn(torch, (B, n, n), gen))
    lam = lo + (1 - lo) * torch.rand((B, 1, n), generator=gen, device="cuda")
    a = (q * lam) @ q.transpose(-1, -2)
    return a / torch.linalg.matrix_norm(a, keepdim=True)


def family_checks(torch, rows):
    """The sign and coupled sqrt families of K3, K6 and K7 against their
    plain versions, fp32 and bf16, at the Shampoo bias shapes [30, 16, 16]
    and [30, 64, 64] and at the largest coupled slice the fused tier admits
    in each dtype.  Each kernel runs on non-symmetric, independent X and Y
    (for which X^T X != X X and Y X != X Y: symmetric or commuting inputs
    would pass a kernel with those mixed up); K3 runs one iteration there,
    where the function stays of unit size, and three on Shampoo's own
    inputs (X = A symmetric positive definite, Y = I; sign on a symmetric
    X).  K7 runs with a non-symmetric R (0.95 times an orthogonal matrix)
    and a different alpha in every slice.  A coupled slice one larger than
    the limit must take the grid tier, and K3's launcher must refuse one
    past its own block."""
    from repro_torch.config import PrismConfig
    from repro_torch.core import newton_schulz
    from repro_torch.core.rng import Key
    from repro_torch.kernels import fused_iter, ops
    from repro_torch.core import matfn

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    coeffs = ops._gd_coeffs(2)
    warm = (1.45, 1.45, 1.45)
    for dtype in DTYPES:
        dt = getattr(torch, dtype)
        big = coupled_limit(dtype)
        for shape in [(30, 16, 16), (30, 64, 64), (15, 16, 16),
                      (15, 64, 64), (4, big, big)]:
            B, n, _ = shape
            main = B in (30, 15) and dtype == "float32"
            x, y = (nonsym(torch, shape, gen).to(dt) for _ in range(2))
            a_spd = spd(torch, B, n, gen).to(dt)
            eye = torch.eye(n, device="cuda", dtype=dt).expand(shape)
            x_sym = (normalized(torch, shape, gen) +
                     normalized(torch, shape, gen).transpose(-1, -2)) / 2
            x_sym = x_sym.to(dt)
            # K3: one iteration on independent inputs, three on Shampoo's
            for what, fam, xx, yy, al in (
                    ("nonsym", "sign", x, None, warm[:1]),
                    ("nonsym", "sqrt", x, y, warm[:1]),
                    ("sym", "sign", x_sym, None, warm),
                    ("spd,I", "sqrt", a_spd, eye.contiguous(), warm)):
                want = fused_iter.plain(xx, al, coeffs=coeffs, family=fam,
                                        Y=yy)
                poison(torch, shape, dt)
                got = fused_iter.warm_tail(xx, al, coeffs=coeffs,
                                           family=fam, Y=yy)
                if fam == "sqrt":
                    err = max(check(torch, f"warm_tail/{fam}",
                                    (B, n, n, what, len(al)), dtype, g, w,
                                    WARM_TOL[dtype])
                              for g, w in zip(got, want))
                else:
                    err = check(torch, f"warm_tail/{fam}",
                                (B, n, n, what, len(al)), dtype, got, want,
                                WARM_TOL[dtype])
                if main and what in ("sym", "spd,I"):
                    rows[(f"warm_tail/{fam}", shape)] = dict(
                        shape=[list(shape), len(al)], max_abs_err=err)
            # K6 on the independent inputs, 6 and 10 powers
            S = randn(torch, (8, n), gen, 8 ** -0.5).to(dt)
            st = S.t().contiguous()
            for fam, yy in (("sign", None), ("sqrt", y)):
                for maxp in (6, 10):
                    want_r, want_t = fused_iter.plain_residual_chain(
                        x, S, maxp, family=fam, Y=yy)
                    poison(torch, (B, n, n), dt)
                    got_r, got_t = fused_iter.residual_chain(
                        x, st, maxp, family=fam, Y=yy)
                    name = f"residual_chain/{fam}"
                    err_r = check(torch, name, shape, dtype, got_r, want_r,
                                  FIT_TOL[dtype])
                    err_t = check(torch, name, (B, n, n, maxp), dtype,
                                  got_t.reshape(B, 1, maxp),
                                  want_t.reshape(B, 1, maxp), FIT_TOL[dtype])
                    if fam == "sqrt" and not torch.equal(
                            got_r, got_r.transpose(-1, -2)):
                        fail(f"{name} {shape} {dtype}: R not symmetric")
                    same_twice(torch, name, (B, n, n, maxp), dtype,
                               (got_r, got_t), fused_iter.residual_chain(
                                   x, st, maxp, family=fam, Y=yy))
                    if main and maxp == 10:
                        rows[(name, shape)] = dict(
                            shape=[list(shape), [n, 8], maxp],
                            max_abs_err=max(err_r, err_t))
            # K7 coupled: X, Y ~ N(0, 1), R = 0.95 Q (not symmetric)
            q, _ = torch.linalg.qr(randn(torch, shape, gen))
            r = (0.95 * q).to(dt).contiguous()
            xa, ya = randn(torch, shape, gen).to(dt), \
                randn(torch, shape, gen).to(dt)
            for degree in (1, 2):
                cf = ops._gd_coeffs(degree)
                lo, hi = {1: (0.5, 1.0), 2: (0.375, 1.45)}[degree]
                alpha = torch.linspace(lo, hi, B, device="cuda")
                want = fused_iter.plain_apply_g(xa, r, alpha, coeffs=cf,
                                                Y=ya)
                poison(torch, shape, dt, count=2)
                got = fused_iter.apply_g(xa, r, alpha, coeffs=cf, Y=ya)
                err = max(check(torch, "apply_g/coupled",
                                (B, n, n, f"d{degree}", side), dtype, g, w,
                                FIT_TOL[dtype])
                          for g, w, side in zip(got, want, ("X'", "Y'")))
                if main and degree == 2:
                    rows[("apply_g/coupled", shape)] = dict(
                        shape=[list(shape), [B, n, n]], max_abs_err=err)
        # one past the limit: the grid tier, never a fused launch
        over = big + 1
        cfg = PrismConfig(degree=2, iterations=2, warm_alpha_iters=1,
                          sketch_dim=8, dtype=dtype, use_kernels=True)
        if newton_schulz._fused_tier(cfg, (over, over), coupled=True) or \
                not newton_schulz._fused_tier(cfg, (big, big), coupled=True):
            fail(f"coupled fused-tier limit in {dtype} is not {big}")
        # K3's launcher refuses a coupled slice past its own block (in bf16
        # K6's block sets the tier's limit, below K3's)
        item = 2 if dtype == "bfloat16" else 4
        k3_over = over
        while fused_iter.smem_bytes(k3_over, k3_over, item, True) <= \
                fused_iter.MAX_SMEM_BYTES:
            k3_over += 1
        try:
            fused_iter.warm_tail(eye_like(torch, k3_over, dt), (1.0,),
                                 coeffs=coeffs, family="sqrt",
                                 Y=eye_like(torch, k3_over, dt))
        except ValueError:
            pass
        else:
            fail(f"warm_tail took a coupled [{k3_over}, {k3_over}] {dtype} "
                 f"slice")
        ops.reset_launches()
        matfn.sqrtm(spd(torch, 2, over, gen).to(dt), cfg=cfg, key=Key(1))
        counts = ops.launch_counts()
        if counts["warm_tail"] or counts["residual_chain"] or \
                counts["apply_g"] or not counts["matmul_add"]:
            fail(f"sqrtm on [2, {over}, {over}] {dtype}: launches {counts}")
        log(f"  coupled fused-tier limit {dtype}: [{big}, {big}] "
            f"({ops.fused_smem_bytes((big, big), dtype, coupled=True)} "
            f"bytes); [{over}, {over}] needs "
            f"{ops.fused_smem_bytes((over, over), dtype, coupled=True)} and "
            f"took the grid tier: {counts}")
    return rows


def eye_like(torch, n, dt):
    return torch.eye(n, device="cuda", dtype=dt).expand(1, n, n).contiguous()


def fit_kernel_timings(torch, rows):
    """ms / plain_ms / bound_ms of one launch of K4-K7 (polar) at their
    main-path shapes, fp32 (K5 at all three: the Shampoo factor bucket
    [100, 1024, 1024] with 10 powers, and PRISM-3's [40, 1024, 1024] and
    [20, 1024, 1024] with 6; K4 at ``STEP_SHAPES``, also back to back and
    profiled, with R's streamed rate), with K5's cluster size, resident
    clusters, registers, spills and achieved rate; keyed by (name, shape).
    No single PyTorch call computes any of them (a chain of products with a
    trace epilogue; a residual with its chain; a Horner chain with a
    per-slice alpha), so ``library_ms`` is null."""
    from repro_torch.kernels import fused_iter, ops, sketch_traces

    item = 4
    out = {}
    r, st = rows["sketch_chain"]["operands"]
    B, n, _ = r.shape
    p = st.shape[1]
    maxp = 6
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for nb, powers in ((100, 10), (40, 6), (20, 6), (50, 10)):
        rb = r if nb == B else spectrum_r(torch, nb, n, gen)
        t = out[("sketch_chain", (nb, n, n, powers))] = dict(
            ms=time_ms(torch, lambda: sketch_traces.sketch_chain(
                rb, st, powers)),
            plain_ms=time_ms(torch, lambda: sketch_traces.plain_chain(
                rb, st, powers)),
            library_ms=None,
            # 2 n^2 p flops a power; R read once, St read, traces written
            bound=bound_ms(2.0 * nb * powers * n * n * p,
                           item * (nb * n * n + n * p + nb * powers),
                           "float32"))
        info = sketch_traces.chain_launch_info(rb, st)
        streamed = item * nb * powers * n * n   # R once a power
        log(f"  sketch_chain ({nb}, {n}, {n}) x {powers}: cluster "
            f"{info['cluster']}, {info['active_clusters']} clusters "
            f"resident ({info['active_clusters'] * item * n * n / 1e6:.1f} "
            f"MB of R in their slices), {info['registers']} registers, "
            f"{info['local_bytes']} B local (spills), {info['threads']} "
            f"threads, {info['stages']} stages, {info['rows_a_warp']} rows "
            f"a warp, {info['smem_bytes']} B shared; R streamed "
            f"{streamed / 1e9:.3f} GB at {streamed / t['ms'] / 1e6:.1f} GB/s "
            f"(device-memory floor {streamed / PEAK_BYTES * 1e3:.4f} ms)")
        del rb
    for shape in STEP_SHAPES:
        # let go of the operands after: phases 4-7 report peak memory
        r, st = rows[("sketch_step", shape)].pop("operands")
        B, n, _ = shape
        ps = st.shape[1]
        v = st.expand(B, n, ps).contiguous()
        t = out[("sketch_step", shape)] = dict(
            ms=time_ms(torch, lambda: sketch_traces.sketch_step(r, v, st)),
            **small_times(torch, lambda: sketch_traces.sketch_step(r, v, st),
                          "sketch_step"),
            plain_ms=time_ms(torch, lambda: sketch_traces.plain_step(
                r, v, st)),
            library_ms=None,
            # 2 n^2 p flops; R, V and St read once, V' and t' written
            bound=bound_ms(2.0 * B * n * n * ps,
                           item * (B * n * n + 2 * B * n * ps + n * ps + B),
                           "float32"))
        dev = t["device_ms"]
        log(f"  sketch_step {shape}: R streamed {item * B * n * n / 1e9:.3f}"
            f" GB, at " + ("not measured" if dev is None else
                           f"{item * B * n * n / dev / 1e6:.1f} GB/s") +
            " (profiled device time)")
    x, st6 = rows["residual_chain"]["operands"]
    S6 = st6.t().contiguous()
    B, m, n = x.shape
    p = st6.shape[1]
    out[("residual_chain", (B, m, n, maxp))] = dict(
        ms=time_ms(torch, lambda: fused_iter.residual_chain(x, st6, maxp)),
        **small_times(torch, lambda: fused_iter.residual_chain(x, st6, maxp),
                      "residual_chain"),
        plain_ms=time_ms(torch, lambda: fused_iter.plain_residual_chain(
            x, S6, maxp)),
        library_ms=None,
        # the Gram (full, 2 m n^2) and the chain; X and St read, R and t
        # written
        bound=bound_ms(B * (2.0 * m * n * n + 2.0 * maxp * n * n * p),
                       item * (B * m * n + n * p + B * n * n + B * maxp),
                       "float32"))
    xa, ra, alpha = rows["apply_g"]["operands"]
    coeffs = ops._gd_coeffs(1)
    out[("apply_g", (B, m, n))] = dict(
        ms=time_ms(torch, lambda: fused_iter.apply_g(xa, ra, alpha,
                                                     coeffs=coeffs)),
        **small_times(torch, lambda: fused_iter.apply_g(
            xa, ra, alpha, coeffs=coeffs), "apply_g"),
        plain_ms=time_ms(torch, lambda: fused_iter.plain_apply_g(
            xa, ra, alpha, coeffs=coeffs)),
        library_ms=None,
        bound=bound_ms(B * (2.0 * m * n * n + 3.0 * m * n),
                       item * (2 * B * m * n + B * n * n + B), "float32"))
    for (name, shape), t in out.items():
        log(f"  {name:14s} {str(shape):22s} float32 kernel "
            f"{t['ms']:.4f} ms{small_note(t)}  plain {t['plain_ms']:.4f} "
            f"ms  library none  bound {t['bound'][0]:.5f} ms "
            f"({t['bound'][1]})")
    return out


def family_timings(torch):
    """ms / plain_ms / bound_ms of one launch of the sign and coupled sqrt
    families of K3, K6 and K7 at the Shampoo bias shapes, fp32, on the
    inputs the main path gives them (X = A symmetric positive definite,
    Y = I; 3 warm iterations of degree 2; 10 powers with p = 8).  No
    single PyTorch call computes any of them: ``library_ms`` is null.
    Keys: (name, shape)."""
    from repro_torch.kernels import fused_iter, ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    item, d, maxp, p = 4, 2, 10, 8
    coeffs = ops._gd_coeffs(d)
    warm = (1.45,) * 3
    out = {}
    for shape in [(30, 16, 16), (30, 64, 64), (15, 16, 16), (15, 64, 64)]:
        B, n, _ = shape
        a = spd(torch, B, n, gen)
        eye = torch.eye(n, device="cuda").expand(shape).contiguous()
        S = randn(torch, (p, n), gen, p ** -0.5)
        st = S.t().contiguous()
        alpha = torch.full((B,), 1.2, device="cuda")
        r = ops.residual_chain(a, S, maxp, family="sqrt", Y=eye)[0]
        mat = B * n * n
        horner = d * 2.0 * n ** 3 + (3 * d + 1) * n * n   # one side
        cases = {
            # residual 2 n^3 (+ sym), then one Horner a side, per iteration
            "warm_tail/sqrt": (
                lambda: fused_iter.warm_tail(a, warm, coeffs=coeffs,
                                             family="sqrt", Y=eye),
                lambda: fused_iter.plain(a, warm, coeffs=coeffs,
                                         family="sqrt", Y=eye),
                len(warm) * B * (2.0 * n ** 3 + 3 * n * n + 2 * horner),
                item * 4 * mat),
            "warm_tail/sign": (
                lambda: fused_iter.warm_tail(a, warm, coeffs=coeffs,
                                             family="sign"),
                lambda: fused_iter.plain(a, warm, coeffs=coeffs,
                                         family="sign"),
                len(warm) * B * (2.0 * n ** 3 + n * n + horner),
                item * 2 * mat),
            # residual, then the chain's 2 n^2 p a power; X (Y), St read,
            # R and the traces written
            "residual_chain/sqrt": (
                lambda: fused_iter.residual_chain(a, st, maxp, family="sqrt",
                                                  Y=eye),
                lambda: fused_iter.plain_residual_chain(
                    a, S, maxp, family="sqrt", Y=eye),
                B * (2.0 * n ** 3 + 3 * n * n + 2.0 * maxp * n * n * p),
                item * (3 * mat + n * p + B * maxp)),
            "residual_chain/sign": (
                lambda: fused_iter.residual_chain(a, st, maxp,
                                                  family="sign"),
                lambda: fused_iter.plain_residual_chain(a, S, maxp,
                                                        family="sign"),
                B * (2.0 * n ** 3 + n * n + 2.0 * maxp * n * n * p),
                item * (2 * mat + n * p + B * maxp)),
            # one Horner a side; X, Y, R read, X', Y' written, alpha read
            "apply_g/coupled": (
                lambda: fused_iter.apply_g(a, r, alpha, coeffs=coeffs,
                                           Y=eye),
                lambda: fused_iter.plain_apply_g(a, r, alpha, coeffs=coeffs,
                                                 Y=eye),
                B * 2 * horner, item * (5 * mat + B)),
        }
        for name, (kern, plain, flops, nbytes) in cases.items():
            t = dict(ms=time_ms(torch, kern),
                     **small_times(torch, kern, name.split("/")[0]),
                     plain_ms=time_ms(torch, plain), library_ms=None,
                     bound=bound_ms(flops, nbytes, "float32"))
            out[(name, shape)] = t
            log(f"  {name:20s} {str(shape):14s} float32 kernel "
                f"{t['ms']:.4f} ms{small_note(t)}  plain "
                f"{t['plain_ms']:.4f} ms  library none  bound "
                f"{t['bound'][0]:.6f} ms ({t['bound'][1]})")
    return out


def kernel_timings(torch, rows):
    """ms / plain_ms / library_ms / bound_ms of one launch of each kernel at
    each main-path shape, fp32 (the main paths' matfn dtype), keyed by
    (name, shape); K1 and K2 also in bf16 (tensor cores, bf16 bound),
    keyed by (name, shape, "bfloat16")."""
    from repro_torch.kernels import fused_iter, gram, matmul_add, ops

    coeffs = ops._gd_coeffs(2)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    main_shapes = [("matmul_add", (40, 1024, 1024), "float32"),
                   ("matmul_add", (20, 4096, 1024), "float32"),
                   ("matmul_add", (100, 1024, 1024), "float32"),
                   ("gram_upper", (40, 1024, 1024), "float32"),
                   ("gram_upper", (20, 4096, 1024), "float32"),
                   ("warm_tail", (30, 64, 16), "float32"),
                   ("warm_tail", (15, 64, 16), "float32")]
    main_shapes += [(name, shape, "bfloat16")
                    for name, shape, _ in main_shapes[:5]]
    out = {}
    for name, shape, dtype in main_shapes:
        B, m, n = shape
        dt = getattr(torch, dtype)
        item = 2 if dtype == "bfloat16" else 4
        if name == "warm_tail":
            x = rows[(name, shape)]["operands"][0]
            alphas, d = (1.45,) * 3, 2
            flops = len(alphas) * B * (m * n * (n + 1) + d * 2.0 * m * n * n
                                       + (3 * d + 1) * m * n)
            t = dict(
                ms=time_ms(torch, lambda: fused_iter.warm_tail(
                    x, alphas, coeffs=coeffs)),
                **small_times(torch, lambda: fused_iter.warm_tail(
                    x, alphas, coeffs=coeffs), "warm_tail"),
                plain_ms=time_ms(torch, lambda: fused_iter.plain(
                    x, alphas, coeffs=coeffs)),
                library_ms=None,
                bound=bound_ms(flops, item * 2 * B * m * n + 4 * len(alphas),
                               "float32"))
        else:
            x = normalized(torch, shape, gen).to(dt)
            if name == "matmul_add":
                r = gram.plain(x)
                acc = 1.45 * x
                t = dict(
                    ms=time_ms(torch, lambda: matmul_add.matmul_add(
                        acc, r, x, beta=0.5)),
                    plain_ms=time_ms(torch, lambda: matmul_add.plain(
                        acc, r, x, beta=0.5)),
                    library_ms=time_ms(torch, lambda: torch.baddbmm(
                        x, acc, r, beta=0.5)),
                    # A, C, D [B, m, n] and R [B, n, n], each moved once
                    bound=bound_ms(2.0 * B * m * n * n + 3.0 * B * m * n,
                                   item * (3 * B * m * n + B * n * n),
                                   dtype))
            else:
                eye = torch.eye(n, device="cuda", dtype=dt)
                xt = x.transpose(-1, -2)
                t = dict(
                    ms=time_ms(torch, lambda: gram.gram_upper(x)),
                    plain_ms=time_ms(torch, lambda: gram.plain(x)),
                    library_ms=time_ms(torch, lambda: torch.baddbmm(
                        eye, xt, x, alpha=-1.0)),
                    bound=bound_ms(1.0 * B * m * n * (n + 1),
                                   item * (B * m * n + B * n * n),
                                   dtype))
            del x
        lib = "n/a" if t["library_ms"] is None else f"{t['library_ms']:.4f}"
        log(f"  {name:10s} {str(shape):18s} {dtype:8s} kernel "
            f"{t['ms']:.4f} ms{small_note(t)}  plain {t['plain_ms']:.4f} "
            f"ms  library {lib} ms  bound {t['bound'][0]:.4f} ms "
            f"({t['bound'][1]})")
        out[(name, shape) if dtype == "float32"
            else (name, shape, dtype)] = t
    return out


# --------------------------------------------------------------- phases 4-5

def _clone_state(opt):
    return ({p: {k: v.clone() for k, v in st.items()}
             for p, st in opt.state.items()}, opt.count)


def _make_opt(model, cfg, p_root=2):
    """The optimizer ``cfg.name`` names over the model's parameters; a
    Shampoo of inverse ``p_root``-th roots when ``p_root`` is not 2."""
    from repro_torch.optim import Shampoo, make_optimizer

    if p_root != 2:
        return Shampoo(model.named_parameters(), cfg, model.logical_axes(),
                       p_root=p_root)
    return make_optimizer(cfg, model.named_parameters(),
                          model.logical_axes())


def _opt_from(torch, model, cfg, state, p_root=2):
    """``_make_opt``'s optimizer with a copy of ``state``."""
    opt = _make_opt(model, cfg, p_root)
    per_param, count = state
    for p, st in per_param.items():
        opt.state[p] = {k: v.clone() for k, v in st.items()}
    opt.count = count
    return opt


def _with_prism(cfg, **kw):
    import dataclasses

    return dataclasses.replace(cfg, prism=dataclasses.replace(cfg.prism,
                                                              **kw))


def _expect_launches(counts, want, what):
    full = dict.fromkeys(KERNEL_NAMES, 0)
    full.update(want)
    if counts != full:
        fail(f"{what}: launches {counts}, want {full}")


def _restore(torch, model, run):
    """Parameters and gradients as the last training step left them."""
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(run["before"][k])
            p.grad = run["grads"][k].clone()


def _opt_step(torch, model, cfg, run, key):
    """One optimizer update from the saved state, parameters and gradients;
    returns (milliseconds, parameter deltas)."""
    o = _opt_from(torch, model, cfg, run["state"], run["p_root"])
    _restore(torch, model, run)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o.step(key=key)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, {k: (p.detach() - run["before"][k])
                for k, p in model.named_parameters()}


def _worst_gap(torch, got, want, what, gate=True):
    worst = 0.0
    for k, dk in got.items():
        dp = want[k]
        scale = float(dp.abs().max())
        rel = float((dk - dp).abs().max()) / max(scale, 1e-30)
        worst = max(worst, rel)
        if gate and not rel <= UPDATE_REL_TOL:
            fail(f"{what}: the update of {k} differs by {rel:.3e} of the "
                 f"largest update entry (bound {UPDATE_REL_TOL})")
    return worst


class AlphaTape:
    """Records the fitted alphas of a run in call order (``replay=None``),
    or hands a recorded run's alphas back in the same order: every fit
    goes through ``prism.fit_alpha_from_traces`` (the fused tier's K6
    traces and the grid tier's sketched chain alike), which is patched
    for the duration of a ``with`` block."""

    def __init__(self, replay=None):
        self.alphas = []
        self.replay = replay

    def __enter__(self):
        from repro_torch.core import prism

        self._real = real = prism.fit_alpha_from_traces

        def fit(*a, **k):
            out = real(*a, **k)
            if self.replay is not None:
                alpha = self.replay[len(self.alphas)]
                out = (alpha, out[1]) if isinstance(out, tuple) else alpha
            self.alphas.append(out[0] if isinstance(out, tuple) else out)
            return out

        prism.fit_alpha_from_traces = fit
        return self

    def __exit__(self, *exc):
        from repro_torch.core import prism

        prism.fit_alpha_from_traces = self._real


def count_syncs(torch, fn):
    """The synchronizing CUDA calls ``fn()`` makes, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    torch.cuda.synchronize()
    with SyncLog(torch) as syncs:
        fn()
    torch.cuda.synchronize()
    return syncs.messages()


class SyncLog:
    """The synchronizing CUDA calls made inside a ``with`` block, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them, read whole
    (``messages()``) or in parts: ``mark()`` returns how many were made
    since the last mark."""

    def __init__(self, torch):
        import warnings

        self._torch = torch
        self._catch = warnings.catch_warnings(record=True)
        self._caught, self._seen = [], 0

    def __enter__(self):
        import warnings

        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        self._torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        self._torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)

    def messages(self):
        return [str(w.message).splitlines()[0] for w in self._caught
                if "called a synchronizing CUDA operation" in str(w.message)]

    def mark(self) -> int:
        n = len(self.messages())
        new, self._seen = n - self._seen, n
        return new


def path_spec(path):
    """(optimizer, PRISM configuration, OptimizerConfig changes, p_root)
    of a key of PATHS."""
    spec = PATHS[path]
    return spec + ({}, 2)[len(spec) - 2:]


def build_path(path):
    """(model, optimizer, train_step, batch_for_step, (seq, batch)) of
    ``path`` at full width: the launcher's ``build``, with the path's
    OptimizerConfig changes and inverse-root power (``PATHS``)."""
    import dataclasses

    from repro_torch.data import make_batch_fn
    from repro_torch.launch import train_lm
    from repro_torch.models import Model
    from repro_torch.train import make_train_step

    optimizer, prism, changes, p_root = path_spec(path)
    cfg, ocfg, dcfg = train_lm.configs("full", "prism", "float32", 0, prism,
                                       optimizer, precondition_every=1)
    ocfg = dataclasses.replace(ocfg, **changes)
    model = Model(cfg, device="cuda", seed=0)
    opt = _make_opt(model, ocfg, p_root)
    return (model, opt, make_train_step(model, opt, ocfg),
            make_batch_fn(cfg, dcfg, "cuda"), (dcfg.seq_len,
                                               dcfg.global_batch))


def train_path(torch, path, steps=STEPS, per_step=None):
    """The gpt2-paper training step at full width on ``path`` (a key of
    PATHS: the optimizer, its PRISM configuration and any change of its
    OptimizerConfig): ``steps`` steps through ``build_path``, the launch
    gate (``per_step`` launches a step, else ``PER_STEP[path]``), the loss
    and update gates, and the timings."""
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops

    optimizer, prism, changes, p_root = path_spec(path)
    unaligned = unaligned_launches()
    model, opt, step, batch_fn, (seq, batch) = build_path(path)
    per_step = PER_STEP[path] if per_step is None else per_step(opt)
    pc = opt.cfg.prism
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  model {model.cfg.name}: {n_params} params, seq {seq}, batch "
        f"{batch}, {optimizer} {prism} (degree {pc.degree}, "
        f"{pc.warm_alpha_iters} warm of {pc.iterations} iterations, sketch "
        f"{pc.sketch_dim}, lr {opt.cfg.learning_rate}), use_kernels=True, "
        f"matfn_dtype float32"
        + "".join(f", {k}={v!r}" for k, v in changes.items())
        + (f", p_root={p_root}" if p_root != 2 else ""))
    batches = [batch_fn(s) for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    losses, times = [], []
    for s, b in enumerate(batches):
        t0 = time.perf_counter()
        m = step(b, s)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
    counts = ops.launch_counts()
    if unaligned_launches() != unaligned:
        fail(f"{path}: K1/K2 launched their unaligned instantiation "
             f"({unaligned} -> {unaligned_launches()} launches)")

    peak_mem = torch.cuda.max_memory_allocated()
    for i, (loss, t) in enumerate(zip(losses, times)):
        log(f"  step {i}: loss {loss:.4f}  {t:.1f} ms")
    step_ms = statistics.median(times[1:])
    log(f"  step time (median of steps 1..{steps - 1}): {step_ms:.1f} ms, "
        f"{seq * batch / (step_ms / 1e3):.0f} tokens/s, "
        f"max_memory_allocated {peak_mem / 2**30:.2f} GiB")
    log(f"  launches over {steps} steps: {counts}")
    _expect_launches(counts, {k: v * steps for k, v in per_step.items()},
                     f"{path} ({sum(per_step.values())} a step: "
                     f"{per_step})")
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite loss: {losses}")
    ln_v = math.log(model.cfg.vocab_size)
    if abs(losses[0] - ln_v) > 1.5:
        fail(f"first loss {losses[0]:.4f} not within 1.5 of ln(V) "
             f"{ln_v:.4f}")

    # one update through the kernels vs through the plain versions, on the
    # clipped gradients the last step left in .grad, with the key the next
    # step would use
    run = dict(model=model, opt=opt, key=Key(0).fold_in(steps),
               p_root=p_root,
               before={k: p.detach().clone()
                       for k, p in model.named_parameters()},
               grads={k: p.grad.clone()
                      for k, p in model.named_parameters()},
               state=_clone_state(opt), counts=counts, step_ms=step_ms,
               peak_gib=peak_mem / 2**30)
    deltas, opt_ms, tapes = {}, {"kernels": [], "plain": []}, {}
    for tag in ("kernels", "plain", "plain", "kernels"):
        cfg = _with_prism(opt.cfg, use_kernels=tag == "kernels")
        with AlphaTape() as tape:
            ms, d = _opt_step(torch, model, cfg, run, run["key"])
        opt_ms[tag].append(ms)
        deltas.setdefault(tag, d)
        tapes.setdefault(tag, tape.alphas)
    pinned = path in PINNED_ALPHA
    worst = _worst_gap(torch, deltas["kernels"], deltas["plain"],
                       f"{path} kernels vs plain", gate=not pinned)
    if pinned:
        # the same update through torch.matmul with the kernel run's
        # fitted alphas: what the kernels compute, apart from the fit
        dalpha = max((float((a - b).abs().max()) for a, b in
                      zip(tapes["kernels"], tapes["plain"])), default=0.0)
        with AlphaTape(replay=tapes["kernels"]) as tape:
            _, d = _opt_step(torch, model,
                             _with_prism(opt.cfg, use_kernels=False), run,
                             run["key"])
        if len(tape.alphas) != len(tapes["kernels"]):
            fail(f"{path}: {len(tape.alphas)} fits through torch.matmul, "
                 f"{len(tapes['kernels'])} through the kernels")
        worst_pinned = _worst_gap(torch, deltas["kernels"], d,
                                  f"{path} kernels vs plain, same alphas")
        log(f"  {len(tape.alphas)} alpha fits a step; largest alpha gap "
            f"kernels vs plain {dalpha:.3e}; update gap with the kernel "
            f"run's alphas {worst_pinned:.3e} (bound {UPDATE_REL_TOL})")
        run.update(dalpha=dalpha, worst_pinned=worst_pinned)
    run.update(deltas=deltas, opt_ms=opt_ms, worst=worst)
    # forward + backward alone (the rest of a step is clipping and the
    # optimizer)
    fb = []
    for b in batches[1:]:
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.loss(b)[0].backward()
        torch.cuda.synchronize()
        fb.append((time.perf_counter() - t0) * 1e3)
    log(f"  forward+backward alone (median of {len(fb)}): "
        f"{statistics.median(fb):.1f} ms")
    gate = ("printed; the gate holds the same alphas" if pinned
            else f"bound {UPDATE_REL_TOL}")
    log(f"  {optimizer} update, kernels vs plain versions: worst relative "
        f"gap {worst:.3e} ({gate})")
    log(f"  {optimizer} step through the kernels "
        + ", ".join(f"{t:.1f}" for t in opt_ms["kernels"])
        + " ms; through torch.matmul (use_kernels=False) "
        + ", ".join(f"{t:.1f}" for t in opt_ms["plain"]) + " ms")
    # the synchronizing calls of one optimizer step through the kernels
    o = _opt_from(torch, model, opt.cfg, run["state"], p_root)
    _restore(torch, model, run)
    run["syncs"] = count_syncs(torch, lambda: o.step(key=run["key"]))
    log(f"  synchronizing calls in one {optimizer} step: "
        f"{len(run['syncs'])} {sorted(set(run['syncs']))}")
    if len(run["syncs"]) > SYNCS_BOUND:
        fail(f"{path}: {len(run['syncs'])} synchronizing calls in one "
             f"{optimizer} step, more than the {SYNCS_BOUND} of K3's former "
             f"alpha copy")
    return run


def fallback_path(torch, run):
    """One PRISM-3 Muon step with the shared-memory budget forced just
    below sketch_chain's footprint on the grid buckets' Gram side (96 KiB
    at d_model = 1024, fp32, p = 8; the fused tier's bias view needs 17 KB
    and keeps its tier): the chains run as sketch_step launches (2 buckets
    x 2 fits x 6 powers), and the update stays within UPDATE_REL_TOL of
    the update through sketch_chain."""
    from repro_torch.kernels import ops, sketch_traces

    pc = run["opt"].cfg.prism
    budget = sketch_traces.chain_smem_bytes(
        run["model"].cfg.d_model, pc.sketch_dim, 4) - 16
    route_report(torch, pc.sketch_dim, budget)
    cfg = _with_prism(run["opt"].cfg, vmem_budget=budget)
    ops.reset_launches()
    ms, d = _opt_step(torch, run["model"], cfg, run, run["key"])
    counts = ops.launch_counts()
    log(f"  Muon step with vmem_budget={budget}: {ms:.1f} ms, launches "
        f"{counts}")
    _expect_launches(counts, dict(matmul_add=10, gram_upper=10, warm_tail=1,
                                  sketch_step=24, residual_chain=2,
                                  apply_g=2), "fallback (sketch_step) path")
    worst = _worst_gap(torch, d, run["deltas"]["kernels"],
                       "sketch_step vs sketch_chain")
    log(f"  update through sketch_step vs through sketch_chain: worst "
        f"relative gap {worst:.3e} (bound {UPDATE_REL_TOL})")
    return counts


# the residual buckets whose sketched chains run on K5 or K4: Muon's two
# grid buckets (R = I - X^T X of [40, 1024, 1024] and [20, 4096, 1024])
# and Shampoo's 1024-side factor bucket
GRID_BUCKETS = [(40, 1024, 1024), (20, 1024, 1024), (100, 1024, 1024)]


def route_report(torch, p, forced_budget):
    """Which of K5 and K4 ``ops.chain_route`` picks for each grid bucket,
    fp32, with the card's budget and with ``forced_budget``, beside the
    card's resident K5 clusters: K5 with the first (the main paths' launch
    counts hold that), K4 with the second."""
    from repro_torch.kernels import ops, sketch_traces

    for shape in GRID_BUCKETS:
        B, n, _ = shape
        r = torch.empty(shape, device="cuda")
        st = torch.empty((n, p), device="cuda")
        clusters = sketch_traces.resident_clusters(r, st)
        routes = [ops.chain_route(n, p, torch.float32, budget=b,
                                  resident_clusters=clusters)
                  for b in (0, forced_budget)]
        log(f"  route of {shape}, p = {p}: {routes[0]} ({clusters} K5 "
            f"clusters resident, block "
            f"{sketch_traces.chain_smem_bytes(n, p, 4)} B); with the budget "
            f"forced to {forced_budget} B: {routes[1]}")
        if routes != ["sketch_chain", "sketch_step"]:
            fail(f"route of {shape}: {routes}")
        del r, st


def profile_step(torch, run, what, fit_buckets=(), whole_fit=False,
                 by_shape=False, fresh=None):
    """A torch.profiler trace of one optimizer step through the kernels
    (``what`` names it): the device time of each of the port's kernels and
    of all other device work (memory copies and PyTorch's own kernels),
    against the step's wall time; and the alpha fit (the sketch draws and
    the closed-form fits, marked with record_function here; with
    ``whole_fit`` all of ``prism.fit_alpha``, the sketched chain included):
    its host time (a clock around each outermost call) and the device time
    of the kernels it launched.  ``fit_buckets``: (batch, fits a step) of
    each bucket whose closed-form fit is then timed alone.  ``by_shape``:
    each K1/K2 launch's device time, summed by operand shapes, and the
    device time of the copy kernels.  ``fresh()`` returns the optimizer to
    step with the parameters and gradients restored (default: a copy of
    ``run``'s saved state, ``_opt_from`` and ``_restore``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core import prism, sketch
    from repro_torch.kernels import ops

    fit_host = [0.0]
    depth = [0]
    shapes = []

    def marked(fn):
        def wrapper(*a, **k):
            if depth[0]:
                return fn(*a, **k)
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                with record_function("alpha_fit"):
                    return fn(*a, **k)
            finally:
                fit_host[0] += time.perf_counter() - t0
                depth[0] -= 1
        return wrapper

    def shaped(name, fn):
        def wrapper(*a, **k):
            desc = "@".join(str(list(t.shape)) for t in a[:2]
                            if t is not None)
            if len(a) > 2 and a[2] is not None or k.get("C") is not None:
                desc += " + C"
            shapes.append((name, desc))
            return fn(*a, **k)
        return wrapper

    saved = {(prism, "fit_alpha_from_traces"): prism.fit_alpha_from_traces,
             (sketch, "gaussian_sketch"): sketch.gaussian_sketch}
    if whole_fit:
        saved[(prism, "fit_alpha")] = prism.fit_alpha
    patched = {k: marked(f) for k, f in saved.items()}
    if by_shape:
        for name, attr in (("matmul_add", "matmul_add"),
                           ("gram_upper", "gram")):
            saved[(ops, attr)] = getattr(ops, attr)
            patched[(ops, attr)] = shaped(name, getattr(ops, attr))
    for (mod, attr), f in patched.items():
        setattr(mod, attr, f)
    if fresh is None:
        def fresh():
            o = _opt_from(torch, run["model"], run["opt"].cfg, run["state"],
                          run["p_root"])
            _restore(torch, run["model"], run)
            return o
    try:
        o = fresh()
        o.step(key=run["key"])  # warm
        o = fresh()
        torch.cuda.synchronize()
        fit_host[0] = 0.0
        shapes.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            o.step(key=run["key"])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for (mod, attr), f in saved.items():
            setattr(mod, attr, f)

    kernel_us, other_us, fit_dev_us, fit_calls = 0.0, 0.0, 0.0, 0
    per_kernel = dict.fromkeys(KERNEL_NAMES, 0.0)
    for e in prof.key_averages():
        if e.key == "alpha_fit":
            fit_dev_us = max(fit_dev_us, e.device_time_total)
            fit_calls = max(fit_calls, e.count)
        # device activity only; the GPU-side spans of record_function
        # ranges (Muon.step, alpha_fit) would count their kernels twice
        elif e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            name = next((n for n in KERNEL_NAMES
                         if f"{n}_kernel" in e.key), None)
            if name is not None:
                kernel_us += e.self_device_time_total
                per_kernel[name] += e.self_device_time_total / 1e3
            else:
                other_us += e.self_device_time_total
    busy_ms = (kernel_us + other_us) / 1e3
    fit_ms = fit_host[0] * 1e3
    log(f"  profiled {what} step: wall {wall_ms:.1f} ms; device busy "
        f"{busy_ms:.2f} ms (port kernels {kernel_us / 1e3:.2f} ms, other "
        f"device work {other_us / 1e3:.2f} ms); idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}; port kernels: "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in per_kernel.items() if v))
    log(f"  alpha fit ({fit_calls} marked calls"
        f"{', all of prism.fit_alpha' if whole_fit else ''}): host "
        f"{fit_ms:.2f} ms ({fit_ms / wall_ms:.3f} of the step's wall time), "
        f"device {fit_dev_us / 1e3:.3f} ms")
    if by_shape:
        _launches_by_shape(prof, shapes)
    # the fit alone, unprofiled: one closed-form fit from fp32 traces of
    # each bucket, times its fitted iterations a step
    from repro_torch.core import polynomials as poly

    pc = run["opt"].cfg.prism
    apoly = poly.newton_schulz_residual(pc.degree)
    lo, hi = pc.bounds
    per_fit = []
    for B, _ in fit_buckets:
        t = torch.rand((B, poly.max_trace_power(apoly) + 1), device="cuda")
        per_fit.append(time_ms(torch, lambda: prism.fit_alpha_from_traces(
            t, apoly, lo, hi)))
    if fit_buckets:
        log(f"  one closed-form fit alone (B = "
            + ", ".join(str(B) for B, _ in fit_buckets) + "): "
            + ", ".join(f"{v:.3f}" for v in per_fit) + " ms; "
            + f"{sum(v * k for v, (_, k) in zip(per_fit, fit_buckets)):.2f}"
            + " ms a step")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms)


def _launches_by_shape(prof, shapes):
    """Device time of each K1/K2 launch of a profiled step, summed by the
    operand shapes its wrapper was called with (``shapes``, in launch
    order: one stream), and the device time of the copy kernels (the
    transposes K1's row-major operands need)."""
    from torch.autograd import DeviceType

    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and ("matmul_add_kernel" in e.name
                          or "gram_upper_kernel" in e.name)),
                    key=lambda e: e.time_range.start)
    if len(events) != len(shapes) or any(
            f"{n}_kernel" not in e.name for (n, _), e in zip(shapes, events)):
        log(f"  by shape: the trace holds {len(events)} K1/K2 launches, the "
            f"wrappers made {len(shapes)}: not matched")
        return
    agg = {}
    for key, e in zip(shapes, events):
        n, us = agg.get(key, (0, 0.0))
        agg[key] = (n + 1, us + e.time_range.elapsed_us())
    for (name, desc), (n, us) in sorted(agg.items(), key=lambda t: -t[1][1]):
        log(f"    {name:10s} {desc:42s} {n:3d} launches, device "
            f"{us / 1e3:8.3f} ms ({us / 1e3 / n:.3f} each)")
    copy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and ("copy" in e.name.lower() or "memcpy" in e.name.lower()))
    log(f"    copy kernels (other device work): {copy_us / 1e3:.3f} ms")


def adaptive_runs(torch):
    """matfn.polar with a tol and a budget of 5 fitted iterations on a
    grid-tier bucket and a fused-tier one, inputs of condition 1 to 1e3:
    prints each slice's iterations and status, and holds the launches to
    the iterations that ran (2+d per fitted iteration on the grid tier, 2
    on the fused tier, one warm tail)."""
    from repro_torch.config import PrismConfig
    from repro_torch.core import matfn, prism
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    d, warm, budget = 2, 1, 5
    for shape, tier in (((40, 1024, 1024), "grid"), ((30, 64, 16),
                                                      "fused")):
        B, m, n = shape
        q, _ = torch.linalg.qr(randn(torch, (B, m, n), gen))
        cond = torch.linspace(0.0, 3.0, B, device="cuda")[:, None, None]
        a = q * 10.0 ** (-cond * torch.linspace(0.0, 1.0, n,
                                                device="cuda"))
        tol = 0.05 * n ** 0.5
        cfg = PrismConfig(degree=d, iterations=warm + budget,
                          warm_alpha_iters=warm, sketch_dim=8, tol=tol,
                          use_kernels=True)
        ops.reset_launches()
        x, used, status = matfn.polar(a, cfg=cfg, key=Key(5),
                                      return_iters=True, return_status=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if not bool(torch.isfinite(x).all()):
            fail(f"adaptive {tier}: non-finite result")
        used_l, status_l = used.tolist(), status.tolist()
        fitted = budget
        if prism.STATUS_MAXITER not in status_l:
            fitted = min(budget, max(used_l) - warm + 1)
        if tier == "grid":
            want = dict(gram_upper=warm + fitted, sketch_chain=fitted,
                        matmul_add=d * (warm + fitted))
        else:
            want = dict(warm_tail=1, residual_chain=fitted, apply_g=fitted)
        log(f"  adaptive {tier} {shape} tol {tol:.3g}: iters_used "
            f"{used_l}; status {status_l}; {fitted} fitted iterations ran; "
            f"launches {counts}")
        _expect_launches(counts, want, f"adaptive {tier}")


def shampoo_extras(torch, run):
    """On the fitted Shampoo path: a Shampoo with precondition_every=2 takes
    two steps from the saved state (count 0: it refreshes; count 1: it
    serves the cached inverse roots and must launch nothing); and one
    Shampoo step with matfn_method="eigh" (torch.linalg.eigh, the paper's
    baseline) is timed beside the one through the kernels."""
    import dataclasses

    from repro_torch.kernels import ops

    model = run["model"]
    cfg2 = dataclasses.replace(run["opt"].cfg, precondition_every=2)
    o = _opt_from(torch, model, cfg2, (run["state"][0], 0))
    _restore(torch, model, run)
    ops.reset_launches()
    o.step(key=run["key"])
    torch.cuda.synchronize()
    first = ops.launch_counts()
    ops.reset_launches()
    _restore(torch, model, run)
    o.step(key=run["key"].fold_in(1))
    torch.cuda.synchronize()
    second = ops.launch_counts()
    log(f"  precondition_every=2: step 0 launches {first}; step 1 launches "
        f"{second}")
    _expect_launches(first, PER_STEP["shampoo_fig5"],
                     "precondition_every=2, step 0")
    _expect_launches(second, {}, "precondition_every=2, step 1")
    cfg_e = dataclasses.replace(run["opt"].cfg, matfn_method="eigh")
    eigh_ms = [_opt_step(torch, model, cfg_e, run, run["key"])[0]
               for _ in range(3)]
    log("  Shampoo step with matfn_method='eigh' (torch.linalg.eigh): "
        + ", ".join(f"{t:.1f}" for t in eigh_ms) + " ms; through the "
        "kernels (fitted PRISM) "
        + ", ".join(f"{t:.1f}" for t in run["opt_ms"]["kernels"]) + " ms")
    return dict(eigh_ms=eigh_ms)


def adaptive_sqrtm_runs(torch):
    """matfn.sqrtm with a tol and a budget of 5 fitted iterations after one
    warm iteration on a grid-tier bucket and a fused-tier one, symmetric
    positive definite inputs of condition 1 to 1e3: prints each slice's
    iterations and status, and holds the launches to the iterations that
    ran (a fitted grid iteration: 1 matmul_add for Y X, one sketch_chain,
    2d matmul_add for the two Horner sides; a fitted fused one:
    residual_chain + apply_g; the warm iteration: 1 + 2d matmul_add, or one
    warm_tail)."""
    from repro_torch.config import PrismConfig
    from repro_torch.core import matfn, prism
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    d, warm, budget = 2, 1, 5
    for shape, tier in (((20, 1024, 1024), "grid"), ((30, 64, 64),
                                                      "fused")):
        B, n, _ = shape
        q, _ = torch.linalg.qr(randn(torch, shape, gen))
        cond = torch.linspace(0.0, 3.0, B, device="cuda")[:, None, None]
        lam = 10.0 ** (-cond * torch.linspace(0.0, 1.0, n, device="cuda"))
        a = (q * lam) @ q.transpose(-1, -2)
        tol = 0.05 * n ** 0.5
        cfg = PrismConfig(degree=d, iterations=warm + budget,
                          warm_alpha_iters=warm, sketch_dim=8, tol=tol,
                          use_kernels=True)
        ops.reset_launches()
        (x, y), used, status = matfn.sqrtm(a, cfg=cfg, key=Key(5),
                                           return_iters=True,
                                           return_status=True)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        if not (bool(torch.isfinite(x).all()) and
                bool(torch.isfinite(y).all())):
            fail(f"adaptive sqrtm {tier}: non-finite result")
        used_l, status_l = used.tolist(), status.tolist()
        fitted = budget
        if prism.STATUS_MAXITER not in status_l:
            fitted = min(budget, max(used_l) - warm + 1)
        if tier == "grid":
            want = dict(matmul_add=(1 + 2 * d) * (warm + fitted),
                        sketch_chain=fitted)
        else:
            want = dict(warm_tail=1, residual_chain=fitted, apply_g=fitted)
        log(f"  adaptive sqrtm {tier} {shape} tol {tol:.3g}: iters_used "
            f"{used_l}; status {status_l}; {fitted} fitted iterations ran; "
            f"launches {counts}")
        _expect_launches(counts, want, f"adaptive sqrtm {tier}")


# --------------------------------------------------------------- phase 8

def _host_state(torch, trainer):
    """The trainer's checkpoint tree, flattened with "|", copied to the
    host."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}|")
            elif isinstance(v, torch.Tensor):
                out[prefix + k] = v.detach().to("cpu", copy=True)
            else:
                out[prefix + k] = torch.as_tensor(int(v))
    walk(trainer.state_tree(), "")
    return out


def _per_step_launches(log_to):
    """Zeroes the launch counts and returns an ``on_metrics`` that files
    each step's launches (and loss) from there on."""
    from repro_torch.kernels import ops

    ops.reset_launches()
    last = [ops.launch_counts()]

    def on_metrics(t, m):
        now = ops.launch_counts()
        log_to[t] = ({k: now[k] - last[0][k] for k in now},
                     float(m["loss"]))
        last[0] = now
    return on_metrics


def _trainer_for(cfgs, ckpt_dir, seed, **tkw):
    from repro_torch.config import TrainConfig
    from repro_torch.models import Model
    from repro_torch.train import Trainer

    cfg, ocfg, dcfg = cfgs
    return Trainer(Model(cfg, device=DEVICE, seed=seed), ocfg,
                   TrainConfig(checkpoint_dir=str(ckpt_dir), log_every=1,
                               **tkw), dcfg)


def trainer_path(torch, preset="full"):
    """Phase 8's runs A and B (see the module docstring) in a temporary
    directory under build/, removed at the end; returns run A's launch
    counts, its refresh and skip step times (ms) and the synchronizing
    calls of each of its skip steps."""
    import shutil
    import tempfile

    from repro_torch.launch import train_lm

    cfgs = train_lm.configs(preset, "prism", "float32",
                            precond_every=TRAINER_K)
    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase8_", dir=base_dir))
    try:
        return _trainer_runs(torch, cfgs, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _trainer_runs(torch, cfgs, work):
    import shutil

    from repro_torch import checkpoint as ckpt
    from repro_torch.kernels import ops

    refresh_steps = {t for t in range(TRAINER_STEPS) if t % TRAINER_K == 0}
    a_dir, b_dir = work / "a", work / "b"
    tr = _trainer_for(cfgs, a_dir, 0, steps=TRAINER_STEPS,
                      checkpoint_every=TRAINER_EVERY, keep_checkpoints=2,
                      async_checkpoint=False)
    writes, held, run_a, syncs_a = [], {}, {}, {}
    write = tr._checkpoint
    sync_log = SyncLog(torch)

    def timed_write(step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write(step)
        writes.append((step, time.perf_counter() - t0))
        sync_log.mark()  # the write's host copies are not a step's
    tr._checkpoint = timed_write
    log(f"  run A: {TRAINER_STEPS} steps, Muon PRISM-5, precond_every "
        f"{TRAINER_K}, a checkpoint every {TRAINER_EVERY} steps (2 kept), "
        f"synchronous writes")
    filed = _per_step_launches(run_a)

    def on_a(t, m):
        syncs_a[t] = sync_log.mark()
        filed(t, m)
        if t == TRAINER_EVERY - 1:  # the state step_00000003 holds
            held.update(_host_state(torch, tr))
        sync_log.mark()  # the reads above are this script's, not a step's
    with sync_log:
        tr.run(on_metrics=on_a)
    counts_a = ops.launch_counts()
    for t, (c, _) in sorted(run_a.items()):
        _expect_launches(c, PER_STEP["prism5"] if t in refresh_steps else {},
                         f"trainer run A, step {t}")
    losses_a = {t: loss for t, (_, loss) in run_a.items()}
    if not all(math.isfinite(v) for v in losses_a.values()):
        fail(f"trainer run A: non-finite loss {losses_a}")
    times = dict(zip(range(1, TRAINER_STEPS), tr.step_times))
    log("  run A per step: " + "; ".join(
        f"{t} loss {losses_a[t]:.4f} launches {sum(run_a[t][0].values())}"
        + (f" {times[t] * 1e3:.1f} ms" if t in times else "")
        for t in sorted(losses_a)) + " (step 0 is the run's first: "
        "excluded from the Trainer's step times)")
    refresh_ms = [times[t] * 1e3 for t in times if t in refresh_steps]
    skip_ms = [times[t] * 1e3 for t in times if t not in refresh_steps]
    log(f"  refresh step {', '.join(f'{v:.1f}' for v in refresh_ms)} ms; "
        f"skip steps median {statistics.median(skip_ms):.1f} ms ("
        + ", ".join(f"{v:.1f}" for v in skip_ms) + ")")
    skip_syncs = {t: n for t, n in syncs_a.items()
                  if t and t not in refresh_steps}
    log("  synchronizing calls a step (run A, checkpoint writes left out): "
        + ", ".join(f"{t} {n}" for t, n in sorted(syncs_a.items())))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    syncs = count_syncs(torch, lambda: tr.batch_fn(TRAINER_STEPS))
    log(f"  one batch_fn(step) alone (the synthetic bigram stream, "
        f"{cfgs[2].seq_len - 1} sequential draws, inside each step's time): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, {len(syncs)} "
        f"synchronizing calls")
    hb = (a_dir / "HEARTBEAT").read_text().split()
    if hb[0] != str(TRAINER_STEPS - 1):
        fail(f"trainer run A: HEARTBEAT reads {hb}, want step "
             f"{TRAINER_STEPS - 1}")
    kept = sorted(d.name for d in a_dir.iterdir() if d.name != "HEARTBEAT")
    want = [f"step_{s:08d}" for s in range(TRAINER_EVERY, TRAINER_STEPS,
                                           TRAINER_EVERY)]
    if kept != want:
        fail(f"trainer run A: checkpoint directory holds {kept}, want {want}")
    for step, secs in writes:
        d = a_dir / f"step_{step:08d}"
        nbytes = sum(f.stat().st_size for f in d.iterdir())
        t0 = time.perf_counter()
        ok = ckpt.verify_step(str(a_dir), step)
        verify_s = time.perf_counter() - t0
        log(f"  checkpoint step {step}: {nbytes} bytes, written in "
            f"{secs:.2f} s ({nbytes / secs / 1e9:.2f} GB/s: host copy, npz, "
            f"crc32, rename), verified in {verify_s:.2f} s")
        if not ok:
            fail(f"trainer run A: step {step} does not verify")
    del tr
    torch.cuda.empty_cache()

    # run B: a fresh Trainer (another model seed) over step 3 alone
    first = TRAINER_EVERY
    b_dir.mkdir()
    shutil.copytree(a_dir / f"step_{first:08d}", b_dir / f"step_{first:08d}",
                    copy_function=os.link)
    tr = _trainer_for(cfgs, b_dir, 1, steps=TRAINER_STEPS,
                      checkpoint_every=0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = tr.restore_or_init()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if start != first:
        fail(f"trainer run B resumed at step {start}, want {first}")
    got = _host_state(torch, tr)
    if set(got) != set(held):
        fail(f"trainer run B restored {sorted(set(got) ^ set(held))[:5]} "
             f"unlike run A's state")
    differ = [k for k in held if not torch.equal(got[k], held[k])]
    if differ:
        fail(f"trainer run B: {len(differ)} restored leaves differ from run "
             f"A's state after step {first - 1}, e.g. {differ[:3]}")
    log(f"  run B restored step {first} in {restore_s:.2f} s (crc32 check "
        f"of the step, npz read, host-to-device copy): {len(held)} leaves, "
        f"count {int(got['opt|count'])}, bitwise equal to run A's state "
        f"after step {first - 1}")
    run_b = {}
    tr.run(on_metrics=_per_step_launches(run_b))
    if sorted(run_b) != list(range(first, TRAINER_STEPS)):
        fail(f"trainer run B ran steps {sorted(run_b)}")
    for t, (c, _) in sorted(run_b.items()):
        _expect_launches(c, PER_STEP["prism5"] if t in refresh_steps else {},
                         f"trainer run B, step {t}")
    gaps = {t: abs(loss - losses_a[t]) for t, (_, loss) in run_b.items()}
    log("  run B per step: " + "; ".join(
        f"{t} loss {run_b[t][1]:.6f} launches {sum(run_b[t][0].values())}"
        f" |loss - run A's| {gaps[t]:.3e}" for t in sorted(run_b))
        + f" (bound {RESUME_LOSS_TOL})")
    if not all(g <= RESUME_LOSS_TOL for g in gaps.values()):
        fail(f"trainer run B: losses {gaps} off run A's by more than "
             f"{RESUME_LOSS_TOL}")
    del tr
    torch.cuda.empty_cache()
    return dict(counts=counts_a, refresh_ms=refresh_ms, skip_ms=skip_ms,
                skip_syncs=skip_syncs)


def baseline_steps(torch, prism5_ms, preset="full"):
    """Two train steps each of ``--method polar_express`` and ``--optimizer
    adamw`` (finite losses, no port kernel), their optimizer step timed
    beside PRISM-5's; one Muon step with ``matfn_method="svd"``."""
    import dataclasses

    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops
    from repro_torch.launch import train_lm
    from repro_torch.optim import make_optimizer

    for what, method, optimizer in (("polar_express", "polar_express",
                                     "muon"), ("adamw", "prism", "adamw")):
        model, opt, step, batch_fn, _ = train_lm.build(
            preset, method, "float32", device=DEVICE, optimizer=optimizer)
        ops.reset_launches()
        losses = [float(step(batch_fn(s), s)["loss"]) for s in range(2)]
        _expect_launches(ops.launch_counts(), {}, f"{what} steps")
        if not all(math.isfinite(v) for v in losses):
            fail(f"{what}: non-finite losses {losses}")
        ms = []
        for s in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step(key=Key(0).fold_in(2 + s))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"  {what}: losses {', '.join(f'{v:.4f}' for v in losses)}, no "
            f"port kernel; optimizer step {', '.join(f'{v:.1f}' for v in ms)}"
            f" ms (Muon PRISM-5 through the kernels, phase 4: "
            f"{', '.join(f'{v:.1f}' for v in prism5_ms)} ms)")
        if what == "polar_express":
            o = make_optimizer(dataclasses.replace(opt.cfg,
                                                   matfn_method="svd"),
                               model.named_parameters(),
                               model.logical_axes())
            before = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o.step()
            torch.cuda.synchronize()
            svd_ms = (time.perf_counter() - t0) * 1e3
            moved = max(float((p.detach() - before[k]).abs().max())
                        for k, p in model.named_parameters())
            finite = all(bool(torch.isfinite(p).all())
                         for p in model.parameters())
            log(f"  Muon step with matfn_method='svd' (torch.linalg.svd, "
                f"fp32): {svd_ms:.1f} ms; largest parameter change "
                f"{moved:.3e}")
            if not finite or not moved > 0:
                fail(f"svd Muon step: finite {finite}, largest change "
                     f"{moved}")
            del o, before
        del model, opt, step
        torch.cuda.empty_cache()


def guard_check(torch, syncs_bound, preset="full"):
    """``skip_nonfinite`` on the card: a NaN written into one gradient
    leaves the parameters, the state and the count bitwise as they were,
    advances bad_steps to 1, launches what a good step launches and makes
    no more synchronizing calls than ``syncs_bound``."""
    import dataclasses

    from repro_torch.core.rng import Key
    from repro_torch.data import make_batch_fn
    from repro_torch.kernels import ops
    from repro_torch.launch import train_lm
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step

    cfg, ocfg, dcfg = train_lm.configs(preset, "prism", "float32")
    ocfg = dataclasses.replace(ocfg, skip_nonfinite=True)
    model = Model(cfg, device=DEVICE, seed=0)
    opt = make_optimizer(ocfg, model.named_parameters(),
                         model.logical_axes())
    make_train_step(model, opt, ocfg)(make_batch_fn(cfg, dcfg, DEVICE)(0), 0)
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    ops.reset_launches()
    opt.step(key=Key(0).fold_in(1))
    torch.cuda.synchronize()
    good = ops.launch_counts()
    _expect_launches(good, PER_STEP["prism5"], "guarded good step")
    named = dict(model.named_parameters())
    for k, p in named.items():
        p.grad = grads[k].clone()
    named["layers.attn.wq"].grad.view(-1)[12345] = float("nan")

    def state():
        out = {f"param|{k}": p.detach().clone() for k, p in named.items()}
        for k, p in named.items():
            out.update({f"{k}|{n}": v.clone()
                        for n, v in opt.state[p].items()})
        out["count"] = opt.count.clone()
        return out
    before = state()
    ops.reset_launches()
    syncs = count_syncs(torch, lambda: opt.step(key=Key(0).fold_in(2)))
    poisoned = ops.launch_counts()
    after = state()
    differ = [k for k in before if not torch.equal(before[k], after[k])]
    bad = int(opt.bad_steps)
    log(f"  skip_nonfinite: a NaN in layers.attn.wq's gradient; "
        f"{len(before)} buffers, {len(differ)} changed; bad_steps {bad}; "
        f"launches {sum(poisoned.values())} (a good step "
        f"{sum(good.values())}); synchronizing calls {len(syncs)} (phase 4's"
        f" step {syncs_bound})")
    if differ or bad != 1:
        fail(f"skip_nonfinite: {differ[:3]} changed, bad_steps {bad}")
    if poisoned != good:
        fail(f"skip_nonfinite: the poisoned step launched {poisoned}, a "
             f"good one {good}")
    if len(syncs) > syncs_bound:
        fail(f"skip_nonfinite: {len(syncs)} synchronizing calls {syncs}, "
             f"more than phase 4's {syncs_bound}")
    del model, opt, grads, before, after
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 9

LOWRANK_TIERS = {(1024, 50272): "lowrank", (1024, 1024): "grid",
                 (1024, 4096): "grid", (16, 64): "fused"}
PHASE9_STEPS = 2
# full-rank SPD bucket of the card's inverse-root checks: eigenvalues in
# [0.1, 1], 40 iterations; the reference's bounds (tests/test_matfn.py)
ROOT_BUCKET = (16, 1024, 1024)
ROOT_ITERS = 40
PROOT_REL_TOL = 2e-3
INV_REL_TOL = 1e-3
# one update through Shampoo's per-leaf loop against the bucketed one:
# PRISM-5 draws no sketch and each slice runs the same kernels, but two
# torch reductions of the chain (the ridge's trace and sqrtm's Frobenius
# norm) sum in an order that depends on the batch they run in, so the
# inverse roots may differ in their last bits: each within 1e-6 of its
# largest entry; the parameter change, rounded into parameters whose ulp
# is ~1e-4 of it, within UPDATE_REL_TOL
PER_LEAF_REL_TOL = 1e-6
# what a K2 entry of a path's shapes ends with where it forms the local
# reshard's partial Gram (``gram_alpha``)
PARTIAL = "partial -X^T X"
# K1/K2 at the lowrank tier's shapes on gpt2-paper's vocab bucket
# [2, 1024, 50272] (X = its transpose [2, 50272, 1024], l = 136):
# (kernel, A, B, with C, what it computes)
LOWRANK_SHAPES = [
    ("gram_upper", (2, 50272, 136), None, False, "rangefinder polar R"),
    ("matmul_add", (2, 50272, 1024), (2, 1024, 136), False,
     "Y = X Omega, X (X^T Y)"),
    ("matmul_add", (2, 1024, 50272), (2, 50272, 136), False, "X^T Y"),
    ("matmul_add", (2, 136, 50272), (2, 50272, 1024), False, "B = Q^T X"),
    ("matmul_add", (2, 50272, 136), (2, 136, 136), True,
     "rangefinder Horner"),
    ("matmul_add", (2, 50272, 136), (2, 136, 1024), False, "lift Q P"),
]


def _lowrank_key(name, a, b, dtype):
    shape = a if b is None else a + (b[-1],)
    return (name, shape) if dtype == "float32" else (name, shape, dtype)


def _lowrank_operands(torch, a, b, with_c, dt, gen):
    """Operands whose products are of unit size: A, B ~ N(0, k^-1/2) make
    A @ B ~ N(0, 1); X ~ N(0, m^-1/2) makes X^T X's off-diagonal N(0, 1)
    (its diagonal ~sqrt(m)); C ~ N(0, 1)."""
    k = a[-1] if b is not None else a[-2]
    A = randn(torch, a, gen, k ** -0.25).to(dt)
    B = None if b is None else randn(torch, b, gen, k ** -0.25).to(dt)
    C = randn(torch, a[:-1] + (b[-1],), gen).to(dt) if with_c else None
    return A, B, C


def gram_alpha(what: str) -> float:
    """K2's alpha at a path's shape: 0 for the local reshard's partial
    Gram (-X^T X, I added after the all-reduce), else 1 (R = I - X^T X)."""
    return 0.0 if what.endswith(PARTIAL) else 1.0


def gemm_shape_checks(torch, rows, shapes=LOWRANK_SHAPES, dtypes=DTYPES,
                      seed=9):
    """K1 and K2 at a path's shapes (``LOWRANK_SHAPES``, the long
    contraction K = 50272 included, ``GRANITE_SHAPES`` and so on) against
    their plain versions with KERNEL_TOL, each on the aligned
    instantiation, K2 with the path's alpha (``gram_alpha``); and, with
    the lowrank shapes, one ragged case (l = 21: 84- and 42-byte rows) on
    the element-by-element one, which no main path takes."""
    from repro_torch.kernels import gram, matmul_add

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    cases = [(n, a, b, c, dtypes, True, gram_alpha(w))
             for n, a, b, c, w in shapes]
    if shapes is LOWRANK_SHAPES:
        cases += [("gram_upper", (1, 300, 21), None, False, DTYPES, False,
                   1.0),
                  ("matmul_add", (1, 300, 21), (1, 21, 21), True, DTYPES,
                   False, 1.0)]
    for name, a, b, with_c, dtypes, main, alpha in cases:
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            A, B, C = _lowrank_operands(torch, a, b, with_c, dt, gen)
            before = unaligned_launches()
            if name == "gram_upper":
                want = gram.plain(A, alpha=alpha, beta=-1.0)
                poison(torch, (a[0], a[-1], a[-1]), dt)
                got = gram.gram_upper(A, alpha=alpha, beta=-1.0)
                fast = matmul_add.aligned(A)
            else:
                want = matmul_add.plain(A, B, C, alpha=1.0, beta=0.5)
                poison(torch, a[:-1] + (b[-1],), dt)
                got = matmul_add.matmul_add(A, B, C, alpha=1.0, beta=0.5)
                fast = matmul_add.aligned(A, B, C)
            what = name if alpha == 1.0 else f"{name} alpha={alpha:g}"
            err = check(torch, what, a if b is None else (a, b), dtype, got,
                        want, KERNEL_TOL[dtype])
            took = unaligned_launches() - before
            if took != (0 if fast else 1) or fast != main:
                fail(f"{name} {a} {dtype}: {took} unaligned launches, "
                     f"aligned predicate {fast}, main path {main}")
            log(f"    {'aligned' if fast else 'unaligned'} instantiation")
            if main:
                shape = [list(a)] + ([] if b is None else [list(b)])
                rows[_lowrank_key(name, a, b, dtype)] = dict(
                    shape=shape, max_abs_err=err)
            del A, B, C, got, want
    torch.cuda.empty_cache()
    return rows


def gemm_shape_timings(torch, shapes=LOWRANK_SHAPES, dtypes=DTYPES,
                       seed=10, reps=TIMED_REPS):
    """Kernel, plain, library (``torch.bmm`` / ``baddbmm``) and bound ms of
    one launch at each of a path's shapes (``gemm_shape_checks``), each
    the median of ``reps`` launches."""
    from repro_torch.kernels import gram, matmul_add

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    out = {}
    for name, a, b, with_c, what in shapes:
        for dtype in dtypes:
            dt = getattr(torch, dtype)
            item = 2 if dtype == "bfloat16" else 4
            A, B, C = _lowrank_operands(torch, a, b, with_c, dt, gen)
            if name == "gram_upper":
                nb, m, n = a
                ga = gram_alpha(what)
                eye = ga * torch.eye(n, device="cuda", dtype=dt)
                At = A.transpose(-1, -2)
                t = dict(
                    ms=time_ms(torch, lambda: gram.gram_upper(
                        A, alpha=ga), reps),
                    plain_ms=time_ms(torch, lambda: gram.plain(
                        A, alpha=ga), reps),
                    library_ms=time_ms(torch, lambda: torch.baddbmm(
                        eye, At, A, alpha=-1.0), reps),
                    bound=bound_ms(1.0 * nb * m * n * (n + 1),
                                   item * (nb * m * n + nb * n * n), dtype))
            else:
                nb, m, k = a
                n = b[-1]
                beta = 0.5 if with_c else 0.0
                lib = ((lambda: torch.baddbmm(C, A, B, beta=0.5)) if with_c
                       else (lambda: torch.bmm(A, B)))
                t = dict(
                    ms=time_ms(torch, lambda: matmul_add.matmul_add(
                        A, B, C, beta=beta), reps),
                    plain_ms=time_ms(torch, lambda: matmul_add.plain(
                        A, B, C, beta=beta), reps),
                    library_ms=time_ms(torch, lib, reps),
                    bound=bound_ms(
                        2.0 * nb * m * k * n + (3.0 if with_c else 0) * nb
                        * m * n,
                        item * (nb * m * k + nb * k * n
                                + (2 if with_c else 1) * nb * m * n),
                        dtype))
            log(f"  {name:10s} {str(a if b is None else (a, b)):42s} "
                f"{dtype:8s} ({what}) kernel {t['ms']:.4f} ms  plain "
                f"{t['plain_ms']:.4f} ms  library {t['library_ms']:.4f} ms"
                f"  bound {t['bound'][0]:.4f} ms ({t['bound'][1]})")
            out[_lowrank_key(name, a, b, dtype)] = t
            del A, B, C
    torch.cuda.empty_cache()
    return out


def _spd_eigs(torch, shape, lo, hi, gen):
    """Symmetric positive definite [B, n, n] with eigenvalues uniform in
    [lo, hi] (Q diag Q^T, Q from a QR of a Gaussian)."""
    B, n, _ = shape
    q, _ = torch.linalg.qr(randn(torch, shape, gen))
    lam = lo + (hi - lo) * torch.rand((B, 1, n), generator=gen,
                                      device="cuda")
    return (q * lam) @ q.transpose(-1, -2)


def root_checks(torch):
    """matfn.inv_proot(p = 4) and matfn.inv(method="prism_chebyshev") on a
    full-rank SPD bucket (``ROOT_BUCKET``, eigenvalues in [0.1, 1],
    ``ROOT_ITERS`` iterations) against the LAPACK baselines on the card
    (``eigh``, ``solve``), at the reference's relative bounds; neither
    chain launches a port kernel (the reference computes them outside
    its kernels)."""
    from repro_torch.core import matfn
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    a = _spd_eigs(torch, ROOT_BUCKET, 0.1, 1.0, gen)
    for what, run, base, bound in (
            ("inv_proot p=4 (PRISM inverse Newton)",
             lambda: matfn.inv_proot(a, p=4, iters=ROOT_ITERS, key=Key(0)),
             lambda: matfn.inv_proot(a, p=4, method="eigh"), PROOT_REL_TOL),
            ("inv prism_chebyshev",
             lambda: matfn.inv(a, method="prism_chebyshev",
                               iters=ROOT_ITERS, key=Key(0)),
             lambda: matfn.inv(a, method="solve"), INV_REL_TOL)):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = ops.launch_counts()
        t0 = time.perf_counter()
        want = base()
        torch.cuda.synchronize()
        base_ms = (time.perf_counter() - t0) * 1e3
        rel = float(torch.linalg.norm(got - want) / torch.linalg.norm(want))
        log(f"  {what} on {ROOT_BUCKET}, {ROOT_ITERS} iterations: "
            f"{ms:.1f} ms, relative gap to its baseline {rel:.3e} (bound "
            f"{bound:g}; baseline {base_ms:.1f} ms); port kernels "
            f"{sum(counts.values())}")
        _expect_launches(counts, {}, what)
        if not rel < bound:
            fail(f"{what}: relative gap {rel:.3e} to its baseline, bound "
                 f"{bound:g}")
        del got, want
    del a
    torch.cuda.empty_cache()


def per_leaf_launches(opt):
    """K1/K3 launches a step of Shampoo's per-leaf loop, from its leaves:
    each full factor (L or R) of each matrix leaf is one coupled chain of
    the PRISM configuration — one K3 launch where its [n, n] slice pair
    fits the fused tier, else per warm iteration one K1 for Y X and
    ``degree`` for each side's Horner update."""
    from repro_torch.core import newton_schulz

    pc = opt.cfg.resolved_prism
    k1 = k3 = 0
    for st in opt.state.values():
        for side in ("L", "R"):
            if side in st:
                n = st[side].shape[-1]
                if newton_schulz._fused_tier(pc, (n, n), coupled=True):
                    k3 += 1
                else:
                    k1 += pc.iterations * (1 + 2 * pc.degree)
    return dict(matmul_add=k1, warm_tail=k3)


def per_leaf_check(torch, run):
    """One Shampoo step through the per-leaf loop and one through the
    bucketed engine from the same state: every inverse root (Linv, Rinv)
    within PER_LEAF_REL_TOL of its largest entry, the parameter change
    within UPDATE_REL_TOL; prints whether each is bitwise equal, the
    momentum's gap, and why they may not be: a factor's Frobenius norm
    computed alone and inside the bucket."""
    import dataclasses

    from repro_torch.core.newton_schulz import _safe_fro

    model = run["model"]
    out = {}
    for tag, bucketed in (("per-leaf", False), ("bucketed", True)):
        cfg = dataclasses.replace(run["opt"].cfg, bucketed=bucketed)
        o = _opt_from(torch, model, cfg, run["state"])
        _restore(torch, model, run)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o.step(key=run["key"])
        torch.cuda.synchronize()
        out[tag] = (o, (time.perf_counter() - t0) * 1e3,
                    {k: p.detach() - run["before"][k]
                     for k, p in model.named_parameters()})
    (o_l, ms_l, d_l), (o_b, ms_b, d_b) = out["per-leaf"], out["bucketed"]
    gaps = {"Linv/Rinv": [0.0, True], "mom": [0.0, True]}
    for p in model.parameters():
        for name, v in o_l.state[p].items():
            kind = "mom" if name == "mom" else (
                "Linv/Rinv" if name in ("Linv", "Rinv") else None)
            if kind is None:
                continue
            w = o_b.state[p][name].float()
            gap = float((v.float() - w).abs().max()
                        / w.abs().max().clamp(min=1e-30))
            gaps[kind][0] = max(gaps[kind][0], gap)
            gaps[kind][1] &= torch.equal(v, o_b.state[p][name])
    worst = _worst_gap(torch, d_l, d_b, "per-leaf vs bucketed")
    bitwise = all(torch.equal(d_l[k], d_b[k]) for k in d_l)
    factors = [st["L"] for st in o_l.state.values()
               if "L" in st and st["L"].shape[-1] > 64]
    alone = _safe_fro(factors[0])
    inside = _safe_fro(torch.cat(factors))[:factors[0].shape[0]]
    log(f"  per-leaf vs bucketed, one step from the same state: inverse "
        f"roots worst gap {gaps['Linv/Rinv'][0]:.3e} of their largest entry "
        f"(bound {PER_LEAF_REL_TOL:g}, bitwise {gaps['Linv/Rinv'][1]}); "
        f"momentum {gaps['mom'][0]:.3e} (bitwise {gaps['mom'][1]}); "
        f"parameter change {worst:.3e} (bound {UPDATE_REL_TOL}, bitwise "
        f"{bitwise}); optimizer step per-leaf {ms_l:.1f} ms, bucketed "
        f"{ms_b:.1f} ms")
    log(f"  the Frobenius norm of a {list(factors[0].shape)} factor alone "
        f"and inside the {len(factors) * factors[0].shape[0]}-slice bucket: "
        f"bitwise {torch.equal(alone, inside)}, gap "
        f"{float((alone - inside).abs().max()):.3e} of "
        f"{float(inside.abs().max()):.3e}")
    if not gaps["Linv/Rinv"][0] <= PER_LEAF_REL_TOL:
        fail(f"per-leaf Shampoo inverse roots differ from the bucketed ones "
             f"by {gaps['Linv/Rinv'][0]:.3e} of their largest entry")


def lowrank_tiers(torch, opt):
    """The tier of each Muon bucket of gpt2-paper with LOWRANK (gated on
    ``LOWRANK_TIERS``, and on each leaf's int32 "tier" state), and the
    routing the default aspect 4.0 would give, not run."""
    import dataclasses

    from repro_torch.optim import base, bucketing

    cfg = opt.cfg
    params = opt.param_groups[0]["params"]
    views = [tuple(base.to_matrix_view(torch.empty(p.shape, device="meta"),
                                       a)[0].shape)
             for p, a in zip(params, opt.axes) if opt._matrix(a, p.shape)]
    for c, gate in ((cfg, True), (dataclasses.replace(
            cfg, lowrank_aspect=4.0), False)):
        got = {}
        for b in bucketing.plan_buckets(views):
            tier = bucketing.resolve_tier(c, b.shape)
            got[b.shape] = tier
            log(f"  aspect {c.lowrank_aspect}: bucket {[b.size, *b.shape]} "
                f"-> {tier} (code {bucketing.TIER_CODES[tier]}, l "
                f"{bucketing.resolve_lowrank_tier(c, b.shape)})"
                + ("" if gate else " [not run]"))
        if gate and got != LOWRANK_TIERS:
            fail(f"lowrank tiers {got}, want {LOWRANK_TIERS}")
    codes = {int(opt.state[p]["tier"]) for p, a in zip(params, opt.axes)
             if opt._matrix(a, p.shape)}
    want = {bucketing.TIER_CODES[t] for t in LOWRANK_TIERS.values()}
    if codes != want:
        fail(f"the leaves' tier states {codes}, want {want}")


def phase9(torch, runs):
    """Shampoo's inverse fourth roots, DB-Newton and per-leaf loop, and
    Muon's lowrank tier, each PHASE9_STEPS full-width gpt2-paper steps
    (see the module docstring)."""
    log("  (a) Shampoo p_root=4 (PRISM coupled inverse Newton)")
    run = train_path(torch, "shampoo_p4", steps=PHASE9_STEPS)
    log(f"  step {run['step_ms']:.1f} ms against Shampoo PRISM-5 (p = 2, "
        f"phase 6) {runs['shampoo_prism5']['step_ms']:.1f} ms")
    profile_step(torch, run, "Shampoo p_root=4", whole_fit=True)
    _drop(torch, run)
    root_checks(torch)
    runs["shampoo_p4"] = run

    log("  (b) Shampoo matfn_method='newton' (DB-Newton, Cholesky)")
    run = train_path(torch, "shampoo_newton", steps=PHASE9_STEPS)
    log(f"  step {run['step_ms']:.1f} ms against Shampoo PRISM-5 (phase 6) "
        f"{runs['shampoo_prism5']['step_ms']:.1f} ms")
    profile_step(torch, run, "Shampoo DB-Newton")
    _drop(torch, run)
    runs["shampoo_newton"] = run

    log("  (c) Shampoo PRISM-5, bucketed=False (the per-leaf loop)")
    run = train_path(torch, "shampoo_per_leaf", steps=PHASE9_STEPS,
                     per_step=per_leaf_launches)
    per_leaf_check(torch, run)
    _drop(torch, run)
    runs["shampoo_per_leaf"] = run

    log("  (d) Muon PRISM-5 with the lowrank tier "
        + ", ".join(f"{k}={v}" for k, v in LOWRANK.items()))
    run = train_path(torch, "muon_lowrank", steps=PHASE9_STEPS)
    lowrank_tiers(torch, run["opt"])
    log(f"  step {run['step_ms']:.1f} ms against Muon PRISM-5 (phase 4) "
        f"{runs['prism5']['step_ms']:.1f} ms")
    profile_step(torch, run, "Muon lowrank", by_shape=True)
    _drop(torch, run)
    runs["muon_lowrank"] = run


# --------------------------------------------------------------- main

# --------------------------------------------------------------- phase 10

ASYNC_K = 5        # (a): Muon PRISM-5's refresh period, as phase 8's
ASYNC_STEPS = 7    # bootstrap at 0, the clock at 5; swaps at 0 and 6
SHAMPOO_ASYNC_K = 3
SHAMPOO_ASYNC_STEPS = 5  # bootstrap at 0, the clock at 3; swaps at 0, 4


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms inside the block: without them the
    embedding gradient's atomic adds make two runs of one step differ in
    their last bits, whatever the refresh plane does.  cuBLAS runs
    deterministically on one stream with ``main``'s workspace setting;
    the fill of uninitialized memory that the mode adds is left off."""
    import torch.utils.deterministic as det

    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


def async_run(torch, cfgs, work, steps, blocking=False, sync_log=None,
              seed=0, check=None, **tkw):
    """A Trainer run of ``steps`` steps with the async refresh plane in
    ``work``: the launches of each ``step_begin`` (the refresh) and of
    each step apart, the synchronizing calls of each step (with a
    ``sync_log``), the losses, step times, telemetry and the final state
    copied to the host.  ``blocking`` synchronizes the card after every
    ``step_begin``: the refresh then ends before the step starts;
    ``check(t, trainer)`` runs after each step."""
    from repro_torch.kernels import ops
    from repro_torch.optim import base

    tkw.setdefault("checkpoint_every", 0)
    tr = _trainer_for(cfgs, work, seed, steps=steps, **tkw)
    refresh, own, syncs = {}, {}, {}
    real = base.AsyncPrecondService.step_begin
    mark = [None]

    def step_begin(self, t, key, drift=0.0):
        before = ops.launch_counts()
        real(self, t, key, drift)
        if blocking:
            torch.cuda.synchronize()
        mark[0] = ops.launch_counts()
        refresh[t] = {k: mark[0][k] - before[k] for k in before}

    def on_metrics(t, m):
        now = ops.launch_counts()
        own[t] = {k: now[k] - mark[0][k] for k in now}
        if sync_log is not None:
            syncs[t] = sync_log.mark()
        if check is not None:
            check(t, tr)

    ops.reset_launches()
    base.AsyncPrecondService.step_begin = step_begin
    try:
        with contextlib.ExitStack() as stack:
            if sync_log is not None:
                stack.enter_context(sync_log)
            _, _, losses = tr.run(on_metrics=on_metrics)
    finally:
        base.AsyncPrecondService.step_begin = real
    start = min(refresh)
    return dict(tr=tr, refresh=refresh, own=own, syncs=syncs,
                losses=dict(zip(range(start, steps), losses)),
                total=ops.launch_counts(), telemetry=tr.matfn_telemetry,
                times=dict(zip(range(start + 1, steps), tr.step_times)))


def _expect_async(run, what, per_refresh, dispatch_steps, telemetry):
    """The gates every async run holds: ``per_refresh`` launches at each
    dispatch step's ``step_begin`` and none at any other, none in any step
    of its own, finite losses, and the service's counters."""
    for t, c in sorted(run["refresh"].items()):
        _expect_launches(c, per_refresh if t in dispatch_steps else {},
                         f"{what}: step_begin at step {t}")
    for t, c in sorted(run["own"].items()):
        _expect_launches(c, {}, f"{what}: step {t}'s own launches")
    if not all(math.isfinite(v) for v in run["losses"].values()):
        fail(f"{what}: non-finite losses {run['losses']}")
    tele = run["telemetry"]
    if any(tele[k] != v for k, v in telemetry.items()):
        fail(f"{what}: telemetry {tele}, want {telemetry}")


def _bitwise(torch, a, b, what):
    """Fail unless two host states (``_host_state``) are bitwise equal."""
    if set(a) != set(b):
        fail(f"{what}: states hold other leaves, e.g. "
             f"{sorted(set(a) ^ set(b))[:3]}")
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    if differ:
        fail(f"{what}: {len(differ)} of {len(a)} leaves differ, e.g. "
             f"{differ[:3]}")
    return len(a)


def async_profile(torch, tr, t):
    """A torch.profiler trace of one dispatch step of ``tr`` at step ``t``
    (``step_begin``, then ``batch_fn`` and the step, as ``Trainer.run``
    does): the streams the port's kernels and the step's kernels ran on,
    the refresh's device time on its stream and how much of it overlaps
    the step stream's kernels.  Logged only."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.rng import Key

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.precond.step_begin(t, Key(1).fold_in(t), drift=0.0)
        m = tr.step_fn(tr.batch_fn(t), t, False)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "stream" in e.get("args", {})]
    if tr.precond.last_dispatch != t:
        fail(f"profiled step {t} dispatched no refresh")
    if not kernels:
        log("  profiled dispatch step: the trace holds no kernel events; "
            "stream ids and overlap not measured")
        return
    ours = [e for e in kernels
            if any(f"{n}_kernel" in e["name"] for n in KERNEL_NAMES)]
    side = {e["args"]["stream"] for e in ours}
    main = {e["args"]["stream"] for e in kernels} - side
    on_side = [e for e in kernels if e["args"]["stream"] in side]
    on_main = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels
                     if e["args"]["stream"] in main)
    union = []
    for a, b in on_main:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    side_us = sum(e["dur"] for e in on_side)
    overlap_us = sum(max(0.0, min(e["ts"] + e["dur"], b) - max(e["ts"], a))
                     for e in on_side for a, b in union)
    main_us = sum(b - a for a, b in union)
    busy_us = main_us + side_us - overlap_us  # the card busy on either
    span = (min(e["ts"] for e in on_side),
            max(e["ts"] + e["dur"] for e in on_side))
    log(f"  profiled dispatch step {t}: wall {wall_ms:.1f} ms; the port's "
        f"{len(ours)} kernels on stream(s) {sorted(side)}, the step's "
        f"{sum(1 for e in kernels if e['args']['stream'] in main)} kernels "
        f"on stream(s) {sorted(main)}; the refresh stream's "
        f"{len(on_side)} kernels: device {side_us / 1e3:.2f} ms from "
        f"{(span[0] - union[0][0]) / 1e3 if union else 0.0:.2f} to "
        f"{(span[1] - union[0][0]) / 1e3 if union else 0.0:.2f} ms after "
        f"the step stream's first kernel, {overlap_us / 1e3:.2f} ms "
        f"({overlap_us / max(side_us, 1e-9):.3f}) of it while the step "
        f"stream ran a kernel; step stream busy {main_us / 1e3:.2f} ms; "
        f"the card busy {busy_us / 1e3:.2f} ms, idle share "
        f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f}")


def phase10(torch, phase8):
    """The §12 async refresh plane at full width (see the module
    docstring), in a temporary directory under build/, removed at the
    end; returns the launch counts of (a) and (b)'s async runs."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase10_", dir=base_dir))
    try:
        with deterministic(torch):
            return _phase10(torch, phase8, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase10(torch, phase8, work):
    import dataclasses

    import numpy as np

    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train_lm
    from repro_torch.optim import Muon, base

    muon = train_lm.configs("full", "prism", "float32", precond_every=ASYNC_K,
                            precond_async=True)  # swap delay 1, the default
    ln_v = math.log(muon[0].vocab_size)

    log(f"  (a) Muon PRISM-5 through the Trainer, precond_every {ASYNC_K}, "
        f"precond_async, swap delay 1, {ASYNC_STEPS} steps "
        f"(deterministic algorithms on in this phase)")
    a = async_run(torch, muon, work / "a", ASYNC_STEPS,
                  sync_log=SyncLog(torch))
    dispatch = {0, ASYNC_K}
    _expect_async(a, "(a) async Muon", PER_STEP["prism5"], dispatch,
                  dict(refreshes=2, bootstrap=1, clock_triggered=1,
                       discarded=0))
    if abs(a["losses"][0] - ln_v) > 1.5:
        fail(f"(a): first loss {a['losses'][0]:.4f} not within 1.5 of "
             f"ln(V) = {ln_v:.4f}")
    log("  (a) per step: " + "; ".join(
        f"{t} loss {a['losses'][t]:.4f} refresh launches "
        f"{sum(a['refresh'][t].values())} step launches "
        f"{sum(a['own'][t].values())} syncs {a['syncs'][t]}"
        + (f" {a['times'][t] * 1e3:.1f} ms" if t in a["times"] else "")
        for t in sorted(a["losses"])))
    steady = [t for t in range(1, ASYNC_STEPS) if t not in dispatch
              and t != ASYNC_K + 1]
    steady_ms = [a["times"][t] * 1e3 for t in steady]
    log(f"  (a) dispatch step {ASYNC_K} {a['times'][ASYNC_K] * 1e3:.1f} ms, "
        f"swap step {ASYNC_K + 1} {a['times'][ASYNC_K + 1] * 1e3:.1f} ms, "
        f"steady steps median {statistics.median(steady_ms):.1f} ms ("
        + ", ".join(f"{v:.1f}" for v in steady_ms) + "); phase 8's "
        f"synchronous refresh step "
        + ", ".join(f"{v:.1f}" for v in phase8["refresh_ms"])
        + f" ms, its skip steps median "
        f"{statistics.median(phase8['skip_ms']):.1f} ms")
    bound = max(phase8["skip_syncs"].values())
    worst = max(a["syncs"][t] for t in steady)
    swap_syncs = a["syncs"][ASYNC_K + 1]
    log(f"  (a) synchronizing calls: steady steps at most {worst}, dispatch "
        f"step {a['syncs'][ASYNC_K]}, swap step {swap_syncs}, bootstrap "
        f"step {a['syncs'][0]} (phase 8's skip steps at most {bound})")
    if worst > bound:
        fail(f"(a): a steady async step makes {worst} synchronizing calls, "
             f"phase 8's steady Trainer step {bound}")
    if swap_syncs > worst + 1:
        fail(f"(a): the swap step makes {swap_syncs} synchronizing calls, "
             f"more than a steady step's {worst} and the verdict's one")
    async_muon = a["total"]
    held = _host_state(torch, a["tr"])
    async_profile(torch, a["tr"], ASYNC_STEPS - 1 + ASYNC_K)
    del a
    torch.cuda.empty_cache()
    b = async_run(torch, muon, work / "a_blocking", ASYNC_STEPS,
                  blocking=True)
    n = _bitwise(torch, held, _host_state(torch, b["tr"]),
                 "(a) async vs blocking")
    log(f"  (a) the run with torch.cuda.synchronize() after each step_begin:"
        f" its {n} state leaves bitwise the async run's; its step times "
        + ", ".join(f"{t} {v * 1e3:.1f} ms" for t, v in b["times"].items()))
    del b, held
    torch.cuda.empty_cache()

    sham = train_lm.configs("full", "prism", "float32", prism="fig5",
                            optimizer="shampoo",
                            precond_every=SHAMPOO_ASYNC_K,
                            precond_async=True)
    log(f"  (b) fitted Shampoo (Fig. 5 PRISM) through the Trainer, "
        f"precond_every {SHAMPOO_ASYNC_K}, precond_async, "
        f"{SHAMPOO_ASYNC_STEPS} steps")
    runs = []
    for blocking in (False, True):
        r = async_run(torch, sham, work / f"b{int(blocking)}",
                      SHAMPOO_ASYNC_STEPS, blocking=blocking)
        _expect_async(r, f"(b) {'blocking' if blocking else 'async'} "
                      f"Shampoo", PER_STEP["shampoo_fig5"],
                      {0, SHAMPOO_ASYNC_K},
                      dict(refreshes=2, bootstrap=1, clock_triggered=1,
                           discarded=0))
        runs.append((r["total"], r["losses"], _host_state(torch, r["tr"]),
                     r["times"]))
        del r
        torch.cuda.empty_cache()
    n = _bitwise(torch, runs[0][2], runs[1][2], "(b) async vs blocking")
    log(f"  (b) losses " + ", ".join(f"{v:.4f}" for v in
                                     runs[0][1].values())
        + "; step times " + ", ".join(f"{t} {v * 1e3:.1f} ms" for t, v in
                                      runs[0][3].items())
        + f"; {n} state leaves bitwise the blocking run's")
    async_shampoo = runs[0][0]
    del runs
    torch.cuda.empty_cache()

    log("  (c) a poisoned refresh: the bootstrap's pending polars get a NaN "
        "before the verdict")
    real = Muon.pending_twins
    calls = [0]

    def poisoned(self, key):
        parts = real(self, key)
        calls[0] += 1
        if calls[0] == 1:
            twin = next(p for p in parts if p)["ortho_p"]
            twin[(0,) * twin.dim()] = math.nan
        return parts

    def active_finite(tr):
        return bool(torch.stack([
            torch.isfinite(v).all() for st in tr.opt.state.values()
            for k, v in st.items()
            if k not in base.PENDING_STATE_KEYS]).all())

    def after_bootstrap(t, tr):
        if t != 0:
            return
        tele = tr.matfn_telemetry
        log(f"  (c) after step 0: telemetry {tele}, pending_at "
            f"{tr.opt.pending_at}")
        if tele["discarded"] != 1 or tr.opt.pending_at != base.NO_PENDING \
                or not active_finite(tr):
            fail(f"(c): the poisoned bootstrap was not discarded cleanly: "
                 f"telemetry {tele}, pending_at {tr.opt.pending_at}, "
                 f"active buffers finite {active_finite(tr)}")

    Muon.pending_twins = poisoned
    try:
        c = async_run(torch, muon, work / "c", 4, check=after_bootstrap)
    finally:
        Muon.pending_twins = real
    tele = c["telemetry"]
    dispatched = sorted(t for t, v in c["refresh"].items() if any(v.values()))
    log(f"  (c) telemetry {tele}; refreshes dispatched at steps {dispatched}"
        f" (the backoff step 1 falls inside the bootstrap's swap window, so "
        f"the retry goes at 2); losses "
        + ", ".join(f"{v:.4f}" for v in c["losses"].values()))
    _expect_async(c, "(c) poisoned", PER_STEP["prism5"], {0, 2},
                  dict(refreshes=2, bootstrap=1, retries=1, discarded=1,
                       degraded=0))
    if not active_finite(c["tr"]) or \
            c["tr"].opt.pending_at != base.NO_PENDING:
        fail(f"(c): after the retry swapped: pending_at "
             f"{c['tr'].opt.pending_at}, active buffers finite "
             f"{active_finite(c['tr'])}")
    del c
    torch.cuda.empty_cache()

    log("  (d) a checkpoint while a refresh is in flight (precond_every 2: "
        "dispatched at step 2, saved after it, swap due at 3), restored by a "
        "fresh Trainer")
    mid = (muon[0], dataclasses.replace(muon[1], precond_every=2), muon[2])
    d_dir = work / "d"
    d = async_run(torch, mid, d_dir, 3, checkpoint_every=3,
                  keep_checkpoints=1, async_checkpoint=False)
    with np.load(d_dir / "step_00000003" / "tree.npz") as data:
        files = data.files
        pending_at = int(data["opt|pending_at"]) \
            if "opt|pending_at" in files else None
    dropped = [k for k in files
               if base.PENDING_STATE_KEYS.intersection(k.split("|"))]
    if pending_at != 2 or dropped:
        fail(f"(d): the checkpoint holds pending_at {pending_at} (want 2) "
             f"and pending keys {dropped[:3]}")
    del d
    torch.cuda.empty_cache()
    r = async_run(torch, mid, d_dir, 5, seed=1)
    _expect_async(r, "(d) restored", PER_STEP["prism5"], {3},
                  dict(refreshes=1, bootstrap=1, discarded=0))
    if sorted(r["losses"]) != [3, 4]:
        fail(f"(d): the restored run ran steps {sorted(r['losses'])}")
    log(f"  (d) checkpoint: pending_at 2, no pending key among "
        f"{len(files)} leaves; the restored run bootstraps at step 3 "
        f"({sum(r['refresh'][3].values())} refresh launches), steps 3, 4 "
        f"launch 0, losses " + ", ".join(f"{v:.4f}" for v in
                                         r["losses"].values()))
    del r
    torch.cuda.empty_cache()
    return dict(async_muon=async_muon, async_shampoo=async_shampoo)


# ------------------------------------------------------- phase 11: serving

# (a) batch mode, as launch/serve.py runs it: the prompt crosses two KV
# blocks of 1024; the cache holds prompt + gen
SERVE_ARGS = dict(batch=4, prompt_len=1536, gen_len=32, cache_len=1568,
                  seed=0)
PARITY_LENGTHS = (96, 61, 17)   # prefill against a streamed decode loop
PARITY_TOL = 5e-2               # tests/test_serving.py:277
MOE_PARITY_TOL = 2e-2           # tests/test_models_smoke.py:134, fp32
# (b) the Engine with the reference launcher's trace palettes; its 64
# requests cut to 20, still more than the 16 slots hold (each run of the
# trace is host-bound, ~25-40 ms a tick), so that the script with phase
# 15 stays well inside its time limit
ENGINE_CFG = dict(slots=16, cache_len=64, eos_id=0)
ENGINE_TRACE = dict(n_requests=20, qps=20.0)
# the virtual clock's tick: the card's wall time of a full-table decode
# tick (35.1-40.9 ms, phases 11 and 12 on the H100), so that the trace
# arrives at the rate the card serves it, not over many ticks with few
# lanes active
STEP_DT = 0.035
WALL_QPS = (20.0, 1e6)          # offered loads of the wall-clock runs
PROFILE_TICKS = 8
# (c) a slot-table sequence may leave its batch-1 loop only at a token
# whose top-2 logit gap is under this share of the largest |logit|
INVARIANCE_REQUESTS = 8
INVARIANCE_GAP = 1e-2
SAMPLED = dict(greedy=False, temperature=0.8, top_k=50)


def phase11(torch):
    """Serving at full width (see the module docstring), the handoff's
    checkpoints in a temporary directory under build/, removed at the
    end."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase11_", dir=base_dir))
    try:
        _phase11(torch, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase11(torch, work):
    from repro_torch.kernels import ops
    from repro_torch.serving import make_trace

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = serve_handoff(torch, work)
    with torch.inference_mode():
        params = model.cast_params()
    ops.reset_launches()
    batch_mode(torch, model, params)
    trace = make_trace(0, vocab_size=model.cfg.vocab_size, **ENGINE_TRACE)
    greedy = engine_checks(torch, model, params, trace)
    batching_invariance(torch, model, params, greedy, trace)
    sampling_checks(torch, model, params, greedy, trace)
    counts = ops.launch_counts()
    if sum(counts.values()):
        fail(f"serving launched PRISM kernels: {counts}")
    log(f"  serving launched 0 PRISM kernels; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB for the "
        f"phase")


def serve_handoff(torch, work):
    """Two Trainer steps of Muon PRISM-5 with a checkpoint every step; a
    fresh Model (another seed) through ``restore_params`` must hold the
    Trainer's parameters bitwise, and with a byte of the newest payload
    flipped ``restore_params`` must fall back to step 1.  Returns the
    restored model."""
    from repro_torch.checkpoint import restore_params
    from repro_torch.launch import train_lm
    from repro_torch.models import Model

    cfgs = train_lm.configs("full", "prism", "float32")
    tr = _trainer_for(cfgs, work, 0, steps=2, checkpoint_every=1,
                      async_checkpoint=False)
    t0 = time.perf_counter()
    _, _, losses = tr.run()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    if len(losses) != 2 or not all(math.isfinite(v) for v in losses):
        fail(f"handoff: the Trainer's losses {losses}")
    served = Model(cfgs[0], device=DEVICE, seed=1)
    t0 = time.perf_counter()
    step, restored = restore_params(str(work),
                                    dict(served.named_parameters()))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != 2:
        fail(f"handoff: restore_params took step {step}, not 2")
    served.load_params(restored)
    own = dict(tr.model.named_parameters())
    for name, p in served.named_parameters():
        if not torch.equal(p, own[name]):
            fail(f"handoff: {name} is not bitwise the Trainer's")
    n = len(own)
    del tr, own, restored
    torch.cuda.empty_cache()
    npz = work / "step_00000002" / "tree.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    step, _ = restore_params(str(work), dict(served.named_parameters()))
    if step != 1:
        fail(f"handoff: with step 2 corrupt restore_params took step "
             f"{step}, not 1")
    torch.cuda.empty_cache()
    log(f"  handoff: 2 Trainer steps (Muon PRISM-5, losses "
        + ", ".join(f"{v:.4f}" for v in losses) + f") with checkpoints in "
        f"{train_s:.1f} s; restore_params of step 2 ({len(raw)} bytes) "
        f"in {restore_s:.2f} s, {n} parameters bitwise the Trainer's; "
        f"a byte flipped in step 2 falls back to step 1")
    return served


@contextlib.contextmanager
def dropfree(model, fp32=False):
    """``model`` with drop-free MoE capacity (capacity_factor = E) inside
    the block, as the reference's tests hold prefill against decode
    (tests/test_models_smoke.py:110-121): with capacity dropping, a
    prefill's tokens compete for other slots than a decode step's.  A
    no-op for the other families.  ``fp32``: the compute and cache dtype
    float32 too (the caller passes the fp32 masters as params)."""
    import dataclasses

    cfg = model.cfg
    changes = dict(dtype="float32", emb_dtype="float32") if fp32 else {}
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts))
    model.cfg = cfg.replace(**changes)
    try:
        yield model
    finally:
        model.cfg = cfg


def batch_mode(torch, model, params):
    """(a): ``launch/serve.py``'s batch loop at ``SERVE_ARGS`` (tokens in
    the vocab, every logit finite), then a prefill of ragged lanes against
    a streamed, active-masked decode loop over the same prompts (drop-free
    for moe): kpos bitwise, the last real position's logits within
    PARITY_TOL.  Returns the batch loop's results."""
    from types import SimpleNamespace

    from repro_torch.launch import serve

    V = model.cfg.vocab_size
    a = SimpleNamespace(**SERVE_ARGS)
    res = serve.batch_loop(model, params, a, torch.device(DEVICE))
    toks = res["tokens"]
    if toks.shape != (a.batch, a.gen_len + 1) or toks.min() < 0 \
            or toks.max() >= V:
        fail(f"(a): tokens of shape {toks.shape} in [{toks.min()}, "
             f"{toks.max()}]")
    if not res["finite"]:
        fail("(a): a logit is not finite")
    log(f"  (a) batch {a.batch}, prompt {a.prompt_len} (2 KV blocks), gen "
        f"{a.gen_len}, cache_len {a.cache_len}: prefill "
        f"{res['prefill_s'] * 1e3:.2f} ms ({res['prefill_tok_s']:.0f} "
        f"prompt tok/s; first call {res['first_prefill_s'] * 1e3:.1f} ms), "
        f"decode {res['decode_ms_step']:.3f} ms a step "
        f"({res['decode_tok_s']:.1f} tok/s), KV cache "
        f"{res['cache_bytes']} bytes; tokens in the vocab, logits finite")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(a.seed)
    prompts = torch.randint(0, V, (a.batch, a.prompt_len), generator=gen,
                            device=DEVICE, dtype=torch.int32)
    lg, cache = model.prefill_cache({"tokens": prompts}, a.cache_len,
                                    params=params)
    tok = torch.argmax(lg, dim=-1).to(torch.int32)
    pos = torch.full((a.batch, 1), a.prompt_len, dtype=torch.int32,
                     device=DEVICE)
    profile_ticks(torch, lambda: model.decode_step(cache, tok, pos,
                                                   params=params),
                  f"(a) a decode step (batch {a.batch}, cache "
                  f"{a.cache_len})")
    del cache

    prefill_parity(torch, model, params, "(a)")
    return res


def prefill_parity(torch, model, params, what):
    """``prefill_cache`` of ragged lanes (PARITY_LENGTHS) against a
    streamed, active-masked decode loop over the same prompts, drop-free
    for moe: kpos bitwise, the last real position's logits within
    PARITY_TOL + PARITY_TOL |x| in the compute dtype.  A moe model is
    gated in fp32 (MOE_PARITY_TOL, as the reference's moe decode test runs
    in fp32): in bf16 a rounding difference between the prefill's and a
    decode step's products can flip a near-tie at the top-k boundary and
    route a token to another expert; its bf16 gap is printed."""
    if model.cfg.moe is None:
        _parity(torch, model, params, what, PARITY_TOL, gate=True)
        return
    masters = {k: p.detach() for k, p in model.named_parameters()}
    _parity(torch, model, masters, f"{what} fp32", MOE_PARITY_TOL,
            gate=True, fp32=True)
    _parity(torch, model, params, f"{what} {model.cfg.dtype}", PARITY_TOL,
            gate=False)


def _parity(torch, model, params, what, tol, gate, fp32=False):
    cfg = model.cfg
    V = cfg.vocab_size
    B, S = len(PARITY_LENGTHS), max(PARITY_LENGTHS)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(11)
    shape = (B, cfg.num_codebooks, S) if cfg.family == "audio" else (B, S)
    prompts = torch.randint(0, V, shape, generator=gen, device=DEVICE,
                            dtype=torch.int32)
    lengths = torch.tensor(PARITY_LENGTHS, dtype=torch.int32, device=DEVICE)
    with dropfree(model, fp32):
        lp, cp = model.prefill_cache({"tokens": prompts}, S, lengths,
                                     params=params)
        cache = model.init_cache(B, S)
        last = torch.zeros_like(lp)
        lane = (B,) + (1,) * (lp.ndim - 1)
        for t in range(S):
            lg, cache = model.decode_step(
                cache, prompts[..., t:t + 1],
                torch.full((B, 1), t, dtype=torch.int32, device=DEVICE),
                active=t < lengths, params=params)
            last = torch.where((t == lengths - 1).reshape(lane), lg, last)
    if not torch.equal(cp["kpos"], cache["kpos"]):
        fail(f"{what}: prefill_cache's kpos differs from the streamed "
             f"loop's")
    err = (lp - last)[..., :V].abs()
    excess = (err - tol * (1 + last[..., :V].abs())).max().item()
    kv_err = max((cp[n] - cache[n]).float().abs().max().item()
                 for n in ("k", "v"))
    log(f"  {what} prefill_cache of lengths {list(PARITY_LENGTHS)} against "
        f"{S} streamed decode steps"
        + (" (drop-free capacity)" if cfg.moe else "")
        + f": kpos bitwise, logits max |diff| {err.max().item():.3e} "
        f"(tolerance {tol} + {tol}|x|{'' if gate else ', printed'}), k/v "
        f"max |diff| {kv_err:.3e}")
    if excess > 0 and gate:
        fail(f"{what}: prefill logits leave the streamed loop's by "
             f"{excess:.3e} beyond the tolerance")


def _engine(model, params, **kw):
    from repro_torch.serving import Engine, EngineConfig

    return Engine(model, params, EngineConfig(**dict(ENGINE_CFG, **kw)))


def _tokens_of(res):
    return {c.rid: c.tokens for c in res.completions}


def engine_checks(torch, model, params, trace):
    """(b): the Engine on the virtual clock (the shape contract, every
    request done, frozen lanes, replay, continuous against static), then
    on the wall clock at each of WALL_QPS, and a profile of full-table
    ticks; returns the greedy continuous run.  A moe model's lanes share
    each expert's capacity (global dispatch), so continuous and static
    admission may generate other tokens: their counts are printed, not
    held equal."""
    from repro_torch.serving import make_trace

    V = model.cfg.vocab_size
    eng = _engine(model, params)
    t0 = time.perf_counter()
    cont = eng.run(trace, step_dt=STEP_DT)
    run_s = time.perf_counter() - t0
    if cont.decode_step_shapes != 1:
        fail(f"(b): {cont.decode_step_shapes} decode shapes, not 1")
    if sorted(c.rid for c in cont.completions) != [r.rid for r in trace]:
        fail("(b): not every request completed")
    if not all(0 <= t < V for c in cont.completions for t in c.tokens):
        fail("(b): a token outside the vocab")
    frozen_lanes(torch, model, params, eng)
    if _engine(model, params).run(trace, step_dt=STEP_DT) != cont:
        fail("(b): two runs of the trace differ")
    stat = _engine(model, params, admission="static").run(trace,
                                                          step_dt=STEP_DT)
    if not cont.n_decode_steps < stat.n_decode_steps:
        fail(f"(b): continuous took {cont.n_decode_steps} decode steps, "
             f"static {stat.n_decode_steps}")
    if cont.generated_tokens != stat.generated_tokens and \
            model.cfg.moe is None:
        fail(f"(b): continuous generated {cont.generated_tokens} tokens, "
             f"static {stat.generated_tokens}")
    same = sum(a == b for a, b in zip(_tokens_of(cont).values(),
                                      _tokens_of(stat).values()))
    log(f"  (b) virtual clock, {len(trace)} requests, slots "
        f"{ENGINE_CFG['slots']}, cache_len {ENGINE_CFG['cache_len']}: 1 "
        f"decode shape, all done, {cont.generated_tokens} tokens; "
        f"continuous {cont.n_decode_steps} decode steps and "
        f"{cont.n_prefill_launches} prefill calls against static "
        f"{stat.n_decode_steps} and {stat.n_prefill_launches} "
        f"({same} of {len(trace)} sequences equal, {stat.generated_tokens} "
        f"tokens); two runs equal; "
        f"{run_s:.2f} s of wall time a run")
    for qps in WALL_QPS:
        wall = make_trace(0, vocab_size=V, n_requests=len(trace), qps=qps)
        eng = _engine(model, params)
        ticks = []
        step = eng.step

        def timed(step=step, ticks=ticks):
            t0 = time.perf_counter()
            out = step()
            ticks.append(time.perf_counter() - t0)
            return out
        eng.step = timed
        res = eng.run(wall)
        if len(res.completions) != len(wall) or res.decode_step_shapes != 1:
            fail(f"(b) qps {qps}: {len(res.completions)} done, "
                 f"{res.decode_step_shapes} decode shapes")
        lat = res.latency_percentiles()
        log(f"  (b) wall clock, qps {qps:g}: {res.tokens_per_s:.1f} tok/s "
            f"({res.generated_tokens} tokens in {res.elapsed:.3f} s), "
            f"latency p50 {lat['p50'] * 1e3:.1f} ms p99 "
            f"{lat['p99'] * 1e3:.1f} ms, decode "
            f"{statistics.median(ticks) * 1e3:.3f} ms a tick (median of "
            f"{len(ticks)}; min {min(ticks) * 1e3:.3f}), "
            f"{res.n_prefill_launches} prefill calls")
    tick_profile(torch, model, params, trace)
    return cont


def frozen_lanes(torch, model, params, eng):
    """One decode tick over the Engine's cache with every other lane
    inactive: those lanes' k, v and kpos rows bitwise as they were, the
    active lanes' changed."""
    S = ENGINE_CFG["slots"]
    cache = eng.cache
    before = {k: v.clone() for k, v in cache.items()}
    active = torch.arange(S, device=DEVICE) % 2 == 0
    tokens = (torch.arange(S, dtype=torch.int32, device=DEVICE)
              + 100).reshape(S, 1)
    pos = torch.full((S, 1), 50, dtype=torch.int32, device=DEVICE)
    model.decode_step(cache, tokens, pos, active=active, params=params)
    for name, ax in (("k", 1), ("v", 1), ("kpos", 0)):
        old, new = before[name], cache[name]
        idle = all(torch.equal(old.select(ax, s), new.select(ax, s))
                   for s in range(1, S, 2))
        wrote = all(not torch.equal(old.select(ax, s), new.select(ax, s))
                    for s in range(0, S, 2))
        if not (idle and wrote):
            fail(f"(b): {name}: inactive lanes kept {idle}, active lanes "
                 f"wrote {wrote}")
    log(f"  (b) a tick with lanes 1, 3, .., {S - 1} inactive: their k, v "
        f"and kpos rows bitwise unchanged, the active lanes' written")


def profile_ticks(torch, tick, what):
    """``tick()`` PROFILE_TICKS times on the host clock to a synchronize,
    then PROFILE_TICKS times in a profiler trace: the wall ms a tick
    against its device busy ms and device activities, and the host ops
    with the most self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_TICKS):
        tick()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_TICKS
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_TICKS):
            tick()
        torch.cuda.synchronize()
    busy_us, kernels, host = 0.0, 0, []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            busy_us += e.self_device_time_total
            kernels += e.count
        elif e.device_type == DeviceType.CPU:
            host.append((e.self_cpu_time_total, e.count, e.key))
    busy_ms = busy_us / 1e3 / PROFILE_TICKS
    top = sorted(host, reverse=True)[:6]
    log(f"  {what}: wall {wall_ms:.3f} ms a tick (host clock, "
        f"{PROFILE_TICKS} ticks), device busy {busy_ms:.3f} ms in "
        f"{kernels / PROFILE_TICKS:.0f} device activities a tick "
        f"(profiled); idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}; "
        f"most host self time a tick: "
        + ", ".join(f"{k} {us / 1e3 / PROFILE_TICKS:.2f} ms "
                    f"({n // PROFILE_TICKS} calls)" for us, n, k in top))


def tick_profile(torch, model, params, trace):
    """A full table's Engine ticks (16 requests admitted, no sweep)
    through ``profile_ticks``."""
    S = ENGINE_CFG["slots"]
    eng = _engine(model, params)
    eng.admit(trace[:S], list(range(S)), 0.0)
    profile_ticks(torch, eng.step, f"(b) a full-table Engine tick ({S} "
                  f"lanes, the token read included)")


def batching_invariance(torch, model, params, greedy, trace):
    """(c): each of INVARIANCE_REQUESTS requests through a batch-1 loop
    (prefill at its pow2 length, then decode) against its tokens from the
    slot table; where they part, the batch-1 loop's top-2 logit gap there
    must be under INVARIANCE_GAP of its largest |logit|.  A moe model's
    global dispatch couples the lanes by design (``models/moe.py``): its
    count of equal sequences and its divergences are printed, not
    gated."""
    import numpy as np

    from repro_torch.serving import pow2_pad

    V = model.cfg.vocab_size
    eos = ENGINE_CFG["eos_id"]
    got = _tokens_of(greedy)
    equal, parts = 0, []
    for r in trace[:INVARIANCE_REQUESTS]:
        P = pow2_pad(r.prompt_len)
        toks = torch.from_numpy(np.pad(r.prompt, (0, P - r.prompt_len))
                                .reshape(1, P)).to(DEVICE)
        lg, cache = model.prefill_cache(
            {"tokens": toks}, ENGINE_CFG["cache_len"],
            torch.tensor([r.prompt_len], dtype=torch.int32, device=DEVICE),
            params=params)
        out, logits = [], []
        while True:
            logits.append(lg[0, 0, :V])
            out.append(int(torch.argmax(lg[0, 0])))
            if len(out) >= r.max_new or out[-1] == eos:
                break
            lg, cache = model.decode_step(
                cache, torch.tensor([[out[-1]]], dtype=torch.int32,
                                    device=DEVICE),
                torch.tensor([[r.prompt_len + len(out) - 1]],
                             dtype=torch.int32, device=DEVICE),
                active=torch.ones(1, dtype=torch.bool, device=DEVICE),
                params=params)
        mine = got[r.rid]
        j = next((i for i, (a, b) in enumerate(zip(out, mine)) if a != b),
                 None)
        if j is None and len(out) == len(mine):
            equal += 1
            continue
        j = min(len(out), len(mine)) - 1 if j is None else j
        top = torch.topk(logits[j], 2).values
        share = ((top[0] - top[1]) / logits[j].abs().max()).item()
        parts.append(f"rid {r.rid} at token {j}: gap {share:.3e}")
        if share >= INVARIANCE_GAP and model.cfg.moe is None:
            fail(f"(c): rid {r.rid} leaves its batch-1 loop at token {j}, "
                 f"where the top-2 gap is {share:.3e} of the largest "
                 f"|logit| (bound {INVARIANCE_GAP})")
    log(f"  (c) batching invariance: {equal} of {INVARIANCE_REQUESTS} "
        f"sequences bitwise their batch-1 loop's"
        + (f"; divergences: {'; '.join(parts)}" if parts else ""))


def sampling_checks(torch, model, params, greedy, trace):
    """(d): ``top_k=1`` at temperature 0.7 gives the greedy tokens; a
    sampled run (SAMPLED) replays bitwise."""
    top1 = _engine(model, params, greedy=False, temperature=0.7,
                   top_k=1).run(trace, step_dt=STEP_DT)
    if _tokens_of(top1) != _tokens_of(greedy):
        fail("(d): top_k=1 sampling differs from greedy decoding")
    t0 = time.perf_counter()
    first = _engine(model, params, **SAMPLED).run(trace, step_dt=STEP_DT)
    run_s = time.perf_counter() - t0
    if _engine(model, params, **SAMPLED).run(trace, step_dt=STEP_DT) \
            != first:
        fail("(d): two sampled runs differ")
    moved = sum(a != b for a, b in zip(_tokens_of(first).values(),
                                       _tokens_of(greedy).values()))
    log(f"  (d) top_k=1 at temperature 0.7 gives the greedy tokens; "
        f"sampled (temperature {SAMPLED['temperature']}, top_k "
        f"{SAMPLED['top_k']}) replays bitwise, {moved} of {len(trace)} "
        f"sequences differ from greedy, {first.generated_tokens} tokens, "
        f"{run_s:.2f} s of wall time a run")


# ---------------------------------------------- phase 12: the moe family

GRANITE = "granite-moe-1b-a400m"
# every published width, depth cut from 24 layers so that the script stays
# well inside its time limit (its checkpoint, restore and serving scale
# with the depth)
GRANITE_LAYERS = 6
GRANITE_PARAMS = 421_770_240
# launch/train.py at its defaults (the published config, seq 512, batch 8,
# Muon PRISM-5, matfn fp32) over the config cut to GRANITE_LAYERS; the
# step count is cut too (phase 12 (a) also cuts the sequence: GRANITE_SEQ)
GRANITE_ARGV = ["--arch", GRANITE, "--steps", str(STEPS)]
GRANITE_SEQ = 256   # phase 12 (a)'s sequence, cut from 512 (CHANGES.md)
# Muon's matrix views by shape: the experts' w_gate/w_up/w_down and
# wk/wv (98 a layer), wq/wo (2), the routers (1)
GRANITE_VIEWS = {(1024, 512): 98 * GRANITE_LAYERS,
                 (1024, 1024): 2 * GRANITE_LAYERS, (1024, 32): GRANITE_LAYERS}
# no bucket fits the fused tier (the routers' [1024, 32] views neither):
# each runs three warm iterations of one K2 (R = I - X^T X) and two K1
# (Horner on R)
GRANITE_PER_STEP = dict(matmul_add=6 * len(GRANITE_VIEWS),
                        gram_upper=3 * len(GRANITE_VIEWS))


def bucket_shapes(views, labels):
    """K1/K2 at Muon's buckets of ``views`` ({(m, n): count}), as the polar
    runs them (a wide view transposed to [B, max, min]: the Gram side is
    the short one): R = I - X^T X, and each Horner step X P(R) + c X;
    ``labels`` names each view shape."""
    out = []
    for (m, n), B in views.items():
        hi, lo = max(m, n), min(m, n)
        out += [("gram_upper", (B, hi, lo), None, False,
                 f"{labels[m, n]}: R"),
                ("matmul_add", (B, hi, lo), (B, lo, lo), True,
                 f"{labels[m, n]}: Horner")]
    return out


GRANITE_SHAPES = bucket_shapes(GRANITE_VIEWS, {
    (1024, 512): "experts, wk/wv", (1024, 1024): "wq/wo",
    (1024, 32): "routers"})
# a balanced router's Switch loss: E * sum_e f_e P_e = K with P_e = 1/E,
# times the coefficient, summed over the layers (6 x 0.01 x 8 = 0.48); a
# random router at step 0 sits near it, a wrong factor (E, K, the layer
# sum, the coefficient) falls outside this band around it
AUX_BAND = (0.5, 2.0)
# 2 (k, v) x GRANITE_LAYERS x batch 4 x 1568 slots x 8 kv heads x 64 x 2
# bytes, plus kpos [4, 1568] int32
GRANITE_KV_BYTES = 2 * GRANITE_LAYERS * 4 * 1568 * 8 * 64 * 2 + 4 * 1568 * 4
# (c): the other new families at their published widths, depth cut
FAMILY_LAYERS = 2
FAMILY_BATCH, FAMILY_SEQ = 2, 512


def phase12(torch):
    """(a) granite-moe-1b-a400m trained through launch/train.py and (b)
    served from the Trainer's checkpoint (a temporary directory under
    build/, removed at the end); (c) the other new families.  Returns the
    training run's launch counts."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase12_", dir=base_dir))
    try:
        counts, trained = granite_training(torch, work)
        granite_serving(torch, work, trained)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    family_runs(torch)
    return counts


def cut_trainer(args, layers):
    """launch/train.py's Trainer of ``args`` (as its ``build`` makes it)
    over the config cut to ``layers`` layers, on the card."""
    from repro_torch.launch import train as train_launch
    from repro_torch.models import Model
    from repro_torch.train import Trainer

    cfg, ocfg, tcfg, dcfg = train_launch.configs(args)
    return Trainer(Model(cfg.replace(num_layers=layers), device=DEVICE,
                         seed=args.seed), ocfg, tcfg, dcfg)


def _granite_views(opt):
    """Muon's matrix views of ``opt``'s parameters, counted by shape."""
    from repro_torch.optim import base

    views = {}
    for p, axes in zip(opt.param_groups[0]["params"], opt.axes):
        if base.is_matrix_param(axes, tuple(p.shape)):
            m, n = base.matrix_view_dims(axes, tuple(p.shape))
            views[(m, n)] = views.get((m, n), 0) + p.numel() // (m * n)
    return views


def granite_training(torch, work):
    """(a): STEPS Trainer steps through launch/train.py's ``build`` with a
    checkpoint at the last; the gates of the module docstring.  Returns
    (launch counts of the run, the trained parameters on the host)."""
    from repro_torch.configs import get_config
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    args = train_launch.parser().parse_args(
        GRANITE_ARGV + ["--seq", str(GRANITE_SEQ), "--ckpt_dir", str(work),
                        "--ckpt_every", str(STEPS)])
    tr = cut_trainer(args, GRANITE_LAYERS)
    model, cfg, pc = tr.model, tr.model.cfg, tr.ocfg.prism
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != GRANITE_PARAMS:
        fail(f"(a): {n_params} parameters, not {GRANITE_PARAMS}")
    views = _granite_views(tr.opt)
    if views != GRANITE_VIEWS:
        fail(f"(a): Muon's views {views}, want {GRANITE_VIEWS}")
    log(f"  (a) {cfg.name}: {n_params} params ({cfg.num_layers} of "
        f"{get_config(GRANITE).num_layers} layers, depth cut, "
        f"d {cfg.d_model}, {cfg.moe.num_experts} experts top-"
        f"{cfg.moe.num_experts_per_tok}, d_ff {cfg.d_ff}, capacity "
        f"{cfg.moe.capacity_factor}, {cfg.moe.dispatch} dispatch), seq "
        f"{args.seq}, batch {args.batch}, {cfg.dtype} compute, fp32 "
        f"masters; Muon PRISM-5 (degree {pc.degree}, {pc.warm_alpha_iters} "
        f"warm of {pc.iterations} iterations, sketch {pc.sketch_dim}), "
        f"use_kernels={pc.use_kernels}, matfn_dtype {tr.ocfg.matfn_dtype}; "
        f"Muon views " + ", ".join(f"{n} x {list(s)}" for s, n in
                                   sorted(views.items())))
    per_step, mets = {}, {}
    unaligned = unaligned_launches()
    ops.reset_launches()
    last = [ops.launch_counts()]

    def on_metrics(t, m):
        now = ops.launch_counts()
        per_step[t] = {k: now[k] - last[0][k] for k in now}
        last[0] = now
        mets[t] = {k: float(torch.as_tensor(m[k]).detach())
                   for k in ("loss", "ce", "aux", "grad_norm")}

    t0 = time.perf_counter()
    _, _, losses = tr.run(on_metrics=on_metrics)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if unaligned_launches() != unaligned:
        fail("(a): K1/K2 launched their unaligned instantiation")
    for t in sorted(per_step):
        m = mets[t]
        log(f"  (a) step {t}: loss {m['loss']:.4f} (ce {m['ce']:.4f}, aux "
            f"{m['aux']:.5f}), grad_norm {m['grad_norm']:.4f}, launches "
            + ", ".join(f"{k} {v}" for k, v in per_step[t].items() if v))
        _expect_launches(per_step[t], GRANITE_PER_STEP, f"(a) step {t}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"(a): non-finite loss {losses}")
    ln_v = math.log(cfg.vocab_size)
    want_aux = cfg.num_layers * cfg.moe.router_aux_loss_coef \
        * cfg.moe.num_experts_per_tok
    if abs(mets[0]["ce"] - ln_v) > 1.5:
        fail(f"(a): step-0 CE {mets[0]['ce']:.4f} not within 1.5 of ln(V) "
             f"{ln_v:.4f}")
    lo, hi = (f * want_aux for f in AUX_BAND)
    if not lo <= mets[0]["aux"] <= hi:
        fail(f"(a): step-0 aux {mets[0]['aux']:.5f} outside [{lo:.3f}, "
             f"{hi:.3f}] around a balanced router's {want_aux:.3f}")
    step_ms = statistics.median(tr.step_times) * 1e3
    tokens = args.seq * args.batch
    data = []
    for t in range(1, STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.batch_fn(t)
        torch.cuda.synchronize()
        data.append((time.perf_counter() - t0) * 1e3)
    npz = work / f"step_{STEPS:08d}" / "tree.npz"
    log(f"  (a) {STEPS} steps in {run_s:.1f} s with a checkpoint at step "
        f"{STEPS} ({npz.stat().st_size} bytes); step-0 CE "
        f"{mets[0]['ce']:.4f} against ln(V) {ln_v:.4f}, aux "
        f"{mets[0]['aux']:.5f} against a balanced router's {want_aux:.3f} "
        f"(coef x K, summed over {cfg.num_layers} layers); "
        f"step {step_ms:.1f} ms (median of steps 1..{STEPS - 1}, the "
        f"Trainer's clock: data, forward, backward, Muon), "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s; the data stream alone "
        f"{statistics.median(data):.1f} ms a batch; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; the allocator's retries (cache flushes) "
        f"{torch.cuda.memory_stats().get('num_alloc_retries', 0)}")
    trained = {k: p.detach().to("cpu", copy=True)
               for k, p in model.named_parameters()}
    granite_update(torch, tr, Key(0).fold_in(STEPS))
    batches = [tr.batch_fn(t) for t in range(1, STEPS)]
    fb = []
    for b in batches:
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.loss(b)[0].backward()
        torch.cuda.synchronize()
        fb.append((time.perf_counter() - t0) * 1e3)
    log(f"  (a) forward+backward alone (median of {len(fb)}): "
        f"{statistics.median(fb):.1f} ms")
    profile_train_step(torch, lambda: tr.step_fn(batches[0], STEPS),
                       "(a) a granite-moe train step")
    repeated_step(torch, tr, batches[1], STEPS + 1)
    log(f"  (a) max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB over (a)")
    del tr, model, batches
    torch.cuda.empty_cache()
    return counts, trained


def pinned(torch, t):
    """A copy of ``t`` in page-locked host memory (where there is a card):
    the copies of a full-width model's parameters and state to the host
    and back run at the bus's rate, not through a staging buffer."""
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


def granite_update(torch, tr, key, what="(a)", name="granite-moe",
                   profile=True):
    """One Muon update from the Trainer's state, parameters and last
    clipped gradients, through the kernels and through torch.matmul
    (``use_kernels=False``): within UPDATE_REL_TOL of the largest update
    entry, the kernels' update bitwise the same when repeated, no
    synchronizing call, the times, and (``profile``) a profile by K1/K2
    shape; ``what`` labels the lines, ``name`` the model.  Leaves the
    Trainer's parameters and state as it found them and their gradients
    cleared."""
    from repro_torch.optim import make_optimizer

    model, src = tr.model, tr.opt
    named = dict(model.named_parameters())
    axes = model.logical_axes()
    before = {k: p.detach().clone() for k, p in named.items()}
    grads = {k: p.grad for k, p in named.items()}
    state = dict(src.state)

    def fresh(use_kernels):
        # Muon.step replaces its state tensors and never writes into
        # them, so the new optimizer may hold the Trainer's own
        o = make_optimizer(_with_prism(src.cfg, use_kernels=use_kernels),
                           list(named.items()), axes)
        for p in named.values():
            o.state[p] = dict(state[p])
        o.count = src.count
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(before[k])
                p.grad = grads[k]
        return o

    def timed(o):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o.step(key=key)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def update(use_kernels):
        """ms of one update of every leaf"""
        return timed(fresh(use_kernels))

    # the kernels' result waits on the host: the card holds the masters,
    # their copy, the gradients, the Trainer's state and a step
    opt_ms = {"kernels": [update(True)], "plain": []}
    after = {k: pinned(torch, p.detach()) for k, p in named.items()}
    opt_ms["plain"].append(update(False))
    worst = 0.0
    for k, p in named.items():
        b = before[k].to(p.device)
        dk = after[k].to(p.device) - b
        rel = float((dk - (p.detach() - b)).abs().max()) / max(
            float(dk.abs().max()), 1e-30)
        worst = max(worst, rel)
        if not rel <= UPDATE_REL_TOL:
            fail(f"{what}: the update of {k} through the kernels differs from "
                 f"torch.matmul's by {rel:.3e} of its largest entry "
                 f"(bound {UPDATE_REL_TOL})")
    opt_ms["plain"].append(update(False))
    opt_ms["kernels"].append(update(True))
    o = fresh(True)
    syncs = count_syncs(torch, lambda: o.step(key=key))
    del o
    differ = [k for k, p in named.items()
              if not torch.equal(p.detach(), after[k].to(p.device))]
    if differ:
        fail(f"{what}: a repeated Muon step through the kernels differs in "
             f"{len(differ)} parameters, e.g. {differ[:3]}")
    del after
    log(f"  {what} Muon update, kernels vs torch.matmul: worst relative gap "
        f"{worst:.3e} (bound {UPDATE_REL_TOL}); repeated through the "
        f"kernels bitwise the same; Muon step through the kernels "
        + ", ".join(f"{t:.1f}" for t in opt_ms["kernels"])
        + " ms, through torch.matmul "
        + ", ".join(f"{t:.1f}" for t in opt_ms["plain"])
        + f" ms; synchronizing calls in one Muon step: {len(syncs)} "
        f"{sorted(set(syncs))}")
    if syncs:
        fail(f"{what}: {len(syncs)} synchronizing calls in one Muon step")
    run = dict(model=model, opt=src, key=key)
    if profile:
        profile_step(torch, run, f"{what} {name} Muon PRISM-5",
                     by_shape=True, fresh=lambda: fresh(True))
    with torch.no_grad():
        for k, p in named.items():
            p.copy_(before[k])
            p.grad = None
    for p, st in state.items():
        src.state[p] = {k: v.to(p.device) for k, v in st.items()}
    del run, before, grads, state
    torch.cuda.empty_cache()


def profile_train_step(torch, fn, what, top=8):
    """A torch.profiler trace of one call of ``fn`` (a whole train step):
    the device's busy time against the wall time, the idle share, and the
    device kernels with the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not (
                getattr(e, "is_user_annotation", False)
                or e.key.startswith("Optimizer.")):
            n, us = per.get(e.key, (0, 0.0))
            per[e.key] = (n + e.count, us + e.self_device_time_total)
    busy_ms = sum(us for _, us in per.values()) / 1e3
    log(f"  {what}, profiled: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms, idle share {max(0.0, 1 - busy_ms / wall_ms):.3f}"
        f"; {sum(n for n, _ in per.values())} device activities")
    for key, (n, us) in sorted(per.items(), key=lambda t: -t[1][1])[:top]:
        log(f"    {us / 1e3:9.2f} ms {n:6d}x  {key[:90]}")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms)


def repeated_step(torch, tr, batch, t, what="(a)", host=False):
    """One Trainer step run twice from the same parameters and optimizer
    state, with deterministic algorithms on, as phase 10 runs (the
    embedding's backward): bitwise the same parameters (gated); then once
    more with the mode off, its equality printed (the MoE dispatch's
    backward adds no atomics: ``models/moe.py::_Dispatch``).  The
    parameters are kept on the host, and with ``host`` the optimizer state
    too (else its tensors stay referenced on the card)."""
    import warnings

    model, opt = tr.model, tr.opt
    named = dict(model.named_parameters())
    saved = {k: pinned(torch, p.detach()) for k, p in named.items()}
    state = {p: {k: pinned(torch, v) if host else v
                 for k, v in st.items()} for p, st in opt.state.items()}
    count = opt.count

    def again():
        with torch.no_grad():
            for k, p in named.items():
                p.copy_(saved[k])
        for p, st in state.items():
            opt.state[p] = {k: v.to(p.device) for k, v in st.items()}
        opt.count = count
        tr.step_fn(batch, t)
        torch.cuda.synchronize()
        return [k for k, p in named.items()
                if not torch.equal(p.detach(), first[k].to(p.device))]

    with deterministic(torch), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.step_fn(batch, t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        first = {k: pinned(torch, p.detach())
                 for k, p in named.items()}
        differ = again()
    loose = again()
    notes = sorted({str(x.message).splitlines()[0][:120] for x in w
                    if "deterministic" in str(x.message)})
    log(f"  {what} a train step repeated from the same state with "
        f"deterministic algorithms: {len(named) - len(differ)} of "
        f"{len(named)} parameters bitwise the same ({ms:.1f} ms a step in "
        f"that mode)" + (f"; warnings: {notes}" if notes else "")
        + f"; with the mode off, {len(named) - len(loose)} of {len(named)}"
        f" bitwise the first run's")
    if differ:
        fail(f"{what}: a repeated train step differs in {len(differ)} "
             f"parameters, e.g. {differ[:3]}")


def granite_serving(torch, work, trained):
    """(b): the Trainer's checkpoint into a fresh Model (another seed)
    through ``restore_params``, bitwise the trained parameters; then phase
    11's serving checks on it in bf16 (batch mode with the KV cache's
    bytes gated, prefill against a streamed decode drop-free, the Engine,
    batching printed; sampling, which no model changes, stays phase
    11's)."""
    from repro_torch.checkpoint import restore_params
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import Model
    from repro_torch.serving import make_trace

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(GRANITE).replace(num_layers=GRANITE_LAYERS)
    served = Model(cfg, device=DEVICE, seed=1)
    t0 = time.perf_counter()
    step, restored = restore_params(str(work),
                                    dict(served.named_parameters()))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != STEPS:
        fail(f"(b): restore_params took step {step}, not {STEPS}")
    served.load_params(restored)
    del restored
    for name, p in served.named_parameters():
        if not torch.equal(p.detach(), trained[name].to(p.device)):
            fail(f"(b): {name} is not bitwise the Trainer's")
    log(f"  (b) restore_params of step {STEPS} in {restore_s:.2f} s: "
        f"{len(trained)} parameters bitwise the Trainer's")
    trained.clear()
    with torch.inference_mode():
        params = served.cast_params()
    ops.reset_launches()
    res = batch_mode(torch, served, params)
    if res["cache_bytes"] != GRANITE_KV_BYTES:
        fail(f"(b): KV cache of {res['cache_bytes']} bytes, not "
             f"{GRANITE_KV_BYTES}")
    trace = make_trace(0, vocab_size=cfg.vocab_size, **ENGINE_TRACE)
    greedy = engine_checks(torch, served, params, trace)
    batching_invariance(torch, served, params, greedy, trace)
    counts = ops.launch_counts()
    if sum(counts.values()):
        fail(f"(b): serving launched PRISM kernels: {counts}")
    log(f"  (b) serving launched 0 PRISM kernels; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del served, params
    torch.cuda.empty_cache()


def _finite(torch, what, tensors):
    bad = [k for k, v in tensors.items()
           if v is not None and not bool(torch.isfinite(v).all())]
    if bad:
        fail(f"{what}: non-finite {bad[:3]}")


def family_runs(torch):
    """(c): mixtral-8x7b, musicgen-medium and llava-next-34b at their
    published widths, FAMILY_LAYERS layers each (the only cut), bf16
    compute, random weights from seed 0."""
    from repro_torch.configs import get_config

    for arch in ("mixtral-8x7b", "musicgen-medium", "llava-next-34b"):
        full = get_config(arch)
        cfg = full.replace(num_layers=FAMILY_LAYERS)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        family_run(torch, arch, full, cfg)
        torch.cuda.empty_cache()


def family_run(torch, arch, full, cfg):
    """One (c) run: vlm forward, loss and ``prefill_cache`` (no backward);
    moe forward+backward and prefill against a streamed decode drop-free;
    audio forward+backward, one Muon PRISM-5 step (launch/train.py's
    optimizer) and one decode step."""
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch
    from repro_torch.models import Model
    from repro_torch.models.inputs import make_decode_inputs, make_train_batch
    from repro_torch.optim import make_optimizer

    model = Model(cfg, device=DEVICE, seed=0)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    B = 1 if cfg.family == "vlm" else FAMILY_BATCH
    S = FAMILY_SEQ
    batch = make_train_batch(gen, cfg, B, S)
    n = sum(p.numel() for p in model.parameters())
    what = (f"(c) {arch} [{cfg.family}] (layers {full.num_layers} -> "
            f"{cfg.num_layers}, {n} params), batch {B}, seq {S}")
    ln_v = math.log(cfg.vocab_size)
    if cfg.family == "vlm":
        with torch.inference_mode():
            params = model.cast_params()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, m = model.loss(batch, params=params)
            torch.cuda.synchronize()
            loss_ms = (time.perf_counter() - t0) * 1e3
            logits, _ = model(batch, params=params)
        P = cfg.num_patches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, cache = model.prefill_cache(batch, P + S, params=params)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        _finite(torch, what, {"logits": logits, "prefill": lg,
                              "k": cache["k"], "v": cache["v"]})
        filled = int((cache["kpos"] < P + S).sum())
        if tuple(logits.shape) != (B, S, model.padded_vocab) or \
                filled != B * (P + S):
            fail(f"{what}: logits {tuple(logits.shape)}, {filled} cache "
                 f"slots filled")
        if abs(float(m["ce"]) - ln_v) > 1.5:
            fail(f"{what}: CE {float(m['ce']):.4f} not within 1.5 of ln(V) "
                 f"{ln_v:.4f}")
        log(f"  {what}, {P} patches x {cfg.vision_dim}: loss "
            f"{float(loss):.4f} (ln V {ln_v:.4f}) in {loss_ms:.1f} ms "
            f"(forward only); prefill_cache of {P + S} positions in "
            f"{pre_ms:.1f} ms, every slot filled; logits finite")
    else:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, m = model.loss(batch)
        loss.backward()
        torch.cuda.synchronize()
        fb_ms = (time.perf_counter() - t0) * 1e3
        _finite(torch, what, {k: p.grad for k, p in
                              model.named_parameters()})
        ce = float(m["ce"].detach())
        aux = float(torch.as_tensor(m["aux"]).detach())
        if abs(ce - ln_v) > 1.5:
            fail(f"{what}: CE {ce:.4f} not within 1.5 of ln(V) {ln_v:.4f}")
        note = ""
        if cfg.family == "audio":
            args = train_launch.parser().parse_args(["--arch", arch])
            opt = make_optimizer(train_launch.configs(args)[1],
                                 model.named_parameters(),
                                 model.logical_axes())
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step(key=Key(0).fold_in(0))
            torch.cuda.synchronize()
            opt_ms = (time.perf_counter() - t0) * 1e3
            c = {k: v for k, v in ops.launch_counts().items() if v}
            _finite(torch, what, dict(model.named_parameters()))
            del opt
        for p in model.parameters():
            p.grad = None
        with torch.inference_mode():
            params = model.cast_params()
        if cfg.family == "audio":
            with torch.inference_mode():
                cache = model.init_cache(B, 64)
                inp = make_decode_inputs(gen, cfg, B, 0)
                lg, cache = model.decode_step(cache, inp["tokens"],
                                              inp["pos"], params=params)
            _finite(torch, what, {"decode": lg})
            if tuple(lg.shape) != (B, cfg.num_codebooks, 1,
                                   model.padded_vocab):
                fail(f"{what}: decode logits {tuple(lg.shape)}")
            note = (f"; one Muon PRISM-5 step in {opt_ms:.1f} ms (launches "
                    f"{c}); one decode step of {B} lanes x "
                    f"{cfg.num_codebooks} codebooks, logits finite")
        else:
            prefill_parity(torch, model, params, f"(c) {arch}")
        log(f"  {what}: loss {float(loss):.4f} (ce {ce:.4f}, ln V "
            f"{ln_v:.4f}, aux {aux:.5f}), forward+backward {fb_ms:.1f} ms, "
            f"gradients finite" + note)
    log(f"  {what}: max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


# ------------------------------------- phase 13: the recurrent families

RGEMMA = "recurrentgemma-2b"
# every published width, depth cut from 26 layers to one (rec, rec, attn)
# period and the two recurrent tail layers, every kind of layer kept, so
# that the script stays well inside its time limit
RGEMMA_LAYERS = 5
RGEMMA_PARAMS = 1_005_432_320
FALCON = "falcon-mamba-7b"
# all 64 layers hold ~7.3e9 parameters, whose fp32 masters, gradients and
# momentum alone (~87 GB) pass the card's 80 GB; 2 layers, every width
# kept: the least depth at which one SSM layer's state and output reach
# the next, in training, in decode against forward and in the served state
FALCON_LAYERS = 2
FALCON_PARAMS = 743_305_216
# Muon's matrix views by shape: recurrentgemma's RG-LRU matrices (in_x,
# in_gate, w_a, w_i, out_proj of 4 recurrent layers), MLPs (5 x w_up,
# w_down), wq/wo at 16 padded heads, wk/wv (one kv head) of the attention
# layer; falcon's in_proj, out_proj, x_proj, dt_proj and A_log (min dim
# 16: a matrix leaf in both packages, base.is_matrix_param)
RGEMMA_VIEWS = {(2560, 2560): 20, (2560, 7680): 10, (2560, 4096): 2,
                (2560, 256): 2}
FALCON_VIEWS = {(4096, 16384): FALCON_LAYERS, (4096, 8192): FALCON_LAYERS,
                (8192, 288): FALCON_LAYERS, (256, 8192): FALCON_LAYERS,
                (8192, 16): FALCON_LAYERS}
RECURRENT_SHAPES = bucket_shapes(RGEMMA_VIEWS, {
    (2560, 2560): "recurrentgemma RG-LRU", (2560, 7680): "recurrentgemma MLPs",
    (2560, 4096): "recurrentgemma wq/wo", (2560, 256): "recurrentgemma wk/wv"}
) + bucket_shapes(FALCON_VIEWS, {
    (4096, 16384): "falcon in_proj", (4096, 8192): "falcon out_proj",
    (8192, 288): "falcon x_proj", (256, 8192): "falcon dt_proj",
    (8192, 16): "falcon A_log"})
RECURRENT_REPS = 5  # launches a median at these shapes (up to ~0.1 s each)
# (a)/(b): the training sequence, cut from launch/train.py's 512 for the
# script's clock (CHANGES.md; the scan's host loop runs a chunk at a time)
RECURRENT_SEQ = 256
# (c): launch/serve.batch_loop; the prompt is cut from phase 11's 1536
# (and from 256, CHANGES.md), since the scan prefill takes one full decode
# step a prompt token
RECURRENT_SERVE = dict(batch=4, prompt_len=128, gen_len=32, cache_len=0,
                       seed=0)
# the decode state at batch 4, cache_len 160 (prompt + gen): falcon's
# FALCON_LAYERS x 4 lanes x (conv 3 x 8192 bf16 + ssm 8192 x 16 fp32);
# recurrentgemma's 2 recurrent period layers (conv 3 x 2560 bf16, h 2560
# fp32 a lane), the attention layer's k, v [4, 160, 1, 256] bf16, kpos
# [4, 160] int32 and the 2 tail layers
FALCON_STATE_BYTES = FALCON_LAYERS * 4 * (3 * 8192 * 2 + 8192 * 16 * 4)
RGEMMA_STATE_BYTES = 1_067_520
# (d): decode against forward in fp32 at full width, tests/test_models_
# smoke.py:110-130's tolerance (2e-2 + 2e-2 |x|)
DECODE_FWD_LAYERS = {RGEMMA: 5, FALCON: FALCON_LAYERS}  # hybrid: 1 period
# and the 2 tail layers
DECODE_FWD_TOL = 2e-2
DECODE_FWD_BATCH, DECODE_FWD_SEQ = 2, 32


def phase13(torch):
    """(a) recurrentgemma-2b and (b) falcon-mamba-7b trained through
    launch/train.py's configuration, (c) each served from a checkpoint of
    its trained parameters (a temporary directory under build/, removed at
    the end), (d) decode against forward in fp32.  Returns each training
    run's launch counts."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase13_", dir=base_dir))
    counts = {}
    free_card(torch, "phase 13")
    try:
        for key, arch, layers, n, views, what in (
                ("rgemma", RGEMMA, RGEMMA_LAYERS, RGEMMA_PARAMS, RGEMMA_VIEWS,
                 "(a)"),
                ("falcon", FALCON, FALCON_LAYERS, FALCON_PARAMS,
                 FALCON_VIEWS, "(b)")):
            ckpt = work / key
            t0 = time.perf_counter()
            counts[key], trained = recurrent_training(
                torch, arch, layers, n, views, ckpt, what)
            t1 = time.perf_counter()
            recurrent_serving(torch, arch, layers, ckpt, trained,
                              f"(c) {arch}")
            shutil.rmtree(ckpt, ignore_errors=True)
            log(f"  {what} {arch}: training and its gates {t1 - t0:.1f} s, "
                f"(c) serving {time.perf_counter() - t1:.1f} s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    decode_vs_forward(torch)
    log(f"  (d) in {time.perf_counter() - t0:.1f} s")
    return counts


def free_card(torch, what):
    """Collect the garbage of earlier phases (a Trainer's reference cycles
    keep its tensors until the cyclic collector runs) and return the
    allocator's free blocks; logs what stays allocated."""
    before = torch.cuda.memory_allocated()
    gc_collect(torch, "cuda")
    log(f"  {what}: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
        f"allocated on the card ({before / 2**30:.2f} GiB before collecting "
        f"garbage); host {host_gib()}")


def gc_collect(torch, device):
    """Free a dropped Trainer's tensors (its reference cycles wait for the
    cyclic collector) and return the allocator's free blocks, the pinned
    host blocks gloo staged CUDA tensors through among them."""
    import gc

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        empty_host = getattr(torch._C, "_host_emptyCache", None)
        if empty_host is not None:
            empty_host()


def host_gib():
    """This process's resident host memory (VmRSS) and its peak
    (``getrusage``'s maxrss)."""
    import resource

    try:
        rss = next(int(ln.split()[1]) for ln in Path(
            "/proc/self/status").read_text().splitlines()
            if ln.startswith("VmRSS"))
    except (OSError, StopIteration):
        return "not measured"
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return (f"{rss / 2**20:.2f} GiB resident, peak {peak / 2**20:.2f}")


def plan_launches(model, ocfg):
    """K1/K2/K3 launches of one Muon step, derived from the port's bucket
    plan of ``model``'s matrix views and each bucket's tier: a grid-tier
    bucket runs each warm iteration as one K2 (R = I - X^T X) and
    ``degree`` K1 (Horner on R), a fused-tier one a K3.  Returns (counts,
    [(bucket shape, slices, tier)])."""
    from repro_torch.optim import base, bucketing

    pc = ocfg.resolved_prism
    if pc.iterations != pc.warm_alpha_iters:
        fail(f"plan_launches covers warm iterations only: {pc}")
    shapes = []
    for name, shape in model.param_shapes().items():
        axes = model.logical_axes()[name]
        if base.is_matrix_param(axes, shape):
            m, n = base.matrix_view_dims(axes, shape)
            shapes.append((math.prod(shape) // (m * n), m, n))
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    plan = []
    for b in bucketing.plan_buckets(shapes, pad=ocfg.bucket_pad,
                                    pad_slack=ocfg.bucket_pad_slack):
        tier = bucketing.resolve_tier(ocfg, b.shape)
        plan.append((b.shape, sum(e.count for e in b.entries), tier))
        if tier == "grid":
            counts["matmul_add"] += pc.degree * pc.iterations
            counts["gram_upper"] += pc.iterations
        elif tier == "fused":
            counts["warm_tail"] += 1
        else:
            fail(f"bucket {b.shape}: tier {tier} not in the launch plan")
    return counts, plan


def recurrent_training(torch, arch, layers, want_params, want_views, ckpt,
                       what):
    """(a)/(b): STEPS Trainer steps of launch/train.py's configuration
    cut to ``layers`` layers (``cut_trainer``), the gates of the module
    docstring; then a checkpoint of the trained parameters in their compute
    dtypes under ``ckpt``.  Returns (launch counts of the run, those
    parameters on the host)."""
    from repro_torch.checkpoint import save
    from repro_torch.configs import get_config
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops
    from repro_torch.launch import train as train_launch

    free_card(torch, what)
    torch.cuda.reset_peak_memory_stats()
    args = train_launch.parser().parse_args(["--arch", arch, "--steps",
                                             str(STEPS), "--seq",
                                             str(RECURRENT_SEQ)])
    tr = cut_trainer(args, layers)
    model, cfg, pc = tr.model, tr.model.cfg, tr.ocfg.prism
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != want_params:
        fail(f"{what}: {n_params} parameters, not {want_params}")
    views = _granite_views(tr.opt)
    if views != want_views:
        fail(f"{what}: Muon's views {views}, want {want_views}")
    want, plan = plan_launches(model, tr.ocfg)
    depth = f" of {get_config(arch).num_layers}, depth cut"
    log(f"  {what} {cfg.name} [{cfg.family}]: {n_params} params "
        f"({cfg.num_layers} layers{depth}, d {cfg.d_model}, vocab "
        f"{cfg.vocab_size}), seq {args.seq}, batch {args.batch}, "
        f"{cfg.dtype} compute, fp32 masters, remat {cfg.remat}; Muon "
        f"PRISM-5 (degree {pc.degree}, {pc.warm_alpha_iters} warm of "
        f"{pc.iterations} iterations), use_kernels={pc.use_kernels}; "
        f"buckets " + ", ".join(f"{[n] + list(s)} {t}" for s, n, t in plan)
        + "; launches a step from the plan "
        + ", ".join(f"{k} {v}" for k, v in want.items() if v))
    per_step, mets = {}, {}
    unaligned = unaligned_launches()
    ops.reset_launches()
    last = [ops.launch_counts()]

    def on_metrics(t, m):
        now = ops.launch_counts()
        per_step[t] = {k: now[k] - last[0][k] for k in now}
        last[0] = now
        mets[t] = {k: float(torch.as_tensor(m[k]).detach())
                   for k in ("loss", "ce", "grad_norm")}

    t0 = time.perf_counter()
    _, _, losses = tr.run(on_metrics=on_metrics)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if unaligned_launches() != unaligned:
        fail(f"{what}: K1/K2 launched their unaligned instantiation")
    for t in sorted(per_step):
        m = mets[t]
        log(f"  {what} step {t}: loss {m['loss']:.4f} (ce {m['ce']:.4f}), "
            f"grad_norm {m['grad_norm']:.4f}, launches "
            + ", ".join(f"{k} {v}" for k, v in per_step[t].items() if v))
        _expect_launches(per_step[t], want, f"{what} step {t}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"{what}: non-finite loss {losses}")
    ln_v = math.log(cfg.vocab_size)
    if abs(mets[0]["ce"] - ln_v) > 1.5:
        fail(f"{what}: step-0 CE {mets[0]['ce']:.4f} not within 1.5 of "
             f"ln(V) {ln_v:.4f}")
    step_ms = statistics.median(tr.step_times) * 1e3
    tokens = args.seq * args.batch
    with torch.inference_mode():
        cast = model.cast_params()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save(str(ckpt), STEPS, {"params": cast}, keep=1)
    save_s = time.perf_counter() - t0
    trained = {k: pinned(torch, v) for k, v in cast.items()}
    del cast
    log(f"  {what} {STEPS} steps in {run_s:.1f} s; step-0 CE "
        f"{mets[0]['ce']:.4f} against ln(V) {ln_v:.4f}; step "
        f"{step_ms:.1f} ms (median of steps 1..{STEPS - 1}, the Trainer's "
        f"clock: data, forward, backward, Muon), "
        f"{tokens / (step_ms / 1e3):.0f} tokens/s; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; the trained parameters in their compute "
        f"dtypes checkpointed in {save_s:.1f} s "
        f"({(ckpt / f'step_{STEPS:08d}' / 'tree.npz').stat().st_size} "
        f"bytes)")
    free_card(torch, f"{what} before the update gate")
    granite_update(torch, tr, Key(0).fold_in(STEPS), what=what, name=arch,
                   profile=False)
    batches = [tr.batch_fn(t) for t in range(1, STEPS)]
    fb = []
    for b in batches[:2]:
        for p in model.parameters():
            p.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.loss(b)[0].backward()
        torch.cuda.synchronize()
        fb.append((time.perf_counter() - t0) * 1e3)
    for p in model.parameters():
        p.grad = None
    log(f"  {what} forward+backward alone (mean of {len(fb)}): "
        f"{statistics.median(fb):.1f} ms")
    free_card(torch, f"{what} after the update gate")
    profile_train_step(torch, lambda: tr.step_fn(batches[0], STEPS),
                       f"{what} a {arch} train step")
    repeated_step(torch, tr, batches[1], STEPS + 1, what, host=True)
    if cfg.family == "ssm":
        scan_profile(torch, model, args.batch, args.seq, what)
    log(f"  {what} max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB over {what}")
    del tr, model, batches
    torch.cuda.empty_cache()
    return counts, trained


def _device_profile(torch, fn):
    """(wall ms, device busy ms, device kernels) of one ``fn()`` in a
    profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, n = 0.0, 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            busy += e.self_device_time_total
            n += e.count
    return wall_ms, busy / 1e3, n


def scan_profile(torch, model, B, S, what):
    """The selective scan of falcon's layer 0 alone, on its trained
    parameters and a random bf16 input [B, S, d]: forward (under autograd,
    chunks checkpointed) and backward ms on the host clock (median of 3),
    and each profiled: wall, device busy, device kernels."""
    import torch.nn.functional as F

    from repro_torch.models import ssm

    cfg = model.cfg
    with torch.no_grad():
        p = {k[len("layers.mamba."):]: v[0] for k, v in
             model.cast_params().items() if k.startswith("layers.mamba.")}
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(13)
        x = torch.randn((B, S, cfg.d_model), generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        xin = torch.chunk(x @ p["in_proj"], 2, dim=-1)[0]
        xc = F.silu(ssm._conv(xin, p["conv_w"], p["conv_b"],
                              cfg.ssm.conv_dim).float()).to(x.dtype)
        dt, Bm, Cm = ssm._ssm_params(p, xc, cfg)
        A = -torch.exp(p["A_log"])
        g = torch.randn((B, S, ssm._d_inner(cfg)), generator=gen,
                        device=DEVICE)
    ins = [t.detach().requires_grad_(True)
           for t in (dt, xc.float(), Bm, Cm, A)]
    state = {}

    def fwd():
        state["y"] = ssm.selective_scan(*ins)

    def bwd():
        state.pop("y").backward(g)

    f_ms, b_ms = [], []
    for _ in range(3):
        for t in ins:
            t.grad = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fwd()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        bwd()
        torch.cuda.synchronize()
        f_ms.append((t1 - t0) * 1e3)
        b_ms.append((time.perf_counter() - t1) * 1e3)
    fp = _device_profile(torch, fwd)
    bp = _device_profile(torch, bwd)
    if not all(bool(torch.isfinite(t.grad).all()) for t in ins):
        fail(f"{what}: the selective scan's gradients are not finite")
    log(f"  {what} the selective scan of one layer ([{B}, {S}, "
        f"{ssm._d_inner(cfg)}, {cfg.ssm.state_dim}], chunks of "
        f"{ssm.SCAN_CHUNK}): forward {statistics.median(f_ms):.1f} ms, "
        f"backward {statistics.median(b_ms):.1f} ms (host clock, median of "
        f"3); profiled forward: wall {fp[0]:.1f} ms, device busy "
        f"{fp[1]:.1f} ms, {fp[2]} device kernels; backward: wall "
        f"{bp[0]:.1f} ms, device busy {bp[1]:.1f} ms, {bp[2]} device "
        f"kernels")
    del ins, state, dt, Bm, Cm, xc, xin, x, g


def _lane_axes(cache):
    """(leaf, batch axis) of every leaf of a recurrent decode cache, in
    ``cache_leaves`` order within each group."""
    from repro_torch.models.transformer import cache_leaves

    if "ssm" in cache:
        return [(t, 1) for t in cache_leaves(cache)]
    return ([(t, 1) for t in cache_leaves(cache["rec"])]
            + [(cache["k"], 2), (cache["v"], 2), (cache["kpos"], 0)]
            + [(t, 0) for t in cache_leaves(cache.get("tail", []))])


def recurrent_serving(torch, arch, layers, ckpt, trained, what):
    """(c): the checkpoint into a fresh Model (another seed) through
    ``restore_params``, bitwise the trained compute-dtype parameters;
    ``launch/serve.batch_loop`` at RECURRENT_SERVE in bf16 (tokens in the
    vocab, logits finite, the decode state's bytes exact), a profiled
    decode step, the scan prefill bitwise a streamed active-masked decode
    loop over ragged lengths (logits and every cache leaf), and inactive
    lanes' leaves bitwise frozen; no PRISM kernel launched."""
    from types import SimpleNamespace

    from repro_torch.checkpoint import restore_params
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.models.transformer import cache_leaves

    free_card(torch, what)
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch).replace(num_layers=layers)
    served = Model(cfg, device=DEVICE, seed=1)
    with torch.inference_mode():
        target = served.cast_params()
    t0 = time.perf_counter()
    step, params = restore_params(str(ckpt), target)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del target
    if step != STEPS:
        fail(f"{what}: restore_params took step {step}, not {STEPS}")
    for name, v in params.items():
        if not torch.equal(v, trained[name].to(v.device)):
            fail(f"{what}: {name} is not bitwise the trained parameter")
    log(f"  {what} restore_params of step {STEPS} in {restore_s:.2f} s: "
        f"{len(params)} compute-dtype parameters bitwise the trained ones")
    trained.clear()
    ops.reset_launches()
    a = SimpleNamespace(**RECURRENT_SERVE)
    res = serve.batch_loop(served, params, a, torch.device(DEVICE))
    toks = res["tokens"]
    if toks.shape != (a.batch, a.gen_len + 1) or toks.min() < 0 \
            or toks.max() >= cfg.vocab_size:
        fail(f"{what}: tokens of shape {toks.shape} in [{toks.min()}, "
             f"{toks.max()}]")
    if not res["finite"]:
        fail(f"{what}: a logit is not finite")
    clen = a.prompt_len + a.gen_len
    with torch.inference_mode():
        shapes = sum(t.numel() * t.element_size()
                     for t in cache_leaves(served.init_cache(a.batch, clen)))
    want = FALCON_STATE_BYTES if cfg.family == "ssm" else RGEMMA_STATE_BYTES
    if not res["cache_bytes"] == shapes == want:
        fail(f"{what}: decode state of {res['cache_bytes']} bytes; "
             f"init_cache's shapes {shapes}, want {want}")
    log(f"  {what} batch {a.batch}, prompt {a.prompt_len}, gen "
        f"{a.gen_len}, {cfg.dtype}: prefill (one decode step a prompt "
        f"token) {res['prefill_s'] * 1e3:.1f} ms ({res['prefill_tok_s']:.0f}"
        f" prompt tok/s; first call {res['first_prefill_s'] * 1e3:.1f} ms),"
        f" decode {res['decode_ms_step']:.3f} ms a step "
        f"({res['decode_tok_s']:.1f} tok/s), decode state "
        f"{res['cache_bytes']} bytes (init_cache's shapes exactly); tokens "
        f"in the vocab, logits finite")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(12)
    B, S = len(PARITY_LENGTHS), max(PARITY_LENGTHS)
    prompts = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            device=DEVICE, dtype=torch.int32)
    lengths = torch.tensor(PARITY_LENGTHS, dtype=torch.int32, device=DEVICE)
    lp, cp = served.prefill_cache({"tokens": prompts}, S, lengths,
                                  params=params)
    cache = served.init_cache(B, S)
    last = torch.zeros_like(lp)
    for t in range(S):
        lg, cache = served.decode_step(
            cache, prompts[:, t:t + 1],
            torch.full((B, 1), t, dtype=torch.int32, device=DEVICE),
            active=t < lengths, params=params)
        last = torch.where((t == lengths - 1).reshape(B, 1, 1), lg, last)
    pairs = list(zip(cache_leaves(cp), cache_leaves(cache)))
    if not torch.equal(lp, last) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs):
        fail(f"{what}: the scan prefill is not bitwise the streamed "
             f"decode loop")
    tok = torch.argmax(lp, dim=-1).to(torch.int32)
    pos = lengths.reshape(B, 1)
    profile_ticks(torch, lambda: served.decode_step(cp, tok, pos,
                                                    params=params),
                  f"{what} a decode step (batch {B})")
    before = [(t.clone(), ax) for t, ax in _lane_axes(cache)]
    active = torch.tensor([True, False, True], device=DEVICE)
    served.decode_step(cache, tok, pos, active=active, params=params)
    for (old, ax), (new, _) in zip(before, _lane_axes(cache)):
        if not torch.equal(old.select(ax, 1), new.select(ax, 1)):
            fail(f"{what}: an inactive lane's cache leaf changed")
        if torch.equal(old.select(ax, 0), new.select(ax, 0)):
            fail(f"{what}: an active lane's cache leaf did not move")
    counts = ops.launch_counts()
    if sum(counts.values()):
        fail(f"{what}: serving launched PRISM kernels: {counts}")
    log(f"  {what} prefill_cache of lengths {list(PARITY_LENGTHS)} bitwise "
        f"{S} streamed active-masked decode steps, in the logits and all "
        f"{len(pairs)} cache leaves; a step with lane 1 inactive leaves "
        f"its {len(before)} leaves bitwise and moves the others'; 0 PRISM "
        f"kernels; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del served, params, cache, cp, before
    torch.cuda.empty_cache()


def decode_vs_forward(torch):
    """(d): both configs at full width, DECODE_FWD_LAYERS layers, fp32
    compute, random weights from seed 0: greedy decode logits against the
    forward logits at every position, within DECODE_FWD_TOL + DECODE_FWD_TOL
    |x|."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    for arch, layers in DECODE_FWD_LAYERS.items():
        torch.cuda.empty_cache()
        cfg = get_config(arch).replace(num_layers=layers, dtype="float32",
                                       emb_dtype="float32")
        model = Model(cfg, device=DEVICE, seed=0)
        B, S = DECODE_FWD_BATCH, DECODE_FWD_SEQ
        gen = torch.Generator(device=DEVICE)
        gen.manual_seed(14)
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                             device=DEVICE, dtype=torch.int32)
        with torch.inference_mode():
            params = model.cast_params()
            full, _ = model({"tokens": toks}, params=params)
        cache = model.init_cache(B, S)
        worst, excess = 0.0, -1.0
        for t in range(S):
            lg, cache = model.decode_step(
                cache, toks[:, t:t + 1],
                torch.full((B, 1), t, dtype=torch.int32, device=DEVICE),
                params=params)
            want = full[:, t:t + 1, :cfg.vocab_size]
            err = (lg[..., :cfg.vocab_size] - want).abs()
            worst = max(worst, err.max().item())
            excess = max(excess, (err - DECODE_FWD_TOL
                                  * (1 + want.abs())).max().item())
        log(f"  (d) {arch} at full width, {layers} layers, fp32, batch {B}:"
            f" {S} greedy decode steps against the forward logits, max "
            f"|diff| {worst:.3e} (tolerance {DECODE_FWD_TOL} + "
            f"{DECODE_FWD_TOL}|x|)")
        if excess > 0:
            fail(f"(d) {arch}: decode logits leave the forward's by "
                 f"{excess:.3e} beyond the tolerance")
        del model, params, full, cache


# ------------------------------------------------------------ phase 14

P14_WORLD = 2            # ranks sharing the one card
# steps cut for the script's clock (CHANGES.md): (b) 4 -> 2; (e) 7 at K 5
# -> 4 at K 2 (the bootstrap at 0, the clock at 2, a swap at 3)
P14_STEPS = 2            # (b): the Trainer on the mesh, a checkpoint
P14_ASYNC_STEPS = 4      # (e): bootstrap at 0, the clock at P14_ASYNC_K
P14_ASYNC_K = 2
P14_EXTRA_STEPS = 2      # (c): bf16 gradients, int8 compression
# (c)'s losses against (b)'s: the sound runs read at most 1.35e-4 on the
# H100, the same steps with no update at all 1.50e-3 (the control, which
# must lie beyond the bound, or the gate could not tell a broken update)
P14_EXTRA_LOSS_TOL = 5e-4
P14_POLAR_TOL = 2e-5     # tests/test_sharded_precond.py, sharded vs not
P14_PSUM_STEPS = 8       # int8_psum's bound: tests/test_sharded_precond.py
P14_TIMEOUT_S = 300      # a collective that waits longer fails the rank
P14_DEADLINE_S = 900     # the whole world
P14_PATHS = ("prism5", "prism3")


def phase14(torch, preset="full", device="cuda", launches=True):
    """Phase 14 (see the module docstring) in a temporary build/phase14_*
    directory, removed at the end; returns rank 0's launch counts of (b).
    ``preset``/``device``/``launches`` let it rehearse on the CPU."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase14_", dir=base_dir))
    try:
        return _phase14(torch, work, preset, device, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _p14_cfgs(preset, fp32=False, **kw):
    from repro_torch.launch import train_lm

    cfg, ocfg, dcfg = train_lm.configs(preset, "prism", "float32", 0,
                                       "prism5", "muon", **kw)
    if fp32 or preset == "cpu-small":
        # fp32 compute: bf16 GEMMs round differently at each batch size
        # (the CPU rehearsal's gradients 3e-3 apart), so the update gate
        # against one process runs here
        cfg = cfg.replace(dtype="float32", emb_dtype="float32")
    return cfg, ocfg, dcfg


def _p14_trainer(cfgs, device, mesh=None, **tkw):
    from repro_torch.config import TrainConfig
    from repro_torch.models import Model
    from repro_torch.train import Trainer

    cfg, ocfg, dcfg = cfgs
    tkw.setdefault("log_every", 1)
    return Trainer(Model(cfg, device=device, seed=0), ocfg,
                   TrainConfig(**tkw), dcfg, mesh=mesh)


def _p14_sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _crcs(torch, tree):
    """crc32 of each leaf of a checkpoint tree, as checkpoint.save takes
    them (host copies)."""
    from repro_torch.checkpoint import checkpoint as ck

    return {k: ck._crc(ck._host(v)) for k, v in ck._flatten(tree).items()}


def _p14_step0_update(torch, tr, on_metrics=None):
    """Run ``tr``; returns (losses, its step-0 parameter change)."""
    before = {k: p.detach().clone() for k, p in tr.model.named_parameters()}
    upd = {}

    def hook(t, m):
        if t == 0:
            upd.update({k: p.detach() - before.pop(k)
                        for k, p in tr.model.named_parameters()})
        if on_metrics is not None:
            on_metrics(t, m)
    _, _, losses = tr.run(on_metrics=hook)
    return losses, upd


def _p14_references(torch, work, preset, device):
    """The single-process Trainer runs (b) is held against: P14_STEPS steps
    (its losses, returned, and its step-0 update) and one step at fp32
    compute (its update); the updates go to files."""
    tr = _p14_trainer(_p14_cfgs(preset), device, steps=P14_STEPS)
    losses, upd = _p14_step0_update(torch, tr)
    torch.save({k: v.cpu() for k, v in upd.items()}, work / "ref_update.pt")
    del tr, upd
    tr = _p14_trainer(_p14_cfgs(preset, fp32=True), device, steps=1)
    _, upd = _p14_step0_update(torch, tr)
    torch.save({k: v.cpu() for k, v in upd.items()},
               work / "ref_update32.pt")
    del tr, upd
    return losses


class Shadow:
    """A single process's optimizer beside a rank's Trainer: its own copy
    of the parameters and state, stepped without the mesh (no sharding)
    on the gradients the rank's step consumed (each parameter's .grad
    after the step: the reduced, clipped gradients), with its own §12
    service when the Trainer has one.  It computes what one process
    computes from the same gradients."""

    def __init__(self, torch, tr):
        from repro_torch.optim import base, make_optimizer

        self.tr = tr
        self.named = [(k, torch.nn.Parameter(p.detach().clone()))
                      for k, p in tr.model.named_parameters()]
        self.opt = make_optimizer(tr.ocfg, self.named,
                                  tr.model.logical_axes())
        self.svc = (base.AsyncPrecondService(self.opt)
                    if tr.ocfg.precond_async else None)
        self.drift = 0.0
        self.dispatched = []

    def step(self, t):
        from repro_torch.core.rng import Key
        from repro_torch.optim import base

        if self.svc is not None:
            self.svc.step_begin(t, Key(1).fold_in(t), drift=self.drift)
            if self.svc.last_dispatch == t:
                self.dispatched.append(t)
        for (_, s), p in zip(self.named, self.tr.model.parameters()):
            s.grad = p.grad
        self.opt.step(key=Key(0).fold_in(t),
                      refresh=False if self.svc is not None else None)
        if self.svc is not None:
            self.drift = float(base.precond_drift(self.opt))

    def gap(self, torch, names=("ortho",)):
        """The largest entry of |rank - shadow| - tol |shadow| and of
        |rank - shadow| over the parameters and the ``names`` caches."""
        from repro_torch.optim import base

        base.wait_pending(self.opt)
        worst = over = 0.0
        for (_, s), p in zip(self.named, self.tr.model.parameters()):
            pairs = [(p.detach(), s.detach())] + [
                (self.tr.opt.state[p][n].float(), self.opt.state[s][n].float())
                for n in names if n in self.opt.state[s]]
            for a, b in pairs:
                d = (a - b).abs()
                worst = max(worst, float(d.max()))
                over = max(over, float((d - P14_POLAR_TOL * b.abs()).max()))
        return over, worst


def _phase14(torch, work, preset, device, launches):
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import latest_step
    from repro_torch.kernels import ops

    cuda = torch.device(device).type == "cuda"
    if cuda:
        free_card(torch, "phase 14")
    card = _card_line()
    t0 = time.perf_counter()
    ref_losses = _p14_references(torch, work, preset, device)
    log(f"  the single-process Trainer ((b)'s reference, {P14_STEPS} steps) "
        f"in {time.perf_counter() - t0:.1f} s; losses "
        f"{', '.join(f'{v:.4f}' for v in ref_losses)}")
    if cuda:
        free_card(torch, "before the ranks")
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _phase14_rank, args=(P14_WORLD, str(work), preset, device,
                             ref_losses, launches),
        nprocs=P14_WORLD, start_method="spawn", join=False)
    deadline = time.monotonic() + P14_DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"phase 14: the world of {P14_WORLD} ranks did not "
                     f"finish in {P14_DEADLINE_S} s")
    except Exception as e:  # a rank raised or died: the phase fails
        for r in range(P14_WORLD):
            err = work / f"rank{r}.err"
            if err.exists():
                log(f"  rank {r} raised:\n{err.read_text()}")
        fail(f"phase 14: a rank failed: {type(e).__name__}: "
             f"{str(e).splitlines()[0] if str(e) else ''}")
    world_s = time.perf_counter() - t0
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(P14_WORLD)]
    log(f"  the world of {P14_WORLD} ranks (spawned, gloo) ran in "
        f"{world_s:.1f} s ({card})")
    for r, rr in enumerate(res):
        log(f"  rank {r}: (a) engine "
            + ", ".join(f"{p} {rr['a'][p]['ms']:.1f} ms (all-gathers "
                        f"{rr['a'][p]['gather_ms']:.1f} ms)"
                        for p in P14_PATHS)
            + f"; (b) step {rr['step_ms']:.1f} ms, gradient all-reduce "
            f"{', '.join(f'{v:.1f}' for v in rr['grad_ms'])} ms; "
            f"max_memory_allocated {rr['peak_gib']:.2f} GiB ({card})")
    r0 = res[0]
    # (a)/(b)/(e): what every rank must hold alike
    for key in ("digests", "dispatched", "final_crcs", "c_crcs",
                "async_final"):
        if any(r[key] != r0[key] for r in res[1:]):
            fail(f"phase 14: the ranks disagree on {key}")
    log(f"  (b) parameters bitwise equal on every rank after each of "
        f"{len(r0['digests'])} steps, and (c)'s after their last (crc32 of "
        f"every parameter); (e) both ranks dispatched at steps "
        f"{r0['dispatched']}")
    # (d): a single process restores the world's checkpoint
    cfgs = _p14_cfgs(preset)
    ck = work / "ckpt_b"
    if latest_step(str(ck)) != P14_STEPS:
        fail(f"phase 14 (d): the world's checkpoint is at step "
             f"{latest_step(str(ck))}, not {P14_STEPS}")
    tr = _p14_trainer(cfgs, device, steps=P14_STEPS + 1,
                      checkpoint_dir=str(ck), checkpoint_every=0)
    t0 = time.perf_counter()
    start = tr.restore_or_init()
    restore_s = time.perf_counter() - t0
    count = int(tr.opt.count)
    crcs = _crcs(torch, tr.state_tree())
    want = r0["final_crcs"]
    if start != P14_STEPS or crcs != want:
        bad = sorted(k for k in set(crcs) | set(want)
                     if crcs.get(k) != want.get(k))
        fail(f"phase 14 (d): the restored state is not what the ranks "
             f"held (start {start}; leaves differing: {bad[:5]})")
    ops.reset_launches()
    tr.step_fn(tr.batch_fn(P14_STEPS), P14_STEPS)
    _p14_sync(torch, device)
    counts = ops.launch_counts()
    if launches:
        _expect_launches(counts, PER_STEP["prism5"],
                         "phase 14 (d), the restored run's next step")
    log(f"  (d) a single process restored the world's step-{P14_STEPS} "
        f"checkpoint in {restore_s:.1f} s: {len(crcs)} leaves bitwise the "
        f"ranks' (crc32), count {count}; its next step "
        f"launched {sum(counts.values())} ({card})")
    del tr
    return r0["counts_b"]


def _card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except FileNotFoundError:
        return "no nvidia-smi"
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "no nvidia-smi"


def _phase14_rank(rank, world, work, preset, device, ref_losses, launches):
    """One rank of phase 14: (a), (b), (c) and (e); writes
    rank<r>.json, or rank<r>.err with the traceback when it raises."""
    import traceback

    work = Path(work)
    try:
        res = _p14_rank_body(rank, world, work, preset, device, ref_losses,
                             launches)
        (work / f"rank{rank}.json").write_text(json.dumps(res))
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _rank_log(rank, msg):
    if rank == 0:
        print(msg, flush=True)


def _p14_expect(rank, counts, path, what, launches):
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(PER_STEP[path])
    if launches and counts != want:
        raise AssertionError(f"rank {rank}, {what}: launches {counts}, "
                             f"want {want}")


def _p14_rank_body(rank, world, work, preset, device, ref_losses,
                   launches):
    import torch

    from repro_torch import collectives
    from repro_torch.launch import mesh as lmesh

    dev = lmesh.init_world(rank, world, f"file://{work}/store",
                           device=device, timeout_s=P14_TIMEOUT_S)
    try:
        mesh = lmesh.make_debug_mesh(data=world, model=1)
        card = _card_line() if dev.type == "cuda" else "cpu"
        res = {"backend": lmesh.world_backend()}
        _rank_log(rank, f"  rank 0: backend {res['backend']}, device {dev}, "
                  f"{card}")
        res["a"] = {p: _p14_engine(torch, rank, mesh, dev, preset, p,
                                   launches) for p in P14_PATHS}
        res.update(_p14_trainer_b(torch, rank, mesh, dev, work, preset,
                                  ref_losses, launches))
        res.update(_p14_update32(torch, rank, mesh, dev, work, preset))
        res.update(_p14_extras(torch, rank, mesh, dev, preset, res))
        res.update(_p14_async(torch, rank, mesh, dev, preset, launches))
        res["peak_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                           if dev.type == "cuda" else 0.0)
        _rank_log(rank, f"  max_memory_allocated: rank 0 "
                  f"{res['peak_gib']:.2f} GiB ({card})")
        collectives.barrier()
        return res
    finally:
        lmesh.close_world()


def _p14_engine(torch, rank, mesh, dev, preset, path, launches):
    """(a): gpt2-paper Muon's buckets through polar_bucketed, single and
    sharded, on this rank."""
    from repro_torch import collectives
    from repro_torch.core.rng import Key
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding
    from repro_torch.launch import train_lm
    from repro_torch.models.transformer import param_specs
    from repro_torch.optim import base, bucketing
    from repro_torch.sharding_ctx import activation_sharding

    cfg, ocfg, _ = train_lm.configs(preset, "prism", "float32", 0, path,
                                    "muon")
    cfg = _p14_cfgs(preset)[0]
    shapes = [tuple(base.to_matrix_view(torch.empty(s, device="meta"),
                                        a)[0].shape)
              for s, a, _ in param_specs(cfg).values()
              if base.is_matrix_param(a, tuple(s))]
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    views = [torch.randn(s, generator=gen, device=dev) for s in shapes]
    key = Key(0).fold_in(0)
    rules = sharding.activation_rules(cfg, mesh)

    def run(sharded):
        ops.reset_launches()
        _p14_sync(torch, dev)
        t0 = time.perf_counter()
        with collectives.count_collectives() as calls:
            if sharded:
                with activation_sharding(mesh, rules):
                    out = bucketing.polar_bucketed(views, ocfg, key)
            else:
                out = bucketing.polar_bucketed(views, ocfg, key)
            _p14_sync(torch, dev)
        return (out, (time.perf_counter() - t0) * 1e3, ops.launch_counts(),
                calls)

    run(False)  # warm up: the kernels' first launches load them
    single, single_ms, c1, _ = run(False)
    run(True)
    sharded, ms, c2, calls = run(True)
    _p14_expect(rank, c1, path, f"(a) {path} single", launches)
    _p14_expect(rank, c2, path, f"(a) {path} sharded", launches)
    gap = max(float((a - b).abs().max()) for a, b in zip(sharded, single))
    bitwise = all(torch.equal(a, b) for a, b in zip(sharded, single))
    if not gap <= P14_POLAR_TOL:
        raise AssertionError(f"rank {rank}, (a) {path}: the gathered polars "
                             f"differ from the single process's by {gap:.3e} "
                             f"(bound {P14_POLAR_TOL})")
    gathers = [c for c in calls if c.op == "all_gather"]
    out = {"views": len(views), "launches": sum(c2.values()), "counts": c2,
           "ms": ms, "single_ms": single_ms, "gap": gap, "bitwise": bitwise,
           "gathers": len(gathers),
           "gather_ms": sum(c.ms for c in gathers),
           "gather_bytes": sum(c.nbytes for c in gathers)}
    _rank_log(rank, f"  (a) {path}: {len(views)} views, {len(gathers)} "
              f"buckets; rank 0 launched {out['launches']} ({c2}) = the "
              f"single process's; engine {ms:.1f} ms (single process "
              f"{single_ms:.1f} ms), of which {len(gathers)} all-gathers "
              f"{out['gather_ms']:.1f} ms, {out['gather_bytes']} bytes sent "
              f"a rank; polars within {gap:.3e} of the single process's "
              f"(bound {P14_POLAR_TOL}), bitwise {bitwise}")
    return out


def _p14_trainer_b(torch, rank, mesh, dev, work, preset, ref_losses,
                   launches):
    """(b): the Trainer on the mesh, P14_STEPS steps, a checkpoint at the
    last."""
    from repro_torch import collectives
    from repro_torch.kernels import ops

    cfgs = _p14_cfgs(preset)
    tr = _p14_trainer(cfgs, dev, mesh, steps=P14_STEPS,
                      checkpoint_dir=str(work / "ckpt_b"),
                      checkpoint_every=P14_STEPS)
    digests, per_step = [], []
    last = [None]

    def on_metrics(t, m):
        now = ops.launch_counts()
        per_step.append({k: now[k] - last[0][k] for k in now})
        last[0] = now
        digests.append([_crcs(torch, {k: p}) for k, p in
                        tr.model.named_parameters()])

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    last[0] = ops.launch_counts()
    with collectives.count_collectives() as calls:
        losses, upd = _p14_step0_update(torch, tr, on_metrics)
    # Muon's leaves (AdamW's first update is lr * sign(g)); the gap to
    # the single-process Trainer's update at bf16 compute is printed (bf16
    # activations round differently at 2 rows than at 4), the update gate
    # runs at fp32 compute (_p14_update32)
    ref = torch.load(work / "ref_update.pt", map_location=dev)
    worst_bf16 = _worst_gap(torch, {k: v for k, v in upd.items()
                                    if k in _muon_leaves(tr)}, ref, "",
                            gate=False)
    del upd, ref
    for t, c in enumerate(per_step):
        _p14_expect(rank, c, "prism5", f"(b) step {t}", launches)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"(b) non-finite losses {losses}")
    ln_v = math.log(tr.model.cfg.vocab_size)
    gaps = [abs(a - b) for a, b in zip(losses, ref_losses)]
    if abs(losses[0] - ln_v) > 1.5 or not max(gaps) <= RESUME_LOSS_TOL:
        raise AssertionError(f"(b) losses {losses} vs the single process's "
                             f"{ref_losses} (bound {RESUME_LOSS_TOL}; ln V "
                             f"{ln_v:.4f})")
    grads = [c for c in calls if c.op == "all_reduce_sum" and c.numel > 3]
    seq, batch = tr.dcfg.seq_len, tr.dcfg.global_batch
    step_ms = statistics.median(tr.step_times) * 1e3
    final = _crcs(torch, tr.state_tree())
    # the synchronizing calls of one more step (not checkpointed)
    syncs = count_syncs(torch, lambda: tr.step_fn(tr.batch_fn(P14_STEPS),
                                                  P14_STEPS)) \
        if dev.type == "cuda" else []
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    out = {"losses": losses, "digests": digests, "counts_b": total,
           "final_crcs": final, "step_ms": step_ms,
           "grad_calls": len(grads) / len(losses),
           "grad_bytes": sum(c.nbytes for c in grads) / len(losses),
           "grad_ms": [c.ms for c in grads], "syncs": len(syncs),
           "worst_b_bf16": worst_bf16}
    _rank_log(rank, f"  (b) Trainer on the mesh, global batch {batch} "
              f"({batch // mesh.size} rows a rank), seq {seq}: losses "
              f"{', '.join(f'{v:.4f}' for v in losses)} (single process: "
              f"largest gap {max(gaps):.2e}, bound {RESUME_LOSS_TOL}); "
              f"launches {sum(per_step[0].values())} a step on rank 0; "
              f"step-0 Muon update {worst_bf16:.3e} of the largest entry "
              f"from the single-process Trainer's at bf16 compute "
              f"(printed; the gate runs at fp32 compute)")
    _rank_log(rank, f"  (b) step {step_ms:.1f} ms (median of steps "
              f"1..{P14_STEPS - 1}), {seq * batch / (step_ms / 1e3):.0f} "
              f"tokens/s over both ranks; gradient all-reduce "
              f"{out['grad_calls']:g} call(s) a step, "
              f"{out['grad_bytes']:.0f} bytes a rank a step, "
              f"{', '.join(f'{v:.1f}' for v in out['grad_ms'])} ms; "
              f"{len(syncs)} synchronizing calls in one step "
              f"{sorted(set(syncs))[:4]}")
    del tr
    return out


def _muon_leaves(tr):
    """The parameters Muon steps (AdamW's state has "nu")."""
    return {k for k, p in tr.model.named_parameters()
            if "nu" not in tr.opt.state[p]}


def _p14_update32(torch, rank, mesh, dev, work, preset):
    """(b) at fp32 compute: one step of the Trainer on the mesh, its Muon
    update within UPDATE_REL_TOL of the single-process Trainer's."""
    tr = _p14_trainer(_p14_cfgs(preset, fp32=True), dev, mesh, steps=1)
    _, upd = _p14_step0_update(torch, tr)
    ref = torch.load(work / "ref_update32.pt", map_location=dev)
    worst = _worst_gap(torch, {k: v for k, v in upd.items()
                               if k in _muon_leaves(tr)}, ref, "",
                       gate=False)
    del tr, upd, ref
    if not worst <= UPDATE_REL_TOL:
        raise AssertionError(f"rank {rank}, (b) fp32: the step-0 Muon "
                             f"update differs from the single process's by "
                             f"{worst:.3e} of its largest entry (bound "
                             f"{UPDATE_REL_TOL})")
    _rank_log(rank, f"  (b) at fp32 compute: the step-0 Muon update within "
              f"{worst:.3e} of the single-process Trainer's, relative to "
              f"its largest entry (bound {UPDATE_REL_TOL})")
    return {"worst_b32": worst}


def _p14_extras(torch, rank, mesh, dev, preset, res):
    """(c): bf16 gradients, int8 compression, int8_psum on the card."""
    import dataclasses

    from repro_torch import collectives
    from repro_torch.optim import compression

    out = {"c_crcs": {}}
    still = None
    for what, change in (("bf16", dict(grads_dtype="bfloat16")),
                         ("int8", dict(gradient_compression="int8"))):
        cfg, ocfg, dcfg = _p14_cfgs(preset)
        ocfg = dataclasses.replace(ocfg, **change)
        tr = _p14_trainer((cfg, ocfg, dcfg), dev, mesh,
                          steps=P14_EXTRA_STEPS)
        if still is None:
            # the control: the same steps' losses with no update at all
            with torch.no_grad():
                still = [float(collectives.all_reduce(
                    tr.model.loss(tr.batch_fn(t))[0].float().reshape(1),
                    "sum")) / tr.n_data for t in range(P14_EXTRA_STEPS)]
        with collectives.count_collectives() as calls:
            _, _, losses = tr.run()
        out["c_crcs"][what] = _crcs(torch, {"p": dict(
            tr.model.named_parameters())})
        del tr
        gap = max(abs(a - b) for a, b in zip(losses, res["losses"]))
        if not all(math.isfinite(v) for v in losses) or \
                not gap <= P14_EXTRA_LOSS_TOL:
            raise AssertionError(f"(c) {what}: losses {losses} vs (b)'s "
                                 f"{res['losses']} (bound "
                                 f"{P14_EXTRA_LOSS_TOL})")
        dtypes = sorted({str(c.dtype) for c in calls
                         if c.op == "all_reduce_sum" and c.numel > 3})
        out[what] = {"losses": losses, "gap": gap, "dtypes": dtypes}
        _rank_log(rank, f"  (c) {what}: losses "
                  f"{', '.join(f'{v:.4f}' for v in losses)}, within "
                  f"{gap:.2e} of (b)'s (bound {P14_EXTRA_LOSS_TOL}); "
                  f"gradients reduced as {dtypes}")
    still_gap = max(abs(a - b) for a, b in zip(still, res["losses"]))
    if not still_gap > P14_EXTRA_LOSS_TOL:
        raise AssertionError(f"(c) the losses with no update, {still}, lie "
                             f"within {P14_EXTRA_LOSS_TOL} of (b)'s: the gate "
                             f"cannot tell a broken update")
    out["still_gap"] = still_gap
    _rank_log(rank, f"  (c) the control, the same steps with no update: "
              f"losses {', '.join(f'{v:.4f}' for v in still)}, "
              f"{still_gap:.2e} from (b)'s (beyond the bound "
              f"{P14_EXTRA_LOSS_TOL}, as it must be)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(100 + rank)
    x = torch.randn(1000, generator=gen, device=dev) * (10.0 ** rank / 1e3)
    exact = collectives.all_reduce(x.clone(), "sum")
    top = collectives.all_reduce(x.abs().max().reshape(1), "max")
    with collectives.count_collectives() as calls:
        q = compression.int8_psum(x)
    census = [(c.op, str(c.dtype)) for c in calls]
    if sorted(census) != [("all_reduce_max", "torch.float32"),
                          ("all_reduce_sum", "torch.int32")]:
        raise AssertionError(f"(c) int8_psum's collectives {census}")
    step = float(top) / 127.0
    err = float((q - exact).abs().max())
    if not err <= P14_PSUM_STEPS * step:
        raise AssertionError(f"(c) int8_psum error {err:.3e} > "
                             f"{P14_PSUM_STEPS} steps of {step:.3e}")
    out["psum"] = {"err": err, "step": step, "census": census}
    _rank_log(rank, f"  (c) int8_psum on the card: {census}, error "
              f"{err:.3e} = {err / step:.2f} int8 steps (bound "
              f"{P14_PSUM_STEPS})")
    return out


def _p14_async(torch, rank, mesh, dev, preset, launches):
    """(e): the async plane on the mesh, P14_ASYNC_STEPS steps, beside a
    ``Shadow`` (one process's async Muon on the same gradients)."""
    from repro_torch.kernels import ops

    cfgs = _p14_cfgs(preset, precond_every=P14_ASYNC_K, precond_async=True)
    tr = _p14_trainer(cfgs, dev, mesh, steps=P14_ASYNC_STEPS)
    begin, steps, dispatched = {}, {}, []
    real, shadow = None, None

    def counted_begin(t, key, drift=0.0):
        ops.reset_launches()
        real(t, key, drift=drift)
        _p14_sync(torch, dev)
        begin[t] = sum(ops.launch_counts().values())
        if tr.precond.last_dispatch == t:
            dispatched.append(t)
        ops.reset_launches()

    def on_metrics(t, m):
        steps[t] = sum(ops.launch_counts().values())
        shadow.step(t)

    # the run's init_state makes a new optimizer and service: wrap the
    # service's step_begin, and copy the shadow, once the run made them
    real_init = tr.init_state

    def init_state(seed=None):
        nonlocal real, shadow
        start = real_init(seed)
        real = tr.precond.step_begin
        tr.precond.step_begin = counted_begin
        shadow = Shadow(torch, tr)
        return start
    tr.init_state = init_state
    tr.run(on_metrics=on_metrics)
    want_at = [0, P14_ASYNC_K]
    per = sum(PER_STEP["prism5"].values())
    if dispatched != want_at or shadow.dispatched != want_at:
        raise AssertionError(f"(e) dispatched at {dispatched}, one "
                             f"process at {shadow.dispatched}, want "
                             f"{want_at}")
    if launches and ([begin[t] for t in want_at] != [per, per]
                     or any(steps.values())
                     or any(begin[t] for t in begin if t not in want_at)):
        raise AssertionError(f"(e) launches in step_begin {begin}, in the "
                             f"steps {steps}")
    over, worst = shadow.gap(torch)
    if not over <= P14_POLAR_TOL:
        raise AssertionError(f"(e) the final state differs from one "
                             f"process's by {worst:.3e} (bound "
                             f"{P14_POLAR_TOL} + {P14_POLAR_TOL}|x|)")
    final = _crcs(torch, {"p": {k: p for k, p in
                                tr.model.named_parameters()}})
    _rank_log(rank, f"  (e) async plane on the mesh: dispatched at "
              f"{dispatched} on rank 0 (one process on the same gradients: "
              f"{shadow.dispatched}), step_begin launched "
              f"{[begin[t] for t in sorted(begin)]}, the steps "
              f"{[steps[t] for t in sorted(steps)]}; final parameters and "
              f"caches within {worst:.3e} of one process's async run on the "
              f"same gradients (bound {P14_POLAR_TOL} + "
              f"{P14_POLAR_TOL}|x|)")
    del tr, shadow
    return {"dispatched": dispatched, "async_final": final,
            "async_begin": begin, "async_steps": steps}



# ------------------------------------------------------------------ phase 15

P15_WORLD = 4            # ranks sharing the one card
P15_MESH = (2, 2)        # (data, model)
# steps of (a) and (b), cut for the script's clock (CHANGES.md): 3 -> 1
# and 2 -> 1
P15_STEPS = 1            # (a): tp, a checkpoint at the last
P15_RESUME_STEPS = 1     # (b): zero, resumed from (a)'s checkpoint
P15_LOSS_TOL = 1e-4      # the world's losses against one process's
P15_TIMEOUT_S = 300      # a collective that waits longer fails the rank
P15_DEADLINE_S = 600     # the whole world
P15_WRAPPED = ("matmul_add", "gram", "warm_tail", "sketch_traces",
               "residual_chain", "apply_g")
# K1/K2 at phase 15's shapes, checked and timed in phase 3: gpt2-paper's
# buckets ([40, 1024, 1024] wq/wk/wv/wo, [20, 4096, 1024] the mlp) as (a)'s
# engine shares them over the data axis, and as (b)'s local reshard splits
# their slices over the model axis and their rows over the data axis
P15_BUCKETS = {(1024, 1024): ("wq/wk/wv/wo", 40),
               (4096, 1024): ("w_up/w_down", 20)}
P15_SHAPES = bucket_shapes(
    {v: B // P15_MESH[0] for v, (_, B) in P15_BUCKETS.items()},
    {v: f"(a) {w}" for v, (w, _) in P15_BUCKETS.items()}) + [
    entry for (m, n), (w, B) in P15_BUCKETS.items()
    for blk in [(B // P15_MESH[1], m // P15_MESH[0], n)]
    for entry in [("gram_upper", blk, None, False, f"(b) {w}: {PARTIAL}"),
                  ("matmul_add", blk, (blk[0], n, n), True,
                   f"(b) {w}: Horner")]]

# K1 at (c)'s and (d)'s share of Shampoo's [100, 1024, 1024] factor bucket
# (each data rank's half, ``shampoo_shares``), checked and timed in phase 3
P15_SHAMPOO_SHAPES = [("matmul_add", (100 // P15_MESH[0], 1024, 1024),
                       (100 // P15_MESH[0], 1024, 1024), True,
                       "(c)/(d) Shampoo's factor share: Horner")]


def phase15(torch, preset="full", device="cuda", launches=True):
    """Phase 15 (see the module docstring) in a temporary build/phase15_*
    directory, removed at the end; returns rank 0's launch counts of (a)
    and (b).  ``preset``/``device``/``launches`` let it rehearse on the
    CPU."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase15_", dir=base_dir))
    try:
        return _phase15(torch, work, preset, device, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _p15_cfgs(preset, optimizer="muon", prism="prism5", **kw):
    """gpt2-paper's ``optimizer`` experiment with the PRISM configuration
    ``prism`` (a key of ``train_lm.PRISM``) at fp32 compute (the gates
    against one process: bf16 activations round differently at each row
    count)."""
    import dataclasses

    from repro_torch.launch import train_lm

    cfg, ocfg, dcfg = train_lm.configs(preset, "prism", "float32", 0, prism,
                                       optimizer)
    cfg = cfg.replace(dtype="float32", emb_dtype="float32")
    return cfg, dataclasses.replace(ocfg, **kw), dcfg


def _p15_trainer(cfgs, device, mesh=None, strategy="tp", **tkw):
    """A Trainer of ``cfgs`` (seed 0), on the mesh's blocks under
    ``strategy`` when a mesh is given."""
    from repro_torch.config import TrainConfig
    from repro_torch.launch import sharding
    from repro_torch.models import Model
    from repro_torch.models.transformer import param_specs
    from repro_torch.train import Trainer

    cfg, ocfg, dcfg = cfgs
    tkw.setdefault("log_every", 1)
    shards = None
    if mesh is not None:
        specs = param_specs(cfg)
        shards = {"params": sharding.tree_shardings(
            mesh, {k: a for k, (_, a, _) in specs.items()},
            sharding.param_rules(cfg, mesh, strategy),
            {k: s for k, (s, _, _) in specs.items()})}
    return Trainer(Model(cfg, device=device, seed=0), ocfg,
                   TrainConfig(**tkw), dcfg, mesh=mesh, shardings=shards,
                   strategy=strategy)


@contextlib.contextmanager
def _p15_shapes():
    """Record (wrapper, operand shape) of every K1/K2/K3 wrapper call in
    the block; yields the dict of counts."""
    from repro_torch.kernels import ops

    seen: dict = {}
    real = {n: getattr(ops, n) for n in P15_WRAPPED}

    def wrap(name):
        def call(X, *a, **k):
            key = f"{name} {list(X.shape)}"
            seen[key] = seen.get(key, 0) + 1
            return real[name](X, *a, **k)
        return call

    for n in P15_WRAPPED:
        setattr(ops, n, wrap(n))
    try:
        yield seen
    finally:
        for n, f in real.items():
            setattr(ops, n, f)


def _p15_by_kind(calls, steps):
    """{kind: [calls, bytes, ms]} a step of a census, without the gates'
    own gathers (kind "gate")."""
    out = {}
    for c in calls:
        if c.kind == "gate":
            continue
        k = out.setdefault(c.kind or "other", [0, 0, 0.0])
        k[0] += 1
        k[1] += c.nbytes
        k[2] += c.ms
    return {k: [v[0] / steps, v[1] / steps, v[2] / steps]
            for k, v in sorted(out.items())}


def _p15_kind_note(by):
    return "; ".join(f"{k} {v[0]:g} calls, {v[1]:.0f} B, {v[2]:.1f} ms"
                     for k, v in by.items())


def _phase15(torch, work, preset, device, launches):
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import latest_step

    cuda = torch.device(device).type == "cuda"
    if cuda:
        free_card(torch, "phase 15")
    card = _card_line()
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _phase15_rank, args=(P15_WORLD, str(work), preset, device,
                             launches),
        nprocs=P15_WORLD, start_method="spawn", join=False)
    deadline = time.monotonic() + P15_DEADLINE_S
    # (a)'s reference, while the ranks start: one process's losses and
    # step-0 Muon update, handed to the ranks through files
    t1 = time.perf_counter()
    try:
        tr = _p15_trainer(_p15_cfgs(preset), device, steps=P15_STEPS)
        ref_losses, upd = _p14_step0_update(torch, tr)
        muon = _muon_leaves(tr)
        torch.save({k: v.cpu() for k, v in upd.items() if k in muon},
                   work / "ref_update.pt")
        (work / "ref.json.tmp").write_text(json.dumps(ref_losses))
        (work / "ref.json.tmp").rename(work / "ref.json")
        del tr, upd
        ref_c, ref_d = _p15_shampoo_refs(torch, work, preset, device)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    if cuda:
        free_card(torch, "(a)'s reference done")
    log(f"  one process ((a)'s, (c)'s and (d)'s references at fp32 "
        f"compute, beside the ranks' start) in "
        f"{time.perf_counter() - t1:.1f} s; losses (a) "
        f"{', '.join(f'{v:.5f}' for v in ref_losses)}, (c) Shampoo PRISM-5 "
        f"{', '.join(f'{v:.5f}' for v in ref_c)}, (d) fitted Shampoo "
        f"{', '.join(f'{v:.5f}' for v in ref_d)}")
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"phase 15: the world of {P15_WORLD} ranks did not "
                     f"finish in {P15_DEADLINE_S} s")
    except Exception as e:  # a rank raised or died: the phase fails
        for r in range(P15_WORLD):
            err = work / f"rank{r}.err"
            if err.exists():
                log(f"  rank {r} raised:\n{err.read_text()}")
        fail(f"phase 15: a rank failed: {type(e).__name__}: "
             f"{str(e).splitlines()[0] if str(e) else ''}")
    world_s = time.perf_counter() - t0
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(P15_WORLD)]
    log(f"  the world of {P15_WORLD} ranks (spawned, gloo, mesh (data, "
        f"model) = {P15_MESH}) ran in {world_s:.1f} s, (a)'s reference "
        f"beside its start ({card})")
    for r, rr in enumerate(res):
        log(f"  rank {r} {rr['coords']}: (a) tp step {rr['a_step_ms']:.1f} "
            f"ms, (b) zero step {rr['b_step_ms']:.1f} ms; "
            f"max_memory_allocated {rr['peak_gib']:.2f} GiB ({card})")
    # (a): the leaves replicated over data, equal on the two data ranks
    for r, rr in enumerate(res):
        other = res[r ^ P15_MESH[1]]  # the same model coordinate
        if rr["coords"]["model"] != other["coords"]["model"] or \
                rr["replicated"] != other["replicated"]:
            fail(f"phase 15 (a): ranks {r} and {r ^ P15_MESH[1]} disagree "
                 f"on the leaves replicated over data")
    if any(rr[k] != res[0][k] for rr in res
           for k in ("a_losses", "b_losses", "c_losses", "d_losses")):
        fail("phase 15: the ranks' losses differ")
    # (e): every host decision of the refresh plane alike on every rank
    want_tele = {"refreshes": 2, "bootstrap": 1, "clock_triggered": 1,
                 "drift_triggered": 0, "discarded": 0, "retries": 0,
                 "degraded": 0}
    for r, rr in enumerate(res):
        if rr["e_telemetry"] != want_tele or \
                rr["e_drift"] != res[0]["e_drift"] or \
                rr["e_nan"] != res[0]["e_nan"] or \
                rr["e_nan"]["discarded"] != 1:
            fail(f"phase 15 (e): rank {r} telemetry {rr['e_telemetry']} "
                 f"(want {want_tele}), drift {rr['e_drift']} (rank 0 "
                 f"{res[0]['e_drift']}), after the NaN {rr['e_nan']}")
    log(f"  (e) every rank: telemetry {want_tele}, the drift it read at "
        f"each step {res[0]['e_drift']} (identical on the {P15_WORLD} "
        f"ranks), the planted NaN discarded on every rank "
        f"({res[0]['e_nan']})")
    for r, rr in enumerate(res):
        log(f"  rank {r}: (c) {rr['c_step_ms']:.1f} ms, (d) "
            f"{rr['d_step_ms']:.1f} ms, (e) {rr['e_step_ms']:.1f} ms a step; "
            f"peaks (c) {rr['c_peak_gib']:.2f}, (d) {rr['d_peak_gib']:.2f}, "
            f"(e) {rr['e_peak_gib']:.2f} GiB, (e)'s optimizer step "
            f"{rr['e_transient_mib']:.1f} MiB above its start; cache bytes "
            f"(c) {rr['c_cache'][0]} of {rr['c_cache'][2]}, (d) "
            f"{rr['d_cache'][0]} of {rr['d_cache'][2]}, (e) "
            f"{rr['e_cache'][0]} of {rr['e_cache'][2]} ({card})")
    log(f"  (a) leaves replicated over data "
        f"({', '.join(sorted(res[0]['replicated'][0]))}): crc32-equal on "
        f"both data ranks after each of {len(res[0]['replicated'])} steps")
    # (b)'s reference: one process resumes the world's checkpoint
    ck = work / "ckpt"
    if latest_step(str(ck)) != P15_STEPS:
        fail(f"phase 15: the world's checkpoint is at step "
             f"{latest_step(str(ck))}, not {P15_STEPS}")
    cfgs_b = _p15_cfgs(preset, muon_local_reshard=True)
    tr = _p15_trainer(cfgs_b, device, steps=P15_STEPS + P15_RESUME_STEPS,
                      checkpoint_dir=str(ck), checkpoint_every=0)
    _, _, one_b = tr.run()
    del tr
    b = res[0]["b_losses"]
    gaps = [abs(x - y) for x, y in zip(b, one_b)]
    if not all(math.isfinite(v) for v in b) or \
            not max(gaps) <= P15_LOSS_TOL:
        fail(f"phase 15 (b): losses {b} against one process resuming the "
             f"same checkpoint {one_b} (bound {P15_LOSS_TOL})")
    log(f"  (b) one process resuming the world's step-{P15_STEPS} "
        f"checkpoint: losses {', '.join(f'{v:.5f}' for v in one_b)}; the "
        f"world's within {max(gaps):.2e} (bound {P15_LOSS_TOL}) ({card})")
    _p15_one_restore(torch, work, preset, device)
    out = {"tp": res[0]["a_counts"], "zero": res[0]["b_counts"]}
    out.update({path: res[0][f"{k}_counts"]
                for k, path in P15_NEW_PATHS.items()})
    return out


def _p15_unlike_manifest(crcs, manifest):
    """The leaves of a restored state whose crc32 is not the MANIFEST's:
    every leaf but the pending twins (never written) and ``pending_at``,
    which a restore clears (the refresh in flight at the checkpoint is
    never swapped in)."""
    from repro_torch.optim import base

    kept = {k: v for k, v in crcs.items() if k != "opt|pending_at"
            and not set(k.split("|")) & set(base.PENDING_STATE_KEYS)}
    want = {k: v for k, v in manifest.items() if k != "opt|pending_at"}
    return sorted(k for k in set(kept) | set(want)
                  if kept.get(k) != want.get(k))


def _p15_one_restore(torch, work, preset, device):
    """(f)'s second half: one process restores (e)'s checkpoint, every
    leaf crc32-equal to the MANIFEST."""
    from repro_torch.optim import base

    ck = work / "ckpt_e"
    manifest = json.loads((ck / f"step_{P15_ASYNC_STEPS:08d}" /
                           "MANIFEST").read_text())["crc32"]
    cfgs = _p15_cfgs(preset, precond_every=P15_ASYNC_K, precond_async=True)
    tr = _p15_trainer(cfgs, device, steps=P15_ASYNC_STEPS,
                      checkpoint_dir=str(ck), checkpoint_every=0)
    start = tr.restore_or_init()
    bad = _p15_unlike_manifest(_crcs(torch, tr.state_tree()), manifest)
    pending = tr.opt.pending_host
    del tr
    if start != P15_ASYNC_STEPS or bad or pending != base.NO_PENDING:
        fail(f"phase 15 (f): one process restored (e)'s checkpoint at "
             f"{start}, pending_at {pending}; leaves differ from the "
             f"MANIFEST: {bad[:5]}")
    log(f"  (f) one process restores (e)'s checkpoint: every leaf "
        f"crc32-equal to the MANIFEST ({len(manifest)} leaves), the refresh "
        f"in flight at step {P15_ASYNC_STEPS - 1} cleared")


def _phase15_rank(rank, world, work, preset, device, launches):
    """One rank of phase 15: (a) and (b); writes rank<r>.json, or
    rank<r>.err with the traceback when it raises."""
    import traceback

    work = Path(work)
    try:
        res = _p15_rank_body(rank, world, work, preset, device, launches)
        (work / f"rank{rank}.json").write_text(json.dumps(res))
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _p15_rank_body(rank, world, work, preset, device, launches):
    import torch

    from repro_torch import collectives
    from repro_torch.launch import mesh as lmesh

    dev = lmesh.init_world(rank, world, f"file://{work}/store",
                           device=device, timeout_s=P15_TIMEOUT_S)
    try:
        mesh = lmesh.make_debug_mesh(*P15_MESH)
        card = _card_line() if dev.type == "cuda" else "cpu"
        res = {"backend": lmesh.world_backend(), "coords": mesh.coords()}
        _rank_log(rank, f"  rank 0: backend {res['backend']}, device {dev}, "
                  f"mesh {mesh!r}, {card}")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res.update(_p15_tp(torch, rank, mesh, dev, work, preset, launches))
        res.update(_p15_zero(torch, rank, mesh, dev, work, preset,
                             launches, res["a_shapes"]))
        res["peak_gib"] = _p15_peak(torch, dev)
        res.update(_p15_shampoo(torch, rank, mesh, dev, work, preset,
                                launches))
        res.update(_p15_fitted(torch, rank, mesh, dev, work, preset,
                               launches))
        res.update(_p15_async(torch, rank, mesh, dev, work, preset,
                              launches))
        res.update(_p15_restore(torch, rank, mesh, dev, work, preset))
        collectives.barrier()
        return res
    finally:
        lmesh.close_world()


def _p15_steps(torch, tr, dev, on_step=None):
    """Run ``tr`` with the launches of each step counted (from their
    difference) and every collective and K1/K2/K3 wrapper call recorded;
    returns (losses, per-step launches, census, shapes, step-0 update,
    each step's aux loss)."""
    from repro_torch import collectives
    from repro_torch.kernels import ops

    per_step, last, aux = [], [None], []
    # each step from its batch to its loss on the host (``run_step_ms``: a
    # run of one step has nothing on the Trainer's clock, which leaves out
    # the run's first)
    batch_fn, starts = tr.batch_fn, []
    tr.step_walls = []

    def batch_at(t):
        starts.append(time.perf_counter())
        return batch_fn(t)

    def on_metrics(t, m):
        tr.step_walls.append(time.perf_counter() - starts[-1])
        now = ops.launch_counts()
        per_step.append({k: now[k] - last[0][k] for k in now})
        last[0] = now
        aux.append(m["aux"])
        if on_step is not None:
            on_step(t)

    ops.reset_launches()
    last[0] = ops.launch_counts()
    tr.batch_fn = batch_at
    try:
        with collectives.count_collectives() as calls, \
                _p15_shapes() as shapes:
            losses, upd = _p14_step0_update(torch, tr, on_metrics)
    finally:
        tr.batch_fn = batch_fn
    _p14_sync(torch, dev)
    return losses, per_step, list(calls), shapes, upd, \
        [float(torch.as_tensor(a)) for a in aux]


def run_step_ms(tr):
    """A sub-run's step ms on this rank: the median of the Trainer's clock
    (the steps after the run's first), or in a run of one step that step
    from its batch to its loss (``_p15_steps``; its warm-up included)."""
    return statistics.median(tr.step_times or tr.step_walls) * 1e3


def _step_note(tr):
    return (f"median of steps 1..{len(tr.step_times)}" if tr.step_times
            else "its one step, warm-up included")


def _p15_reference(work):
    """(a)'s reference losses, once the main process has written them."""
    ref = work / "ref.json"
    deadline = time.monotonic() + P15_TIMEOUT_S
    while not ref.exists():
        if time.monotonic() > deadline:
            raise AssertionError(f"no reference losses in {P15_TIMEOUT_S} s")
        time.sleep(0.2)
    return json.loads(ref.read_text())


def _p15_tp(torch, rank, mesh, dev, work, preset, launches):
    """(a): "tp" on the mesh, P15_STEPS steps, a checkpoint at the last."""
    from repro_torch.launch import sharding

    cfgs = _p15_cfgs(preset)
    tr = _p15_trainer(cfgs, dev, mesh, "tp", steps=P15_STEPS,
                      checkpoint_dir=str(work / "ckpt"),
                      checkpoint_every=P15_STEPS)
    lay = tr.model.layout
    rep = [k for k, sh in lay.shardings.items()
           if "data" not in sharding.sharded_axes(sh)]
    replicated = []

    def on_step(t):
        named = dict(tr.model.named_parameters())
        replicated.append(_crcs(torch, {k: named[k] for k in rep}))

    losses, per_step, calls, shapes, upd, _ = _p15_steps(torch, tr, dev,
                                                         on_step)
    for t, c in enumerate(per_step):
        _p14_expect(rank, c, "prism5", f"phase 15 (a) step {t}", launches)
    ref_losses = _p15_reference(work)
    gaps = [abs(a - b) for a, b in zip(losses, ref_losses)]
    if not all(math.isfinite(v) for v in losses) or \
            not max(gaps) <= P15_LOSS_TOL:
        raise AssertionError(f"(a) losses {losses} vs one process's "
                             f"{ref_losses} (bound {P15_LOSS_TOL})")
    # the step-0 Muon update, gathered whole, against one process's
    names = _muon_leaves(tr)
    whole = {k: sharding.gather_full(v, lay.shardings[k])
             for k, v in upd.items() if k in names}
    worst = math.nan  # rank 0 holds the update against one process's
    if rank == 0:
        ref = torch.load(work / "ref_update.pt", map_location=dev)
        worst = _worst_gap(torch, whole, ref, "", gate=False)
        del ref
        if not worst <= UPDATE_REL_TOL:
            raise AssertionError(f"(a) the step-0 Muon update differs from "
                                 f"one process's by {worst:.3e} of its "
                                 f"largest entry (bound {UPDATE_REL_TOL})")
    del whole, upd
    steps = len(losses)
    by = _p15_by_kind(calls, steps)
    seq, batch = tr.dcfg.seq_len, tr.dcfg.global_batch
    a_ms = run_step_ms(tr)
    _rank_log(rank, f"  (a) tp, {batch // lay.batch_size} rows a data rank, "
              f"seq {seq}: losses {', '.join(f'{v:.5f}' for v in losses)} "
              f"(one process: largest gap {max(gaps):.2e}, bound "
              f"{P15_LOSS_TOL}); the step-0 Muon update within {worst:.3e} "
              f"of one process's (bound {UPDATE_REL_TOL})")
    _rank_log(rank, f"  (a) launches a step on rank 0: "
              f"{sum(per_step[0].values())} ({per_step[0]}); K1/K2/K3 calls "
              f"by shape over {steps} steps: {shapes}")
    _rank_log(rank, f"  (a) step {a_ms:.1f} ms on rank 0 ({_step_note(tr)}), "
              f"{seq * batch / (a_ms / 1e3):.0f} "
              f"tokens/s over the world; collectives a step on rank 0 by "
              f"kind: {_p15_kind_note(by)}")
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    del tr
    return {"a_losses": losses, "a_counts": total, "a_step_ms": a_ms,
            "a_by_kind": by, "replicated": replicated, "a_shapes": shapes}


def _row_blocks(shapes):
    """The K2 calls of (a)'s ``shapes`` (over P15_STEPS steps) with their
    rows (the long side) halved, over P15_RESUME_STEPS steps: (b)'s
    blocks of (a)'s slices, whose batch the model axis halves as (a)'s
    engine halved it over the data axis."""
    out = {}
    for k, v in shapes.items():
        if k.startswith("gram "):
            b, m, n = json.loads(k[len("gram "):])
            out[f"gram {[b, m // P15_MESH[0], n]}"] = \
                v // P15_STEPS * P15_RESUME_STEPS
    return out


def _p15_zero(torch, rank, mesh, dev, work, preset, launches, a_shapes):
    """(b): resume (a)'s checkpoint under "zero" with the local reshard,
    P15_RESUME_STEPS steps."""
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.optim import base

    cfgs = _p15_cfgs(preset, muon_local_reshard=True)
    ckpt_dir = work / "ckpt"
    tr = _p15_trainer(cfgs, dev, mesh, "zero",
                      steps=P15_STEPS + P15_RESUME_STEPS,
                      checkpoint_dir=str(ckpt_dir), checkpoint_every=0)
    manifest = json.loads((ckpt_dir / f"step_{P15_STEPS:08d}" /
                           "MANIFEST").read_text())["crc32"]
    restored = {}
    real_restore = tr.restore_or_init

    def restore_or_init(seed=None):
        start = real_restore(seed)
        tree = tr.gathered_state_tree()
        if rank == 0:
            restored.update(_crcs(torch, tree))
        del tree
        return start
    tr.restore_or_init = restore_or_init
    losses, per_step, calls, shapes, _, _ = _p15_steps(torch, tr, dev)
    if rank == 0:
        kept = {k: v for k, v in restored.items()
                if not set(k.split("|")) & set(base.PENDING_STATE_KEYS)}
        if kept != manifest:
            bad = sorted(k for k in set(kept) | set(manifest)
                         if kept.get(k) != manifest.get(k))
            raise AssertionError(f"(b) restored leaves differ from the "
                                 f"checkpoint's crc32: {bad[:5]}")
    for t, c in enumerate(per_step):
        _p14_expect(rank, c, "prism5", f"phase 15 (b) step {t}", launches)
    steps = len(losses)
    grams = [c for c in calls if c.kind == "gram"]
    k2 = sum(v for k, v in shapes.items() if k.startswith("gram "))
    if len(grams) != k2:
        raise AssertionError(f"(b) {len(grams)} Gram all-reduces for {k2} "
                             f"K2 calls: one a grid-tier iteration and "
                             f"bucket expected")
    k2_shapes = {k: v for k, v in shapes.items() if k.startswith("gram ")}
    if launches and k2_shapes != _row_blocks(a_shapes):
        raise AssertionError(f"(b) K2 calls {k2_shapes}, want the row "
                             f"blocks {_row_blocks(a_shapes)}")
    by = _p15_by_kind(calls, steps)
    b_ms = run_step_ms(tr)
    seq, batch = tr.dcfg.seq_len, tr.dcfg.global_batch
    _rank_log(rank, f"  (b) zero + muon_local_reshard, resumed at step "
              f"{tr.opt.count - steps}: restored leaves gathered whole "
              f"crc32-equal to the checkpoint's MANIFEST "
              f"({len(manifest)} leaves); losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}")
    _rank_log(rank, f"  (b) launches a step on rank 0: "
              f"{sum(per_step[0].values())}; K1/K2/K3 calls by shape over "
              f"{steps} steps (K2 on row blocks): {shapes}; Gram "
              f"all-reduces {len(grams) / steps:g} a step, "
              f"{sorted({c.nbytes for c in grams})} bytes each")
    _rank_log(rank, f"  (b) step {b_ms:.1f} ms on rank 0 ({_step_note(tr)}), "
              f"{seq * batch / (b_ms / 1e3):.0f} tokens/s over the world; "
              f"collectives a step on rank 0 by kind: {_p15_kind_note(by)}")
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    del tr
    return {"b_losses": losses, "b_counts": total, "b_step_ms": b_ms,
            "b_by_kind": by, "b_shapes": shapes}


# (c)-(f): Shampoo and the §12 async plane on the same world
# steps of the sub-runs, cut for the script's clock (CHANGES.md): (c) 3 -> 2
# -> 1, (d) 2 -> 1, (e) 7 -> 6 -> 3 with the clock at 2 (its checkpoint
# then holds the refresh dispatched at step 2)
P15_SHAMPOO_STEPS = 1    # (c): Shampoo PRISM-5 under "tp"
P15_FITTED_STEPS = 1     # (d): fitted Shampoo under "zero"
P15_ASYNC_STEPS = 3      # (e): async Muon, bootstrap at 0, the clock at 2
P15_ASYNC_K = 2
P15_NAN_RANK = 1         # (e): the rank whose pending block gets the NaN
P15_CACHE_KEYS = ("ortho", "Linv", "Rinv", "ortho_p", "Linv_p", "Rinv_p")
# the kernels line's paths of the new sub-runs (rank 0's launches)
P15_NEW_PATHS = {"c": "model_axis_shampoo_rank0",
                 "d": "model_axis_fitted_rank0",
                 "e": "model_axis_async_rank0"}


def _p15_wait(work, name):
    """The file ``name`` the main process writes for the ranks, once it
    is there."""
    path = work / name
    deadline = time.monotonic() + P15_TIMEOUT_S
    while not path.exists():
        if time.monotonic() > deadline:
            raise AssertionError(f"no {name} in {P15_TIMEOUT_S} s")
        time.sleep(0.2)
    return path


def _p15_publish(torch, work, tag, losses, upd, names):
    """Hand one process's losses and step-0 update of ``names`` to the
    ranks: ``ref_<tag>*`` files, the json last."""
    torch.save({k: v.cpu() for k, v in upd.items() if k in names},
               work / f"ref_{tag}_update.pt")
    (work / f"ref_{tag}.json.tmp").write_text(json.dumps(losses))
    (work / f"ref_{tag}.json.tmp").rename(work / f"ref_{tag}.json")


def _shampoo_leaves(tr):
    """The parameters Shampoo preconditions (a factor or a diagonal)."""
    named = dict(tr.model.named_parameters())
    return sorted(k for k, p in named.items()
                  if "L" in tr.opt.state[p] or "diagL" in tr.opt.state[p])


def _p15_shampoo_refs(torch, work, preset, device):
    """(c)'s and (d)'s references: one process's Shampoo Trainer runs."""
    tr = _p15_trainer(_p15_cfgs(preset, "shampoo", "prism5"), device,
                      steps=P15_SHAMPOO_STEPS)
    losses, upd = _p14_step0_update(torch, tr)
    _p15_publish(torch, work, "c", losses, upd, _shampoo_leaves(tr))
    del tr, upd
    tr = _p15_trainer(_p15_cfgs(preset, "shampoo", "fig5"), device,
                      steps=P15_FITTED_STEPS)
    fl, upd = _p14_step0_update(torch, tr)
    _p15_publish(torch, work, "d", fl, upd, _shampoo_leaves(tr))
    del tr, upd
    return losses, fl


def shampoo_shares(cfg, ocfg, parts=P15_MESH[0]):
    """{(n, n): slices} of each data rank's share of Shampoo's inverse-root
    buckets of ``cfg`` (every factor side no longer than
    ``max_precond_dim``, bucketed by shape, the batch split over
    ``parts`` ranks), and the sides the fused tier takes."""
    import torch

    from repro_torch.models.transformer import param_specs
    from repro_torch.optim import base, bucketing

    sides = []
    for shape, axes, _ in param_specs(cfg).values():
        if not base.is_matrix_param(axes, tuple(shape)):
            continue
        v = base.to_matrix_view(torch.empty(shape, device="meta"),
                                axes)[0].shape
        sides += [tuple(v[:-2]) + (k, k) for k in v[-2:]
                  if k <= ocfg.max_precond_dim]
    shares, fused = {}, set()
    for b in bucketing.plan_buckets(sides):
        shares[b.shape] = b.size // parts
        if bucketing.resolve_fused_tier(ocfg.resolved_prism, b).fuse == "on":
            fused.add(b.shape)
    return shares, fused


def shampoo_calls(cfg, ocfg, path, steps):
    """The wrapper calls by shape (``_p15_shapes``' keys) a rank makes in
    ``steps`` Shampoo steps of ``path``: each launch of ``PER_STEP[path]``
    on its data share of the bucket that takes it (K1 and K5 the grid
    tier's factor bucket; K3, K6 and K7 once a fused bucket each)."""
    shares, fused = shampoo_shares(cfg, ocfg)
    grid = [s for s in shares if s not in fused]
    per = PER_STEP[path]
    wrapper = {"matmul_add": "matmul_add", "warm_tail": "warm_tail",
               "sketch_chain": "sketch_traces",
               "residual_chain": "residual_chain", "apply_g": "apply_g"}
    out = {}
    for kernel, count in per.items():
        on = grid if kernel in ("matmul_add", "sketch_chain") else \
            sorted(fused)
        for n, _ in on:
            key = f"{wrapper[kernel]} {[shares[n, n], n, n]}"
            out[key] = count // len(on) * steps
    return out


def _p15_cache_bytes(torch, tr):
    """(this rank's bytes of the cached preconditioners and their twins,
    the bytes of their ``precond_cache_sharding`` blocks computed from
    the whole caches' shapes, the whole caches' bytes)."""
    from repro_torch.launch import sharding
    from repro_torch.optim import base

    lay = tr.model.layout
    axes = tr.model.logical_axes()
    mine = want = whole = 0
    for k, p in tr.model.named_parameters():
        full = sharding.full_shape(tuple(p.shape), lay.shardings[k])
        view = tuple(base.to_matrix_view(torch.empty(full, device="meta"),
                                         axes[k])[0].shape)
        for sk, v in tr.opt.state[p].items():
            if sk not in P15_CACHE_KEYS:
                continue
            shape = view if sk.startswith("ortho") else view[:-2] + (
                (view[-2],) * 2 if sk.startswith("L") else (view[-1],) * 2)
            sh = sharding.precond_cache_sharding(lay.mesh, shape)
            item = v.element_size()
            mine += v.numel() * item
            want += math.prod(sharding.local_shape(shape, sh)) * item
            whole += math.prod(shape) * item
    return mine, want, whole


def _p15_note(rank, what, tr, by, peak, cache):
    """Log a sub-run's step time, tokens/s over the world, collectives a
    step by kind, peak memory and cache bytes (rank 0)."""
    ms = run_step_ms(tr)
    seq, batch = tr.dcfg.seq_len, tr.dcfg.global_batch
    mine, _, whole = cache
    _rank_log(rank, f"  {what} step {ms:.1f} ms on rank 0 ({_step_note(tr)}), "
              f"{seq * batch / (ms / 1e3):.0f} tokens/s over the world; "
              f"max_memory_allocated {peak:.2f} GiB; cached preconditioners "
              f"{mine} B on the rank of {whole} B whole; collectives a step "
              f"by kind: {_p15_kind_note(by)}")
    return ms


def _p15_peak(torch, dev):
    """max_memory_allocated since the last call, GiB (0 off the card)."""
    if dev.type != "cuda":
        return 0.0
    peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    return peak


def _p15_grads0(torch, tr, names=None):
    """An ``on_step`` hook that keeps the world's step-0 gradients (the
    reduced, clipped ones the optimizer read) of ``names`` (default:
    every parameter), gathered whole (collective: every rank gathers;
    rank 0 keeps them)."""
    from repro_torch import collectives
    from repro_torch.launch import sharding

    lay = tr.model.layout
    kept = {}

    def on_step(t):
        if t != 0:
            return
        for k, p in tr.model.named_parameters():
            if names is not None and k not in names:
                continue
            g = sharding.gather_full(p.grad, lay.shardings[k], kind="gate")
            if collectives.rank(None) == 0:
                kept[k] = g
    return kept, on_step


class ShareNorms:
    """Inside a ``with`` block, every per-slice Frobenius norm of the
    matrix functions (``newton_schulz._fro``, in each module that took
    it) over a batch of B > 1 slices is computed as the §8 engine's
    ``parts`` data ranks compute it: on each rank's contiguous share of
    ceil(B / parts) slices.  On the card torch sums a [B, n, n] batch's
    slices in an order that depends on B, so a whole bucket's norms and
    its shares' differ in the last bit; nothing else of the program is
    changed.  Records how many slices' norms differ (``differ`` of
    ``slices``) and by how much at most (``max_rel``)."""

    MODULES = ("newton_schulz", "inverse_newton", "polar_express",
               "lowrank", "newton")

    def __init__(self, parts):
        self.parts = parts
        self.differ = self.slices = 0
        self.max_rel = 0.0

    def __enter__(self):
        import importlib

        import torch

        from repro_torch.core import newton_schulz

        real = self.real = newton_schulz._fro
        self.mods = [m for m in (importlib.import_module(
            f"repro_torch.core.{name}") for name in self.MODULES)
            if getattr(m, "_fro", None) is real]

        def fro(M):
            whole = real(M)
            B = M.shape[0] if M.dim() >= 3 else 1
            if B < 2:
                return whole
            per = -(-B // self.parts)
            pad = per * self.parts - B
            X = torch.cat([M, M.new_zeros((pad,) + tuple(M.shape[1:]))]) \
                if pad else M
            shares = torch.cat([real(c) for c in X.split(per)])[:B]
            self.slices += B
            self.differ += int((shares != whole).sum())
            self.max_rel = max(self.max_rel, float(
                ((shares - whole).abs() / whole.abs().clamp(min=1e-30))
                .max()))
            return shares
        for m in self.mods:
            m._fro = fro
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m._fro = self.real


def _p15_gate_update(torch, rank, tr, cfgs, dev, upd, grads0, work, tag,
                     what, alphas=None):
    """The step-0 update of the preconditioned leaves, gathered whole
    (collective), against one process's optimizer (rank 0): a fresh one
    over seed 0's whole parameters stepped once on the world's step-0
    gradients (``grads0``), on whole buckets.  The gate: within
    UPDATE_REL_TOL of its largest entry when that process takes each
    slice's Frobenius norm as the data ranks do, on their shares of the
    bucket (``ShareNorms``).  Printed: the gap with the process's own
    norms, with ``alphas`` (the world's fitted alphas, gathered over
    data) replayed, and to one process's Trainer (its own gradients).
    Returns (gate gap, own-norms gap, Trainer gap, the ShareNorms)."""
    from repro_torch.core.rng import Key
    from repro_torch.launch import sharding
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer

    lay = tr.model.layout
    names = _shampoo_leaves(tr)
    whole = {k: sharding.gather_full(v, lay.shardings[k], kind="gate")
             for k, v in upd.items() if k in names}
    if rank != 0:
        return math.nan, math.nan, math.nan, None
    cfg, ocfg, _ = cfgs
    model = Model(cfg, device=dev, seed=0)
    named = list(model.named_parameters())
    before = {k: p.detach().clone() for k, p in named}

    def one_step(ctx):
        with torch.no_grad():
            for k, p in named:
                p.copy_(before[k])
        opt = make_optimizer(ocfg, named, model.logical_axes())
        for k, p in named:
            p.grad = grads0[k]
        with ctx:
            opt.step(key=Key(0).fold_in(0))
        return {k: p.detach() - before[k] for k, p in named if k in names}

    norms = ShareNorms(P15_MESH[0])
    gate = _worst_gap(torch, whole, one_step(norms), "", gate=False)
    bucket = _worst_gap(torch, whole, one_step(
        AlphaTape(replay=alphas) if alphas is not None
        else contextlib.nullcontext()), "", gate=False)
    del model, before, named
    grads0.clear()
    _p15_wait(work, f"ref_{tag}.json")
    ref = torch.load(work / f"ref_{tag}_update.pt", map_location=dev)
    trainer = _worst_gap(torch, whole, ref, "", gate=False)
    if not gate <= UPDATE_REL_TOL:
        raise AssertionError(f"{what} the step-0 Shampoo update differs "
                             f"from one process's on the same gradients "
                             f"with the shares' norms by {gate:.3e} of its "
                             f"largest entry (bound {UPDATE_REL_TOL})")
    return gate, bucket, trainer, norms


def _p15_norms_note(norms):
    """What ``ShareNorms`` saw (rank 0), for (c)'s and (d)'s lines."""
    if norms is None:
        return ""
    return (f"; per-slice norms of whole buckets against their shares': "
            f"{norms.differ} of {norms.slices} slices differ, by at most "
            f"{norms.max_rel:.3e} relative")


def _p15_cache_gate(torch, tr, what):
    """The cache bytes (``_p15_cache_bytes``): the rank's must be its
    layout's blocks."""
    cache = _p15_cache_bytes(torch, tr)
    if cache[0] != cache[1] or not cache[0]:
        raise AssertionError(f"{what} the rank holds {cache[0]} B of cached "
                             f"preconditioners, its layout's blocks are "
                             f"{cache[1]} B")
    return cache


def _p15_shampoo(torch, rank, mesh, dev, work, preset, launches):
    """(c): Shampoo PRISM-5 (phase 6's) under "tp", precondition_every 1,
    P15_SHAMPOO_STEPS steps."""
    cfgs = _p15_cfgs(preset, "shampoo", "prism5")
    _p15_peak(torch, dev)
    tr = _p15_trainer(cfgs, dev, mesh, "tp", steps=P15_SHAMPOO_STEPS)
    grads0, on_step = _p15_grads0(torch, tr)
    losses, per_step, calls, shapes, upd, _ = _p15_steps(torch, tr, dev,
                                                         on_step)
    peak = _p15_peak(torch, dev)
    for t, c in enumerate(per_step):
        _p14_expect(rank, c, "shampoo_prism5", f"phase 15 (c) step {t}",
                    launches)
    want = shampoo_calls(cfgs[0], cfgs[1], "shampoo_prism5", len(losses))
    if launches and shapes != want:
        raise AssertionError(f"(c) wrapper calls {shapes}, want {want}")
    ref = json.loads(_p15_wait(work, "ref_c.json").read_text())
    gaps = [abs(a - b) for a, b in zip(losses, ref)]
    if not all(math.isfinite(v) for v in losses) or \
            not max(gaps) <= P15_LOSS_TOL:
        raise AssertionError(f"(c) losses {losses} vs one process's {ref} "
                             f"(bound {P15_LOSS_TOL})")
    worst, bucket, trainer, norms = _p15_gate_update(
        torch, rank, tr, cfgs, dev, upd, grads0, work, "c", "(c)")
    cache = _p15_cache_gate(torch, tr, "(c)")
    by = _p15_by_kind(calls, len(losses))
    _rank_log(rank, f"  (c) Shampoo PRISM-5 under tp: losses "
              f"{', '.join(f'{v:.5f}' for v in losses)} (one process: "
              f"largest gap {max(gaps):.2e}, bound {P15_LOSS_TOL}); the "
              f"step-0 update within {worst:.3e} of one process's on the "
              f"same gradients with the shares' norms (bound "
              f"{UPDATE_REL_TOL}); printed: {bucket:.3e} of it with its own "
              f"norms, {trainer:.3e} of one process's Trainer"
              f"{_p15_norms_note(norms)}; launches a step on rank 0: "
              f"{sum(per_step[0].values())}; wrapper calls by shape over "
              f"{len(losses)} steps: {shapes}")
    step_ms = _p15_note(rank, "(c)", tr, by, peak, cache)
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    del tr, upd
    return {"c_losses": losses, "c_counts": total, "c_step_ms": step_ms,
            "c_by_kind": by, "c_peak_gib": peak, "c_cache": cache}


def _p15_fitted(torch, rank, mesh, dev, work, preset, launches):
    """(d): fitted Shampoo (phase 7's Fig. 5 preset) under "zero",
    P15_FITTED_STEPS steps; its step-0 update is gated against one
    process's on the same gradients with the world's fitted alphas
    pinned (each rank's share of every bucket's, gathered over data)."""
    from repro_torch import collectives

    cfgs = _p15_cfgs(preset, "shampoo", "fig5")
    _p15_peak(torch, dev)
    tr = _p15_trainer(cfgs, dev, mesh, "zero", steps=P15_FITTED_STEPS)
    grads0, on_step = _p15_grads0(torch, tr)
    with AlphaTape() as tape:
        losses, per_step, calls, shapes, upd, _ = _p15_steps(
            torch, tr, dev, on_step)
    peak = _p15_peak(torch, dev)
    fits = len(tape.alphas) // len(losses)
    group = mesh.group(("data",))
    alphas = [collectives.all_gather(a, group) for a in tape.alphas[:fits]]
    for t, c in enumerate(per_step):
        _p14_expect(rank, c, "shampoo_fig5", f"phase 15 (d) step {t}",
                    launches)
    want = shampoo_calls(cfgs[0], cfgs[1], "shampoo_fig5", len(losses))
    if launches and shapes != want:
        raise AssertionError(f"(d) wrapper calls {shapes}, want {want}")
    ref = json.loads(_p15_wait(work, "ref_d.json").read_text())
    gaps = [abs(a - b) for a, b in zip(losses, ref)]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"(d) losses {losses}")
    worst, bucket, trainer, norms = _p15_gate_update(
        torch, rank, tr, cfgs, dev, upd, grads0, work, "d", "(d)", alphas)
    cache = _p15_cache_gate(torch, tr, "(d)")
    by = _p15_by_kind(calls, len(losses))
    _rank_log(rank, f"  (d) fitted Shampoo under zero ({fits} alpha fits a "
              f"step, each rank on its share): losses "
              f"{', '.join(f'{v:.5f}' for v in losses)} (one process's "
              f"Trainer {', '.join(f'{v:.5f}' for v in ref)}, largest gap "
              f"{max(gaps):.2e}, printed); the step-0 update within "
              f"{worst:.3e} of one process's on the same gradients with "
              f"the shares' norms (bound {UPDATE_REL_TOL}); printed: "
              f"{bucket:.3e} of it with its own norms and the world's "
              f"alphas pinned, {trainer:.3e} of one process's Trainer (its "
              f"own alphas){_p15_norms_note(norms)}; "
              f"launches a step on rank 0: {sum(per_step[0].values())}; "
              f"wrapper calls by shape over {len(losses)} steps: {shapes}")
    step_ms = _p15_note(rank, "(d)", tr, by, peak, cache)
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    del tr, upd
    return {"d_losses": losses, "d_counts": total, "d_step_ms": step_ms,
            "d_by_kind": by, "d_peak_gib": peak, "d_cache": cache}


def _p15_async_run(torch, rank, dev, mesh, preset, steps, ckpt=None,
                   sync=False, plant=False):
    """One async Muon run of (e) on the mesh under "tp": launches counted
    apart in ``step_begin`` and in each step, the drift each step read,
    the host time of each ``step_begin``, and on the card each optimizer
    step's transient (its peak allocation above what was allocated when
    it began: the whole caches it gathers; ``peak`` keeps the run's peak
    across the resets); ``sync`` synchronizes the card after each
    ``step_begin``; ``plant`` writes a NaN into rank P15_NAN_RANK's first
    pending block of the bootstrap's refresh."""
    from repro_torch import collectives
    from repro_torch.kernels import ops
    from repro_torch.optim import base

    cfgs = _p15_cfgs(preset, precond_every=P15_ASYNC_K, precond_async=True)
    tkw = {} if ckpt is None else dict(checkpoint_dir=str(ckpt),
                                       checkpoint_every=steps)
    tr = _p15_trainer(cfgs, dev, mesh, "tp", steps=steps, **tkw)
    out = {"begin": {}, "steps": {}, "drift": [], "dispatched": [],
           "begin_ms": {}, "kernels": dict.fromkeys(KERNEL_NAMES, 0),
           "transient": [], "peak": 0}
    real = [None]
    cuda = dev.type == "cuda"

    def measured(step):
        def run(*a, **k):
            out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            at = torch.cuda.memory_allocated()
            r = step(*a, **k)
            out["transient"].append(torch.cuda.max_memory_allocated() - at)
            return r
        return run

    def counted_begin(t, key, drift=0.0):
        before = ops.launch_counts()
        if plant:
            out["active"] = {k: v.clone() for k, v in _p15_orthos(tr)}
        t0 = time.perf_counter()
        real[0](t, key, drift=drift)
        out["begin_ms"][t] = (time.perf_counter() - t0) * 1e3
        if sync:
            _p14_sync(torch, dev)
        now = ops.launch_counts()
        for k in out["kernels"]:
            out["kernels"][k] += now[k] - before[k]
        out["begin"][t] = sum(now.values()) - sum(before.values())
        out["mark"] = sum(now.values())
        if tr.precond.last_dispatch == t:
            out["dispatched"].append(t)
        if plant:
            out["pending_after"] = tr.opt.pending_host
            out["unchanged"] = all(torch.equal(v, out["active"][k])
                                   for k, v in _p15_orthos(tr))
            del out["active"]

    def poisoned(key):
        parts = real_refresh(key)
        if collectives.rank(None) == P15_NAN_RANK:
            part = next(p for p in parts if p and "ortho_p" in p)
            part["ortho_p"].view(-1)[0] = math.nan
        return parts

    def on_metrics(t, m):
        out["steps"][t] = sum(ops.launch_counts().values()) - out["mark"]
        out["drift"].append(float(m["precond_drift"]))

    real_init = tr.init_state

    def init_state(seed=None):
        nonlocal real_refresh
        start = real_init(seed)
        real[0] = tr.precond.step_begin
        tr.precond.step_begin = counted_begin
        if cuda:
            tr.opt.step = measured(tr.opt.step)
        if plant:
            real_refresh = tr.precond._refresh
            tr.precond._refresh = poisoned
        return start
    real_refresh = None
    tr.init_state = init_state
    with collectives.count_collectives() as calls:
        tr.run(on_metrics=on_metrics)
    _p14_sync(torch, dev)
    base.wait_pending(tr.opt)
    out["telemetry"] = dict(tr.precond.counters)
    out["by"] = _p15_by_kind(calls, steps)
    out["crc"] = _crcs(torch, tr.state_tree())
    out["cache"] = _p15_cache_gate(torch, tr, "(e)")
    out["step_ms"] = statistics.median(tr.step_times) * 1e3 \
        if tr.step_times else math.nan
    if cuda:
        out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated())
    out["tr"] = tr
    return out


def _p15_orthos(tr):
    return [(k, tr.opt.state[p]["ortho"])
            for k, p in tr.model.named_parameters()
            if "ortho" in tr.opt.state[p]]


def _p15_async(torch, rank, mesh, dev, work, preset, launches):
    """(e): async Muon PRISM-5 on the mesh under "tp", P15_ASYNC_STEPS
    steps with deterministic algorithms, a checkpoint at the last; the
    same world synchronized after each ``step_begin`` (bitwise equal);
    one step whose bootstrap refresh carries a NaN in one rank's pending
    block (discarded on every rank)."""
    from repro_torch.optim import base

    torch.use_deterministic_algorithms(True)
    try:
        _p15_peak(torch, dev)
        a = _p15_async_run(torch, rank, dev, mesh, preset, P15_ASYNC_STEPS,
                           ckpt=work / "ckpt_e")
        peak = max(_p15_peak(torch, dev), a["peak"] / 2**30)
        tr = a.pop("tr")
        _p15_note(rank, "(e)", tr, a["by"], peak, a["cache"])
        del tr
        s = _p15_async_run(torch, rank, dev, mesh, preset, P15_ASYNC_STEPS,
                           sync=True)
        del s["tr"]
        n = _p15_async_run(torch, rank, dev, mesh, preset, 1, plant=True)
        del n["tr"]
    finally:
        torch.use_deterministic_algorithms(False)
    want_at = [0, P15_ASYNC_K]
    per = sum(PER_STEP["prism5"].values())
    if a["dispatched"] != want_at:
        raise AssertionError(f"(e) dispatched at {a['dispatched']}, want "
                             f"{want_at}")
    if launches and ([a["begin"][t] for t in want_at] != [per, per]
                     or any(a["steps"].values())
                     or any(v for t, v in a["begin"].items()
                            if t not in want_at)):
        raise AssertionError(f"(e) launches in step_begin {a['begin']}, in "
                             f"the steps {a['steps']}")
    if a["crc"] != s["crc"]:
        bad = sorted(k for k in a["crc"] if a["crc"][k] != s["crc"].get(k))
        raise AssertionError(f"(e) the run differs from the one synchronized "
                             f"after each step_begin: {bad[:5]}")
    if a["drift"] != s["drift"]:
        raise AssertionError(f"(e) drift {a['drift']} vs the synchronized "
                             f"run's {s['drift']}")
    if not (n["pending_after"] == base.NO_PENDING and n["unchanged"]
            and n["telemetry"]["discarded"] == 1):
        raise AssertionError(f"(e) the planted NaN: pending_at "
                             f"{n['pending_after']}, active blocks "
                             f"unchanged {n['unchanged']}, telemetry "
                             f"{n['telemetry']}")
    disp = [a["begin_ms"][t] for t in want_at]
    rest = [v for t, v in a["begin_ms"].items() if t not in want_at]
    _rank_log(rank, f"  (e) async Muon under tp: dispatched at "
              f"{a['dispatched']}, step_begin launched "
              f"{[a['begin'][t] for t in sorted(a['begin'])]}, the steps "
              f"{[a['steps'][t] for t in sorted(a['steps'])]}; telemetry "
              f"{a['telemetry']}; drift read {a['drift']}; the run bitwise "
              f"the one synchronized after each step_begin "
              f"({len(a['crc'])} state leaves); step_begin host ms at the "
              f"dispatches {', '.join(f'{v:.1f}' for v in disp)}, elsewhere "
              f"up to {max(rest):.1f} (gloo holds the host through the "
              f"refresh's collectives); step {a['step_ms']:.1f} ms; "
              f"the optimizer step's transient (the whole caches it "
              f"gathers) at most {max(a['transient'] or [0]) / 2**20:.1f} "
              f"MiB (MiB a step: "
              f"{', '.join(f'{v / 2**20:.1f}' for v in a['transient'])})")
    _rank_log(rank, f"  (e) a NaN in rank {P15_NAN_RANK}'s pending block of "
              f"the bootstrap refresh: telemetry {n['telemetry']}, pending "
              f"cleared, the active blocks bitwise unchanged")
    return {"e_dispatched": a["dispatched"], "e_telemetry": a["telemetry"],
            "e_drift": a["drift"], "e_begin": a["begin"],
            "e_steps": a["steps"], "e_begin_ms": a["begin_ms"],
            "e_step_ms": a["step_ms"], "e_by_kind": a["by"],
            "e_peak_gib": peak, "e_cache": a["cache"],
            "e_transient_mib": max(a["transient"] or [0]) / 2**20,
            "e_counts": a["kernels"], "e_nan": n["telemetry"]}


def _p15_restore(torch, rank, mesh, dev, work, preset):
    """(f): (e)'s checkpoint holds every cache whole; a Trainer on the
    mesh under "zero" restores it, every leaf gathered whole crc32-equal
    to the MANIFEST and each cache block equal to its block of the
    file's whole cache."""
    import numpy as np

    from repro_torch.launch import sharding
    from repro_torch.optim import base

    ck = work / "ckpt_e" / f"step_{P15_ASYNC_STEPS:08d}"
    manifest = json.loads((ck / "MANIFEST").read_text())["crc32"]
    cfgs = _p15_cfgs(preset, precond_every=P15_ASYNC_K, precond_async=True)
    tr = _p15_trainer(cfgs, dev, mesh, "zero", steps=P15_ASYNC_STEPS,
                      checkpoint_dir=str(work / "ckpt_e"),
                      checkpoint_every=0)
    t0 = time.perf_counter()
    start = tr.restore_or_init()
    restore_s = time.perf_counter() - t0
    tree = tr.gathered_state_tree()
    crcs = _crcs(torch, tree) if rank == 0 else {}
    del tree
    if rank == 0:
        bad = _p15_unlike_manifest(crcs, manifest)
        if start != P15_ASYNC_STEPS or bad or \
                tr.opt.pending_host != base.NO_PENDING:
            raise AssertionError(f"(f) restored at {start}, pending_at "
                                 f"{tr.opt.pending_host}; leaves differ "
                                 f"from the MANIFEST: {bad[:5]}")
    data = np.load(ck / "tree.npz")
    layouts = tr.state_shardings()["opt"]
    coords = mesh.coords()
    blocks = whole = 0
    for k, p in tr.model.named_parameters():
        for sk, v in tr.opt.state[p].items():
            if sk not in P15_CACHE_KEYS or sk in base.PENDING_STATE_KEYS:
                continue
            full = data[f"opt|{k}|{sk}"]
            want = torch.from_numpy(np.ascontiguousarray(sharding.local_block(
                full, layouts[k][sk], coords))).to(v.device)
            if tuple(full.shape) == tuple(v.shape) or \
                    not torch.equal(v, want):
                raise AssertionError(f"(f) {k}|{sk}: block {tuple(v.shape)} "
                                     f"of the file's {full.shape} differs")
            blocks += 1
            whole += full.nbytes
    _rank_log(rank, f"  (f) (e)'s checkpoint restored under zero in "
              f"{restore_s:.1f} s: every leaf gathered whole crc32-equal to "
              f"the MANIFEST ({len(manifest)} leaves; the refresh in flight "
              f"cleared); {blocks} caches, "
              f"{whole} B whole in the file, each rank's block bitwise its "
              f"block of the file's")
    del tr
    return {"f_blocks": blocks}


# ---------------------------------------------- phase 16: moe on the mesh

# granite-moe-1b-a400m at its published widths on the (data 2, model 2)
# world, depth cut from 24 layers to P16_LAYERS for the script's clock (the
# FSDP gathers, Muon's whole views and the checkpoint all go through gloo,
# 0.13 GB/s over four ranks)
P16_LAYERS = 2
P16_PARAMS = 207_721_472   # at P16_LAYERS, with the padded vocab (49,168)
# steps cut for the script's clock (CHANGES.md): (a) 3 -> 1, (b) 2 -> 1,
# (c) 2 -> 1
P16_STEPS = 1              # (a): tp, expert parallelism, a checkpoint
P16_RESUME_STEPS = 1       # (b): zero, resumed from (a)'s checkpoint
P16_TENSOR_STEPS = 1       # (c): tp, each expert's columns (mixtral's rule)
P16_DROP_CAPACITY = 0.5    # (d): the drop control
P16_DEADLINE_S = 600       # the whole world
P16_PATHS = {"a": "model_axis_moe_tp_rank0",
             "b": "model_axis_moe_zero_rank0",
             "c": "model_axis_moe_tensor_rank0"}
# Muon's views at P16_LAYERS (phase 12's, GRANITE_VIEWS, a layer) and K1/K2
# at the §8 engine's shares of their buckets over the data axis (each data
# rank's half of the slices, under both strategies), checked and timed in
# phase 3
P16_VIEWS = {(1024, 512): 98 * P16_LAYERS, (1024, 1024): 2 * P16_LAYERS,
             (1024, 32): P16_LAYERS}
P16_SHAPES = bucket_shapes(
    {v: -(-B // P15_MESH[0]) for v, B in P16_VIEWS.items()},
    {(1024, 512): "(a)-(c) experts, wk/wv: share",
     (1024, 1024): "(a)-(c) wq/wo: share",
     (1024, 32): "(a)-(c) routers: share"})


def phase16(torch, preset="full", device="cuda", launches=True):
    """Phase 16 (see the module docstring) in a temporary build/phase16_*
    directory, removed at the end; returns rank 0's launch counts of (a),
    (b) and (c) by path.  ``preset`` ("full", or "smoke": granite's SMOKE
    config at seq 32), ``device`` and ``launches`` let it rehearse on the
    CPU."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase16_", dir=base_dir))
    try:
        return _phase16(torch, work, preset, device, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _p16_cfgs(preset, **moe_kw):
    """launch/train.py's granite configuration (Muon PRISM-5, seq 512,
    global batch 8) cut to P16_LAYERS, at fp32 compute (the gates against
    one process), with ``moe_kw`` replaced in its MoE config."""
    import dataclasses

    from repro_torch.launch import train as train_launch

    argv = GRANITE_ARGV + (["--smoke", "--seq", "32"] if preset == "smoke"
                           else [])
    cfg, ocfg, _, dcfg = train_launch.configs(
        train_launch.parser().parse_args(argv))
    cfg = cfg.replace(dtype="float32", emb_dtype="float32",
                      moe=dataclasses.replace(cfg.moe, **moe_kw))
    if preset == "full":
        cfg = cfg.replace(num_layers=P16_LAYERS)
    return cfg, ocfg, dcfg


def _phase16(torch, work, preset, device, launches):
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import latest_step

    cuda = torch.device(device).type == "cuda"
    if cuda:
        free_card(torch, "phase 16")
    card = _card_line()
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _phase16_rank, args=(P15_WORLD, str(work), preset, device,
                             launches),
        nprocs=P15_WORLD, start_method="spawn", join=False)
    deadline = time.monotonic() + P16_DEADLINE_S
    # (a)'s reference while the ranks start: one process's losses and
    # launches a step, handed to the ranks through a file; then (d)'s
    t1 = time.perf_counter()
    try:
        cfgs = _p16_cfgs(preset)
        tr = _p15_trainer(cfgs, device, steps=P16_STEPS)
        n_params = sum(p.numel() for p in tr.model.parameters())
        if preset == "full" and n_params != P16_PARAMS:
            raise AssertionError(f"{n_params} parameters, not {P16_PARAMS}")
        views = _granite_views(tr.opt)
        if preset == "full" and views != P16_VIEWS:
            raise AssertionError(f"Muon's views {views}, want {P16_VIEWS}")
        ref_losses, ref_steps, _, _, _, ref_aux = _p15_steps(torch, tr,
                                                             device)
        del tr
        if any(c != ref_steps[0] for c in ref_steps):
            raise AssertionError(f"one process's launches differ from step "
                                 f"to step: {ref_steps}")
        (work / "ref.json.tmp").write_text(json.dumps(
            {"losses": ref_losses, "launches": ref_steps[0]}))
        (work / "ref.json.tmp").rename(work / "ref.json")
        drop = _p16_drop_reference(torch, preset, device)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    cfg = cfgs[0]
    log(f"  one process ((a)'s reference and (d)'s, beside the ranks' "
        f"start) in {time.perf_counter() - t1:.1f} s: {cfg.name} "
        f"{n_params} params ({cfg.num_layers} layers, d {cfg.d_model}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.num_experts_per_tok}, "
        f"d_ff {cfg.d_ff}, capacity {cfg.moe.capacity_factor}, "
        f"{cfg.moe.dispatch} dispatch, fp32 compute), Muon views "
        + ", ".join(f"{n} x {list(s)}" for s, n in sorted(views.items()))
        + f"; losses {', '.join(f'{v:.5f}' for v in ref_losses)}, aux "
        f"{', '.join(f'{v:.5f}' for v in ref_aux)}; launches a step "
        f"{sum(ref_steps[0].values())} "
        f"({ {k: v for k, v in ref_steps[0].items() if v} })")
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"phase 16: the world of {P15_WORLD} ranks did not "
                     f"finish in {P16_DEADLINE_S} s")
    except Exception as e:  # a rank raised or died: the phase fails
        for r in range(P15_WORLD):
            err = work / f"rank{r}.err"
            if err.exists():
                log(f"  rank {r} raised:\n{err.read_text()}")
        fail(f"phase 16: a rank failed: {type(e).__name__}: "
             f"{str(e).splitlines()[0] if str(e) else ''}")
    world_s = time.perf_counter() - t0
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(P15_WORLD)]
    log(f"  the world of {P15_WORLD} ranks (spawned, gloo, mesh (data, "
        f"model) = {P15_MESH}) ran in {world_s:.1f} s ({card})")
    if any(rr[k] != res[0][k] for rr in res
           for k in ("a_losses", "b_losses", "c_losses", "d_loss")):
        fail("phase 16: the ranks' losses differ")
    for r, rr in enumerate(res):
        log(f"  rank {r} {rr['coords']}: step (a) {rr['a_step_ms']:.1f} ms, "
            f"(b) {rr['b_step_ms']:.1f} ms, (c) {rr['c_step_ms']:.1f} ms; "
            f"max_memory_allocated (a) {rr['a_peak_gib']:.2f}, (b) "
            f"{rr['b_peak_gib']:.2f}, (c) {rr['c_peak_gib']:.2f}, (d) "
            f"{rr['d_peak_gib']:.2f} GiB ({card})")
    # (b)'s reference: one process resumes the world's checkpoint
    ck = work / "ckpt"
    if latest_step(str(ck)) != P16_STEPS:
        fail(f"phase 16: the world's checkpoint is at step "
             f"{latest_step(str(ck))}, not {P16_STEPS}")
    tr = _p15_trainer(cfgs, device, steps=P16_STEPS + P16_RESUME_STEPS,
                      checkpoint_dir=str(ck), checkpoint_every=0)
    one_b, one_steps, _, _, _, _ = _p15_steps(torch, tr, device)
    del tr
    b = res[0]["b_losses"]
    gaps = [abs(x - y) for x, y in zip(b, one_b)]
    if len(b) != P16_RESUME_STEPS or not all(math.isfinite(v) for v in b) \
            or not max(gaps) <= P15_LOSS_TOL:
        fail(f"phase 16 (b): losses {b} against one process resuming the "
             f"same checkpoint {one_b} (bound {P15_LOSS_TOL})")
    if launches and any(c != one_steps[0] for c in one_steps):
        fail(f"phase 16 (b): one process's launches a step {one_steps}")
    log(f"  (b) one process resuming the world's step-{P16_STEPS} "
        f"checkpoint: losses {', '.join(f'{v:.5f}' for v in one_b)}; the "
        f"world's within {max(gaps):.2e} (bound {P15_LOSS_TOL}) ({card})")
    _p16_drop_gate(res, drop)
    return {path: res[0][f"{k}_counts"] for k, path in P16_PATHS.items()}


def _p16_drop_reference(torch, preset, device):
    """(d)'s one process at capacity P16_DROP_CAPACITY on step 0's global
    batch: the loss, its dropped assignments, and the control: the mean
    of the losses of each data rank's rows routed alone (a rank-local
    dispatch, its capacity and aux from its own rows)."""
    from repro_torch.data import make_batch_fn
    from repro_torch.models import Model
    from repro_torch.models import moe

    cfg, _, dcfg = _p16_cfgs(preset, capacity_factor=P16_DROP_CAPACITY)
    model = Model(cfg, device=device, seed=0)
    batch = make_batch_fn(cfg, dcfg, torch.device(device))(0)
    per = dcfg.global_batch // P15_MESH[0]
    with torch.no_grad(), moe.count_drops() as drops:
        loss = float(model.loss(batch)[0])
        local = [float(model.loss({k: v[i:i + per] for k, v in
                                   batch.items()})[0])
                 for i in range(0, dcfg.global_batch, per)]
    dropped = sum(int(d) for _, d in drops[:cfg.num_layers])
    routed = sum(n for n, _ in drops[:cfg.num_layers])
    del model
    return {"loss": loss, "dropped": dropped, "routed": routed,
            "layers": cfg.num_layers, "local": sum(local) / len(local)}


def _p16_drop_gate(res, drop):
    """(d): the world's step-0 loss at capacity P16_DROP_CAPACITY within
    P15_LOSS_TOL of one process's, as many drops on every rank; the
    rank-local control must lie beyond the bound (the gate can fail)."""
    gap = abs(res[0]["d_loss"] - drop["loss"])
    control = abs(drop["local"] - drop["loss"])
    for r, rr in enumerate(res):
        if rr["d_dropped"] != drop["dropped"]:
            fail(f"phase 16 (d): rank {r} dropped {rr['d_dropped']} "
                 f"assignments, one process {drop['dropped']}")
    if not drop["dropped"] or not gap <= P15_LOSS_TOL or \
            not control > P15_LOSS_TOL:
        fail(f"phase 16 (d): the world's loss {res[0]['d_loss']} against "
             f"one process's {drop['loss']} ({gap:.2e}, bound "
             f"{P15_LOSS_TOL}); {drop['dropped']} assignments dropped; the "
             f"rank-local control {drop['local']} ({control:.2e}) must lie "
             f"beyond the bound")
    log(f"  (d) capacity {P16_DROP_CAPACITY}: {drop['dropped']} of "
        f"{drop['routed']} assignments dropped (the global batch's slot "
        f"table over {drop['layers']} layers, on every rank); "
        f"step-0 loss {res[0]['d_loss']:.6f}, one process's "
        f"{drop['loss']:.6f} (gap {gap:.2e}, bound {P15_LOSS_TOL}); a "
        f"rank-local dispatch (each data rank's rows routed alone) would "
        f"give {drop['local']:.6f} ({control:.2e} away: beyond the bound, "
        f"as it must be)")


def _phase16_rank(rank, world, work, preset, device, launches):
    """One rank of phase 16: (a)-(d); writes rank<r>.json, or rank<r>.err
    with the traceback when it raises."""
    import traceback

    work = Path(work)
    try:
        res = _p16_rank_body(rank, world, work, preset, device, launches)
        (work / f"rank{rank}.json").write_text(json.dumps(res))
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _p16_rank_body(rank, world, work, preset, device, launches):
    import torch

    from repro_torch import collectives
    from repro_torch.launch import mesh as lmesh

    dev = lmesh.init_world(rank, world, f"file://{work}/store",
                           device=device, timeout_s=P15_TIMEOUT_S)
    try:
        mesh = lmesh.make_debug_mesh(*P15_MESH)
        res = {"coords": mesh.coords()}
        _rank_log(rank, f"  rank 0: backend {lmesh.world_backend()}, "
                  f"device {dev}, mesh {mesh!r}")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for tag in "abc":
            res.update(_p16_train(torch, rank, mesh, dev, work, preset,
                                  launches, tag))
        res.update(_p16_drop(torch, rank, mesh, dev, preset))
        collectives.barrier()
        return res
    finally:
        lmesh.close_world()


def _p16_train(torch, rank, mesh, dev, work, preset, launches, tag):
    """(a) "tp" with expert parallelism, P16_STEPS steps and a checkpoint;
    (b) "zero" resumed from it, P16_RESUME_STEPS steps; (c) "tp" with
    ``moe.sharding="tensor"``, P16_TENSOR_STEPS steps."""
    ck = work / "ckpt"
    if tag == "a":
        cfgs, strategy = _p16_cfgs(preset), "tp"
        tkw = dict(steps=P16_STEPS, checkpoint_dir=str(ck),
                   checkpoint_every=P16_STEPS)
    elif tag == "b":
        cfgs, strategy = _p16_cfgs(preset), "zero"
        tkw = dict(steps=P16_STEPS + P16_RESUME_STEPS,
                   checkpoint_dir=str(ck), checkpoint_every=0)
    else:
        cfgs, strategy = _p16_cfgs(preset, sharding="tensor"), "tp"
        tkw = dict(steps=P16_TENSOR_STEPS)
    tr = _p15_trainer(cfgs, dev, mesh, strategy, **tkw)
    lay = tr.model.layout
    what = f"phase 16 ({tag})"
    w_up = lay.shardings["layers.moe.w_up"].spec
    restored = {}
    if tag == "b":
        manifest = json.loads((ck / f"step_{P16_STEPS:08d}" /
                               "MANIFEST").read_text())["crc32"]
        real_restore = tr.restore_or_init

        def restore_or_init(seed=None):
            start = real_restore(seed)
            tree = tr.gathered_state_tree()
            if rank == 0:
                restored.update(_crcs(torch, tree))
            del tree
            return start
        tr.restore_or_init = restore_or_init
        grads0, on_step = {}, None
    else:
        grads0, on_step = _p15_grads0(torch, tr, _muon_leaves(tr))
    losses, per_step, calls, shapes, upd, aux = _p15_steps(torch, tr, dev,
                                                           on_step)
    ref = json.loads(_p15_wait(work, "ref.json").read_text())
    for t, c in enumerate(per_step):
        if launches and c != ref["launches"]:
            raise AssertionError(f"rank {rank}, {what} step {t}: launches "
                                 f"{c}, one process's {ref['launches']}")
    # each K1/K2 call on the rank's share of a bucket, phase 3's shapes
    shares = {f"{'gram' if n == 'gram_upper' else n} {list(a)}"
              for n, a, _, _, _ in P16_SHAPES}
    if launches and set(shapes) != shares:
        raise AssertionError(f"rank {rank}, {what}: K1/K2 calls by shape "
                             f"{shapes}, want the shares {sorted(shares)}")
    m = tr.model.cfg.moe
    want_aux = tr.model.cfg.num_layers * m.router_aux_loss_coef \
        * m.num_experts_per_tok
    lo, hi = (f * want_aux for f in AUX_BAND)
    if not all(lo <= a <= hi for a in aux):
        raise AssertionError(f"{what}: aux {aux} outside [{lo:.3f}, "
                             f"{hi:.3f}] around a balanced router's "
                             f"{want_aux:.3f}")
    note = ""
    if tag == "b":
        if rank == 0 and restored != manifest:
            bad = sorted(k for k in set(restored) | set(manifest)
                         if restored.get(k) != manifest.get(k))
            raise AssertionError(f"{what}: restored leaves differ from the "
                                 f"checkpoint's crc32: {bad[:5]}")
        note = (f"restored leaves gathered whole crc32-equal to the "
                f"checkpoint's MANIFEST ({len(manifest)} leaves); ")
    else:
        ref_losses = ref["losses"][:len(losses)]
        gaps = [abs(a - b) for a, b in zip(losses, ref_losses)]
        if not all(math.isfinite(v) for v in losses) or \
                not max(gaps) <= P15_LOSS_TOL:
            raise AssertionError(f"{what}: losses {losses} vs one "
                                 f"process's {ref_losses} (bound "
                                 f"{P15_LOSS_TOL})")
        gap = _p16_update_gate(torch, rank, tr, cfgs, dev, upd, grads0,
                               what)
        note = (f"one process's losses within {max(gaps):.2e} (bound "
                f"{P15_LOSS_TOL}); the step-0 Muon update gathered whole "
                f"within {gap:.3e} of one process's optimizer on the same "
                f"gradients, relative to its largest entry (bound "
                f"{UPDATE_REL_TOL}); ")
    peak = _p15_peak(torch, dev)  # rank 0's includes its update gate
    steps = len(losses)
    by = _p15_by_kind(calls, steps)
    ms = run_step_ms(tr)
    seq, batch = tr.dcfg.seq_len, tr.dcfg.global_batch
    _rank_log(rank, f"  ({tag}) {strategy}, layers.moe.w_up {w_up}, "
              f"{batch // lay.batch_size} rows a rank of the batch group, "
              f"seq {seq}: losses {', '.join(f'{v:.5f}' for v in losses)}, "
              f"aux {', '.join(f'{v:.5f}' for v in aux)} (a balanced "
              f"router's {want_aux:.3f}); {note}launches a step on rank 0 "
              f"{sum(per_step[0].values())}, one process's; K1/K2 calls by "
              f"shape over {len(losses)} steps (the shares): {shapes}")
    _rank_log(rank, f"  ({tag}) step {ms:.1f} ms on rank 0 "
              f"({_step_note(tr)}), "
              f"{seq * batch / (ms / 1e3):.0f} tokens/s over the "
              f"world; collectives a step on rank 0 by kind: "
              f"{_p15_kind_note(by)}")
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    del tr, upd
    return {f"{tag}_losses": losses, f"{tag}_counts": total,
            f"{tag}_step_ms": ms, f"{tag}_peak_gib": peak}


def _p16_update_gate(torch, rank, tr, cfgs, dev, upd, grads0, what):
    """The step-0 Muon update, gathered whole (collective), against one
    process's optimizer (rank 0): a fresh one over seed 0's whole
    parameters stepped once on the world's step-0 gradients (``grads0``:
    Muon's leaves' at least, whose updates read no other gradient; the
    others step on zeros and are not compared), each slice's Frobenius
    norm taken on the data ranks' shares (``ShareNorms``).  Returns the
    gap (rank 0; NaN elsewhere)."""
    from repro_torch.core.rng import Key
    from repro_torch.launch import sharding
    from repro_torch.models import Model
    from repro_torch.optim import make_optimizer

    lay = tr.model.layout
    names = _muon_leaves(tr)
    whole = {k: sharding.gather_full(v, lay.shardings[k], kind="gate")
             for k, v in upd.items() if k in names}
    if rank != 0:
        return math.nan
    cfg, ocfg, _ = cfgs
    model = Model(cfg, device=dev, seed=0)
    named = list(model.named_parameters())
    before = {k: p.detach().clone() for k, p in named}
    opt = make_optimizer(ocfg, named, model.logical_axes())
    for k, p in named:
        p.grad = grads0[k] if k in grads0 else torch.zeros_like(p)
    with ShareNorms(P15_MESH[0]):
        opt.step(key=Key(0).fold_in(0))
    want = {k: p.detach() - before[k] for k, p in named if k in names}
    gap = _worst_gap(torch, whole, want, "", gate=False)
    del model, before, named, opt, want
    grads0.clear()
    if not gap <= UPDATE_REL_TOL:
        raise AssertionError(f"{what}: the step-0 Muon update differs from "
                             f"one process's on the same gradients by "
                             f"{gap:.3e} of its largest entry (bound "
                             f"{UPDATE_REL_TOL})")
    return gap


def _p16_drop(torch, rank, mesh, dev, preset):
    """(d): the world's step-0 loss under "tp" at capacity
    P16_DROP_CAPACITY (a forward of each rank's rows, averaged over the
    batch group) and the dropped assignments of its slot tables."""
    from repro_torch import collectives
    from repro_torch.models import moe

    cfgs = _p16_cfgs(preset, capacity_factor=P16_DROP_CAPACITY)
    tr = _p15_trainer(cfgs, dev, mesh, "tp", steps=1)
    batch = tr.batch_fn(0)
    with torch.no_grad(), moe.count_drops() as drops:
        loss = tr.model.loss(batch)[0]
    mean = collectives.all_reduce(loss.clone(), "sum", tr.group)
    dropped = sum(int(d) for _, d in drops)
    n = tr.n_data
    del tr
    return {"d_loss": float(mean) / n, "d_dropped": dropped,
            "d_peak_gib": _p15_peak(torch, dev)}


P17_STEPS = 2              # (a)-(c): tp
P17_RESUME_STEPS = 1       # (d): zero, resumed from (c)'s checkpoint
P17_DEADLINE_S = 600       # the whole world
MUSICGEN = "musicgen-medium"
# (tag) -> (arch, layers, parameters at full width): falcon at phase 13's
# depth, recurrentgemma at one (rec, rec, attn) period so that every kind
# of layer runs under "tp", musicgen at phase 12's; every width kept
P17_RUNS = {"a": (FALCON, FALCON_LAYERS, FALCON_PARAMS),
            "b": (RGEMMA, 3, 861_201_920),
            "c": (MUSICGEN, FAMILY_LAYERS, 88_088_064)}
P17_PATHS = {"a": "model_axis_ssm_tp_rank0",
             "b": "model_axis_hybrid_tp_rank0",
             "c": "model_axis_audio_tp_rank0",
             "d": "model_axis_audio_zero_rank0"}
# the families' own collective kinds (models/ssm.py, models/rglru.py)
P17_KINDS = ("tp_gather", "tp_sum", "tp_scatter")
# Muon's views at the cut depths (the port's bucket plan: one grid-tier
# bucket a view shape) and K1/K2 at the §8 engine's shares of their
# buckets over the data axis (each data rank's ceil(B / 2) slices),
# checked and timed in phase 3
P17_VIEWS = {
    FALCON: FALCON_VIEWS,
    RGEMMA: {(2560, 2560): 10, (2560, 7680): 6, (2560, 4096): 2,
             (2560, 256): 2},
    MUSICGEN: {(1536, 2048): 8, (1536, 6144): 4}}
P17_LABELS = {
    (4096, 16384): "(a) falcon in_proj", (4096, 8192): "(a) falcon out_proj",
    (8192, 288): "(a) falcon x_proj", (256, 8192): "(a) falcon dt_proj",
    (8192, 16): "(a) falcon A_log",
    (2560, 2560): "(b) recurrentgemma RG-LRU",
    (2560, 7680): "(b) recurrentgemma MLPs",
    (2560, 4096): "(b) recurrentgemma wq/wo",
    (2560, 256): "(b) recurrentgemma wk/wv",
    (1536, 2048): "(c)/(d) musicgen wq/wk/wv/wo",
    (1536, 6144): "(c)/(d) musicgen MLPs"}


def p17_shares(arch):
    """K1/K2 at each data rank's share of ``arch``'s Muon buckets."""
    return bucket_shapes(
        {v: -(-B // P15_MESH[0]) for v, B in P17_VIEWS[arch].items()},
        {v: f"{P17_LABELS[v]}: share" for v in P17_VIEWS[arch]})


P17_SHAPES = [e for arch in (FALCON, RGEMMA, MUSICGEN)
              for e in p17_shares(arch)]


def phase17(torch, preset="full", device="cuda", launches=True):
    """Phase 17 (see the module docstring) in a temporary build/phase17_*
    directory, removed at the end; returns rank 0's launch counts of
    (a)-(d) by path.  ``preset`` ("full", or "smoke": the SMOKE configs
    at seq 32), ``device`` and ``launches`` let it rehearse on the
    CPU."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase17_", dir=base_dir))
    try:
        return _phase17(torch, work, preset, device, launches)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _p17_cfgs(preset, tag):
    """launch/train.py's configuration of (tag)'s arch (Muon PRISM-5,
    seq 512, global batch 8) cut to its depth, at fp32 compute (the gates
    against one process)."""
    from repro_torch.launch import train as train_launch

    arch, layers, _ = P17_RUNS["c" if tag == "d" else tag]
    argv = ["--arch", arch, "--steps", str(P17_STEPS)] + (
        ["--smoke", "--seq", "32"] if preset == "smoke" else [])
    cfg, ocfg, _, dcfg = train_launch.configs(
        train_launch.parser().parse_args(argv))
    return (cfg.replace(dtype="float32", emb_dtype="float32",
                        num_layers=layers), ocfg, dcfg)


def _p17_reference(torch, preset, device, tag, launches):
    """One process's Trainer of (tag), P17_STEPS steps: its losses and its
    launches a step (the same every step, and the bucket plan's)."""
    cfgs = _p17_cfgs(preset, tag)
    arch, _, want_params = P17_RUNS[tag]
    tr = _p15_trainer(cfgs, device, steps=P17_STEPS)
    n_params = sum(p.numel() for p in tr.model.parameters())
    views = _granite_views(tr.opt)
    if preset == "full" and (n_params != want_params
                             or views != P17_VIEWS[arch]):
        raise AssertionError(f"{arch}: {n_params} parameters, Muon's views "
                             f"{views}; want {want_params}, "
                             f"{P17_VIEWS[arch]}")
    plan, _ = plan_launches(tr.model, cfgs[1])
    losses, per_step, _, _, _, _ = _p15_steps(torch, tr, device)
    del tr
    gc_collect(torch, device)
    if any(c != per_step[0] for c in per_step) or (
            launches and per_step[0] != plan):
        raise AssertionError(f"{arch}: one process's launches {per_step}, "
                             f"the plan's {plan} a step")
    return {"losses": losses, "launches": per_step[0], "params": n_params,
            "views": sorted([list(v), n] for v, n in views.items())}


def _phase17(torch, work, preset, device, launches):
    import torch.multiprocessing as mp

    from repro_torch.checkpoint import latest_step

    if torch.device(device).type == "cuda":
        free_card(torch, "phase 17")
    card = _card_line()
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _phase17_rank, args=(P15_WORLD, str(work), preset, device,
                             launches),
        nprocs=P15_WORLD, start_method="spawn", join=False)
    deadline = time.monotonic() + P17_DEADLINE_S
    # one process's Trainers while the ranks start (they wait for this
    # file before they build a model, so the references' memory is freed
    # before the world's is taken)
    refs = {}
    try:
        for tag in P17_RUNS:
            t1 = time.perf_counter()
            refs[tag] = _p17_reference(torch, preset, device, tag,
                                       launches)
            cfg = _p17_cfgs(preset, tag)[0]
            r = refs[tag]
            log(f"  ({tag}) one process in {time.perf_counter() - t1:.1f} "
                f"s: {cfg.name} [{cfg.family}] {r['params']} params "
                f"({cfg.num_layers} layers, d {cfg.d_model}, vocab "
                f"{cfg.vocab_size}, fp32 compute), Muon views "
                + ", ".join(f"{n} x {v}" for v, n in r["views"])
                + f"; losses {', '.join(f'{v:.5f}' for v in r['losses'])}; "
                f"launches a step {sum(r['launches'].values())} "
                f"({ {k: v for k, v in r['launches'].items() if v} })")
        (work / "ref.json.tmp").write_text(json.dumps(refs))
        (work / "ref.json.tmp").rename(work / "ref.json")
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"phase 17: the world of {P15_WORLD} ranks did not "
                     f"finish in {P17_DEADLINE_S} s")
    except Exception as e:  # a rank raised or died: the phase fails
        for r in range(P15_WORLD):
            err = work / f"rank{r}.err"
            if err.exists():
                log(f"  rank {r} raised:\n{err.read_text()}")
        fail(f"phase 17: a rank failed: {type(e).__name__}: "
             f"{str(e).splitlines()[0] if str(e) else ''}")
    world_s = time.perf_counter() - t0
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(P15_WORLD)]
    log(f"  the world of {P15_WORLD} ranks (spawned, gloo, mesh (data, "
        f"model) = {P15_MESH}) ran in {world_s:.1f} s, the references "
        f"first ({card})")
    if any(rr[f"{k}_losses"] != res[0][f"{k}_losses"] for rr in res
           for k in P17_PATHS):
        fail("phase 17: the ranks' losses differ")
    for r, rr in enumerate(res):
        log(f"  rank {r} {rr['coords']}: step "
            + ", ".join(f"({k}) {rr[f'{k}_step_ms']:.1f}" for k in P17_PATHS)
            + " ms; max_memory_allocated "
            + ", ".join(f"({k}) {rr[f'{k}_peak_gib']:.2f}" for k in P17_PATHS)
            + f" GiB; host after (d): {rr['d_host']} ({card})")
    # (d)'s reference: one process resumes the world's checkpoint
    ck = work / "ckpt"
    if latest_step(str(ck)) != P17_STEPS:
        fail(f"phase 17: the world's checkpoint is at step "
             f"{latest_step(str(ck))}, not {P17_STEPS}")
    tr = _p15_trainer(_p17_cfgs(preset, "d"), device,
                      steps=P17_STEPS + P17_RESUME_STEPS,
                      checkpoint_dir=str(ck), checkpoint_every=0)
    one_d, one_steps, _, _, _, _ = _p15_steps(torch, tr, device)
    del tr
    gc_collect(torch, device)
    d = res[0]["d_losses"]
    gaps = [abs(x - y) for x, y in zip(d, one_d)]
    if len(d) != P17_RESUME_STEPS or not all(math.isfinite(v) for v in d) \
            or not max(gaps) <= P15_LOSS_TOL:
        fail(f"phase 17 (d): losses {d} against one process resuming the "
             f"same checkpoint {one_d} (bound {P15_LOSS_TOL})")
    if launches and any(c != refs["c"]["launches"] for c in one_steps):
        fail(f"phase 17 (d): one process's launches a step {one_steps}")
    log(f"  (d) one process resuming the world's step-{P17_STEPS} "
        f"checkpoint: losses {', '.join(f'{v:.5f}' for v in one_d)}; the "
        f"world's within {max(gaps):.2e} (bound {P15_LOSS_TOL}) ({card})")
    return {path: res[0][f"{k}_counts"] for k, path in P17_PATHS.items()}


def _phase17_rank(rank, world, work, preset, device, launches):
    """One rank of phase 17: (a)-(d); writes rank<r>.json, or rank<r>.err
    with the traceback when it raises."""
    import traceback

    work = Path(work)
    try:
        res = _p17_rank_body(rank, world, work, preset, device, launches)
        (work / f"rank{rank}.json").write_text(json.dumps(res))
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _p17_rank_body(rank, world, work, preset, device, launches):
    import torch

    from repro_torch import collectives
    from repro_torch.launch import mesh as lmesh

    dev = lmesh.init_world(rank, world, f"file://{work}/store",
                           device=device, timeout_s=P15_TIMEOUT_S)
    try:
        mesh = lmesh.make_debug_mesh(*P15_MESH)
        res = {"coords": mesh.coords()}
        _rank_log(rank, f"  rank 0: backend {lmesh.world_backend()}, "
                  f"device {dev}, mesh {mesh!r}")
        ref = json.loads(_p15_wait(work, "ref.json").read_text())
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for tag in P17_PATHS:
            res.update(_p17_train(torch, rank, mesh, dev, work, preset,
                                  launches, tag, ref))
        collectives.barrier()
        return res
    finally:
        lmesh.close_world()


def _p17_train(torch, rank, mesh, dev, work, preset, launches, tag, ref):
    """(a) falcon-mamba-7b, (b) recurrentgemma-2b and (c) musicgen-medium
    under "tp", P17_STEPS steps ((c) with a checkpoint at the last); (d)
    (c)'s checkpoint resumed under "zero", P17_RESUME_STEPS steps."""
    ck = work / "ckpt"
    cfgs = _p17_cfgs(preset, tag)
    if tag == "d":
        strategy = "zero"
        tkw = dict(steps=P17_STEPS + P17_RESUME_STEPS,
                   checkpoint_dir=str(ck), checkpoint_every=0)
    else:
        strategy = "tp"
        tkw = dict(steps=P17_STEPS)
        if tag == "c":
            tkw.update(checkpoint_dir=str(ck), checkpoint_every=P17_STEPS)
    tr = _p15_trainer(cfgs, dev, mesh, strategy, **tkw)
    lay = tr.model.layout
    what = f"phase 17 ({tag})"
    restored = {}
    if tag == "d":
        manifest = json.loads((ck / f"step_{P17_STEPS:08d}" /
                               "MANIFEST").read_text())["crc32"]
        real_restore = tr.restore_or_init

        def restore_or_init(seed=None):
            start = real_restore(seed)
            tree = tr.gathered_state_tree()
            if rank == 0:
                restored.update(_crcs(torch, tree))
            del tree
            return start
        tr.restore_or_init = restore_or_init
        grads0, on_step = {}, None
    else:
        grads0, on_step = _p15_grads0(torch, tr, _muon_leaves(tr))
    losses, per_step, calls, shapes, upd, _ = _p15_steps(torch, tr, dev,
                                                         on_step)
    run = ref["c" if tag == "d" else tag]
    for t, c in enumerate(per_step):
        if launches and c != run["launches"]:
            raise AssertionError(f"rank {rank}, {what} step {t}: launches "
                                 f"{c}, one process's {run['launches']}")
    # each K1/K2 call on the rank's share of a bucket, phase 3's shapes
    arch = P17_RUNS["c" if tag == "d" else tag][0]
    shares = {f"{'gram' if n == 'gram_upper' else n} {list(a)}"
              for n, a, _, _, _ in p17_shares(arch)}
    if launches and set(shapes) != shares:
        raise AssertionError(f"rank {rank}, {what}: K1/K2 calls by shape "
                             f"{shapes}, want the shares {sorted(shares)}")
    if tag == "d":
        if rank == 0 and restored != manifest:
            bad = sorted(k for k in set(restored) | set(manifest)
                         if restored.get(k) != manifest.get(k))
            raise AssertionError(f"{what}: restored leaves differ from the "
                                 f"checkpoint's crc32: {bad[:5]}")
        note = (f"restored leaves gathered whole crc32-equal to the "
                f"checkpoint's MANIFEST ({len(manifest)} leaves); ")
    else:
        gaps = [abs(a - b) for a, b in zip(losses, run["losses"])]
        if len(losses) != P17_STEPS or \
                not all(math.isfinite(v) for v in losses) or \
                not max(gaps) <= P15_LOSS_TOL:
            raise AssertionError(f"{what}: losses {losses} vs one "
                                 f"process's {run['losses']} (bound "
                                 f"{P15_LOSS_TOL})")
        gap = _p16_update_gate(torch, rank, tr, cfgs, dev, upd, grads0,
                               what)
        note = (f"one process's losses within {max(gaps):.2e} (bound "
                f"{P15_LOSS_TOL}); the step-0 Muon update gathered whole "
                f"within {gap:.3e} of one process's optimizer on the same "
                f"gradients, relative to its largest entry (bound "
                f"{UPDATE_REL_TOL}); ")
    peak = _p15_peak(torch, dev)  # rank 0's includes its update gate
    by = _p15_by_kind(calls, len(losses))
    own = {k: v for k, v in by.items() if k in P17_KINDS}
    rest = {k: v for k, v in by.items() if k not in P17_KINDS}
    ms = run_step_ms(tr)
    seq, batch = tr.dcfg.seq_len, tr.dcfg.global_batch
    cfg = tr.model.cfg
    _rank_log(rank, f"  ({tag}) {cfg.name} [{cfg.family}], {strategy}, "
              f"{batch // lay.batch_size} rows a rank of the batch group, "
              f"seq {seq}: losses {', '.join(f'{v:.5f}' for v in losses)}; "
              f"{note}launches a step on rank 0 "
              f"{sum(per_step[0].values())}, one process's; K1/K2 calls by "
              f"shape over {len(losses)} steps (the shares): {shapes}")
    _rank_log(rank, f"  ({tag}) step {ms:.1f} ms on rank 0 "
              f"({_step_note(tr)}), "
              f"{seq * batch / (ms / 1e3):.0f} tokens/s over the "
              f"world; collectives a step on rank 0 by kind: the family's "
              f"own: {_p15_kind_note(own) or 'none'}; the rest: "
              f"{_p15_kind_note(rest)}; host {host_gib()}")
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    del tr, upd
    gc_collect(torch, dev)
    return {f"{tag}_losses": losses, f"{tag}_counts": total,
            f"{tag}_step_ms": ms, f"{tag}_peak_gib": peak,
            f"{tag}_host": host_gib()}


P18_WORLD = P15_WORLD      # ranks sharing the one card
P18_MESH = P15_MESH        # (data, model)
P18_DEADLINE_S = 600       # the whole world
P18_LOGIT_TOL = 1e-4       # the world's logits against one process's
P18_CACHE_TOL = 1e-4       # its cache blocks against one process's blocks
P18_MASKED = 1             # the decode step with the odd lanes inactive
GPT2 = "gpt2-paper"
# (tag) -> (arch, layers (None: every layer), strategy, global batch,
# prompt, decode steps); the cache holds prompt + steps positions, which
# the kv_seq axes divide (model at batch 4, data x model at batch 1)
P18_RUNS = {"a": (GPT2, None, "serve", 4, 512, 16),
            "b": (GPT2, None, "tp", 4, 512, 4),
            "c": (GPT2, None, "serve", 1, 2048, 16),
            "d": (GRANITE, 2, "serve", 4, 512, 8),
            "e1": (FALCON, FALCON_LAYERS, "serve", 4, 64, 8),
            "e2": (RGEMMA, 3, "serve", 4, 64, 8)}
P18_SMOKE = (12, 4)        # prompt, steps of every run at preset "smoke"
P18_BF16 = ("a", 4)        # the run repeated at bf16 compute, its steps
P18_KINDS = ("kv_q", "kv_seq", "logits", "lanes")  # serving's own kinds
P18_PATH = "serve_mesh_rank0"


def phase18(torch, preset="full", device="cuda"):
    """Phase 18 (see the module docstring) in a temporary build/phase18_*
    directory, removed at the end; returns rank 0's kernel launches over
    every run (all 0).  ``preset`` ("full", or "smoke": the SMOKE configs,
    P18_SMOKE's sizes) and ``device`` let it rehearse on the CPU."""
    import shutil
    import tempfile

    base_dir = ROOT / "build"
    base_dir.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="phase18_", dir=base_dir))
    try:
        return _phase18(torch, work, preset, device)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _p18_sizes(preset, tag):
    """(batch, prompt, steps, cache length) of run (tag)."""
    _, _, _, batch, prompt, steps = P18_RUNS[tag]
    if preset == "smoke":
        prompt, steps = P18_SMOKE
    return batch, prompt, steps, prompt + steps


def _p18_cfg(preset, tag, dtype="float32"):
    """(tag)'s config at its depth, fp32 compute (``dtype`` None: the
    config's own dtypes)."""
    from repro_torch.configs import get_config, get_smoke_config

    arch, layers = P18_RUNS[tag][:2]
    cfg = (get_smoke_config if preset == "smoke" else get_config)(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    return cfg if dtype is None else cfg.replace(dtype=dtype,
                                                 emb_dtype=dtype)


def _p18_model(torch, cfg, dev, seed=0):
    from repro_torch.models import Model

    with torch.no_grad():
        return Model(cfg, device=dev, seed=seed)


def _p18_prompt(torch, cfg, tag, preset, dev):
    """The whole prompt batch and lengths of (tag), drawn from a seeded
    CPU generator (the same on every process); batch 4 ragged."""
    B, S, _, _ = _p18_sizes(preset, tag)
    gen = torch.Generator()
    gen.manual_seed(18)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    lengths = None if B == 1 else torch.tensor([S, S - 5, S - 11, S])
    return {"tokens": tokens.to(dev)}, lengths


def _p18_lane_axes(cache):
    """(leaf, lane axis) of every decode cache leaf."""
    if "ssm" in cache or "rec" in cache:
        return _lane_axes(cache)
    return [(cache["k"], 1), (cache["v"], 1), (cache["kpos"], 0)]


def _p18_serve(torch, model, tag, preset, dev, lanes=slice(None),
               dtype="float32"):
    """(tag) served through the entry points: ``prefill_cache`` over the
    whole prompt batch, then greedy ``make_serve_step`` steps on
    ``lanes`` (a rank's), the P18_MASKED step with the odd lanes
    inactive, whose leaves it holds bitwise frozen.  Returns the logits
    and tokens (CPU) of every call, the final cache, the prefill and
    per-step ms and the decode steps' collectives."""
    from repro_torch import collectives
    from repro_torch.serving import make_serve_step

    cfg = model.cfg
    batch, lengths = _p18_prompt(torch, cfg, tag, preset, dev)
    B, S, steps, clen = _p18_sizes(preset, tag)
    if dtype != "float32":
        steps = P18_BF16[1]
    with torch.inference_mode():
        params = model.cast_params()
    sync = (lambda: torch.cuda.synchronize()) if dev.type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = model.prefill_cache(batch, clen, lengths, params=params)
    sync()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    step = make_serve_step(model)
    start = (torch.full((B,), S) if lengths is None else lengths)[lanes]
    start = start.to(dev)
    # the odd lanes inactive; at batch 1 the one lane
    active = ((torch.arange(B) % 2 == 0) & (B > 1))[lanes].to(dev)
    out = {"logits": [logits.float().cpu()], "tokens": []}
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step_ms = []
    with collectives.count_collectives() as calls:
        for t in range(steps):
            out["tokens"].append(tok.cpu())
            pos = (start + t).to(torch.int32)[:, None]
            masked = t == P18_MASKED
            if masked:
                before = [(x.clone(), ax)
                          for x, ax in _p18_lane_axes(cache)]
            sync()
            t0 = time.perf_counter()
            if masked:
                logits, cache = model.decode_step(cache, tok, pos,
                                                  active=active,
                                                  params=params)
                tok = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                logits, tok, cache = step(cache, tok, pos, params=params)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if masked:
                keep = (~active).nonzero()[:, 0]
                for (old, ax), (new, _) in zip(before,
                                               _p18_lane_axes(cache)):
                    if not torch.equal(old.index_select(ax, keep),
                                       new.index_select(ax, keep)):
                        raise AssertionError(f"({tag}) an inactive lane's "
                                             f"cache changed")
            out["logits"].append(logits.float().cpu())
    out.update(cache=cache, prefill_ms=prefill_ms, step_ms=step_ms,
               decode_calls=calls)
    return out


def _p18_reference(torch, preset, dev, work):
    """One process's serving of every run (and of P18_BF16's run at the
    config's own dtypes), saved for the ranks: logits, tokens and the
    final cache whole, on the CPU."""
    notes = {}
    for tag in list(P18_RUNS) + ["bf16"]:
        run = P18_BF16[0] if tag == "bf16" else tag
        cfg = _p18_cfg(preset, run, None if tag == "bf16" else "float32")
        t0 = time.perf_counter()
        model = _p18_model(torch, cfg, dev)
        res = _p18_serve(torch, model, run, preset, dev,
                         dtype="bfloat16" if tag == "bf16" else "float32")
        res["cache"] = _p18_cpu(res["cache"])
        torch.save({k: res[k] for k in ("logits", "tokens", "cache")},
                   work / f"ref_{tag}.pt")
        notes[tag] = (f"{cfg.name} [{cfg.family}] {cfg.num_layers} layers, "
                      f"{sum(p.numel() for p in model.parameters())} params, "
                      f"{cfg.dtype}: prefill {res['prefill_ms']:.1f} ms, "
                      f"decode {statistics.median(res['step_ms']):.2f} ms a "
                      f"step (median), {time.perf_counter() - t0:.1f} s")
        del model, res
        gc_collect(torch, dev)
    (work / "ref.json.tmp").write_text(json.dumps(notes))
    (work / "ref.json.tmp").rename(work / "ref.json")
    return notes


def _phase18(torch, work, preset, device):
    import torch.multiprocessing as mp

    dev = torch.device(device)
    if dev.type == "cuda":
        free_card(torch, "phase 18")
    card = _card_line()
    t0 = time.perf_counter()
    ctx = mp.start_processes(
        _phase18_rank, args=(P18_WORLD, str(work), preset, device),
        nprocs=P18_WORLD, start_method="spawn", join=False)
    deadline = time.monotonic() + P18_DEADLINE_S
    try:  # one process first, while the ranks start (they wait for it)
        notes = _p18_reference(torch, preset, dev, work)
    except BaseException:
        for p in ctx.processes:
            p.kill()
        raise
    for tag, note in notes.items():
        log(f"  ({tag}) one process: {note} ({card})")
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"phase 18: the world of {P18_WORLD} ranks did not "
                     f"finish in {P18_DEADLINE_S} s")
    except Exception as e:  # a rank raised or died: the phase fails
        for r in range(P18_WORLD):
            err = work / f"rank{r}.err"
            if err.exists():
                log(f"  rank {r} raised:\n{err.read_text()}")
        fail(f"phase 18: a rank failed: {type(e).__name__}: "
             f"{str(e).splitlines()[0] if str(e) else ''}")
    res = [json.loads((work / f"rank{r}.json").read_text())
           for r in range(P18_WORLD)]
    log(f"  the world of {P18_WORLD} ranks (spawned, gloo, mesh (data, "
        f"model) = {P18_MESH}) ran in {time.perf_counter() - t0:.1f} s, the "
        f"reference first ({card})")
    for r, rr in enumerate(res):
        log(f"  rank {r} {rr['coords']}: decode ms a token (median) "
            + ", ".join(f"({k}) {rr[k]['step_ms']:.1f}" for k in P18_RUNS)
            + "; prefill ms "
            + ", ".join(f"({k}) {rr[k]['prefill_ms']:.0f}" for k in P18_RUNS)
            + f" ({card})")
    return res[0]["counts"]


def _phase18_rank(rank, world, work, preset, device):
    """One rank of phase 18; writes rank<r>.json, or rank<r>.err with the
    traceback when it raises."""
    import traceback

    work = Path(work)
    try:
        res = _p18_rank_body(rank, world, work, preset, device)
        (work / f"rank{rank}.json").write_text(json.dumps(res))
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise


def _p18_rank_body(rank, world, work, preset, device):
    import torch

    from repro_torch import collectives
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as lmesh

    dev = lmesh.init_world(rank, world, f"file://{work}/store",
                           device=device, timeout_s=P15_TIMEOUT_S)
    try:
        mesh = lmesh.make_debug_mesh(*P18_MESH)
        res = {"coords": mesh.coords()}
        _rank_log(rank, f"  rank 0: backend {lmesh.world_backend()}, "
                  f"device {dev}, mesh {mesh!r}")
        _p15_wait(work, "ref.json")
        before = ops.launch_counts()
        for tag in list(P18_RUNS) + ["bf16"]:
            res[tag] = _p18_run(torch, rank, mesh, dev, work, preset, tag)
        after = ops.launch_counts()
        res["counts"] = {k: after[k] - before[k] for k in after}
        if any(res["counts"].values()):
            raise AssertionError(f"rank {rank}: serving launched port "
                                 f"kernels {res['counts']}")
        collectives.barrier()
        return res
    finally:
        lmesh.close_world()


def _p18_run(torch, rank, mesh, dev, work, preset, tag):
    """Run (tag) on this rank against one process's: the rank's lanes'
    logits within P18_LOGIT_TOL (the bf16 run's gap printed only), the
    greedy tokens equal, every cache leaf within P18_CACHE_TOL of its
    block of one process's and, gathered whole (``sharding.
    gather_cache``), to one process's cache (kpos equal); times and
    collectives by kind."""
    from repro_torch import collectives
    from repro_torch.launch import sharding
    from repro_torch.models.transformer import cache_leaves, param_specs

    run = P18_BF16[0] if tag == "bf16" else tag
    strategy, B = P18_RUNS[run][2:4]
    cfg = _p18_cfg(preset, run, None if tag == "bf16" else "float32")
    model = _p18_model(torch, cfg, dev)
    specs = param_specs(cfg)
    model.shard(mesh, sharding.tree_shardings(
        mesh, {k: a for k, (_, a, _) in specs.items()},
        sharding.param_rules(cfg, mesh, strategy),
        {k: s for k, (s, _, _) in specs.items()}), strategy)
    clen = _p18_sizes(preset, run)[3]
    srv = model.serve_layout(B, clen)
    with collectives.count_collectives() as calls:
        got = _p18_serve(torch, model, run, preset, dev, srv.lanes,
                         "bfloat16" if tag == "bf16" else "float32")
    ref = torch.load(work / f"ref_{tag}.pt")
    gap = max(float((g - w[srv.lanes]).abs().max())
              for g, w in zip(got["logits"], ref["logits"]))
    what = f"rank {rank}, phase 18 ({tag})"
    if tag != "bf16":
        if not gap <= P18_LOGIT_TOL:
            raise AssertionError(f"{what}: logits {gap:.3e} from one "
                                 f"process's (bound {P18_LOGIT_TOL})")
        for g, w in zip(got["tokens"], ref["tokens"]):
            if not torch.equal(g, w[srv.lanes]):
                raise AssertionError(f"{what}: greedy tokens differ from "
                                     f"one process's")
        # the blocks against one process's blocks, then gathered whole
        # (the inverse of cache_blocks) against its whole cache
        whole = sharding.gather_cache(got["cache"], srv.shardings,
                                      kind="gate")
        cache_gap = max(
            _p18_cache_gap(torch, what, got["cache"], sharding.cache_blocks(
                mesh, cfg, ref["cache"], B)),
            _p18_cache_gap(torch, what, whole, ref["cache"]))
        if not cache_gap <= P18_CACHE_TOL:
            raise AssertionError(f"{what}: cache blocks {cache_gap:.3e} "
                                 f"from one process's (bound "
                                 f"{P18_CACHE_TOL})")
    steps = len(got["step_ms"])
    by = _p15_by_kind(got["decode_calls"], steps)
    own = {k: v for k, v in by.items() if k in P18_KINDS}
    rest = {k: v for k, v in by.items() if k not in P18_KINDS}
    pre = _p15_by_kind(calls[:len(calls) - len(got["decode_calls"])], 1)
    ms = statistics.median(got["step_ms"])
    _rank_log(rank, f"  ({tag}) {cfg.name} [{cfg.family}] {cfg.num_layers} "
              f"layers, {cfg.dtype}, {strategy}, batch {B} "
              f"({srv.lanes.stop - srv.lanes.start} lanes a rank), cache "
              f"{clen} "
              f"(kv_seq over {srv.kv.size if srv.kv else 1} ranks): "
              + (f"the bf16 world's logits {gap:.3e} from one process's "
                 f"bf16 (printed, not gated)" if tag == "bf16" else
                 f"logits within {gap:.2e} of one process's (bound "
                 f"{P18_LOGIT_TOL}), greedy tokens equal, cache blocks and "
                 f"the cache they gather within {cache_gap:.2e} (bound "
                 f"{P18_CACHE_TOL}), the inactive lanes' blocks bitwise "
                 f"frozen"))
    _rank_log(rank, f"  ({tag}) prefill {got['prefill_ms']:.1f} ms, decode "
              f"{ms:.2f} ms a token on rank 0 (median of {steps}); "
              f"collectives a decode token by kind: serving's own: "
              f"{_p15_kind_note(own) or 'none'}; the rest: "
              f"{_p15_kind_note(rest)}; the prefill's: "
              f"{_p15_kind_note(pre)}")
    out = {"step_ms": ms, "prefill_ms": got["prefill_ms"], "gap": gap}
    del model, got
    gc_collect(torch, dev)
    return out


def _p18_cache_gap(torch, what, got, want):
    """The largest gap between two decode cache trees; raises where a
    leaf's shape differs or an integer leaf (kpos) is not equal."""
    from repro_torch.models.transformer import cache_leaves

    gap = 0.0
    for g, w in zip(cache_leaves(got), cache_leaves(want)):
        g = g.cpu()
        if g.shape != w.shape or (g.dtype == torch.int32 and
                                  not torch.equal(g, w)):
            raise AssertionError(f"{what}: a cache leaf differs from one "
                                 f"process's")
        if g.numel():
            gap = max(gap, float((g.float() - w.float()).abs().max()))
    return gap


def _p18_cpu(tree):
    """A decode cache tree with every leaf copied to the CPU."""
    if isinstance(tree, dict):
        return {k: _p18_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_p18_cpu(v) for v in tree]
    return tree.cpu()


def bytecode_cache() -> None:
    """Write this process's bytecode under build/pycache and have the
    processes it spawns read it there.  Where the interpreter runs with
    PYTHONDONTWRITEBYTECODE and its packages hold no bytecode, every rank
    of phases 14-17 compiled torch's sources again on its start
    (``tools/smoke_profile.py``); the ranks, spawned with this process's
    flags, still write nothing, but read what this process wrote."""
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False
    os.environ["PYTHONPYCACHEPREFIX"] = sys.pycache_prefix


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"the root of a checkout")
    sys.path.insert(0, str(SRC))
    # cuBLAS's workspace as PyTorch sizes it on Hopper by default, named so
    # that the deterministic mode of phase 10 takes cuBLAS as it is
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # growable segments: phase 13's Muon steps at recurrentgemma-2b's width
    # come within a few GiB of the card, and a pool of fixed segments
    # fragments there (out of memory with 10.5 GiB reserved but free)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", ALLOC_CONF)
    bytecode_cache()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a CUDA "
             "device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    # importing the package switches TF32 off
    from repro_torch.kernels import _build

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("TF32 is on")

    log("phase 2: build")
    t0 = time.perf_counter()
    per_source = _build.build(verbose=True)
    log(f"  built {sorted(per_source) or 'nothing (cached)'} in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas_summary(_build)

    log("phase 3: kernels against their plain versions")
    rows = kernel_checks(torch)
    rows = fit_kernel_checks(torch, rows)
    rows = family_checks(torch, rows)
    log("  K1/K2 at the lowrank tier's shapes (phase 9 (d))")
    rows = gemm_shape_checks(torch, rows)
    log("  K1/K2 at granite-moe's Muon bucket shapes (phase 12)")
    rows = gemm_shape_checks(torch, rows, GRANITE_SHAPES, ("float32",), 13)
    timings = kernel_timings(torch, rows)
    timings.update(fit_kernel_timings(torch, rows))
    timings.update(family_timings(torch))
    timings.update(gemm_shape_timings(torch))
    timings.update(gemm_shape_timings(torch, GRANITE_SHAPES, ("float32",),
                                      14))
    log("  K1/K2 at recurrentgemma-2b's and falcon-mamba-7b's Muon bucket "
        "shapes (phase 13)")
    rows = gemm_shape_checks(torch, rows, RECURRENT_SHAPES, ("float32",), 15)
    timings.update(gemm_shape_timings(torch, RECURRENT_SHAPES, ("float32",),
                                      16, RECURRENT_REPS))
    log("  K1/K2 at phase 15's shapes: (a)'s bucket shares and (b)'s row "
        "blocks (K2's partial Gram, alpha 0)")
    rows = gemm_shape_checks(torch, rows, P15_SHAPES, ("float32",), 17)
    timings.update(gemm_shape_timings(torch, P15_SHAPES, ("float32",), 18))
    log("  K1 at Shampoo's factor share of phase 15 (c)/(d) (K3, K5, K6 and "
        "K7 at their shares run above)")
    rows = gemm_shape_checks(torch, rows, P15_SHAMPOO_SHAPES, ("float32",),
                             19)
    timings.update(gemm_shape_timings(torch, P15_SHAMPOO_SHAPES,
                                      ("float32",), 20))
    log("  K1/K2 at phase 16's shares of granite-moe's Muon buckets (each "
        "data rank's half)")
    rows = gemm_shape_checks(torch, rows, P16_SHAPES, ("float32",), 21)
    timings.update(gemm_shape_timings(torch, P16_SHAPES, ("float32",), 22))
    log("  K1/K2 at phase 17's shares of falcon-mamba-7b's, "
        "recurrentgemma-2b's and musicgen-medium's Muon buckets (each data "
        "rank's half)")
    rows = gemm_shape_checks(torch, rows, P17_SHAPES, ("float32",), 23)
    timings.update(gemm_shape_timings(torch, P17_SHAPES, ("float32",), 24,
                                      RECURRENT_REPS))

    runs = {}
    log("phase 4: PRISM-5 path, gpt2-paper Muon step at full width")
    runs["prism5"] = train_path(torch, "prism5")
    _drop(torch, runs["prism5"])

    log("phase 5: PRISM-3 path (fitted iterations) at full width")
    run3 = runs["prism3"] = train_path(torch, "prism3")
    fallback = fallback_path(torch, run3)
    if len(run3["syncs"]) > len(runs["prism5"]["syncs"]):
        fail(f"the fitted iterations add synchronizing calls: PRISM-3 "
             f"{run3['syncs']} vs PRISM-5 {runs['prism5']['syncs']}")
    profile_step(torch, run3, "PRISM-3 Muon", ((40, 2), (20, 2), (30, 2)))
    log("  adaptive runs (tol, budget 5)")
    adaptive_runs(torch)
    _drop(torch, run3)

    log("phase 6: Shampoo PRISM-5 path, gpt2-paper step at full width")
    runs["shampoo_prism5"] = train_path(torch, "shampoo_prism5")
    profile_step(torch, runs["shampoo_prism5"], "Shampoo PRISM-5")
    _drop(torch, runs["shampoo_prism5"])

    log("phase 7: Shampoo fitted path (Fig. 5 PRISM) at full width")
    runf = runs["shampoo_fig5"] = train_path(torch, "shampoo_fig5")
    shampoo_extras(torch, runf)
    profile_step(torch, runf, "fitted Shampoo", ((30, 5), (30, 5), (100, 5)))
    if len(runf["syncs"]) > len(runs["shampoo_prism5"]["syncs"]):
        fail(f"the fitted iterations add synchronizing calls: fitted "
             f"{runf['syncs']} vs warm {runs['shampoo_prism5']['syncs']}")
    log("  synchronizing calls an optimizer step: "
        + ", ".join(f"{k} {len(r['syncs'])}" for k, r in runs.items())
        + f" (bound {SYNCS_BOUND}, K3's former alpha copy)")
    log("  adaptive sqrtm runs (tol, budget 5)")
    adaptive_sqrtm_runs(torch)
    _drop(torch, runf)

    log("phase 8: the main example through the Trainer, gpt2-paper Muon "
        f"PRISM-5, precond_every {TRAINER_K}, at full width")
    phase8 = trainer_path(torch)
    baseline_steps(torch, runs["prism5"]["opt_ms"]["kernels"])
    guard_check(torch, len(runs["prism5"]["syncs"]))

    log("phase 9: Shampoo's other inverse roots and Muon's lowrank tier at "
        "full width")
    phase9(torch, runs)

    log("phase 10: the async refresh plane at full width")
    async_counts = phase10(torch, phase8)

    log("phase 11: serving gpt2-paper at full width")
    phase11(torch)

    log(f"phase 12: the moe family: granite-moe-1b-a400m ({GRANITE_LAYERS} "
        f"layers) trained through launch/train.py's configuration and "
        f"served at full width; mixtral-8x7b, musicgen-medium and "
        f"llava-next-34b at their widths, {FAMILY_LAYERS} layers")
    granite = phase12(torch)

    log(f"phase 13: the recurrent families: recurrentgemma-2b "
        f"({RGEMMA_LAYERS} layers) and falcon-mamba-7b ({FALCON_LAYERS} "
        f"layers) trained through "
        "launch/train.py's configuration and served at full width")
    recurrent = phase13(torch)

    log(f"phase 14: data parallelism, {P14_WORLD} ranks on the card (gloo): "
        f"the §8 engine, the Trainer, bf16 gradients and int8 compression, "
        f"an elastic restore, the async plane")
    t0 = time.perf_counter()
    dp = phase14(torch)
    log(f"  phase 14 in {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - _T0:.1f} s")

    log(f"phase 15: the model axis, {P15_WORLD} ranks on the card (gloo) on "
        f"a {P15_MESH} (data, model) mesh: tensor parallelism, then ZeRO-3 "
        f"with Muon's local reshard from its checkpoint; Shampoo PRISM-5 "
        f"and fitted, the async plane, its checkpoint restored as blocks")
    t0 = time.perf_counter()
    mp = phase15(torch)
    log(f"  phase 15 in {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - _T0:.1f} s")

    log(f"phase 16: the moe family on the mesh, {P15_WORLD} ranks on the "
        f"card (gloo) on a {P15_MESH} (data, model) mesh: granite-moe-1b-"
        f"a400m ({P16_LAYERS} layers) under tp with expert parallelism, "
        f"resumed under zero, tp with each expert's columns, and a drop "
        f"control at capacity {P16_DROP_CAPACITY}")
    t0 = time.perf_counter()
    moe_mesh = phase16(torch)
    log(f"  phase 16 in {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - _T0:.1f} s")

    log(f"phase 17: the ssm, hybrid and audio families on the mesh, "
        f"{P15_WORLD} ranks on the card (gloo) on a {P15_MESH} (data, model) "
        f"mesh: falcon-mamba-7b ({P17_RUNS['a'][1]} layers), "
        f"recurrentgemma-2b ({P17_RUNS['b'][1]}) and musicgen-medium "
        f"({P17_RUNS['c'][1]}) under tp, musicgen resumed under zero")
    t0 = time.perf_counter()
    family_mesh = phase17(torch)
    log(f"  phase 17 in {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - _T0:.1f} s")

    log(f"phase 18: serving on the mesh, {P18_WORLD} ranks on the card "
        f"(gloo) on a {P18_MESH} (data, model) mesh: gpt2-paper under "
        f"serve and tp at batch 4 and serve at batch 1, granite-moe-1b-"
        f"a400m, falcon-mamba-7b and recurrentgemma-2b under serve, the "
        f"decode caches split over kv_seq")
    t0 = time.perf_counter()
    serve_mesh = phase18(torch)
    log(f"  phase 18 in {time.perf_counter() - t0:.1f} s; the script so far "
        f"{time.perf_counter() - _T0:.1f} s")

    by_path = {k: r["counts"] for k, r in runs.items()}
    by_path["fallback"] = fallback
    by_path["trainer"] = phase8["counts"]
    by_path.update(async_counts)
    by_path["granite"] = granite
    by_path.update(recurrent)
    by_path["data_parallel_rank0"] = dp
    by_path["model_axis_tp_rank0"] = mp["tp"]
    by_path["model_axis_zero_rank0"] = mp["zero"]
    by_path.update({path: mp[path] for path in P15_NEW_PATHS.values()})
    by_path.update(moe_mesh)
    by_path.update(family_mesh)
    by_path[P18_PATH] = serve_mesh
    print(json.dumps({"kernels": kernel_rows(rows, timings, by_path)}),
          flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def ptxas_summary(build) -> None:
    """Registers, spills and static shared memory of each instantiation of
    K1 and K2 (a spill fails), and registers and spills of K3's to K7's,
    from the compiler's -Xptxas -v report of this build."""
    import re

    from repro_torch.kernels import matmul_add

    spills = []
    for name in ("matmul_add", "gram_upper"):
        text = build.LOGS.get(name)
        if text is None:
            log(f"  ptxas {name}: cached build, no report")
            continue
        for entry in text.split("Compiling entry function")[1:]:
            kernel = re.search(r"_kernelI(\w+?)Lb([01])E", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            what = (f"{'bf16' if 'bfloat16' in kernel.group(1) else 'fp32'}"
                    f" {'aligned' if kernel.group(2) == '1' else 'unaligned'}"
                    if kernel else "?")
            log(f"  ptxas {name} {what}: "
                f"{regs.group(1) if regs else '?'} registers, spill stores "
                f"{spill.group(1) if spill else '?'} B, spill loads "
                f"{spill.group(2) if spill else '?'} B, static smem "
                f"{smem.group(1) if smem else 0} B (+ dynamic "
                f"{matmul_add.smem_bytes()} B)")
            if spill and (spill.group(1) != "0" or spill.group(2) != "0"):
                spills.append(f"{name} {what}")
    if spills:
        fail(f"register spills in {spills}")
    for name in ("warm_tail", "residual_chain", "apply_g"):
        for entry in (build.LOGS.get(name) or "").split(
                "Compiling entry function")[1:]:
            kernel = re.search(r"_kernelI(\w+?)Li?b?(\w+?)EE", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", entry)
            if kernel:
                log(f"  ptxas {name} "
                    f"{'bf16' if 'bfloat16' in kernel.group(1) else 'fp32'}"
                    f" {kernel.group(2)}: {regs.group(1) if regs else '?'} "
                    f"registers, spill stores "
                    f"{spill.group(1) if spill else '?'} B, spill loads "
                    f"{spill.group(2) if spill else '?'} B")
    for name in ("sketch_step", "sketch_chain"):
        for entry in (build.LOGS.get(name) or "").split(
                "Compiling entry function")[1:]:
            kernel = re.search(rf"{name}_kernelI(\w+?)Li(\d+)ELi(\d+)E",
                               entry)
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", entry)
            if kernel:
                log(f"  ptxas {name} "
                    f"{'bf16' if 'bfloat16' in kernel.group(1) else 'fp32'}"
                    f" vec {kernel.group(2)} tile {kernel.group(3)}: "
                    f"{regs.group(1) if regs else '?'} registers, spill "
                    f"stores {spill.group(1) if spill else '?'} B, spill "
                    f"loads {spill.group(2) if spill else '?'} B")


def _drop(torch, run):
    """Free a path's model, optimizer and saved tensors; keep its counts."""
    for k in ("model", "opt", "state", "before", "grads", "deltas"):
        run.pop(k, None)
    torch.cuda.empty_cache()


def _p15_path(what):
    """The kernels line's path of a ``P15_SHAPES`` entry."""
    return ("model_axis_tp_rank0" if what.startswith("(a)")
            else "model_axis_zero_rank0")


def _p17_paths(what):
    """The kernels line's paths of a ``P17_SHAPES`` entry: "(a) ..." is
    (a)'s, "(c)/(d) ..." (c)'s and (d)'s."""
    tags = what.split(" ", 1)[0].strip("()").split(")/(")
    return [P17_PATHS[t] for t in tags]


# The kernels line: for each kernel, the measurements of each family and
# main-path shape it was timed at, as (family, row/timing key, path); the
# first entry, the one this slice's path runs where it runs one (K1's and
# K2's: phase 17 (a)'s share of falcon-mamba-7b's in_proj bucket), gives
# the kernel's top-level numbers.  Sign runs on no training path (signm only),
# nor do K1's and K2's bf16 rows (the paths' matfn dtype is fp32).
VARIANTS = {
    "matmul_add": [
        ("-", _lowrank_key(n, a, b, "float32"), path)
        for n, a, b, _, w in P17_SHAPES if n == "matmul_add"
        for path in _p17_paths(w)] + [
        ("-", _lowrank_key(n, a, b, "float32"), path)
        for n, a, b, _, _ in P16_SHAPES if n == "matmul_add"
        for path in P16_PATHS.values()] + [
        ("-", _lowrank_key(n, a, b, "float32"),
         "rgemma" if "recurrentgemma" in w else "falcon")
        for n, a, b, _, w in RECURRENT_SHAPES if n == "matmul_add"] + [
        ("-", _lowrank_key(n, a, b, "float32"), "granite")
        for n, a, b, _, _ in GRANITE_SHAPES if n == "matmul_add"] + [
        ("-", _lowrank_key(n, a, b, "float32"), _p15_path(w))
        for n, a, b, _, w in P15_SHAPES if n == "matmul_add"] + [
        ("-", _lowrank_key(n, a, b, "float32"), P15_NEW_PATHS["e"])
        for n, a, b, _, w in P15_SHAPES
        if n == "matmul_add" and w.startswith("(a)")] + [
        ("-", _lowrank_key(n, a, b, "float32"), P15_NEW_PATHS[k])
        for n, a, b, _, _ in P15_SHAMPOO_SHAPES for k in "cd"] + [

        ("-", ("matmul_add", (20, 4096, 1024)), "trainer"),
        ("-", ("matmul_add", (40, 1024, 1024)), "trainer"),
        ("-", ("matmul_add", (100, 1024, 1024)), "shampoo_prism5"),
        ("-", ("matmul_add", (100, 1024, 1024), "bfloat16"), None),
        ("-", ("matmul_add", (20, 4096, 1024), "bfloat16"), None),
        ("-", ("matmul_add", (40, 1024, 1024), "bfloat16"), None)]
    + [("-", _lowrank_key(n, a, b, dt), "muon_lowrank" if dt == "float32"
        else None)
       for n, a, b, _, _ in LOWRANK_SHAPES if n == "matmul_add"
       for dt in DTYPES],
    "gram_upper": [
        ("polar", _lowrank_key(n, a, b, "float32"), path)
        for n, a, b, _, w in P17_SHAPES if n == "gram_upper"
        for path in _p17_paths(w)] + [
        ("polar", _lowrank_key(n, a, b, "float32"), path)
        for n, a, b, _, _ in P16_SHAPES if n == "gram_upper"
        for path in P16_PATHS.values()] + [
        ("polar", _lowrank_key(n, a, b, "float32"),
         "rgemma" if "recurrentgemma" in w else "falcon")
        for n, a, b, _, w in RECURRENT_SHAPES if n == "gram_upper"] + [
        ("polar", _lowrank_key(n, a, b, "float32"), "granite")
        for n, a, b, _, _ in GRANITE_SHAPES if n == "gram_upper"] + [
        ("polar", _lowrank_key(n, a, b, "float32"), _p15_path(w))
        for n, a, b, _, w in P15_SHAPES if n == "gram_upper"] + [
        ("polar", _lowrank_key(n, a, b, "float32"), P15_NEW_PATHS["e"])
        for n, a, b, _, w in P15_SHAPES
        if n == "gram_upper" and w.startswith("(a)")] + [

        ("polar", ("gram_upper", (20, 4096, 1024)), "trainer"),
        ("polar", ("gram_upper", (40, 1024, 1024)), "trainer"),
        ("polar", ("gram_upper", (20, 4096, 1024), "bfloat16"), None),
        ("polar", ("gram_upper", (40, 1024, 1024), "bfloat16"), None)]
    + [("polar", _lowrank_key(n, a, b, dt), "muon_lowrank"
        if dt == "float32" else None)
       for n, a, b, _, _ in LOWRANK_SHAPES if n == "gram_upper"
       for dt in DTYPES],
    "warm_tail": [
        ("polar", ("warm_tail", (30, 64, 16)), "trainer"),
        ("sqrt", ("warm_tail/sqrt", (30, 64, 64)), "shampoo_prism5"),
        ("sqrt", ("warm_tail/sqrt", (30, 16, 16)), "shampoo_prism5"),
        ("sqrt", ("warm_tail/sqrt", (15, 64, 64)), P15_NEW_PATHS["c"]),
        ("sqrt", ("warm_tail/sqrt", (15, 16, 16)), P15_NEW_PATHS["c"]),
        ("polar", ("warm_tail", (15, 64, 16)), "model_axis_tp_rank0"),
        ("polar", ("warm_tail", (15, 64, 16)), P15_NEW_PATHS["e"]),
        ("sign", ("warm_tail/sign", (30, 64, 64)), None)],
    "sketch_step": [
        ("-", ("sketch_step", (40, 1024, 1024)), "fallback"),
        ("-", ("sketch_step", (20, 1024, 1024)), "fallback"),
        ("-", ("sketch_step", (4, 4096, 4096)), None)],
    "sketch_chain": [
        ("-", ("sketch_chain", (100, 1024, 1024, 10)), "shampoo_fig5"),
        ("-", ("sketch_chain", (40, 1024, 1024, 6)), "prism3"),
        ("-", ("sketch_chain", (20, 1024, 1024, 6)), "prism3"),
        ("-", ("sketch_chain", (50, 1024, 1024, 10)), P15_NEW_PATHS["d"])],
    "residual_chain": [
        ("sqrt", ("residual_chain/sqrt", (30, 64, 64)), "shampoo_fig5"),
        ("sqrt", ("residual_chain/sqrt", (30, 16, 16)), "shampoo_fig5"),
        ("sqrt", ("residual_chain/sqrt", (15, 64, 64)), P15_NEW_PATHS["d"]),
        ("sqrt", ("residual_chain/sqrt", (15, 16, 16)), P15_NEW_PATHS["d"]),
        ("sign", ("residual_chain/sign", (30, 64, 64)), None),
        ("polar", ("residual_chain", (30, 64, 16, 6)), "prism3")],
    "apply_g": [
        ("coupled", ("apply_g/coupled", (30, 64, 64)), "shampoo_fig5"),
        ("coupled", ("apply_g/coupled", (30, 16, 16)), "shampoo_fig5"),
        ("coupled", ("apply_g/coupled", (15, 64, 64)), P15_NEW_PATHS["d"]),
        ("coupled", ("apply_g/coupled", (15, 16, 16)), P15_NEW_PATHS["d"]),
        ("polar", ("apply_g", (30, 64, 16)), "prism3")],
}
REPLACES = {"matmul_add": "src/repro/kernels/matmul_add.py:55",
            "gram_upper": "src/repro/kernels/gram.py:81",
            "warm_tail": "src/repro/kernels/fused_iter.py:301",
            "sketch_step": "src/repro/kernels/sketch_traces.py:64",
            "sketch_chain": "src/repro/kernels/sketch_traces.py:163",
            "residual_chain": "src/repro/kernels/fused_iter.py:138",
            "apply_g": "src/repro/kernels/fused_iter.py:209"}


def kernel_rows(rows, timings, by_path):
    """The entries of the kernels line (see VARIANTS)."""
    out = []
    for name in KERNEL_NAMES:
        variants = []
        for family, key, path in VARIANTS[name]:
            t = timings[key]
            variants.append({
                "family": family, "shape": rows[key]["shape"],
                "path": path,
                "launches": by_path[path][name] if path else 0,
                "max_abs_err": rows[key]["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
                "bound_by": t["bound"][1], "library_ms": t["library_ms"],
                "back_to_back_ms": t.get("b2b_ms"),
                "device_ms": t.get("device_ms"),
                "dtype": key[2] if len(key) > 2 else "float32"})
        top = variants[0]
        out.append({
            "name": name, "status": "ported", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "families": sorted({v["family"] for v in variants}),
            "launches_by_path": {k: v[name] for k, v in by_path.items()},
            **{k: top[k] for k in ("path", "launches", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by",
                                   "library_ms", "back_to_back_ms",
                                   "device_ms", "shape", "dtype")},
            "variants": variants})
    return out


if __name__ == "__main__":
    main()
