"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure raises and the script exits
non-zero without the final result line:

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the five kernels' nine libraries (the forward B1
             as csrc/fused_edge_conv_wgmma.cu, bfloat16 on the tensor cores,
             and csrc/fused_edge_conv_f32_wgmma.cu, float32 on the tensor
             cores through exact three-part bf16 splits; the backward B2 as
             csrc/fused_edge_conv_bwd_wgmma.cu and
             csrc/fused_edge_conv_bwd_f32_wgmma.cu, the same way; their
             rank-r counterparts B3 as csrc/fused_edge_conv_lowrank_wgmma.cu
             and csrc/fused_edge_conv_lowrank_f32_wgmma.cu, and B4 as
             csrc/fused_edge_conv_lowrank_bwd_wgmma.cu and
             csrc/fused_edge_conv_lowrank_bwd_f32_wgmma.cu, the same way at
             every rank, a rank that is not a multiple of 8 padded to the
             next one; and B5, the per-edge messages of conv mode 'pallas',
             float32 on the tensor cores through exact bf16 splits as
             csrc/fused_edge_messages_wgmma.cu on the float32 B1's column
             chunks; one launch of B1, B2 or B5 takes widths and K up to
             256, past it the wrappers run pieces of at most 256 of each)
             from the checkout, one nvcc each, started together; prints
             ptxas's registers and spills of the tensor-core kernels, their
             blocks per SM, chunks and shared memory (each held to the
             wrapper's mirror of the kernel's layout) (``[ptxas]``).
3. kernel  — B1 against its plain PyTorch version on the card, at the
             full-size serving chunk shape, on operands from the real dataset
             chunk: float32 (TF32 off) and bfloat16, compact and dense S,
             each line naming the design that ran (``design=wgmma`` for every
             kernel in both types, as ``fused_conv.design`` says); every
             launch is repeated and must give the same bits.
4. bwd     — B2 against its plain version at the same shape and operands with
             a seeded output gradient, both types and both S forms (repeated
             as B1); then the differentiable layer's gradients on the card
             against the CPU's plain ones on the small mesh's graph.
   train batch — both kernels again at the shapes training gives them: the
             first layer's operands of the 12-subdomain train batch and the
             4-subdomain val batch, built as the scheduler builds them (one
             common blk); B1 and B2 (with a seeded output gradient) on both,
             both types and both S forms.
5. serve   — the port's ``pred_graph_ALDD`` on the synthetic duct at the full
             width of configs/exp_config/neuralop_synthetic_full.yaml (width
             48, depth 4) with a seeded checkpoint: two full-size meshes
             (general lane, 2 chunks x 4 layers = 8 launches each) and one
             small mesh (fast lane, 4 launches); every .vtu finite; the card's
             prediction against the port's float32 plain prediction on the CPU.
6. train   — ``train_graph_ALDD`` on the full-size meshes (16 subdomains,
             12 train / 4 val) with configs/train_config/synthetic_full.yaml
             cut to 10 epochs: finite losses that fall, B2 launched depth x
             steps times and B1 depth x (steps + validations), a checkpoint
             written, then served to a finite .vtu.
7. parity  — three float32 fused train steps on the small mesh on the card
             (kernels, each launched depth times a step and no other, their
             design and counts logged) and on the CPU (plain versions), each
             card step started from the CPU's state at that step (parameters
             and Adam's moments; step 0 the same seeded weights) on the
             CPU's activation branches (a pre-activation within rounding of
             zero may flip; ``own_branch_flips`` counts them): each step's
             loss and every parameter's gradient (relative to its largest
             entry) agree within 1e-4, on every path, or the run fails.
             The CPU's steps run in a worker process from the start; the
             card's side of every path runs after the other phases, when
             they are ready (``[parity] wall_s``).
8. times   — CUDA-event medians of both kernels and their plain versions, the
             warm wall time of one full-size request and of one fused train
             step, and profiles of both.  A float32 kernel on the tensor
             cores is bound by the lesser of float32 FMAs and six bf16
             passes (``bound_basis``; ``bound_fma_ms`` the former).

Phases 3-8 then run again for the rank-16 path, the same config with
``kernel_rank: 16`` (edge-MLP head 2 x 16 x 48 = 1536 columns, factorized
edge kernels) and its depth cut to 2 to keep the run short: B3 and B4
against their plain versions at the same shapes in both types
(``[lowrank_kernel]``, ``[lowrank_bwd]``; float32 on the tensor cores,
``design=wgmma``, csrc/fused_edge_conv_lowrank_f32_wgmma.cu and
csrc/fused_edge_conv_lowrank_bwd_f32_wgmma.cu), serving with 4 B3 launches
per full-size request and none of B1, training with B4 launched depth x
steps times and neither B1 nor B2 (and the same training in float32, for
its loss curve beside the bfloat16 one), card-vs-CPU parity (float32: 6 B3
and 6 B4 launches), and their times (``[lowrank_*]`` lines; the float32
bounds on the six-pass basis).  They run a third time for TEECNet at the full
width of configs/exp_config/teecnet_ansys.yaml (width 48, 5 layers, edge MLP
K = 128) on the same meshes (``[teecnet_*]`` lines): B1 and B2 at K = 128,
10 B1 launches per full-size request, configs/train_config/teecnet.yaml cut
to 2 epochs (its loss is recorded, not held to fall).

   rank 12 — the rank-16 path's config with ``kernel_rank: 12`` (depth 2, a
             rank B3/B4 run padded to 16): one full-size request (4 B3
             launches, the prediction against the CPU's float32 plain one),
             ``train_graph_ALDD`` cut to 2 epochs in bfloat16 and in float32
             (B3 and B4 launch counts held), phase 7's float32 parity card
             vs CPU; B3 and B4 against their plain versions at the full-size
             chunk at ranks 1, 4, 12, 20, 28 and 31 (rank 12 also at the
             train and val batches), both types, both S forms, repeated
             launches bit-identical (``[rank<r>_kernel]``,
             ``[rank<r>_bwd]``); their times and bounds at ranks 4 and 12
             (``[rank<r>_times]``; a padded instance reaches at most r / rp
             of its bound), the warm request and train steps at rank 12
             (``[rank12_*]`` lines).

   width 128 — configs/exp_config/neuralop_synthetic_w64.yaml with
             ``width: 128`` set in memory (K = 128) and its depth cut to 2:
             both full-size meshes served (2 chunks x 2 layers = 4 B1
             launches each, every .vtu finite) and the small mesh against
             the CPU's float32 plain prediction; ``train_graph_ALDD`` cut to
             2 epochs in bfloat16 and in float32 (B1 and B2 launch counts
             held); phase 7's float32 parity card vs CPU; B1 and B2 against
             their plain versions at (c_in, c_out, K) = (128, 128, 128),
             (96, 96, 96), (127, 127, 128) and (72, 128, 48) on the leading
             16 receiver blocks of the full-size chunk (the plain versions'
             [slots, c_in c_out] arrays would take 16 GB on all of it), both
             types, both S forms, repeated launches bit-identical; B1's and
             B2's times and bounds on the full-size chunk (the plain
             versions' on the slice), the warm request and a fused train
             step in both types; TEECNet from teecnet_ansys.yaml at width
             128 (K 128) serving one full-size request (10 B1 launches) and
             trained one epoch (``[w128_*]``, ``[teecnet_w128_*]`` lines).

   width 128, rank r — the width-128 path's config with ``kernel_rank: 32``
             (head 2 x 32 x 128 = 8 192 columns; B3 and B4 past width 64,
             K 64 and rank 32): both full-size meshes served (4 B3 launches
             each, none of B1 or B2, every .vtu finite) and the small mesh
             against the CPU's float32 plain prediction;
             ``train_graph_ALDD`` cut to 1 epoch in bfloat16 and in float32
             (B3 and B4 launch counts held); phase 7's float32 parity card
             vs CPU; B3 and B4 against their plain versions at
             (c_in, c_out, K, rank) = (128, 128, 128, 64), (128, 128, 128,
             32), (128, 128, 128, 40), (96, 96, 96, 48), (127, 127, 128, 57),
             (72, 128, 48, 20) and (48, 48, 48, 36) on the leading 16
             receiver blocks of the full-size chunk, both types, both S
             forms, repeated launches bit-identical; their times and bounds
             on the full-size chunk at rank 32 (the plain versions' on the
             slice; rank 64 at this width: lowrank_step_check.py --width
             128), the warm request and a fused train step in both types
             (``[w128r_*]``, ``[w128r<r>_*]`` lines).

   width 256 — the width-128 path's config at width 256 (K = 256, depth
             2; B1 and B2 past width 128: the bfloat16 B1 in column chunks
             of c_out and B2's rows kernel in chunks of c_in, the float32
             ones with the A operand's parts in shared memory past a depth
             of 128): both full-size meshes served (4 B1 launches each, every
             .vtu finite), the small mesh against the CPU's float32 plain
             prediction and, in 'edge3d' on the card (the general lane, no
             kernel), against it too, and in 'pallas' (B5, 2 launches)
             against both; ``train_graph_ALDD`` for one epoch in
             bfloat16 and in float32 (B1 and B2 launch counts held); phase
             7's float32 parity card vs CPU; B1 and B2 against their plain
             versions at (c_in, c_out, K) = (256, 256, 256), (256, 256,
             128), (129, 129, 129), (136, 250, 200), (48, 256, 256) and
             (256, 40, 72) on the leading 16 receiver blocks of the
             full-size chunk, both types, both S forms, repeated launches
             bit-identical; their times at (256, 256, 256) on the full-size
             chunk (the plain versions' on the slice), the warm request and
             a fused train step in each type; TEECNet at width 256 (K 128)
             serving one full-size request and trained one epoch, its B1 and
             B2 checked and timed at its own chunk (``[w256_*]``,
             ``[teecnet_w256_*]`` lines).

   width 256, rank r — the width-256 path's config with ``kernel_rank:
             32`` (head 2 x 32 x 256 = 16 384 columns; B3 and B4 past width
             and K 128: the bfloat16 chunks in stages of 64 deep past a
             depth of 128, the float32 kernels in their wide layouts): both
             full-size meshes served (4 B3 launches each, none of B1 or B2,
             every .vtu finite) and the small mesh against the CPU's
             float32 plain prediction; ``train_graph_ALDD`` for one epoch in
             bfloat16 and in float32 (B3 and B4 launch counts held); phase
             7's float32 parity card vs CPU; at ``kernel_rank: 100`` (two
             slabs of 64) one full-size request (4 B3 launches) and the
             parity again; B3 and B4 against their
             plain versions at (c_in, c_out, K, rank) = (256, 256, 256, 64),
             (256, 256, 256, 32), (129, 129, 129, 57), (136, 250, 200, 33),
             (48, 48, 256, 16), (256, 48, 64, 24) and (40, 256, 72, 40) on
             the leading 16 receiver blocks of the full-size chunk, and past
             rank 64 (slabs of 64 in turn inside each kernel) at (256, 256,
             256, 256), (256, 256, 256, 100), (128, 128, 128, 128), (129,
             129, 129, 65), (136, 250, 200, 97) and (40, 48, 72, 200), both
             types, both S forms, repeated launches bit-identical; their
             times and bounds on the full-size chunk at ranks 32, 100 and
             256 (the plain versions' on the slice), the warm request and a
             fused train step in each type (``[w256r_*]``, ``[w256r<r>_*]``
             lines).

   width 320 — the width-128 path's config at width 320 (K = 320, depth
             2; B1, B2 and B5 past 256: the wrappers cut each of K, c_in
             and c_out into pieces of at most 256, two of 160 here, and run
             each piece on the existing instances, eight launches a layer,
             their results added in a fixed order): both full-size meshes
             served (4 x 8 B1 launches each, every .vtu finite), the small
             mesh against the CPU's float32 plain prediction, in 'edge3d'
             on the card and in 'pallas' (B5, 2 x 8 launches) against it;
             ``train_graph_ALDD`` for one epoch in bfloat16 and in float32;
             phase 7's float32 parity card vs CPU; B1 and B2 against their
             plain versions at (c_in, c_out, K) = (320, 320, 320), (257,
             257, 257), (300, 520, 264), (264, 136, 520), (600, 40, 17) and
             (512, 512, 512) on the leading receiver blocks of the
             full-size chunk (fewer than 16 where the plain versions'
             [slots, c_in c_out] arrays would pass ``PLAIN_BYTES``), both
             types, both S forms, repeated launches bit-identical; their
             times at 320 on the full-size chunk, the warm request and a
             fused train step in each type; TEECNet at width 320 (K 128,
             four pieces a layer) serving one full-size request and trained
             one epoch, its B1 and B2 checked and timed at its chunk
             (``[w320_*]``, ``[teecnet_w320_*]`` lines).

             Phase 7's CPU side of every path runs in one worker process at
             niceness ``PARITY_NICE``, started right after the build, while
             the card's phases go on (the plain steps take 90-190 s at
             width 256, 310-340 s at 320), and saves each step's starting
             state, loss and gradients for the card's side; each path's
             ``*_parity`` line with ``cpu=worker`` gives the worker's
             seconds, how long the path waited for them and when they
             ended (``ended_at_s``, from the start of the run).  The CPU
             references of the phases after the first path (the float32
             plain predictions from the ``*_cpu`` checkpoints, and phase
             25's CPU steps) run in a second worker at niceness
             ``REF_NICE``, also from the build's end, in the order the
             phases need them (``start_references``, ``cpu_prediction``);
             both workers are stopped while a phase is timed (``quiet``).
             The meshes and checkpoints are made while the build runs.

9. pallas  — KernelNN and TEECNet built with ``mode='pallas'`` serve one
             full-size mesh each with FESR_FUSED_PREDICT=0 (the general lane's
             ``apply``): B5 launched depth x chunks times (8, 10), no other
             kernel; the prediction against the same checkpoint's 'edge3d'
             prediction on the card; each model's warm request time in
             both modes.  The same for the width-128 path's KernelNN (K
             128, depth 2: 4 launches) and TEECNet (K 128: 10 launches),
             from their checkpoints (``model=kernelnn_w128``,
             ``model=teecnet_w128``), and for the width-256 path's
             (``model=kernelnn_w256``: K 256, 4 launches;
             ``model=teecnet_w256``: K 128, 10 launches) in 'pallas' alone
             ('edge3d' would build [E, c_in c_out] arrays of 67 GB; their
             small mesh is held to 'edge3d' in the width-256 path), and
             for the width-320 path's (``model=kernelnn_w320``: K 320, 4 x
             8 launches; ``model=teecnet_w320``: K 128, 10 x 4 launches),
             pieces of at most 256.  B5
             against its plain version at the six chunk shapes (K 48, K 128
             at width 48; K = c_in = c_out = 128 twice; K = c_in = c_out =
             256, and K 128 at c_in = c_out = 256), repeated launches
             bit-identical, its first launch (the stage image of w3 and b3)
             bit-equal to its plain version, and the times of B5, its plain
             version and one einsum computing the same function
             (``library_ms``; at widths 128 and 256 the plain version and
             the einsum on the chunk's first ``MSG_SLICE`` edges, the
             kernel's time there beside them); its bound is the lesser of
             float32 FMAs and six bf16 tensor-core passes (``bound_basis``;
             ``bound_fma_ms`` the former).  B5 alone, checked the same way,
             at (K, c_in, c_out) = (256, 256, 256), (128, 256, 256), (256,
             48, 200), (96, 200, 72), (129, 129, 129) and (200, 136, 250) on
             the leading ``MSG_SLICE`` edges of the width-256 chunk, and as
             pieces at the width-320 path's six shapes as (K, c_in, c_out)
             on the width-320 chunk's leading edges (fewer where the plain
             version's array would pass ``PLAIN_BYTES``), each piece's
             stage image bit-equal to ``stage_image``'s.

10. routed — the paper's routed pipeline at the full width of
             configs/exp_config/neuralop_synthetic_full.yaml with
             ``n_clusters: 2`` and ``n_components: 2`` of
             configs/exp_config/neuralop_synthetic_routed.yaml added in
             memory, ``--encoder=pca --classifier=kmeans``: training on the
             full-size meshes (partition sizes, each expert's losses, B2
             launched depth x steps summed over the experts, checkpoints and
             routing state written); serving both full-size meshes through
             the routed predict (B1 launched depth x sum_k ceil(n_k /
             chunk_b) times for the request's label counts n_k), full
             mesh 0 again with a smaller budget (a padded tail chunk in a
             label group) and a larger one (the routed lane over at least
             two label groups), and the small mesh through the routed lane;
             every .vtu finite, labels
             on the card equal to the CPU's, the prediction against the
             port's float32 plain one on the CPU; B1 and B2 against their
             plain versions on a routed chunk's and an expert's batches;
             warm times of a routed full-size request and a routed-lane
             request (``[routed_*]`` lines).
11. coalesced — R = 4 seeded payloads on the small mesh through
             ``predict_full_batch``, each against its own ``predict_full``,
             and the batch's warm time against R single requests
             (``[coalesced*]`` lines).

12. physics_ops — every physics operator on the full mesh's duct (27 648
             nodes, K 16) with the analytic field plus noise 0.05: both
             weight operators (and the fallback-branch nodes counted on both
             sides), both divergences, the Laplacian, the composite A and its
             adjoint A^T in both forms, the pressure correction and one CGNR
             solve at 20 iterations, card against the port's CPU results;
             the adjoint's dot-product test in float64 on the card; the
             composite pair's time against its bound, and the masked CG's
             cost per inner iteration (``[physics_ops]``).
13. physics_smooth — ``pred_graph_ALDD(smooth=True)`` on both full meshes
             from the serve phase's checkpoint (B1 8 times each, counted as
             B1's ``smooth`` launches): initial and final divergence, ratio,
             the projection's and the request's wall time; two projections
             of one field give the same bits; on the small mesh the card's
             host and device loops against the CPU's.
14. physics_amg — the AMG host build on the full mesh (seconds, level
             sizes), one V-cycle card vs CPU on the same hierarchy, and the
             device loop with ``precond='amg'`` against ``'none'``.
15. physics_scale — the device loop at 97 556 nodes
             (benchmarks/projection_scale.py's field; the reference's
             500k-1M nodes are cut to fit the time limit), plain and AMG.
16. wss     — ``python -m fast_eng_super_resolution_tpu_torch.compute_wss``
             on the first smoothed .vtu, each field's .vtp against the CPU,
             and the analytic shear on a duct.
17. powerseries — TEECNet at teecnet_ansys.yaml's width with
             ``kernel_type='powerseries'``: one full-size request through the
             general lane, no kernel launched; the small mesh card vs CPU.
18. lut     — KernelNN at full width in mode 'lut' and with
             ``kernel_dtype='bfloat16'`` in mode 'edge3d', the same way.

19. grid    — the one-step grid family, which runs no hand-written kernel
             (B1-B5 launched 0 times across these phases), at the published
             widths, modes, resolution, padding and batch of
             configs/exp_config/fno_advected_256.yaml (FNO2d, width 16,
             modes 12, 256^2 padded to 265^2, batch 32),
             fno3d_advected_64.yaml (FNO3d, width 16, modes 8, 64^3 padded
             to 70^3, batch 16), fno_burgers.yaml (FNO1d, width 32, modes
             16, 256 points) and deeponet_advected.yaml (width 128, 64^2,
             trunk_size 2), each with its recipe (fno_advected.yaml,
             fno3d_advected.yaml).  Cut: the sample count (72, 24, 40, 40,
             with train_samples 64, 16, 32, 32 and the idxs to match; the
             datasets are generated in worker processes during phases
             2-18) and the recipe's 300 epochs to 10.  ``[grid_spectral]``:
             one spectral conv per FNO, 'fft' (cuFFT) vs 'matmul' on the
             card vs the CPU, their warm times and the form 'auto' takes;
             ``[grid_train]``: ``train_grid`` per model (finite losses,
             FNO2d's falling, the stamped checkpoint, the warm step, the
             peak memory); ``[grid_parity]``: three FNO2d steps card vs
             CPU; ``[grid_serve]``: ``pred_grid`` per checkpoint (finite
             .npz, the improvement factors, the warm request).

20. rollout — the grid rollout lane at the published widths, modes,
             resolution, t_frames, trajectory counts and train_samples of
             configs/exp_config/fno_ns_rollout.yaml (128 NS trajectories,
             64^2, T 16), fno_ns_rollout_guided.yaml (the same data with
             the coarse guidance channel), fno_adv_rollout.yaml (128, 64^2,
             T 10, velocity as static channels) and fno3d_adv_rollout.yaml
             (64 volumes, 32^3, T 10), each with its recipe
             (fno_advected.yaml, batch 32; fno3d_advected.yaml, batch 16)
             cut from 300 epochs to ROLLOUT_EPOCHS (the trajectories are
             generated in worker processes during phases 2-18):
             ``train_grid``, then ``pred_rollout`` with rollout_impl 'scan'
             and 'stepwise' (the same bits), the card against the port's
             CPU run of the same checkpoint, finite .npz artifacts; the warm
             rollout per impl, per step, its peak memory, the train step and
             the improvement factors (recorded, not held)
             (``[rollout_*]`` lines).
21. mat     — ``mat_grid``: fno_darcy_mat.yaml on the repo's
             tests/fixtures/darcy_sample_r32_N12.mat ('sr'), and
             fno_darcy_mat_operator.yaml's layout ('operator', width 32) on
             a 64^2, 160-sample v5 file this script writes with
             benchmarks/make_darcy_mat.py's recipe (the port's
             ``_grf_threshold_coeff`` and ``solve_darcy``, scipy's
             ``savemat``): ``train_grid`` (epochs cut), then ``pred_grid``
             (``[mat]`` lines).
22. graphsage — ``init_model('graphsage', 4, 4)`` (5 layers, no fused
             form) on the full duct: a full-size request through
             ``pred_graph_ALDD`` (the general lane) and its warm time, the
             small mesh card vs CPU, ``train_graph_ALDD`` in the 'merged'
             layout (the gate's choice, asserted) with the trained
             checkpoint served, three merged steps card vs CPU; then the
             training-layout gate's check: TEECNet with
             ``kernel_type='powerseries'`` trains through
             ``train_graph_ALDD`` on the card in the 'merged' layout (B1
             and B2 at 0), and three of its steps on the card agree with the
             CPU's (layout_gate_check.py) (``[graphsage*]``,
             ``[powerseries_train]`` lines).
23. host    — ``prefetch_to_device`` over the full KernelNN path's train
             batches on the card (order, bits, device; its wall time beside
             sequential uploads); one full-size KernelNN request under
             ``FESR_TRACE_DIR`` (``utils.tracing.trace_dir``): the Chrome
             trace exists and names B1's CUDA kernel; and
             ``gaussian_interpolate_device`` card vs CPU on the duct's
             low-to-high neighbour lists (27 648 destination nodes), its
             time beside its bound (``[host_*]`` lines).

Phases 20-23 launch no B1-B5 but the traced request's B1 (8 launches).

24. multi   — multi-device training and serving over ``torch.distributed``
             on the one card, at the full configuration (KernelNN width 48,
             4 layers, the 12 training subdomains and the 2 full meshes).
             (a) Two gloo ranks, spawned processes sharing the card
             (``--multi-rank``), against this process: 3 fused shard steps
             (B1/B2 on each rank's merged group of 6 subdomains; bf16, then
             float32 with TF32 off) against one process's fused step on the
             12, B1/B2 launches per rank; ``predict_full`` on full mesh 0
             through lane ``fast_mc`` against ``predict`` + the host overlap
             average, and through ``routed_mc`` (the routed collection of
             phase 10) against the one-process routed lane; one FNO2d
             data-parallel epoch at fno_advected_256.yaml's widths and
             recipe batch (32 as 16 + 16, seeded data) against one
             process's (``[multi]`` lines, each with its error and
             tolerance).  (b) NCCL at world size 1: ``torchrun --standalone
             --nproc-per-node=1 -m fast_eng_super_resolution_tpu_torch``
             trains (``FESR_STEP_IMPL=shard_map_fused``, 2 epochs) and
             serves both meshes to finite ``.vtu`` files, and under torchrun
             (``--multi-nccl``) the fused shard step and the
             explicit-collective step run over that NCCL group against the
             single-device steps.  Two ranks on one card say nothing about
             scaling across cards.
25. closing — conv mode 'edge' and the hand-written loss backward
             (``[closing]`` lines).  The full path's KernelNN and the
             teecnet path's TEECNet serve full mesh 0 in 'edge' and in
             'edge3d' through the general lane (float32): the fields agree
             within 1e-4 of the max, B1-B5 launched 0 times, each mode's
             warm request time; three merged float32 train steps of
             KernelNN in 'edge' on the small mesh, card against CPU.
             ``FESR_LOSS_VJP=custom``: ``gradient_weight_scalar`` on the
             full request's chunk against autograd on the card (value 1e-4,
             gradients 1e-5 in relative L2) with each one's forward +
             backward ms; three fused float32 train steps of the 12
             training subdomains with it against the same steps without it
             (B1 and B2 launched 4 times per step in each), and the same
             custom steps merged on the CPU against the card's.  One
             ``make_fused_shard_batches`` under ``FESR_TIMING=1`` prints its
             ``[fesr-timing]`` line.

The second-to-last line is a JSON object with the kernels' numbers, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import io
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from fast_eng_super_resolution_tpu_torch.core import checkpoint as ckpt  # noqa: E402
from fast_eng_super_resolution_tpu_torch.core.graph import merge_batch, pad_and_bucket  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.dataset import init_dataset  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.synthetic import duct_field, make_duct_mesh  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.tensorize import cells_to_edges  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.vtu import read_vtu  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.kernelnn import KernelNN  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.registry import init_model  # noqa: E402
from fast_eng_super_resolution_tpu_torch.models.teecnet import (  # noqa: E402
    _EDGE_HIDDEN, TEECNet, _leaky_relu)
from fast_eng_super_resolution_tpu_torch.ops import fused_conv, pallas_mp  # noqa: E402
from fast_eng_super_resolution_tpu_torch.ops.loss import gradient_weight_scalar  # noqa: E402
from fast_eng_super_resolution_tpu_torch.ops.message_passing import apply_edge_mlp_hidden  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics import amg as pamg  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics import divergence as pdiv  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics import projection as pproj  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics.projection import DivergenceFreeProjection  # noqa: E402
from fast_eng_super_resolution_tpu_torch.physics.wss import compute_wall_shear_stress  # noqa: E402
from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average  # noqa: E402
from fast_eng_super_resolution_tpu_torch.parallel.mesh import (  # noqa: E402
    pad_batch_to_multiple, replicate, shard_batch)
from fast_eng_super_resolution_tpu_torch.parallel.train import (  # noqa: E402
    Trainer, make_fused_batch, make_fused_batches, make_fused_shard_batches,
    train_val_split)
from fast_eng_super_resolution_tpu_torch.runner import pred_graph_ALDD, train_graph_ALDD  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.classifiers import init_classifier  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.encoders import init_encoder  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.scheduler import PartitionScheduler  # noqa: E402
from fast_eng_super_resolution_tpu_torch.sched.serving import _as_raw_graph, edge_budget  # noqa: E402
from fast_eng_super_resolution_tpu_torch.utils.config import load_yaml  # noqa: E402

REPO = os.path.dirname(os.path.abspath(__file__))
BASE_CONFIG = os.path.join(REPO, "configs", "exp_config",
                           "neuralop_synthetic_full.yaml")
TRAIN_CONFIG = os.path.join(REPO, "configs", "train_config",
                            "synthetic_full.yaml")
TRAIN_EPOCHS = 10  # the one cut of synthetic_full.yaml (300 epochs)
TEECNET_CONFIG = os.path.join(REPO, "configs", "exp_config",
                              "teecnet_ansys.yaml")
TEECNET_TRAIN = os.path.join(REPO, "configs", "train_config", "teecnet.yaml")
TEECNET_EPOCHS = 2  # the one cut of teecnet.yaml (151 epochs)
TEECNET_K = _EDGE_HIDDEN[-1]  # its operator kernel's K (128)
# the routed path: the full config with this config's n_clusters and
# n_components added in memory, trained TRAIN_EPOCHS epochs
ROUTED_CONFIG = os.path.join(REPO, "configs", "exp_config",
                             "neuralop_synthetic_routed.yaml")
COALESCED_R = 4  # requests per coalesced batch
FULL = dict(n_high=(48, 24, 24), n_low=(20, 10, 10), sub_size=8, num_cases=2)
SMALL = dict(n_high=(16, 8, 8), n_low=(8, 4, 4), sub_size=4, num_cases=1)
SEED = 0
CHUNKS = {"full": 2, "small": 1}  # per request; launches = chunks x depth
RANK = 16  # the rank-r path's kernel_rank (the JAX package's lowrank16 rows)
RANK_DEPTH = 2  # its depth, cut from the config's 4 to keep the run short
# the rank-12 path (B3/B4 at a rank that is not a multiple of 8, run padded
# to 16): its kernel_rank, its training's epoch cut, the ranks at which B3
# and B4 are held against their plain versions and those at which they are
# timed, at the full-size chunk
RANK12 = 12
RANK12_EPOCHS = 2  # 2, not 3: room for the width-128 rank-r path
RANK12_CHECKED = (1, 4, 12, 20, 28, 31)
RANK12_TIMED = (4, 12)
# the width-128 path (B1 and B2 past width 64):
# configs/exp_config/neuralop_synthetic_w64.yaml with its width set to 128
# in memory (K = width: 'neuralop' builds ker_width = width), depth cut to
# 2; its training's epoch cut; the (c_in, c_out, K) at which B1 and B2 are
# held against their plain versions, on the leading WIDE_SLICE_BLOCKS
# receiver blocks of the full-size chunk (the plain versions build [slots,
# c_in c_out] float32 arrays: 16 GB at 128 on the whole chunk); TEECNet at
# width 128 (K 128) served once and trained one epoch
W64_CONFIG = os.path.join(REPO, "configs", "exp_config",
                          "neuralop_synthetic_w64.yaml")
WIDE = 128
WIDE_DEPTH = 2
WIDE_EPOCHS = 2
WIDE_CHECKED = ((128, 128, 128), (96, 96, 96), (127, 127, 128), (72, 128, 48))
WIDE_SLICE_BLOCKS = 16
WIDE_TEECNET_EPOCHS = 1
# its kernels take 10-60 ms a launch and a train step 0.2-0.4 s: timed over
# WIDE_REPS launches and WIDE_STEP_REPS steps (those of the width-128 rank-r
# path too), fewer than the narrower paths' (20, 5)
WIDE_REPS = 10
WIDE_STEP_REPS = 3
# the width-256 path (B1 and B2 past width 128): the same config at width
# 256 (K 256), depth 2, one epoch a type; B1 and B2 held against their
# plain versions at WIDER_CHECKED on the same leading slice (the plain B1
# builds [16 384, 65 536] float32 there, 4.3 GB; 'edge3d' would take 67.6
# GB per chunk and layer of a full-size mesh, so it serves the small one);
# TEECNet at width 256 (K 128) served once and trained one epoch
WIDER = 256
WIDER_EPOCHS = 1
# its kernels take 35-420 ms a launch and a train step 2-3 s: each timed
# over fewer launches and steps than the narrower paths' (20, 5), after
# one warm-up, not 3, the plain versions over 3 calls, not 5
# (``timing_reps``); B5 at its chunks (50-95 ms) over WIDER_REPS too
WIDER_REPS = 3
WIDER_STEP_REPS = 1
WIDER_CHECKED = ((256, 256, 256), (256, 256, 128), (129, 129, 129),
                 (136, 250, 200), (48, 256, 256), (256, 40, 72))
# the width-320 path (B1, B2 and B5 past 256: pieces of at most 256 of each
# of K, c_in and c_out on the existing instances, ``fused_conv.width_pieces``;
# two of 160 in each at 320, eight launches a layer): the width-256 path's
# config at width 320 (K 320), depth 2, one epoch a type; B1 and B2 held
# against their plain versions at WIDEST_CHECKED (c_in, c_out, K) on the
# leading slice, with fewer receiver blocks where the plain versions'
# [slots, c_in c_out] float32 arrays would pass PLAIN_BYTES (B5 likewise at
# (K, c_in, c_out) on fewer edges); TEECNet at width 320 (K 128: four
# pieces a layer) served in both lanes and trained one epoch
WIDEST = 320
WIDEST_CHECKED = ((320, 320, 320), (257, 257, 257), (300, 520, 264),
                  (264, 136, 520), (600, 40, 17), (512, 512, 512))
PLAIN_BYTES = 4 << 30
# the width-128 rank-r path (B3 and B4 past width 64, K 64 and rank 32):
# the width-128 path's config at kernel_rank WIDE_RANK, its training's epoch
# cut, the (c_in, c_out, K, rank) at which B3 and B4 are held against their
# plain versions on the leading WIDE_SLICE_BLOCKS receiver blocks of the
# full-size chunk (the plain rank-64 uv alone takes 16 GB on all of it),
# and the ranks at which they are timed on the full-size chunk.  No top
# rank here (its rank-64 request and parity went for the width-256 path's
# rank 100; rank 64 stays held in WIDE_RANK_CHECKED)
WIDE_RANK = 32
WIDE_RANK_EPOCHS = 1  # 1, not 2: room for the width-256 rank-r path
WIDE_RANK_CHECKED = ((128, 128, 128, 64), (128, 128, 128, 32),
                     (128, 128, 128, 40), (96, 96, 96, 48),
                     (127, 127, 128, 57), (72, 128, 48, 20), (48, 48, 48, 36))
# rank 32 alone (was 32 and 64): rank 64 is timed at width 256, and at 128
# by lowrank_step_check.py --width 128
WIDE_RANK_TIMED = (32,)
# the width-256 rank-r path (B3 and B4 past width 128): the width-256
# path's config at kernel_rank WIDE_RANK, WIDE_RANK_EPOCHS, the top rank
# WIDER_RANK_TOP's request and parity (past 64: two slabs of 64, the second
# 36 real); B3 and B4 held against their plain versions at
# WIDER_RANK_CHECKED (c_in, c_out, K, rank) on the leading slice (each
# wall alone and together: 256 at ranks 64 and 32, 129, 136 x 250 at K
# 200, K alone, c_in alone, c_out alone; past rank 64: 256 at 256 and 100,
# 128 at 128, 129 at 65, 136 x 250 at 97, and 200 past both widths of 40 x
# 48: the plain rank-256 uv there is [16 384, 131 072] float32, 8.6 GB) and
# timed at WIDER_RANK_TIMED on the full-size chunk over WIDER_REPS
# launches (rank 64 by lowrank_step_check.py --width 256; rank 100, the
# top rank, is served and held but no longer timed: room for the
# width-320 path)
WIDER_RANK_TOP = 100
WIDER_RANK_CHECKED = ((256, 256, 256, 64), (256, 256, 256, 32),
                      (129, 129, 129, 57), (136, 250, 200, 33),
                      (48, 48, 256, 16), (256, 48, 64, 24), (40, 256, 72, 40),
                      (256, 256, 256, 256), (256, 256, 256, 100),
                      (128, 128, 128, 128), (129, 129, 129, 65),
                      (136, 250, 200, 97), (40, 48, 72, 200))
WIDER_RANK_TIMED = (32, 256)
# phase 7's CPU side of every path (plain versions on the small mesh:
# 90-110 s at width 256) runs in one worker process while the card's
# phases go on (torch's default threads, as in this process: the same
# bits), stopped while a phase is timed (``quiet``: its pid, from
# ``start_parity``, and the seconds it was stopped); the card's side and
# the check stay in their paths
PARITY_WORKER = {"pid": None, "stopped_s": 0.0, "t0": None}
# the worker processes ``quiet`` stops (futures of their pids): phase 7's
# worker and the reference worker
QUIET = []
# the CPU references of the phases after the first path (the port's float32
# plain predictions from the seeded ``*_cpu`` checkpoints, and the closing
# phase's CPU steps), computed in one more worker process from the build's
# end on, in the order the phases need them (``start_references``), so that
# no phase waits for its own: key -> future of (result, seconds)
CPU_REFS = {}
_REF_DATA = {}  # the reference worker's datasets (mesh -> dataset)
# its niceness: below this process's, which drives the card, above phase
# 7's worker's, whose steps are needed last
REF_NICE = 10
# its niceness: it takes the cores the card's phases leave (started before
# the build, even at 19 it slowed the build by 45-80 s on an H100 host)
PARITY_NICE = 19
# phase 7's card side of every path, run once the other phases are done
# (``defer_parity``, ``run_parities``), when the worker's steps are ready:
# (small mesh, config, the worker's future, the path's result dict)
PARITY_PENDING = []
KERNELS = (fused_conv.fused_edge_conv, fused_conv.fused_edge_conv_bwd,
           fused_conv.fused_edge_conv_lowrank,
           fused_conv.fused_edge_conv_lowrank_bwd,
           pallas_mp.fused_edge_messages)
# rank-r? -> (wrapper, plain version, CUDA launcher), forward and backward
FWD = {False: (fused_conv.fused_edge_conv, fused_conv.fused_edge_conv_plain,
               fused_conv.fused_edge_conv_cuda),
       True: (fused_conv.fused_edge_conv_lowrank,
              fused_conv.fused_edge_conv_lowrank_plain,
              fused_conv.fused_edge_conv_lowrank_cuda)}
BWD = {False: (fused_conv.fused_edge_conv_bwd,
               fused_conv.fused_edge_conv_bwd_plain,
               fused_conv.fused_edge_conv_bwd_cuda),
       True: (fused_conv.fused_edge_conv_lowrank_bwd,
              fused_conv.fused_edge_conv_lowrank_bwd_plain,
              fused_conv.fused_edge_conv_lowrank_bwd_cuda)}

# Kernel vs plain version on the card, relative to the output's max.  Both
# round h, x and w3 to the GEMM type identically and then work in float32,
# summing ~2.4k products per slot in different orders: ~1e-6 expected (B3
# too: its uv, t and msg stay float32 on both sides).
KERNEL_TOL = {"float32": 5e-5, "bfloat16": 1e-4}
# B2 (and B4) vs its plain version, each output relative to its own max: both
# round h, x_src, w3 and dmsg (one exact product per slot) identically, then
# sum float32 products in different orders (dw3: over ~250k slots).
# The differentiable layer on the card vs the CPU's plain versions (float32,
# index_add_ atomics on the card) and the fused train losses card vs CPU
# (float32, 3 steps of Adam): 1e-4.
BWD_TOL = {"float32": 5e-5, "bfloat16": 1e-4}
GRAD_TOL = 1e-4
PARITY_TOL = 1e-4
# (``phase_parity``: each step's loss and every gradient, each card step
# started from the CPU's state at that step; the same for every path)
# Served bf16 prediction vs the CPU float32 plain prediction: bf16 rounding of
# the GEMM inputs (2^-8 relative) through 4-5 layers -> 3e-2 of the max.
SERVE_TOL = 3e-2
# B5 vs its plain version (both float32, TF32 off, sums of (K+1) c_in
# products in other orders), and the 'pallas' prediction vs the 'edge3d' one
# (float32 end to end, through 4-5 layers and the overlap average), each
# relative to the max.
MSG_TOL = 5e-5
PALLAS_TOL = 1e-4
# The edges of a width-128 chunk on which B5's plain version and the einsum
# are timed (both build [E, c_in c_out] float32 arrays: 16.9 GB on all
# 258 048 edges of it), and the slices its plain reference is computed in
MSG_SLICE = 16384
# B5 alone past 128 at (K, c_in, c_out), on the width-256 chunk's leading
# MSG_SLICE edges: c_in alone (96, 200, 72: X's parts in shared memory), K
# and c_out (256, 48, 200: one h tile, X in registers), c_in and c_out
# (TEECNet's at width 256), all three (256, 129, and 200, 136, 250)
MSG_CHECKED = ((256, 256, 256), (128, 256, 256), (256, 48, 200),
               (96, 200, 72), (129, 129, 129), (200, 136, 250))
# A coalesced request vs the same request alone: the same kernel launches
# (bit-identical) and the same segment sums, whose index_add_ atomics may
# add in another order: 1e-6 of the max.
COALESCED_TOL = 1e-6

# The grid family, one path per shipped config at its published widths,
# modes, resolution, padding and batch size; cut: the sample count (and
# train_samples and idxs with it) and the recipe's epochs (300).  FNO1d and
# DeepONet train with fno_advected.yaml, as their configs' comments say.
GRID = {
    "fno2d": dict(model="fno", dataset="advected_grid",
                  exp="fno_advected_256.yaml", train="fno_advected.yaml",
                  num_samples=72, train_samples=64),
    "fno3d": dict(model="fno3d", dataset="advected3d_grid",
                  exp="fno3d_advected_64.yaml", train="fno3d_advected.yaml",
                  num_samples=24, train_samples=16),
    "fno1d": dict(model="fno1d", dataset="burgers_grid",
                  exp="fno_burgers.yaml", train="fno_advected.yaml",
                  num_samples=40, train_samples=32),
    "deeponet": dict(model="deeponet", dataset="advected_grid",
                     exp="deeponet_advected.yaml", train="fno_advected.yaml",
                     num_samples=40, train_samples=32),
}
GRID_EPOCHS = 10
DATA_WORKERS = 4  # processes generating the grid data during phases 2-18
# One spectral conv, card 'fft' vs card 'matmul' vs CPU 'fft' (float32,
# TF32 off; FFTs and DFT sums in other orders over up to 265 points),
# relative to the max; FNO2d's first three train losses card vs CPU.
GRID_SPECTRAL_TOL = 1e-5
GRID_PARITY_TOL = 1e-4

# The grid rollout lane (phase 20), one path per shipped config at its
# published sizes; cut: the recipe's 300 epochs to ROLLOUT_EPOCHS.  "data"
# names the generation job (the two NS configs share one dataset).
ROLLOUT = {
    "ns": dict(model="fno", dataset="ns_rollout", data="ns_rollout",
               exp="fno_ns_rollout.yaml", train="fno_advected.yaml"),
    "ns_guided": dict(model="fno", dataset="ns_rollout", data="ns_rollout",
                      exp="fno_ns_rollout_guided.yaml",
                      train="fno_advected.yaml"),
    "adv": dict(model="fno", dataset="advected_rollout",
                data="advected_rollout", exp="fno_adv_rollout.yaml",
                train="fno_advected.yaml"),
    "adv3d": dict(model="fno3d", dataset="advected3d_rollout",
                  data="advected3d_rollout", exp="fno3d_adv_rollout.yaml",
                  train="fno3d_advected.yaml"),
}
ROLLOUT_EPOCHS = 2
# The rolled-out frames card vs the CPU from one checkpoint: float32, the
# card's 'matmul' spectral form against the CPU's 'fft' (6.8e-7 per conv,
# PERF.md), compounded over T <= 16 steps of the same map: 1e-4 of the max.
ROLLOUT_TOL = 1e-4
# mat_grid (phase 21): the operator layout's file, written by this script
MAT_OPERATOR = dict(n=64, samples=160)
MAT_EPOCHS = 3
# GraphSAGE (phase 22): its train cut; the interpolation (phase 23) card vs
# CPU, float32 sums of 32 weighted neighbours in other orders
SAGE_EPOCHS = 3
INTERP_TOL = 1e-6

# H100 SXM data sheet: HBM rate and dense peaks per input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


@contextlib.contextmanager
def quiet():
    """Stops the worker processes of ``QUIET`` (``start_parity``'s and
    ``start_references``'), if any run, while the block runs (a timed
    phase), so that no time is taken beside them."""
    if not QUIET:
        yield
        return
    pids = [pid.result() for pid in QUIET]
    t0 = time.time()
    for pid in pids:
        os.kill(pid, signal.SIGSTOP)
    try:
        yield
    finally:
        for pid in pids:
            os.kill(pid, signal.SIGCONT)
        PARITY_WORKER["stopped_s"] += time.time() - t0


def cuda_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    with quiet():
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def timing_reps(reps: int) -> tuple:
    """(warm-up calls, plain version's timed calls) beside ``reps`` timed
    kernel launches: past width 128 (``WIDER_REPS``, launches of tens to
    hundreds of ms) one warm-up and 3 plain calls, else 3 and 5."""
    return (1, 3) if reps <= WIDER_REPS else (3, 5)


@contextlib.contextmanager
def env_set(name: str, value):
    """Environment variable ``name`` set to ``str(value)`` while the block
    runs (``None``: left as it is)."""
    saved = os.environ.get(name)
    if value is not None:
        os.environ[name] = str(value)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def launches_of(*kernels) -> dict:
    return {k.__name__: k.launches for k in kernels}


def check_only(label: str, want: dict) -> None:
    """Raises unless each kernel of ``want`` launched as often as it says and
    every other kernel not at all since ``reset_launches``."""
    got = launches_of(*KERNELS)
    want = {k.__name__: want.get(k, 0) for k in KERNELS}
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def prefix(model) -> str:
    """The log prefix of the path ``model`` runs: '' (KernelNN at full
    rank), 'lowrank_' (KernelNN at rank ``RANK``), 'rank<r>_' (at another
    rank r) or 'teecnet_'; at width ``WIDE`` (``WIDER``, ``WIDEST``)
    'w128_' ('w256_', 'w320_') and 'teecnet_w128_' ('teecnet_w256_',
    'teecnet_w320_'), and at a rank 'w128r_' ('w256r_'; rank
    ``WIDE_RANK``) or 'w128r<r>_' ('w256r<r>_')."""
    width = getattr(model, "width", None)
    wide = f"w{width}_" if width in (WIDE, WIDER, WIDEST) else ""
    if isinstance(model, TEECNet):
        return "teecnet_" + wide
    if model.kernel_rank is None:
        return wide
    r = model.kernel_rank
    if wide:
        return f"w{width}r_" if r == WIDE_RANK else f"w{width}r{r}_"
    return "lowrank_" if r == RANK else f"rank{r}_"


def rank_of(model):
    return getattr(model, "kernel_rank", None)


def pieces_per_call(cfg: dict) -> int:
    """Launches of B1, B2 or B5 per conv layer of ``cfg``'s model: one up
    to a K, c_in and c_out of 256, past it one per piece
    (``fused_conv.width_pieces``); K is the width for KernelNN, the
    operator kernel's last hidden width for TEECNet."""
    w = cfg["width"]
    k = w if cfg["model"] == "neuralop" else TEECNET_K
    return fused_conv.piece_count(k, w, w)


def make_model(cfg: dict):
    """The seeded model of ``cfg``: KernelNN (full rank, or rank
    ``kernel_rank``) or TEECNet, as ``cfg['model']`` names it."""
    return init_model(cfg["model"], cfg["in_channels"], cfg["out_channels"],
                      seed=SEED, kernel_rank=cfg.get("kernel_rank"),
                      **{k: cfg[k] for k in ("width", "num_layers")})


def make_mode_model(cfg: dict, mode: str):
    """The seeded model of ``cfg`` in conv mode ``mode``: the mode is a
    constructor argument (never read from a config), so the model is built
    directly."""
    if cfg["model"] == "teecnet":
        return TEECNet(cfg["in_channels"], cfg["width"], cfg["out_channels"],
                       cfg["num_layers"], mode=mode, seed=SEED)
    w = cfg["width"]
    return KernelNN(w, w, cfg["num_layers"], in_width=cfg["in_channels"],
                    out_width=cfg["out_channels"], mode=mode, seed=SEED)


def conv_parts(model):
    """(edge MLP, its activation, the map from fc1's output to the conv
    layer's node features) of ``model``'s shared conv."""
    if isinstance(model, TEECNet):
        return model.kernel.edge_mlp, _leaky_relu, model.kernel.linear
    return model.edge_mlp, torch.relu, lambda h: h


def layer_operands(model, ea, x) -> tuple:
    """(h_e, x, w3, b3) the model's first conv layer takes for blocked (or
    per-edge) edge attributes ``ea`` and node inputs ``x``."""
    edge_mlp, act, node_map = conv_parts(model)
    with torch.no_grad():
        h_e = apply_edge_mlp_hidden(edge_mlp, ea, act).contiguous()
        xl = node_map(model.fc1(x)).contiguous()
        w3 = edge_mlp[-1].weight.t().contiguous()
        b3 = edge_mlp[-1].bias.detach().contiguous()
    return h_e, xl, w3, b3


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    log("device", name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def make_config(root: str, sizes: dict, base: str = BASE_CONFIG,
                model: str = "neuralop", train: str = TRAIN_CONFIG,
                epochs: int = TRAIN_EPOCHS) -> dict:
    """The shipped full-width config ``base`` with this run's mesh sizes and
    root, and (in memory only) the model type, train config and epoch cut of
    the path it drives."""
    cfg = load_yaml(base)
    cfg.update(sizes, root=os.path.join(root, "data"),
               idxs=list(range(sizes["num_cases"])), model=model,
               train_config=train, train_epochs=epochs)
    return cfg


def write_checkpoint(log_dir: str, exp: str, cfg: dict):
    model = make_model(cfg)
    ckpt.save_params(os.path.join(log_dir, "models", f"collection_{exp}",
                                  "partition_0.npz"),
                     model.to_jax_params(),
                     meta={"model": type(model).__name__})
    return model


def request_chunk(dataset, idx=None):
    """(the first serving chunk of mesh 0 (the scheduler's chunking), or its
    subdomains ``idx``, merged into one host graph; its subdomain count)."""
    raw = [_as_raw_graph(d) for d in dataset.get_one_full_sample(0)]
    (_, _, batch), = pad_and_bucket(raw, uniform=True)
    if idx is None:
        idx = np.arange(max(1, edge_budget() // batch.senders.shape[1]))
    return merge_batch(batch.map(lambda a: a[idx]))[0], len(idx)


def chunk_operands(dataset, model, device, idx=None):
    """The first serving chunk of mesh 0 (the scheduler's chunking), or its
    subdomains ``idx`` (a routed chunk), and the first layer's fused
    operands on ``device``."""
    merged, n_sub = request_chunk(dataset, idx)
    ea_b, sp, sm, rows_blk, blk = model.prepare_fused(
        merged.senders, merged.receivers, merged.edge_attr,
        merged.x.shape[0], merged.edge_mask, compact=True)
    m = model.to(device)
    h_e, x, w3, b3 = layer_operands(
        m, torch.as_tensor(ea_b, device=device),
        torch.as_tensor(merged.x, device=device))
    msg = None
    if rank_of(model) is None:
        # B5's operands at full rank: every edge of the merged chunk,
        # padding included, as the general lane's 'pallas' apply hands them
        hid, xl, _, _ = layer_operands(
            m, torch.as_tensor(merged.edge_attr, device=device),
            torch.as_tensor(merged.x, device=device))
        src = torch.as_tensor(merged.senders, device=device).long()
        msg = (hid, xl[src].contiguous(), w3, b3)
    return dict(h=h_e, x=x, sp=torch.as_tensor(sp, device=device),
                w3=w3, b3=b3, s=sm.to(device), rows_blk=rows_blk, blk=blk,
                n=merged.x.shape[0], b=n_sub, rank=rank_of(model),
                tag=prefix(model), msg=msg)


def layer_kw(op) -> dict:
    """The layer's keyword arguments for the operands ``op`` (c_out: the
    width of x unless ``op`` names another)."""
    c = op["x"].shape[1]
    kw = dict(c_in=c, c_out=op.get("c_out", c), rows_blk=op["rows_blk"],
              blk=op["blk"])
    if op["rank"] is not None:
        kw["rank"] = op["rank"]
    return kw


def layer(op, gemm_dtype, plain=False, dense=False):
    """B1 (B3 for a rank-r model's operands) or its plain version."""
    wrapper, plain_fn, _ = FWD[op["rank"] is not None]
    s = op["s"]
    if dense:
        s = fused_conv.expand_s(s.slot_rows, s.row_weight,
                                rows_blk=op["rows_blk"], blk=op["blk"])
    return (plain_fn if plain else wrapper)(
        op["h"], op["x"], op["sp"], op["w3"], op["b3"], s,
        gemm_dtype=gemm_dtype, **layer_kw(op))


def design_of(op, gemm_dtype: str) -> str:
    """The design the kernel of ``op`` runs in ``gemm_dtype``, as
    ``fused_conv.design`` names it ('wgmma': every kernel, both types, on
    the tensor cores)."""
    return fused_conv.design(getattr(torch, gemm_dtype), op["rank"])


def check_repeat(label: str, at: str, dt: str, dense: bool, first,
                 second) -> None:
    """Raises unless a second launch on the same inputs gave the same bits
    (the tensor-core kernels sum in a fixed order, with no atomics)."""
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(label, at=at, dtype=dt, s="dense" if dense else "compact",
        second_launch_bit_identical=same)
    if not same:
        raise AssertionError(f"{label} at {at} {dt}: two launches differ")


def locked_build() -> tuple:
    """``fused_conv.build_kernel(force=True)`` under the lock that loading a
    library takes, so that nothing loads one before the build is done;
    (the library paths, seconds)."""
    t0 = time.time()
    with fused_conv._lib_lock:
        libs = fused_conv.build_kernel(force=True)
    return libs, time.time() - t0


def log_ptxas() -> None:
    """Registers and spills of the tensor-core kernels, as ptxas reported
    them when the libraries were built (and any wgmma serialization it
    warned of), and their blocks per SM at width 48 and K 48 and 128
    (B1/B2 in both types, B5), at width and K 96 and 128 (B1/B2; B5 at
    128), at width 256 and K 256 and 128 and the width-256 path's checked
    shapes (B1/B2, with their chunks; their shared memory must equal the
    wrapper's mirror, ``fused_conv.conv_smem_bytes``), at the widest piece
    of each of the width-320 path's shapes (B1/B2), at K 48, rank 16,
    at width 128 and at ``WIDER_RANK_CHECKED`` (B3/B4 in both types; their
    shared memory must equal ``fused_conv.lowrank_smem_bytes``) and at
    ``MSG_CHECKED`` (B5; its shared memory must equal
    ``pallas_mp.smem_bytes``)."""
    import re
    for lib in ("fused_edge_conv_wgmma", "fused_edge_conv_bwd_wgmma",
                "fused_edge_conv_f32_wgmma", "fused_edge_conv_bwd_f32_wgmma",
                "fused_edge_conv_lowrank_wgmma",
                "fused_edge_conv_lowrank_bwd_wgmma",
                "fused_edge_conv_lowrank_f32_wgmma",
                "fused_edge_conv_lowrank_bwd_f32_wgmma",
                "fused_edge_messages_wgmma"):
        name, spills = None, ("?", "?")
        for line in fused_conv.ptxas_report(lib).splitlines():
            if "wgmma" in line and "erialized" in line:
                log("ptxas", lib=lib, warning=repr(line.strip()[:200]))
            m = re.search(r"Function properties for \S*?"
                          r"(lowrank_fwd_wgmma|lowrank_bwd_rows_wgmma|"
                          r"lowrank_bwd_weights_wgmma|lowrank_fwd_f32_wgmma|"
                          r"lowrank_bwd_rows_f32_wgmma|"
                          r"lowrank_bwd_weights_f32_wgmma|conv_fwd_wgmma|"
                          r"bwd_rows_wgmma|bwd_weights_wgmma|"
                          r"conv_fwd_f32_wgmma|bwd_rows_f32_wgmma|"
                          r"bwd_weights_f32_wgmma|"
                          r"messages_wgmma(?=I))"
                          r"(?:ILi(\d+)E)?(?:Li(\d+)E)?", line)
            if m:
                arg = m.group(2)
                if arg and m.group(1).startswith("lowrank"):
                    arg = f"r{8 * int(arg)}"  # the template's r / 8
                    if m.group(3):  # float32 B3/B4: then S k16 steps
                        arg += f",S{m.group(3)}"
                elif m.group(3):  # B5, float32 B1/B2: N, then S k16 steps
                    arg = f"N{arg},S{m.group(3)}"
                name = m.group(1) + (f"<{arg}>" if arg else "")
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if name and m:
                spills = m.groups()
                continue
            m = re.search(r"Used (\d+) registers", line)
            if name and m:
                log("ptxas", lib=lib, kernel=name, registers=m.group(1),
                    spill_stores=spills[0], spill_loads=spills[1])
                name = None
    # B1/B2 at widths 48 and 128, and past 128 at width 256's K 256 and
    # TEECNet's K 128 and the checked shapes: blocks per SM, shared memory
    # (held to the wrapper's mirror of each layout) and the chunks
    shapes = [(k, c, c) for k, c in ((48, 48), (128, 48), (96, 96), (128, 128),
                                     (WIDER, WIDER), (128, WIDER))]
    shapes += [(k, c_in, c_out) for c_in, c_out, k in WIDER_CHECKED
               if (k, c_in, c_out) not in shapes]
    # past 256 the widest piece's instance (fused_conv.piece_width) of each
    # of the width-320 path's shapes
    shapes += [piece for c_in, c_out, k in WIDEST_CHECKED
               if (piece := tuple(fused_conv.piece_width(v)
                                  for v in (k, c_in, c_out))) not in shapes]
    for k, c_in, c_out in shapes:
        c = dict(c=c_in) if c_in == c_out else dict(c_in=c_in, c_out=c_out)
        log("ptxas", k=k, **c,
            blocks_per_sm=fused_conv.occupancy(k, c_in, c_out),
            bf16_fwd_chunks=fused_conv.wgmma_fwd_chunks(k, c_in, c_out),
            bf16_rows_chunks=fused_conv.wgmma_rows_chunks(k, c_in, c_out),
            f32_fwd_chunks=fused_conv.f32_chunks(c_out, c_in),
            f32_rows_chunks=fused_conv.f32_chunks(c_in, c_out))
        for lib, dt, backward in (
                ("fused_edge_conv_wgmma", torch.bfloat16, False),
                ("fused_edge_conv_bwd_wgmma", torch.bfloat16, True),
                ("fused_edge_conv_f32_wgmma", torch.float32, False),
                ("fused_edge_conv_bwd_f32_wgmma", torch.float32, True)):
            smem = getattr(fused_conv._load_kernel(lib),
                           f"{lib}_smem_bytes")(k, c_in, c_out)
            log("ptxas", lib=lib, k=k, **c, smem_bytes=smem)
            mirror = fused_conv.conv_smem_bytes(dt, k, c_in, c_out, backward)
            if smem != mirror:
                raise AssertionError(f"{lib} at K={k}, {c}: {smem} B of shared "
                                     f"memory, the wrapper's mirror {mirror}")
    # B3/B4 at width 48, rank 16, the width-128 rank-r path's instances and
    # the width-256 rank-r path's checked shapes: blocks per SM of each
    # kernel and the fwd / rows kernels' shared memory, held to the
    # wrapper's mirror of each layout (the weights kernels' mirror logged)
    shapes = [(48, 48, 48, RANK), (48, 48, 48, 36), (96, 96, 96, 48),
              *((WIDE, WIDE, WIDE, r) for r in (16, 32, 40, 57, 64))]
    shapes += [(k, c_in, c_out, r) for c_in, c_out, k, r in WIDER_RANK_CHECKED]
    for k, c_in, c_out, rank in shapes:
        c = dict(c=c_in) if c_in == c_out else dict(c_in=c_in, c_out=c_out)
        log("ptxas", k=k, **c, rank=rank,
            blocks_per_sm=fused_conv.occupancy(k, c_in, c_out, rank=rank))
        for lib, dt, kernel in (
                ("fused_edge_conv_lowrank_wgmma", torch.bfloat16, "fwd"),
                ("fused_edge_conv_lowrank_bwd_wgmma", torch.bfloat16, "rows"),
                ("fused_edge_conv_lowrank_f32_wgmma", torch.float32, "fwd"),
                ("fused_edge_conv_lowrank_bwd_f32_wgmma", torch.float32,
                 "rows")):
            smem = getattr(fused_conv._load_kernel(lib),
                           f"{lib}_smem_bytes")(k, c_in, c_out, rank)
            weights = (fused_conv.lowrank_smem_bytes(dt, k, c_in, c_out, rank,
                                                     "weights")
                       if kernel == "rows" else None)
            log("ptxas", lib=lib, k=k, **c, rank=rank, smem_bytes=smem,
                **({} if weights is None else {"weights_smem_bytes": weights}))
            mirror = fused_conv.lowrank_smem_bytes(dt, k, c_in, c_out, rank,
                                                   kernel)
            if smem != mirror:
                raise AssertionError(f"{lib} at K={k}, {c}, rank {rank}: "
                                     f"{smem} B of shared memory, the "
                                     f"wrapper's mirror {mirror}")
    # B5 at its chunks' shapes and MSG_CHECKED: blocks per SM and shared
    # memory, held to the wrapper's mirror of its layout
    b5 = fused_conv._load_kernel("fused_edge_messages_wgmma")
    shapes = [(48, 48, 48), (128, 48, 48), (WIDE, WIDE, WIDE)]
    shapes += [s for s in MSG_CHECKED if s not in shapes]
    for k, c_in, c_out in shapes:
        c = dict(c=c_in) if c_in == c_out else dict(c_in=c_in, c_out=c_out)
        smem = b5.fused_edge_messages_wgmma_smem_bytes(k, c_in, c_out)
        log("ptxas", kernel="messages_wgmma", k=k, **c,
            blocks_per_sm=b5.fused_edge_messages_wgmma_blocks_per_sm(
                k, c_in, c_out), smem_bytes=smem)
        mirror = pallas_mp.smem_bytes(k, c_in, c_out)
        if smem != mirror:
            raise AssertionError(f"B5 at K={k}, {c}: {smem} B of shared "
                                 f"memory, the wrapper's mirror {mirror}")


def phase_kernel(op, at: str = "chunk", errs: dict | None = None) -> dict:
    """B1 (B3 on the rank-r path) against its plain version on ``op`` (the
    operands at shape ``at``); returns ``errs`` with each type's largest
    absolute error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    slots, k = op["h"].shape
    label = op["tag"] + "kernel"
    log(label, at=at, n=op["n"], subdomains=op["b"],
        num_blocks=slots // op["blk"], blk=op["blk"], slots=slots,
        real_slots=int((op["s"].slot_rows >= 0).sum()), k=k,
        c=op["x"].shape[1], rank=op["rank"])
    errs = {} if errs is None else errs
    with torch.no_grad():
        for dt in ("float32", "bfloat16"):
            ref = layer(op, dt, plain=True)
            for dense in (False, True):
                got = layer(op, dt, dense=dense)
                torch.cuda.synchronize()
                abs_err = (got - ref).abs().max().item()
                rel = abs_err / ref.abs().max().item()
                log(label, at=at, dtype=dt, s="dense" if dense else "compact",
                    design=design_of(op, dt), max_abs_err=f"{abs_err:.3e}",
                    rel_to_max=f"{rel:.3e}", tol=KERNEL_TOL[dt])
                if not (rel <= KERNEL_TOL[dt]):
                    raise AssertionError(f"{label} at {at} {dt} dense={dense}: "
                                         f"{rel:.3e} > {KERNEL_TOL[dt]}")
                errs[dt] = max(errs.get(dt, 0.0), abs_err)
                check_repeat(label, at, dt, dense, (got,),
                             (layer(op, dt, dense=dense),))
            del ref, got
    torch.cuda.empty_cache()
    return errs


def serve(ds, model, idxs, log_dir, exp, device, n: int = 1, **kw):
    """``pred_graph_ALDD`` of meshes ``idxs`` from exp ``exp``'s ``n``
    experts: (lanes, each .vtu's point data), every field finite."""
    lanes = []
    paths = pred_graph_ALDD(idxs, exp, model, ds, n, log_dir=log_dir,
                            device=device, lanes=lanes, **kw)
    fields = []
    for p in paths:
        pd_ = read_vtu(p)["point_data"]
        for key, v in pd_.items():
            if not np.all(np.isfinite(v)):
                raise AssertionError(f"{p}: non-finite {key}")
        fields.append(pd_)
    return lanes, fields


def phase_serve(root: str, datasets: dict, models: dict, cfgs: dict,
                tag: str = "") -> int:
    """Serves both full-size meshes and the small one from the checkpoints
    of exps ``full{tag}`` and ``small{tag}``: lanes, launches (B1, or B3
    for a rank-r model, and no other kernel), finite fields, and the card's
    bf16 prediction against the port's float32 plain one on the CPU."""
    log_dir = os.path.join(root, "logs")
    rank = rank_of(models["full"])
    label = prefix(models["full"]) + "serve"
    kernel = FWD[rank is not None][0]
    launches = 0
    card = {}
    for name, idxs in (("full", cfgs["full"]["idxs"]), ("small", [0])):
        for idx in idxs:
            reset_launches()
            t0 = time.time()
            lanes, fields = serve(datasets[name], models[name], [idx],
                                  log_dir, name + tag, None)
            torch.cuda.synchronize()
            got = kernel.launches
            launches += got
            want_lane = "general" if name == "full" else "fast"
            log(label, mesh=name, idx=idx, lane=lanes[0][1],
                reason=repr(lanes[0][2]), launches=got,
                nodes=len(fields[0]["pressure"]),
                cold_s=f"{time.time() - t0:.3f}")
            if lanes[0][1] != want_lane:
                raise AssertionError(f"{name} mesh took lane {lanes[0][1]}")
            check_only(f"{label} {name} request",
                       {kernel: CHUNKS[name] * cfgs[name]["num_layers"]})
            card[(name, idx)] = fields[0]
    # the card's bf16 serving against the port's float32 plain version on the
    # CPU, same checkpoint and mesh
    for name in ("full", "small"):
        ref, cpu_s = cpu_prediction(datasets[name], models[name], log_dir,
                                    name + tag + "_cpu")
        for key in ("velocity", "pressure"):
            r, g = ref[key], card[(name, 0)][key]
            rel = np.abs(g - r).max() / np.abs(r).max()
            log(label, mesh=name, field=key, vs_cpu_f32=f"{rel:.3e}",
                tol=SERVE_TOL, cpu_s=f"{cpu_s:.1f}")
            if not rel <= SERVE_TOL:
                raise AssertionError(f"{name} {key}: {rel:.3e} > {SERVE_TOL}")
    return launches


def fwd_times(op, smi, plain_op=None, reps: int = 20) -> dict:
    """B1's (B3's on the rank-r path) and its plain version's CUDA-event
    medians at the operands ``op``, and its bound.  With ``plain_op`` (a
    leading slice of ``op``'s blocks, where the plain version's [slots,
    c_in c_out] arrays would not fit at ``op``) the plain version and the
    kernel are also timed there (``plain_slots``, ``ms_at_plain_slots``).
    ``reps``: timed launches of the kernel (fewer where one takes tens of
    milliseconds)."""
    t = {}
    rank = op["rank"]
    _, plain, launcher = FWD[rank is not None]
    warm, plain_reps = timing_reps(reps)
    log(op["tag"] + "times", kernel="fwd", k=op["h"].shape[1],
        c=op["x"].shape[1])

    def typed_operands(o, tdt):
        # operands already in the GEMM type, as apply_fused hands them
        # over (it casts h and w3 once per forward, x once per layer)
        return [o[key].to(tdt).contiguous() for key in ("h", "x", "w3")]

    with torch.no_grad():
        for dt in ("bfloat16", "float32"):
            tdt = getattr(torch, dt)
            h, x, w3 = typed_operands(op, tdt)
            t[f"ms_{dt}"] = cuda_ms(lambda: launcher(
                h, x, op["sp"], w3, op["b3"], op["s"], **layer_kw(op)),
                reps=reps, warm=warm)
            if plain_op is not None:
                h, x, w3 = typed_operands(plain_op, tdt)
                t[f"ms_at_plain_slots_{dt}"] = cuda_ms(lambda: launcher(
                    h, x, plain_op["sp"], w3, plain_op["b3"], plain_op["s"],
                    **layer_kw(plain_op)), reps=reps, warm=warm)
            po = op if plain_op is None else plain_op
            t[f"plain_ms_{dt}"] = cuda_ms(
                lambda: plain(h, x, po["sp"], w3, po["b3"], po["s"],
                              gemm_dtype=dt, **layer_kw(po)),
                reps=plain_reps, warm=warm)
    if plain_op is not None:
        t["plain_slots"] = plain_op["h"].shape[0]
    # bound: real slots' operations at the input type's peak vs every input
    # byte read once and the output written once.  Per slot: the kernel GEMM
    # over K+1 rows (b3 the last) -- [h (x) x, x] W~ at full rank, uv = h~ W~
    # at rank r, then t = U^T x and msg = V t -- and the S weight
    slots, k = op["h"].shape
    c = op["x"].shape[1]
    real = int((op["s"].slot_rows >= 0).sum())
    if rank is None:
        flops = real * (2 * (k + 1) * c * c + 2 * c)
    else:
        flops = real * (2 * (k + 1) * op["w3"].shape[1] + 4 * rank * c + 2 * c)
    for dt, size in (("bfloat16", 2), ("float32", 4)):
        nbytes = (size * (op["h"].numel() + op["x"].numel() + op["w3"].numel())
                  + 4 * (op["b3"].numel() + op["sp"].numel()
                         + op["s"].slot_rows.numel() + op["s"].row_weight.numel()
                         + (slots // op["blk"]) * op["rows_blk"] * c))
        t.update(typed(bound(flops, nbytes, dt, split_of(op, dt)), dt))
    log_times(op["tag"] + "times", "fwd", t, smi)
    return t


def bound(flops: int, nbytes: int, dt: str, split: bool) -> dict:
    """The least time for ``flops`` operations on ``dt`` inputs and
    ``nbytes`` moved once: the operations at the type's dense peak or, for a
    float32 kernel on the tensor cores (``split``: exact through three-part
    bf16 splits), the lesser of float32 FMAs and six bf16 passes
    (``bound_basis``; ``bound_fma_ms`` the FMAs' bound), against the bytes
    at the HBM rate."""
    t_fma = flops / PEAK_FLOPS[dt]
    t_ops = min(t_fma, 6 * flops / PEAK_FLOPS["bfloat16"]) if split else t_fma
    t_bytes = nbytes / HBM_BYTES_PER_S
    out = dict(bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               flops=flops, bytes=nbytes)
    if split:
        out.update(bound_basis=("six bf16 passes" if t_ops < t_fma
                                else "float32 FMA"),
                   bound_fma_ms=max(t_fma, t_bytes) * 1e3)
    return out


def split_of(op, dt: str) -> bool:
    """Whether the kernel of ``op`` runs float32 on the tensor cores."""
    return dt == "float32" and design_of(op, dt) == "wgmma"


def typed(t: dict, dt: str) -> dict:
    """``t``'s keys suffixed with the type ``dt``."""
    return {f"{key}_{dt}": v for key, v in t.items()}


def log_times(label: str, kernel: str, t: dict, smi) -> None:
    for key, v in t.items():
        log(label, kernel=kernel,
            **{key: v if isinstance(v, (int, str)) else f"{v:.4f}"},
            card=repr(smi))


def request_times(datasets, models, root, smi, tag: str = "") -> dict:
    """One warm full-size request (exp ``full{tag}``): predict (2 chunks) +
    node weights + host overlap average, on a scheduler whose operand cache
    is warm; median of 5 and one profile."""
    ms, request = warm_request(datasets["full"], models["full"],
                               os.path.join(root, "logs"), "full" + tag)
    label = prefix(models["full"]) + "times"
    t = {"request_ms": ms}
    t.update(profile_call(request, label + "_request"))
    log_times(label, "request", t, smi)
    return t


def warm_ms(fn, reps: int = 5) -> float:
    """Median wall ms of ``reps`` calls of ``fn`` after one warm-up, each
    ending in a device sync."""
    with quiet():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def warm_request(ds, model, log_dir: str, exp: str, n: int = 1,
                 reps: int = 5, **routing) -> tuple:
    """(median wall ms of ``reps`` full-size requests of mesh 0 after one
    warm-up, the request): predict + host overlap average, ending in a
    device sync,
    on a scheduler serving ``model`` from exp ``exp``'s checkpoints (``n``
    experts, routed by ``routing``'s encoder and classifier)."""
    from fast_eng_super_resolution_tpu_torch.data.reconstruct import overlap_average

    sched = PartitionScheduler(exp, n, ds, model, train=False,
                               log_dir=log_dir, **routing)
    x = ds.get_one_full_sample(0)
    num_nodes = len(ds.full_mesh(0)["points"])
    gids = [d["global_node_ids"] for d in x]

    def request():
        pred_l, _, _, _ = sched.predict(x)
        return overlap_average(pred_l, gids, num_nodes)

    return warm_ms(request, reps), request


def profile_call(fn, label: str) -> dict:
    """Where one warm call's time goes: torch.profiler's device time by
    kernel, and the device's busy share of the call's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with quiet(), profile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only (kernels, copies): an operator's row repeats the
    # device time of the kernels it launched, and an autograd Function's
    # backward (FusedEdgeConvBackward) reports its ctypes-launched kernels
    # as its own self time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    for key, us, count in rows[:8]:
        log("profile", call=label, kernel=repr(key[:60]),
            device_ms=f"{us / 1e3:.3f}", calls=count)
    busy = sum(us for _, us, _ in rows)
    if not rows:  # the profiler saw no device activity: no share to report
        log("profile", call=label, device_time="not measured")
        return {}
    return {"profiled_wall_ms": wall_us / 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / wall_us}


BWD_NAMES = ("dh", "dx_src", "dw3", "db3")


def bwd_operands(op) -> dict:
    """B2's operands at the chunk shape: B1's, the gathered x_src, and a
    seeded gradient of the layer's output."""
    nb = op["h"].shape[0] // op["blk"]
    g = torch.randn(nb * op["rows_blk"], layer_kw(op)["c_out"],
                    generator=torch.Generator().manual_seed(SEED))
    return dict(op, g=g.to(op["x"].device),
                x_src=op["x"][op["sp"].long()].contiguous())


def bwd(bop, gemm_dtype, plain=False, dense=False):
    """B2 (B4 for a rank-r model's operands) or its plain version."""
    wrapper, plain_fn, _ = BWD[bop["rank"] is not None]
    s = bop["s"]
    if dense:
        s = fused_conv.expand_s(s.slot_rows, s.row_weight,
                                rows_blk=bop["rows_blk"], blk=bop["blk"])
    return (plain_fn if plain else wrapper)(
        bop["g"], bop["h"], bop["x_src"], bop["w3"], bop["b3"], s,
        gemm_dtype=gemm_dtype, **layer_kw(bop))


def merged_subdomains(ds, idxs=None):
    """One merged host graph of the dataset's subdomains ``idxs`` (all by
    default), padded as the scheduler pads a batch."""
    idxs = range(len(ds)) if idxs is None else idxs
    raw = [_as_raw_graph(ds.get(int(i))) for i in idxs]
    (_, _, batch), = pad_and_bucket(raw, uniform=True)
    return merge_batch(batch)[0]


def layer_grads(merged, model, device) -> list:
    """The differentiable fused layer's gradients (h, x, w3, b3) for the
    graph ``merged`` at the model's width (and rank), float32, on
    ``device``, from the model's first-layer operands and a seeded output
    gradient."""
    ea, aux, s, rows_blk, blk = model.prepare_fused_train(
        merged.senders, merged.receivers, merged.edge_attr,
        merged.x.shape[0], merged.edge_mask, compact=True)
    h, x, w3, b3 = layer_operands(model, torch.as_tensor(ea),
                                  torch.as_tensor(merged.x))
    c = x.shape[1]
    g = torch.randn(len(s.row_weight), c,
                    generator=torch.Generator().manual_seed(SEED + 1))
    leaves = [t.to(device).requires_grad_() for t in (h, x, w3, b3)]
    aux = {k: torch.as_tensor(v, device=device) for k, v in aux.items()}
    kw = dict(c_in=c, c_out=c, rows_blk=rows_blk, blk=blk,
              gemm_dtype="float32")
    if rank_of(model) is None:
        out = fused_conv.fused_edge_conv_ad(*leaves, s.to(device), aux, **kw)
    else:
        out = fused_conv.fused_edge_conv_lowrank_ad(
            *leaves, s.to(device), aux, rank=model.kernel_rank, **kw)
    (out * g.to(device)).sum().backward()
    return [t.grad.cpu() for t in leaves]


def check_bwd(bop, at: str = "chunk", errs: dict | None = None) -> dict:
    """B2 (B4 on the rank-r path) against its plain version on ``bop`` (the
    operands at shape ``at``), each output relative to its own max; returns
    ``errs`` with each type's largest absolute error."""
    slots, k = bop["h"].shape
    label = bop["tag"] + "bwd"
    log(label, at=at, n=bop["n"], subdomains=bop["b"],
        num_blocks=slots // bop["blk"], blk=bop["blk"], slots=slots,
        real_slots=int((bop["s"].slot_rows >= 0).sum()))
    errs = {} if errs is None else errs
    with torch.no_grad():
        for dt in ("float32", "bfloat16"):
            ref = bwd(bop, dt, plain=True)
            for dense in (False, True):
                got = bwd(bop, dt, dense=dense)
                torch.cuda.synchronize()
                for name, a, b in zip(BWD_NAMES, got, ref):
                    abs_err = (a - b).abs().max().item()
                    rel = abs_err / b.abs().max().item()
                    log(label, at=at, dtype=dt,
                        s="dense" if dense else "compact", out=name,
                        design=design_of(bop, dt),
                        max_abs_err=f"{abs_err:.3e}",
                        rel_to_max=f"{rel:.3e}", tol=BWD_TOL[dt])
                    if not rel <= BWD_TOL[dt]:
                        raise AssertionError(
                            f"{label} kernel at {at} {dt} dense={dense} {name}: "
                            f"{rel:.3e} > {BWD_TOL[dt]}")
                    errs[dt] = max(errs.get(dt, 0.0), abs_err)
                check_repeat(label, at, dt, dense, got,
                             bwd(bop, dt, dense=dense))
            del ref, got
    torch.cuda.empty_cache()
    return errs


def phase_bwd(bop, small_merged, small_model) -> dict:
    """B2 (B4) against its plain version at the chunk shape, then the
    differentiable layer on the card against the CPU."""
    errs = check_bwd(bop)
    model = small_model.cpu()
    rank = rank_of(model)
    fn = "FusedEdgeConv" if rank is None else "FusedEdgeConvLowrank"
    card = layer_grads(small_merged, model, "cuda")
    torch.cuda.synchronize()
    for name, a, b in zip(("h", "x", "w3", "b3"), card,
                          layer_grads(small_merged, model, "cpu")):
        rel = (a - b).abs().max().item() / b.abs().max().item()
        log(prefix(model) + "bwd", layer=fn, grad=name,
            card_vs_cpu=f"{rel:.3e}", tol=GRAD_TOL)
        if not rel <= GRAD_TOL:
            raise AssertionError(f"{fn} grad {name}: {rel:.3e}")
    return errs


def train_indices(ds, cfg: dict, subset=None) -> tuple:
    """The subdomains of ``train_batches``' train and val batch."""
    subset = np.arange(len(ds)) if subset is None else np.asarray(subset)
    tr_idx, va_idx = train_val_split(len(subset), 0.2, 0)
    bs = min(load_yaml(cfg["train_config"])["batch_size"], len(tr_idx))
    return subset[tr_idx[:bs]], subset[va_idx[:bs]]


def train_batches(ds, cfg: dict, subset=None):
    """(model, [train batch, val batch], rows_blk, blk): the first train and
    the first val batch ``PartitionScheduler.train`` builds for ``ds`` (or
    for an expert's ``subset`` of it) with seed 0 and the path's train
    config's batch size (the 12 train and the 4 val subdomains whole at a
    batch size of 16) — each merged into one graph, both blocked with one
    common blk — on the card, with a seeded full-width model."""
    tr_idx, va_idx = train_indices(ds, cfg, subset)
    model = make_model(cfg).cuda()
    fbs, rows_blk, blk = make_fused_batches(
        [merged_subdomains(ds, ix) for ix in (tr_idx, va_idx)], model)
    for fb, ix in zip(fbs, (tr_idx, va_idx)):
        fb["subdomains"] = len(ix)
    return model, fbs, rows_blk, blk


def batch_operands(fb, model, rows_blk: int, blk: int, tag: str) -> dict:
    """The first conv layer's operands of a fused training batch, as
    ``apply_fused_ad`` hands them to the layer, logged as ``tag``."""
    g, fused = fb["graph"], fb["fused"]
    h_e, x, w3, b3 = layer_operands(model, fused["edge_attr"], g.x)
    return dict(h=h_e, x=x, sp=fused["aux"]["senders_perm"], w3=w3, b3=b3,
                s=fused["s"], rows_blk=rows_blk, blk=blk, n=g.x.shape[0],
                b=fb["subdomains"], rank=rank_of(model), tag=tag)


def phase_train_kernels(batches, errs: dict, errs_bwd: dict,
                        tag: str | None = None) -> None:
    """Both kernels against their plain versions at the shapes training
    gives them: B1 and B2 (B3 and B4) on the train and the val batch."""
    model, fbs, rows_blk, blk = batches
    for at, fb in zip(("train_batch", "val_batch"), fbs):
        op = batch_operands(fb, model, rows_blk, blk,
                            prefix(model) if tag is None else tag)
        phase_kernel(op, at, errs)
        check_bwd(bwd_operands(op), at, errs_bwd)
        del op
        torch.cuda.empty_cache()


def phase_train(root: str, datasets: dict, cfgs: dict, tag: str = "") -> dict:
    """The training slice end to end: train_graph_ALDD on the full-size
    meshes (exp ``train_full{tag}``), launch counts (B1 and B2, or B3 and
    B4 for a rank-r config, and no other kernel), then the trained
    checkpoint served.  KernelNN's loss must fall; TEECNet's is recorded."""
    log_dir = os.path.join(root, "logs")
    cfg, ds = cfgs["full"], datasets["full"]
    rank = cfg.get("kernel_rank")
    model = make_model(cfg)
    label = prefix(model) + "train"
    fwd, bwd_k = FWD[rank is not None][0], BWD[rank is not None][0]
    exp = "train_full" + tag
    epochs = cfg["train_epochs"]
    train_cfg = load_yaml(cfg["train_config"])
    log(label, config=os.path.relpath(cfg["train_config"], REPO),
        cut=f"epochs {train_cfg['epochs']} -> {epochs}",
        val_interval=f"{train_cfg['val_interval']} -> 1")
    train_cfg.update(epochs=epochs, val_interval=1)
    depth = cfg["num_layers"]
    tr_idx, va_idx = train_val_split(len(ds), 0.2, 0)
    n_batches = [-(-len(ix) // min(train_cfg["batch_size"], len(tr_idx)))
                 for ix in (tr_idx, va_idx)]
    reset_launches()
    t0 = time.time()
    train_graph_ALDD(exp, model, ds, 1, train_cfg, log_dir=log_dir)
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_fwd, n_bwd = fwd.launches, bwd_k.launches
    with open(os.path.join(log_dir, "metrics",
                           f"{exp}_partition_0.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    vals = [r["val_loss"] for r in records if "val_loss" in r]
    steps = epochs * n_batches[0]
    evals = len(vals) * n_batches[1]
    log(label, subdomains=len(ds), train=len(tr_idx), val=len(va_idx),
        batch_size=train_cfg["batch_size"], epochs=len(losses), steps=steps,
        val_evals=evals, rank=rank, fwd_launches=n_fwd,
        bwd_launches=n_bwd, wall_s=f"{wall:.1f}",
        losses=",".join(f"{v:.5g}" for v in losses),
        val_losses=",".join(f"{v:.5g}" for v in vals))
    if cfg["model"] == "neuralop":
        # TEECNet's loss is recorded as it comes: no nonlinearity between
        # layers, and its lr and init are the reference's, not tuned here
        if len(losses) != epochs or not np.all(np.isfinite(losses + vals)):
            raise AssertionError(f"train losses {losses}, val {vals}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train loss did not fall: {losses}")
    check_only(label, {fwd: depth * (steps + evals), bwd_k: depth * steps})
    ckpt_path = os.path.join(log_dir, "models", f"collection_{exp}",
                             "partition_0.npz")
    if not os.path.exists(ckpt_path):
        raise AssertionError(f"{ckpt_path} was not written")
    reset_launches()
    lanes, fields = serve(ds, model, [0], log_dir, exp, None)
    torch.cuda.synchronize()
    served = fwd.launches
    log(label, served_from=os.path.relpath(ckpt_path, root),
        lane=lanes[0][1], launches=served,
        nodes=len(fields[0]["pressure"]), finite=True)
    check_only(f"{label}: the trained checkpoint's request",
               {fwd: CHUNKS["full"] * depth})
    if rank is not None:
        # the same training in float32 (the float32 kernels) from the same seed,
        # so that the loss curve at this lr can be told from bf16 rounding
        reset_launches()
        train_graph_ALDD(exp + "_f32", make_model(cfg), ds, 1, train_cfg,
                         log_dir=log_dir, gemm_dtype="float32")
        torch.cuda.synchronize()
        check_only(f"{label} float32",
                   {fwd: depth * (steps + evals), bwd_k: depth * steps})
        with open(os.path.join(log_dir, "metrics",
                               f"{exp}_f32_partition_0.jsonl")) as f:
            records = [json.loads(line) for line in f]
        log(label, dtype="float32", design=fused_conv.design(torch.float32,
                                                             rank),
            losses=",".join(f"{r['train_loss']:.5g}" for r in records
                            if "train_loss" in r),
            val_losses=",".join(f"{r['val_loss']:.5g}" for r in records
                                if "val_loss" in r))
    return dict(fwd=n_fwd, bwd=n_bwd, served=served, steps=steps,
                evals=evals, losses=losses)


@contextlib.contextmanager
def same_branches(masks: list, replay: bool):
    """The models' activations (``torch.relu``; TEECNet's leaky ReLU) on
    recorded branches: recording (``replay`` False) appends each call's
    mask (pre-activation > 0, on the CPU) to ``masks`` in call order;
    replaying takes each call's branch from the next recorded mask, and
    appends the number of entries whose own sign disagrees and the largest
    of their magnitudes, as (flips, largest) tuples after the masks.  A
    pre-activation within rounding of zero would otherwise take either
    branch on either side, and one such flip moves every gradient upstream
    of it by that node's whole gradient."""
    from fast_eng_super_resolution_tpu_torch.models import teecnet

    relu, leaky = torch.relu, teecnet._leaky_relu
    at = iter(list(masks)) if replay else None
    flips = []

    def branch(t, slope):
        if not replay:
            masks.append((t > 0).cpu())
            return leaky(t) if slope else relu(t)
        mask = next(at).to(t.device)
        if mask.shape != t.shape:
            raise AssertionError(f"activation {tuple(t.shape)} against the "
                                 f"recorded {tuple(mask.shape)}")
        off = (t > 0) != mask
        flips.append((int(off.sum()), float(t[off].abs().max()) if off.any()
                      else 0.0))
        return torch.where(mask, t, slope * t)

    torch.relu = lambda t: branch(t, 0.0)
    teecnet._leaky_relu = lambda t: branch(t, 0.01)
    try:
        yield flips
        if replay and next(at, None) is not None:
            raise AssertionError("fewer activations than recorded")
    finally:
        torch.relu, teecnet._leaky_relu = relu, leaky


def parity_steps(small_merged, cfg: dict, dev: str, start=None) -> tuple:
    """Three float32 fused train steps of ``cfg``'s seeded model on ``dev``
    (on the card the kernels, depth launches of the forward and of the
    backward kernel per step (past 256 one per piece), counted and checked;
    on the CPU the plain versions).  Without ``start`` (the CPU) each step
    records the state it starts from (the parameters and Adam's moments)
    and its activations' branches (``same_branches``); with ``start`` (the
    CPU's steps) each step first loads that state and takes those
    branches.  Returns (per step its loss, each parameter's gradient, and
    the state and branches (the CPU) or the flipped branches (the card);
    the path's parity label)."""
    lr = load_yaml(cfg["train_config"])["lr"]
    rank = cfg.get("kernel_rank")
    kernels = (FWD[rank is not None][0], BWD[rank is not None][0])
    model = make_model(cfg)
    fb, rows_blk, blk = make_fused_batch(small_merged, model, device=dev)
    trainer = Trainer(model.to(dev), lr=lr, layout="fused",
                      fused_rows_blk=rows_blk, fused_blk=blk,
                      fused_dtype="float32")
    opt = trainer.init()
    reset_launches()
    steps = []
    for i in range(3):
        state, masks = None, []
        if start is not None:
            model.load_state_dict(start[i]["state"]["model"])
            opt.load_state_dict(start[i]["state"]["opt"])
            masks = start[i]["masks"]
        else:
            state = {"model": {k: v.detach().clone()
                               for k, v in model.state_dict().items()},
                     "opt": copy.deepcopy(opt.state_dict())}
        with same_branches(masks, replay=start is not None) as flips:
            loss = float(trainer.step(opt, fb))
        steps.append({"loss": loss, "state": state, "masks": masks,
                      "flips": flips,
                      "grads": {n: p.grad.detach().cpu()
                                for n, p in model.named_parameters()}})
    label = prefix(model) + "parity"
    if dev == "cuda":
        torch.cuda.synchronize()
        want = {k: 3 * cfg["num_layers"] * pieces_per_call(cfg)
                for k in kernels}
        check_only(label, want)
        log(label, dtype="float32",
            design=fused_conv.design(torch.float32, rank),
            **launches_of(*kernels))
    return steps, label


def cpu_parity(small_merged, cfg: dict, path: str) -> tuple:
    """``parity_steps`` on the CPU in a worker process (``start_parity``),
    its steps saved to ``path``: (losses, seconds, path, the time it
    ended)."""
    t0 = time.time()
    steps = parity_steps(small_merged, cfg, "cpu")[0]
    torch.save(steps, path)
    return [st["loss"] for st in steps], time.time() - t0, path, time.time()


def start_parity(small_merged, cfgs: dict, root: str):
    """Starts phase 7's CPU side of each config of ``cfgs`` (key -> config)
    in one worker process at ``PARITY_NICE``, in order, so that the plain
    steps overlap the card's phases, each saving its steps
    under ``root``, and gives ``quiet`` its pid; returns (pool, key ->
    future of ``cpu_parity``)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    pool = cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"),
                                  initializer=os.nice,
                                  initargs=(PARITY_NICE,))
    PARITY_WORKER["pid"] = pool.submit(os.getpid)
    QUIET.append(PARITY_WORKER["pid"])
    return pool, {key: pool.submit(cpu_parity, small_merged, cfg,
                                   os.path.join(root, f"parity_{key}.pt"))
                  for key, cfg in cfgs.items()}


def stop_on_error(pid):
    """An exit callback that kills the worker process (``pid``: a future of
    its pid) when the run fails, so that its pool's shutdown need not wait
    for the plain steps it is running."""
    def stop(exc_type, exc, tb) -> bool:
        if exc_type is not None and pid.done():
            with contextlib.suppress(ProcessLookupError):
                os.kill(pid.result(), signal.SIGCONT)
                os.kill(pid.result(), signal.SIGKILL)
        return False
    return stop


def _ref_init(datasets: dict) -> None:
    os.nice(REF_NICE)
    _REF_DATA.update(datasets)


def _ref_prediction(mesh: str, cfg: dict, log_dir: str, exp: str) -> tuple:
    """``cpu_prediction``'s work in the reference worker."""
    t0 = time.time()
    _, (ref,) = serve(_REF_DATA[mesh], make_model(cfg), [0], log_dir, exp,
                      "cpu", gemm_dtype="float32")
    return ref, time.time() - t0


def closing_cpu_steps(graph, cfg: dict) -> tuple:
    """``closing_fused_custom``'s CPU side: its steps in the merged layout
    ('edge3d', plain torch) with ``FESR_LOSS_VJP=custom`` on ``graph`` (the
    train cell's batch, on the CPU); (losses, seconds)."""
    t0 = time.time()
    with env_set("FESR_LOSS_VJP", "custom"):
        tr = Trainer(make_mode_model(cfg, "edge3d"),
                     lr=load_yaml(cfg["train_config"])["lr"])
        opt = tr.init()
        losses = np.array([float(tr.step(opt, graph))
                           for _ in range(CLOSING_STEPS)])
    return losses, time.time() - t0


def _ref_closing(cfg: dict) -> tuple:
    """``closing_cpu_steps`` in the reference worker, on the batch that
    ``train_batches`` builds, built here on the CPU."""
    ds = _REF_DATA["full"]
    return closing_cpu_steps(
        merged_subdomains(ds, train_indices(ds, cfg)[0]).to_torch("cpu"), cfg)


def start_references(datasets: dict, jobs: dict):
    """Starts the CPU references ``jobs`` (key -> (function, args)) in one
    worker process at ``REF_NICE`` (torch's default threads, as in this
    process: the same bits), in order, into ``CPU_REFS``, and gives
    ``quiet`` its pid; returns the pool."""
    import concurrent.futures as cf
    import multiprocessing as mp

    pool = cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"),
                                  initializer=_ref_init, initargs=(datasets,))
    QUIET.append(pool.submit(os.getpid))
    CPU_REFS.update({key: pool.submit(fn, *args)
                     for key, (fn, args) in jobs.items()})
    return pool


def cpu_prediction(ds, model, log_dir: str, exp: str) -> tuple:
    """(the port's float32 plain prediction of mesh 0 on the CPU from exp
    ``exp``'s checkpoint: the .vtu's point data, its seconds): the
    reference worker's, where ``start_references`` queued it, else computed
    here."""
    ref = CPU_REFS.pop(exp, None)
    if ref is not None:
        return ref.result()
    t0 = time.time()
    _, (ref,) = serve(ds, model, [0], log_dir, exp, "cpu",
                      gemm_dtype="float32")
    return ref, time.time() - t0


def phase_parity(small_merged, cfg: dict, cpu) -> dict:
    """Three float32 fused train steps on the card (kernels, depth launches
    of the forward and of the backward kernel per step) held to the CPU's
    (plain versions; ``cpu``: a future of ``start_parity``'s worker), each
    started from the state the CPU's step started from (step 0: the seeded
    weights, the same on both) on the CPU's activation branches
    (``same_branches``), so that each step compares one function on the
    same inputs: its loss, relative to the CPU's, and each parameter's
    gradient, relative to the largest entry of the CPU's, within
    ``PARITY_TOL``, or the run fails.  (Free-running steps are ill-posed
    where the config's lr lets the loss grow: Adam's first update is about
    lr sign(g), so gradient entries within float32 rounding of zero move
    the two sides' weights 2 lr apart, parity_plain_check.py; and a
    pre-activation within rounding of zero may take the other branch.)
    Returns each step's errors and how many activations took another
    branch of their own (logged with the largest such |pre-activation|)."""
    t1 = time.time()
    cpu_losses, cpu_s, path, ended = cpu.result()
    wait_s = time.time() - t1
    start = torch.load(path, weights_only=False)
    os.remove(path)
    card, label = parity_steps(small_merged, cfg, "cuda", start)
    log(label, cpu="worker", cpu_s=f"{cpu_s:.1f}", wait_s=f"{wait_s:.1f}",
        ended_at_s=f"{ended - PARITY_WORKER['t0']:.1f}")
    rels, grad_rels = [], []
    for step, (a, b) in enumerate(zip(card, start)):
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        worst, name = 0.0, None
        for n, g in b["grads"].items():
            top = g.abs().max().item()
            err = (a["grads"][n] - g).abs().max().item()
            err = err / top if top > 0 else err
            if not err <= worst:  # a NaN too
                worst, name = float("inf") if err != err else err, n
        rels.append(rel)
        grad_rels.append(worst)
        flips = sum(n for n, _ in a["flips"])
        log(label, step=step, card=f"{a['loss']:.8g}", cpu=f"{b['loss']:.8g}",
            rel=f"{rel:.3e}", grad_rel=f"{worst:.3e}", grad_worst=name,
            tol=PARITY_TOL, activations=len(a["flips"]), own_branch_flips=flips,
            flip_max_abs=f"{max((m for _, m in a['flips']), default=0.0):.3e}")
        if not (rel <= PARITY_TOL and worst <= PARITY_TOL):
            raise AssertionError(
                f"{label} step {step}: loss card {a['loss']} vs cpu "
                f"{b['loss']} ({rel:.3e}), gradient {name} {worst:.3e}")
    return {"rel": rels, "grad_rel": grad_rels, "tol": PARITY_TOL,
            "losses_cpu": cpu_losses,
            "own_branch_flips": [sum(n for n, _ in a["flips"]) for a in card]}


def defer_parity(small_merged, cfg: dict, cpu) -> dict:
    """Queues ``phase_parity`` for ``run_parities``; returns the dict its
    errors go into then (the path's JSON entries hold it)."""
    result = {}
    PARITY_PENDING.append((small_merged, cfg, cpu, result))
    return result


def run_parities() -> None:
    """Phase 7's card side of every path, in the paths' order: each fails
    the run past ``PARITY_TOL``."""
    t0 = time.time()
    while PARITY_PENDING:
        small_merged, cfg, cpu, result = PARITY_PENDING.pop(0)
        result.update(phase_parity(small_merged, cfg, cpu))
        torch.cuda.empty_cache()
    log("parity", wall_s=f"{time.time() - t0:.1f}")


def phase_bwd_times(bop, smi, plain_bop=None, reps: int = 20) -> dict:
    """B2's (B4's) and its plain version's CUDA-event medians at the chunk
    shape, and its bound; ``plain_bop`` and ``reps`` as ``fwd_times``'."""
    t = {}
    rank = bop["rank"]
    _, plain, launcher = BWD[rank is not None]
    warm, plain_reps = timing_reps(reps)

    def typed_operands(o, tdt):
        return [o[key].to(tdt).contiguous() for key in ("h", "x_src", "w3")]

    with torch.no_grad():
        for dt in ("bfloat16", "float32"):
            tdt = getattr(torch, dt)
            h, xs, w3 = typed_operands(bop, tdt)
            t[f"ms_{dt}"] = cuda_ms(lambda: launcher(
                bop["g"], h, xs, w3, bop["b3"], bop["s"], **layer_kw(bop)),
                reps=reps, warm=warm)
            if plain_bop is not None:
                h, xs, w3 = typed_operands(plain_bop, tdt)
                t[f"ms_at_plain_slots_{dt}"] = cuda_ms(lambda: launcher(
                    plain_bop["g"], h, xs, w3, plain_bop["b3"],
                    plain_bop["s"], **layer_kw(plain_bop)), reps=reps,
                    warm=warm)
            po = bop if plain_bop is None else plain_bop
            t[f"plain_ms_{dt}"] = cuda_ms(
                lambda: plain(po["g"], h, xs, w3, po["b3"], po["s"],
                              gemm_dtype=dt, **layer_kw(po)),
                reps=plain_reps, warm=warm)
    if plain_bop is not None:
        t["plain_slots"] = plain_bop["h"].shape[0]
    # bound: the real slots' operations at the input type's peak vs every
    # input byte read once and every output written once.  Full rank: dmsg,
    # the two outer products and the three GEMMs (dh, dx_src, dw3 with db3).
    # Rank r: dmsg, the uv recompute, t, dt, dx_src, duv, dh, dw3 with db3
    slots, k = bop["h"].shape
    c = bop["x"].shape[1]
    ncol = bop["w3"].shape[1]
    real = int((bop["s"].slot_rows >= 0).sum())
    if rank is None:
        flops = real * (c + ncol + (k + 1) * c
                        + 2 * k * ncol + 2 * (k + 1) * ncol + 2 * (k + 1) * ncol)
    else:
        flops = real * (c + 2 * (k + 1) * ncol + 6 * rank * c + ncol
                        + 2 * k * ncol + 2 * (k + 1) * ncol)
    rows = len(bop["s"].row_weight)
    for dt, size in (("bfloat16", 2), ("float32", 4)):
        nbytes = (size * (slots * k + slots * c + k * ncol)
                  + 4 * (rows * c + ncol + slots + rows)      # g, b3, S
                  + 4 * (slots * k + slots * c + k * ncol + ncol))  # outputs
        t.update(typed(bound(flops, nbytes, dt, split_of(bop, dt)), dt))
    log_times(bop["tag"] + "times", "bwd", t, smi)
    return t


def phase_train_times(batches, cfg: dict, smi, tag: str | None = None,
                      float32: bool | None = None, reps: int = 5) -> dict:
    """Warm wall time of one fused bf16 train step on the training batch
    (the 12 train subdomains merged at batch size 16), the median of
    ``reps``, and one profiled step; with ``float32`` (by default on the
    rank-r path) also of one float32 step."""
    model, (fb, _), rows_blk, blk = batches
    s = fb["fused"]["s"]
    label = (prefix(model) if tag is None else tag) + "times"
    log(label, train_batch=fb["subdomains"], nodes=fb["graph"].x.shape[0],
        edges=int(fb["graph"].edge_mask.sum()), blk=blk,
        slots=len(s.slot_rows), real_slots=int((s.slot_rows >= 0).sum()))
    trainer = Trainer(model, lr=load_yaml(cfg["train_config"])["lr"],
                      layout="fused", fused_rows_blk=rows_blk, fused_blk=blk)
    opt = trainer.init(SEED)

    def step():
        return trainer.step(opt, fb)

    t = {"train_step_ms": warm_ms(step, reps)}
    t.update({f"train_{k}": v for k, v in
              profile_call(step, label + "_train_step").items()})
    if float32 is None:
        float32 = rank_of(model) is not None
    if float32:
        # the float32 step (float32 B3/B4 on the rank-r path), as the
        # path's float32 training runs it
        trainer32 = Trainer(model, lr=load_yaml(cfg["train_config"])["lr"],
                            layout="fused", fused_rows_blk=rows_blk,
                            fused_blk=blk, fused_dtype="float32")
        opt32 = trainer32.init(SEED)
        t["train_step_ms_float32"] = warm_ms(
            lambda: trainer32.step(opt32, fb), reps)
    log_times(label, "train_step", t, smi)
    return t


def run_path(root, name, smi, datasets, models, cfgs, parity,
             tag: str = "") -> dict:
    """Phases 3-8 for one model configuration (full rank, or rank r with
    ``tag``): kernels against their plain versions at the chunk and the
    training batches, serving, training, parity (``parity``: the CPU's
    losses, a future of ``start_parity``'s worker), times.  Returns what
    the kernels' JSON entries need."""
    t0 = time.time()
    op = chunk_operands(datasets["full"], models["full"], "cuda")
    errs = phase_kernel(op)
    bop = bwd_operands(op)
    small_merged = merged_subdomains(datasets["small"])
    errs_bwd = phase_bwd(bop, small_merged, models["small"])
    batches = train_batches(datasets["full"], cfgs["full"])
    phase_train_kernels(batches, errs, errs_bwd)
    launches = phase_serve(root, datasets, models, cfgs, tag)
    train = phase_train(root, datasets, cfgs, tag)
    defer_parity(small_merged, cfgs["small"], parity)
    t = fwd_times(op, smi)
    t.update(request_times(datasets, models, root, smi, tag))
    tb = phase_bwd_times(bop, smi)
    t.update(phase_train_times(batches, cfgs["full"], smi))
    msg = op["msg"]
    del op, bop, batches
    torch.cuda.empty_cache()
    log(prefix(models["full"]) + "path", depth=cfgs["full"]["num_layers"],
        wall_s=f"{time.time() - t0:.1f}")
    return dict(errs=errs, errs_bwd=errs_bwd, launches=launches, train=train,
                t=t, tb=tb, msg=msg)


def train_types(root: str, ds, cfg: dict, epochs: int,
                dtypes=("bfloat16", "float32")) -> dict:
    """``train_graph_ALDD`` of ``cfg`` on the full-size meshes, cut to
    ``epochs`` epochs, in each of ``dtypes`` from the same seed: finite
    losses, the forward kernel (B1, or B3 at a rank) launched depth x
    (steps + validations) and the backward one depth x steps times in each,
    no other kernel.  Returns each type's (forward, backward) launches."""
    log_dir = os.path.join(root, "logs")
    rank = cfg.get("kernel_rank")
    fwd, bwd_k = FWD[rank is not None][0], BWD[rank is not None][0]
    label = prefix(make_model(cfg)) + "train"
    train_cfg = load_yaml(cfg["train_config"])
    train_cfg.update(epochs=epochs, val_interval=1)
    depth = cfg["num_layers"]
    tr_idx, va_idx = train_val_split(len(ds), 0.2, 0)
    n_batches = [-(-len(ix) // min(train_cfg["batch_size"], len(tr_idx)))
                 for ix in (tr_idx, va_idx)]
    out = {}
    for dt in dtypes:
        exp = f"{label}_full_{dt}"
        reset_launches()
        t0 = time.time()
        train_graph_ALDD(exp, make_model(cfg), ds, 1, dict(train_cfg),
                         log_dir=log_dir, gemm_dtype=dt)
        torch.cuda.synchronize()
        with open(os.path.join(log_dir, "metrics",
                               f"{exp}_partition_0.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["train_loss"] for r in records if "train_loss" in r]
        vals = [r["val_loss"] for r in records if "val_loss" in r]
        steps, evals = epochs * n_batches[0], len(vals) * n_batches[1]
        out[dt] = (fwd.launches, bwd_k.launches)
        log(label, dtype=dt, epochs=len(losses), steps=steps,
            val_evals=evals, design=fused_conv.design(getattr(torch, dt),
                                                      rank),
            fwd_launches=out[dt][0], bwd_launches=out[dt][1],
            wall_s=f"{time.time() - t0:.1f}",
            losses=",".join(f"{v:.5g}" for v in losses),
            val_losses=",".join(f"{v:.5g}" for v in vals))
        if len(losses) != epochs or not np.all(np.isfinite(losses + vals)):
            raise AssertionError(f"{label} {dt} losses {losses}, {vals}")
        n = depth * pieces_per_call(cfg)
        check_only(f"{label} {dt}",
                   {fwd: n * (steps + evals), bwd_k: n * steps})
    return out


def run_rank12(root, smi, datasets, models, cfgs, parity) -> dict:
    """The rank-12 path: B3 and B4 at a rank that is not a multiple of 8.
    One full-size request (the card's bfloat16 prediction against the CPU's
    float32 plain one), the path's training in both types, phase 7's float32
    parity (``parity``: the CPU's losses from ``start_parity``'s worker); B3 and B4 against their plain versions at the full-size chunk at
    each of ``RANK12_CHECKED`` (a seeded model of that rank) and their times
    at ``RANK12_TIMED``, and at rank 12 also at the train and val batches;
    the warm request and train steps at rank 12.
    Returns what the kernels' JSON entries need, with each timed rank's
    numbers under ``by_rank``."""
    t0 = time.time()
    log_dir = os.path.join(root, "logs")
    cfg, ds = cfgs["full"], datasets["full"]
    label = f"rank{RANK12}_serve"
    fwd = FWD[True][0]
    reset_launches()
    lanes, (card,) = serve(ds, models["full"], [0], log_dir, f"full_r{RANK12}",
                           None)
    torch.cuda.synchronize()
    served = fwd.launches
    log(label, mesh="full", lane=lanes[0][1], launches=served,
        design=fused_conv.design(torch.bfloat16, RANK12),
        nodes=len(card["pressure"]))
    check_only(label, {fwd: CHUNKS["full"] * cfg["num_layers"]})
    ref, _ = cpu_prediction(ds, models["full"], log_dir, f"full_r{RANK12}_cpu")
    for key in ("velocity", "pressure"):
        rel = np.abs(card[key] - ref[key]).max() / np.abs(ref[key]).max()
        log(label, field=key, vs_cpu_f32=f"{rel:.3e}", tol=SERVE_TOL)
        if not rel <= SERVE_TOL:
            raise AssertionError(f"{label} {key}: {rel:.3e} > {SERVE_TOL}")
    trained = train_types(root, ds, cfg, RANK12_EPOCHS)
    defer_parity(merged_subdomains(datasets["small"]), cfgs["small"], parity)
    errs, errs_bwd, by_rank = {}, {}, {}
    for rank in RANK12_CHECKED:
        op = chunk_operands(ds, make_model(dict(cfg, kernel_rank=rank)),
                            "cuda")
        e_f, e_b = phase_kernel(op), check_bwd(bwd_operands(op))
        if rank == RANK12:
            errs, errs_bwd = e_f, e_b
        if rank in RANK12_TIMED:
            rp = fused_conv.padded_rank(rank)
            by_rank[rank] = {"padded_rank": rp, "ceiling": rank / rp,
                             "max_abs_err": e_f, "max_abs_err_bwd": e_b,
                             "fwd": fwd_times(op, smi),
                             "bwd": phase_bwd_times(bwd_operands(op), smi)}
        del op
        torch.cuda.empty_cache()
    t = dict(by_rank[RANK12]["fwd"])
    t.update(request_times(datasets, models, root, smi, f"_r{RANK12}"))
    batches = train_batches(ds, cfg)
    phase_train_kernels(batches, errs, errs_bwd)
    t.update(phase_train_times(batches, cfg, smi))
    del batches
    torch.cuda.empty_cache()
    log(f"rank{RANK12}_path", depth=cfg["num_layers"],
        wall_s=f"{time.time() - t0:.1f}")
    fwd_n = sum(n for n, _ in trained.values())
    bwd_n = sum(n for _, n in trained.values())
    return dict(errs=errs, errs_bwd=errs_bwd, launches=served,
                train=dict(fwd=fwd_n, bwd=bwd_n, served=0), t=t,
                tb=by_rank[RANK12]["bwd"], by_rank=by_rank, trained=trained)


def wide_slice(op, c_in: int, c_out: int, k: int, rank=None) -> dict:
    """B1's (at a ``rank``, B3's) operands on the leading
    ``WIDE_SLICE_BLOCKS`` receiver blocks of the chunk ``op`` (B1's on
    fewer where the plain versions' [slots, c_in c_out] float32 arrays would
    pass ``PLAIN_BYTES``): its senders and S there, and at (c_in, c_out, K,
    rank) = ``op``'s its own h, x, w3 and b3, else seeded ones of those
    widths (w3 [K, c_in c_out], or the head [K, rank (c_in + c_out)], and b3
    scaled so that a message stays of order one)."""
    blocks = WIDE_SLICE_BLOCKS
    if rank is None:
        blocks = max(1, min(blocks, PLAIN_BYTES // (4 * op["blk"] * c_in
                                                    * c_out)))
    slots = blocks * op["blk"]
    s = fused_conv.CompactS(op["s"].slot_rows[:slots],
                            op["s"].row_weight[:blocks * op["rows_blk"]])
    dev = op["x"].device
    if (c_in, c_out, k, rank) == (op["x"].shape[1], layer_kw(op)["c_out"],
                                  op["h"].shape[1], op["rank"]):
        h, x, w3, b3 = op["h"][:slots], op["x"], op["w3"], op["b3"]
    else:
        gen = torch.Generator().manual_seed(SEED + c_in + 3 * c_out + k
                                            + (rank or 0))
        h = torch.relu(torch.randn(slots, k, generator=gen))
        x = torch.randn(op["x"].shape[0], c_in, generator=gen)
        scale = (k * c_in) ** -0.5
        ncol = c_in * c_out if rank is None else rank * (c_in + c_out)
        w3 = torch.randn(k, ncol, generator=gen) * scale
        b3 = torch.randn(ncol, generator=gen) * scale
        h, x, w3, b3 = (t.to(dev) for t in (h, x, w3, b3))
    return dict(op, h=h.contiguous(), x=x.contiguous(), sp=op["sp"][:slots],
                w3=w3.contiguous(), b3=b3.contiguous(), s=s, c_out=c_out,
                rank=rank, b=f"{blocks} blocks", msg=None)


def run_wide(root, smi, datasets, models, cfgs, models_tc, cfgs_tc,
             width: int = WIDE, checked=WIDE_CHECKED,
             epochs: int = WIDE_EPOCHS, *, parity) -> dict:
    """A wide path (width 128: B1 and B2 past width 64; 256: past 128;
    320: past 256, as pieces of at most 256, each launch counted).
    Both full-size meshes served (chunks x depth B1 launches each, every
    .vtu finite) and the small mesh against the CPU's float32 plain
    prediction; the path's training in both types (B1 and B2 launch counts
    held); phase 7's float32 parity; B1 and B2 against their plain versions
    at ``checked`` on a leading slice of the full-size chunk, both types,
    both S forms, repeated launches bit-identical; their times at the
    full-size chunk (the plain versions' on the slice), the warm request and
    a fused train step in each type; TEECNet at the same width served once
    and trained one epoch, its launches counted.  Returns what the kernels'
    JSON entries need, and B5's operands at the full-size chunk of both
    models (``msg``, ``tc_msg``) for phase 9.  Past 128 the full-size
    meshes cannot be served in 'edge3d' (its [E, c_in c_out] arrays): the
    small mesh is served in 'edge3d' (the general lane, no kernel) against
    the CPU's plain prediction, and in 'pallas' (B5, ``small_b5``
    launches) against both; TEECNet's B1 and B2 are checked and timed at
    its own chunk (K 128).  ``parity``: phase 7's CPU losses on their way
    from ``start_parity``'s worker."""
    t0 = time.time()
    log_dir = os.path.join(root, "logs")
    cfg, ds = cfgs["full"], datasets["full"]
    depth = cfg["num_layers"]
    fwd = FWD[False][0]
    label = prefix(models["full"]) + "serve"
    reps = ((WIDE_REPS, WIDE_STEP_REPS) if width <= WIDE
            else (WIDER_REPS, WIDER_STEP_REPS))
    marks = [("start", t0)]

    def lap(part):  # the seconds since the last part, on a *_path line
        marks.append((part, time.time()))
        log(prefix(models["full"]) + "path", part=part,
            wall_s=f"{marks[-1][1] - marks[-2][1]:.1f}")

    served = 0
    for name in ("full", "small"):
        for idx in cfgs[name]["idxs"][:2 if name == "full" else 1]:
            reset_launches()
            lanes, (fields,) = serve(datasets[name], models[name], [idx],
                                     log_dir, f"{name}_w{width}", None)
            torch.cuda.synchronize()
            served += fwd.launches
            log(label, mesh=name, idx=idx, lane=lanes[0][1],
                launches=fwd.launches, width=width, depth=depth,
                design=fused_conv.design(torch.bfloat16),
                nodes=len(fields["pressure"]), finite=True)
            check_only(f"{label} {name} {idx}",
                       {fwd: CHUNKS[name] * cfgs[name]["num_layers"]
                        * pieces_per_call(cfgs[name])})
    lap("serve")
    ref, _ = cpu_prediction(datasets["small"], models["small"], log_dir,
                            f"small_w{width}_cpu")
    for key in ("velocity", "pressure"):
        rel = np.abs(fields[key] - ref[key]).max() / np.abs(ref[key]).max()
        log(label, mesh="small", field=key, vs_cpu_f32=f"{rel:.3e}",
            tol=SERVE_TOL)
        if not rel <= SERVE_TOL:
            raise AssertionError(f"{label} small {key}: {rel:.3e} > {SERVE_TOL}")
    lap("serve_cpu")
    if width > WIDE:
        # 'edge3d' on the card (FESR_FUSED_PREDICT=0: the general lane, no
        # kernel), float32 end to end, against the same CPU prediction
        with env_set("FESR_FUSED_PREDICT", "0"):
            reset_launches()
            t1 = time.time()
            lanes, (edge3d,) = serve(datasets["small"], models["small"], [0],
                                     log_dir, f"small_w{width}", None)
            torch.cuda.synchronize()
            check_only(f"{label} small edge3d", {})
        for key in ("velocity", "pressure"):
            rel = np.abs(edge3d[key] - ref[key]).max() / np.abs(ref[key]).max()
            log(label, mesh="small", mode="edge3d", lane=lanes[0][1],
                field=key, vs_cpu_f32=f"{rel:.3e}", tol=PALLAS_TOL,
                cold_s=f"{time.time() - t1:.3f}")
            if not rel <= PALLAS_TOL:
                raise AssertionError(f"{label} small edge3d {key}: {rel:.3e}")
        # conv mode 'pallas' (B5 per layer, the general lane) on the same
        # checkpoint, against 'edge3d' on the card and the CPU's prediction
        b5 = pallas_mp.fused_edge_messages
        with env_set("FESR_FUSED_PREDICT", "0"):
            reset_launches()
            t1 = time.time()
            lanes, (pallas_f,) = serve(
                datasets["small"], make_mode_model(cfgs["small"], "pallas"),
                [0], log_dir, f"small_w{width}", None)
            torch.cuda.synchronize()
            small_b5 = b5.launches
            check_only(f"{label} small pallas",
                       {b5: CHUNKS["small"] * cfgs["small"]["num_layers"]
                        * pieces_per_call(cfgs["small"])})
        for key in ("velocity", "pressure"):
            for vs, r in (("edge3d", edge3d[key]), ("cpu_f32", ref[key])):
                rel = np.abs(pallas_f[key] - r).max() / np.abs(r).max()
                log(label, mesh="small", mode="pallas", lane=lanes[0][1],
                    b5_launches=small_b5, field=key,
                    **{f"vs_{vs}": f"{rel:.3e}"}, tol=PALLAS_TOL,
                    cold_s=f"{time.time() - t1:.3f}")
                if not rel <= PALLAS_TOL:
                    raise AssertionError(f"{label} small pallas {key} vs "
                                         f"{vs}: {rel:.3e}")
        lap("edge3d")
    trained = train_types(root, ds, cfg, epochs)
    lap("train")
    held = defer_parity(merged_subdomains(datasets["small"]), cfgs["small"],
                        parity)
    op = chunk_operands(ds, models["full"], "cuda")
    errs, errs_bwd = {}, {}
    for c_in, c_out, k in checked:
        sop = wide_slice(op, c_in, c_out, k)
        at = f"slice_{c_in}x{c_out}_k{k}"
        phase_kernel(sop, at, errs)
        check_bwd(bwd_operands(sop), at, errs_bwd)
        del sop
        torch.cuda.empty_cache()
    lap("checked")
    sop = wide_slice(op, width, width, width)
    t = fwd_times(op, smi, plain_op=sop, reps=reps[0])
    tb = phase_bwd_times(bwd_operands(op), smi, plain_bop=bwd_operands(sop),
                         reps=reps[0])
    msg = op["msg"]  # B5's operands at the full-size chunk, for phase 9
    del op, sop
    torch.cuda.empty_cache()
    t.update(request_times(datasets, models, root, smi, f"_w{width}"))
    batches = train_batches(ds, cfg)
    t.update(phase_train_times(batches, cfg, smi, float32=True,
                               reps=reps[1]))
    del batches
    torch.cuda.empty_cache()
    lap("times")
    # TEECNet at this width: one full-size request, one epoch of training
    tc_label = prefix(models_tc["full"]) + "serve"
    reset_launches()
    lanes, (fields,) = serve(ds, models_tc["full"], [0], log_dir,
                             f"full_w{width}_teecnet", None)
    torch.cuda.synchronize()
    tc_served = fwd.launches
    log(tc_label, mesh="full", lane=lanes[0][1], launches=tc_served,
        width=width, depth=cfgs_tc["full"]["num_layers"],
        nodes=len(fields["pressure"]), finite=True)
    check_only(tc_label,
               {fwd: CHUNKS["full"] * cfgs_tc["full"]["num_layers"]
                * pieces_per_call(cfgs_tc["full"])})
    tc_trained = train_types(root, ds, cfgs_tc["full"], WIDE_TEECNET_EPOCHS,
                             ("bfloat16",))
    lap("teecnet")
    tc_op = chunk_operands(ds, models_tc["full"], "cuda")
    out = dict(width=width, checked=checked, errs=errs, errs_bwd=errs_bwd,
               launches=served, parity=held,
               train=dict(fwd=sum(n for n, _ in trained.values()),
                          bwd=sum(n for _, n in trained.values()), served=0),
               t=t, tb=tb, trained=trained, tc_served=tc_served,
               tc_trained=tc_trained["bfloat16"], msg=msg,
               tc_msg=tc_op["msg"])
    if width > WIDE:
        out.update(small_b5=small_b5)
        # TEECNet's B1 and B2 at its own chunk (c_in = c_out = width, K 128):
        # against their plain versions on its leading slice, and timed
        tc_k = tc_op["h"].shape[1]
        tc_sop = wide_slice(tc_op, width, width, tc_k)
        at = f"slice_{width}x{width}_k{tc_k}"
        tc_errs = phase_kernel(tc_sop, at)
        tc_errs_bwd = check_bwd(bwd_operands(tc_sop), at)
        tc_t = fwd_times(tc_op, smi, plain_op=tc_sop, reps=reps[0])
        tc_tb = phase_bwd_times(bwd_operands(tc_op), smi,
                                plain_bop=bwd_operands(tc_sop), reps=reps[0])
        lap("teecnet_kernels")
        out.update(tc=dict(errs=tc_errs, errs_bwd=tc_errs_bwd, t=tc_t,
                           tb=tc_tb, k=tc_k))
        del tc_sop
    del tc_op
    torch.cuda.empty_cache()
    log(prefix(models["full"]) + "path", depth=depth,
        wall_s=f"{time.time() - t0:.1f}")
    return out


def run_wide_rank(root, smi, datasets, models, cfgs, width: int = WIDE,
                  checked=WIDE_RANK_CHECKED, timed=WIDE_RANK_TIMED,
                  top=None, models_top=None, *, parity) -> dict:
    """A wide rank-r path (width 128: B3 and B4 past width 64, K 64 and
    rank 32; 256: past 128), at rank ``WIDE_RANK``.  Both full-size meshes
    served (chunks x depth B3 launches each, no other kernel, every .vtu
    finite) and the small mesh against the CPU's float32 plain prediction;
    the path's training in both types (B3 and B4 launch counts held);
    phase 7's float32 parity; at rank ``top`` (if any; ``models_top`` its
    full-size checkpoint) one full-size request and the parity again; B3
    and B4 against their plain versions at ``checked`` (c_in, c_out, K,
    rank) on a leading slice of the full-size chunk, both types, both S
    forms, repeated launches bit-identical; their times at the full-size
    chunk at ``timed`` (the plain versions' on the slice), the warm request
    and a fused train step in each type.  ``parity``: the CPU's steps at
    rank ``WIDE_RANK`` and at ``top`` (rank -> future of ``start_parity``'s
    worker).  Returns what the kernels' JSON entries need, each timed
    rank's numbers under ``by_rank``."""
    t0 = time.time()
    log_dir = os.path.join(root, "logs")
    cfg, ds = cfgs["full"], datasets["full"]
    reps = ((WIDE_REPS, WIDE_STEP_REPS) if width <= WIDE
            else (WIDER_REPS, WIDER_STEP_REPS))
    fwd = FWD[True][0]
    label = prefix(models["full"]) + "serve"
    marks = [time.time()]

    def lap(part):  # the seconds since the last part, on a *_path line
        marks.append(time.time())
        log(prefix(models["full"]) + "path", part=part,
            wall_s=f"{marks[-1] - marks[-2]:.1f}")

    served = 0
    for name in ("full", "small"):
        for idx in cfgs[name]["idxs"][:2 if name == "full" else 1]:
            reset_launches()
            lanes, (fields,) = serve(datasets[name], models[name], [idx],
                                     log_dir, f"{name}_w{width}r{WIDE_RANK}",
                                     None)
            torch.cuda.synchronize()
            served += fwd.launches
            log(label, mesh=name, idx=idx, lane=lanes[0][1],
                launches=fwd.launches, width=width, rank=WIDE_RANK,
                depth=cfgs[name]["num_layers"],
                design=fused_conv.design(torch.bfloat16, WIDE_RANK),
                nodes=len(fields["pressure"]), finite=True)
            check_only(f"{label} {name} {idx}",
                       {fwd: CHUNKS[name] * cfgs[name]["num_layers"]
                        * pieces_per_call(cfgs[name])})
    ref, _ = cpu_prediction(datasets["small"], models["small"], log_dir,
                            f"small_w{width}r{WIDE_RANK}_cpu")
    for key in ("velocity", "pressure"):
        rel = np.abs(fields[key] - ref[key]).max() / np.abs(ref[key]).max()
        log(label, mesh="small", field=key, vs_cpu_f32=f"{rel:.3e}",
            tol=SERVE_TOL)
        if not rel <= SERVE_TOL:
            raise AssertionError(f"{label} small {key}: {rel:.3e} > {SERVE_TOL}")
    lap("serve")
    trained = train_types(root, ds, cfg, WIDE_RANK_EPOCHS)
    lap("train")
    small_merged = merged_subdomains(datasets["small"])
    held = {f"rank{WIDE_RANK}": defer_parity(
        small_merged, cfgs["small"], parity[WIDE_RANK])}
    top_served = 0
    if top is not None:  # the top rank: one full-size request, the parity
        top_label = prefix(models_top) + "serve"
        reset_launches()
        lanes, (fields,) = serve(ds, models_top, [0], log_dir,
                                 f"full_w{width}r{top}", None)
        torch.cuda.synchronize()
        top_served = fwd.launches
        log(top_label, mesh="full", lane=lanes[0][1], launches=top_served,
            width=width, rank=top, padded_rank=fused_conv.padded_rank(top),
            slabs=fused_conv.lowrank_slabs(top), nodes=len(fields["pressure"]),
            finite=True)
        check_only(top_label, {fwd: CHUNKS["full"] * cfg["num_layers"]})
        held[f"rank{top}"] = defer_parity(
            small_merged, dict(cfgs["small"], kernel_rank=top), parity[top])
        lap("top")
    errs, errs_bwd, by_rank = {}, {}, {}
    slice_errs = {}
    op = chunk_operands(ds, models["full"], "cuda")
    for c_in, c_out, k, rank in checked:
        sop = wide_slice(op, c_in, c_out, k, rank)
        at = f"slice_{c_in}x{c_out}_k{k}_r{rank}"
        e_f, e_b = phase_kernel(sop, at), check_bwd(bwd_operands(sop), at)
        slice_errs[at] = {"fwd": e_f, "bwd": e_b}
        for into, e in ((errs, e_f), (errs_bwd, e_b)):
            for dt, v in e.items():
                into[dt] = max(into.get(dt, 0.0), v)
        del sop
        torch.cuda.empty_cache()
    del op
    torch.cuda.empty_cache()
    lap("checked")
    for rank in timed:
        op = chunk_operands(ds, make_model(dict(cfg, kernel_rank=rank)),
                            "cuda")
        sop = wide_slice(op, width, width, width, rank)
        rp = fused_conv.padded_rank(rank)
        by_rank[rank] = {"padded_rank": rp, "ceiling": rank / rp,
                         "slabs": fused_conv.lowrank_slabs(rank),
                         "fwd": fwd_times(op, smi, plain_op=sop,
                                          reps=reps[0]),
                         "bwd": phase_bwd_times(bwd_operands(op), smi,
                                                plain_bop=bwd_operands(sop),
                                                reps=reps[0])}
        del op, sop
        torch.cuda.empty_cache()
    t = dict(by_rank[WIDE_RANK]["fwd"])
    t.update(request_times(datasets, models, root, smi,
                           f"_w{width}r{WIDE_RANK}"))
    batches = train_batches(ds, cfg)
    t.update(phase_train_times(batches, cfg, smi, reps=reps[1]))
    del batches
    torch.cuda.empty_cache()
    lap("times")
    log(prefix(models["full"]) + "path", depth=cfg["num_layers"],
        wall_s=f"{time.time() - t0:.1f}")
    return dict(width=width, errs=errs, errs_bwd=errs_bwd,
                launches=served,
                train=dict(fwd=sum(n for n, _ in trained.values()),
                           bwd=sum(n for _, n in trained.values()), served=0),
                t=t, tb=by_rank[WIDE_RANK]["bwd"], by_rank=by_rank,
                trained=trained, top=top, top_served=top_served,
                slice_errs=slice_errs, parity=held)


def phase_pallas(root: str, datasets: dict, paths: dict, smi) -> tuple:
    """Conv mode 'pallas' end to end: for each (label -> (cfg, exp tag)) of
    ``paths``, the model built with ``mode='pallas'`` serves full-size mesh 0
    from the checkpoint of exp ``full{tag}`` with FESR_FUSED_PREDICT=0 (the
    general lane's ``apply`` per chunk): B5 launched chunks x depth times
    and no other kernel.  The same checkpoint served by the model in its
    default mode ('edge3d' on the card, no kernel) is the reference up to
    width 128 (past it 'edge3d' builds [E, c_in c_out] arrays of 67 GB:
    the small mesh is held to 'edge3d' by ``run_wide``).  Then each model's
    warm request time in each mode it served.  Returns B5's launches per
    path and the warm request times."""
    log_dir = os.path.join(root, "logs")
    launches, requests = {}, {}
    with env_set("FESR_FUSED_PREDICT", "0"):
        for label, (cfg, tag) in paths.items():
            want = CHUNKS["full"] * cfg["num_layers"] * pieces_per_call(cfg)
            fields = {}
            modes = [("pallas", make_mode_model(cfg, "pallas"))]
            if cfg["width"] <= WIDE:
                modes.append(("edge3d", make_model(cfg)))
            for mode, model in modes:
                reset_launches()
                t0 = time.time()
                lanes, (f,) = serve(datasets["full"], model, [0], log_dir,
                                    "full" + tag, None)
                torch.cuda.synchronize()
                got = pallas_mp.fused_edge_messages.launches
                log("pallas", model=label, mode=mode, lane=lanes[0][1],
                    reason=repr(lanes[0][2]), b5_launches=got,
                    nodes=len(f["pressure"]), cold_s=f"{time.time() - t0:.3f}")
                if lanes[0][1] != "general":
                    raise AssertionError(f"{label} {mode} took lane {lanes[0][1]}")
                check_only(f"pallas {label} {mode} request",
                           {pallas_mp.fused_edge_messages: want}
                           if mode == "pallas" else {})
                fields[mode] = f
                # past 256 a request takes about a second: fewer repeats
                ms, _ = warm_request(datasets["full"], model, log_dir,
                                     "full" + tag,
                                     reps=5 if cfg["width"] <= WIDER else 2)
                requests.setdefault(label, {})[mode] = ms
                log("pallas", model=label, mode=mode,
                    request_ms=f"{ms:.4f}", card=repr(smi))
            launches[label] = want
            if "edge3d" not in fields:
                continue
            for key in ("velocity", "pressure"):
                r, g = fields["edge3d"][key], fields["pallas"][key]
                rel = np.abs(g - r).max() / np.abs(r).max()
                log("pallas", model=label, field=key,
                    vs_edge3d=f"{rel:.3e}", tol=PALLAS_TOL)
                if not rel <= PALLAS_TOL:
                    raise AssertionError(f"pallas {label} {key}: {rel:.3e}")
    return launches, requests


def check_messages(label: str, h, x_src, w3, b3, step: int) -> float:
    """B5 against its plain version on the card (the plain reference
    computed ``step`` edges at a time), two launches bit-identical, its
    first launch (the stage image; past 256 each piece's) bit-equal to
    ``stage_image``; one launch counted per call (past 256 one per piece,
    ``fused_conv.width_pieces``).  Raises past ``MSG_TOL``; returns the
    largest absolute error."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = pallas_mp.fused_edge_messages_plain
    b5 = pallas_mp.fused_edge_messages
    e, k = h.shape
    c_in = x_src.shape[1]
    c_out = w3.shape[1] // c_in
    dp, sd = fused_conv.f32_depth(fused_conv.piece_width(c_in))
    pieces = fused_conv.piece_count(k, c_in, c_out)
    with torch.no_grad():
        ref = torch.cat([plain(h[i:i + step], x_src[i:i + step], w3, b3)
                         for i in range(0, e, step)])
        before = b5.launches
        got = pallas_mp.fused_edge_messages_cuda(h, x_src, w3, b3)
        counted = b5.launches - before
        again = pallas_mp.fused_edge_messages_cuda(h, x_src, w3, b3)
        image = pallas_mp.stage_image_cuda(w3, b3, c_in)
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        rel = abs_err / ref.abs().max().item()
        same = torch.equal(got, again)
        image_ok = torch.equal(
            image.view(torch.int16),
            pallas_mp.piece_images(pallas_mp.stage_image, w3, b3,
                                   c_in).view(torch.int16))
        del ref, got, again, image
    torch.cuda.empty_cache()
    log("messages", model=label, edges=e, k=k, c_in=c_in, c_out=c_out,
        design=pallas_mp.design(),
        chunks=fused_conv.f32_chunks(c_out, c_in)[0],
        slices=dp // sd, pieces=pieces,
        max_abs_err=f"{abs_err:.3e}", rel_to_max=f"{rel:.3e}", tol=MSG_TOL,
        bit_identical=same, stage_image_exact=image_ok, counted=counted)
    if not (rel <= MSG_TOL and same and image_ok and counted == pieces):
        raise AssertionError(f"B5 at {label}: {rel:.3e} (tol {MSG_TOL}), "
                             f"repeat identical {same}, stage image exact "
                             f"{image_ok}, launches counted {counted}")
    return abs_err


def messages_slice(msg: tuple, k: int, c_in: int, c_out: int,
                   edges: int = MSG_SLICE) -> tuple:
    """B5's operands on the leading ``edges`` edges of the chunk ``msg``
    (h, x_src, w3, b3): its own at its widths, else seeded ones of (K,
    c_in, c_out) (b3 scaled so that a message stays of order one)."""
    h, x_src, w3, b3 = msg
    if (k, c_in, c_out) == (h.shape[1], x_src.shape[1],
                            w3.shape[1] // x_src.shape[1]):
        return h[:edges], x_src[:edges], w3, b3
    gen = torch.Generator().manual_seed(SEED + k + 3 * c_in + 7 * c_out)
    scale = (k * c_in) ** -0.5
    ops = (torch.relu(torch.randn(edges, k, generator=gen)),
           torch.randn(edges, c_in, generator=gen),
           torch.randn(k, c_in * c_out, generator=gen) * scale,
           torch.randn(c_in * c_out, generator=gen) * scale)
    return tuple(t.to(h.device).contiguous() for t in ops)


def phase_messages(ops: dict, smi, sliced: tuple = ()) -> dict:
    """B5 against its plain version on the card at each chunk shape of
    ``ops`` (label -> (h, x_src, w3, b3): every edge of the full-size
    chunk, padding included; ``check_messages``), then the CUDA-event
    medians of B5, of its plain version and of one PyTorch call computing
    the same function, and B5's bound.  For the labels in ``sliced``
    (widths 128 and 256) the plain reference is computed ``MSG_SLICE``
    edges at a time, and the plain version and the PyTorch call are timed
    on the chunk's first ``MSG_SLICE`` edges, the kernel's time there
    beside them (``plain_edges``, ``ms_at_plain_edges``).  B5's time is
    the median of 20 launches, past width 128 of ``WIDER_REPS``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    plain = pallas_mp.fused_edge_messages_plain
    out = {}
    for label, (h, x_src, w3, b3) in ops.items():
        e, k = h.shape
        c_in = x_src.shape[1]
        c_out = w3.shape[1] // c_in
        step = MSG_SLICE if label in sliced else e
        abs_err = check_messages(label, h, x_src, w3, b3, step)
        warm, plain_reps = timing_reps(20 if c_in <= WIDE else WIDER_REPS)
        with torch.no_grad():
            t = {"ms": cuda_ms(lambda: pallas_mp.fused_edge_messages_cuda(
                h, x_src, w3, b3), reps=20 if c_in <= WIDE else WIDER_REPS,
                warm=warm)}
            # the plain version and the library yardstick, one einsum over
            # [h, 1] and [w3; b3] prepared outside the timed window (float32,
            # TF32 off), on the first `step` edges
            hp, xp = h[:step], x_src[:step]
            h1 = torch.cat([hp, torch.ones_like(hp[:, :1])], 1)
            w3_aug = torch.cat([w3, b3[None]]).reshape(k + 1, c_in, c_out)
            t.update(plain_ms=cuda_ms(lambda: plain(hp, xp, w3, b3),
                                      reps=plain_reps, warm=warm),
                     library_ms=cuda_ms(lambda: torch.einsum(
                         "ek,ei,kio->eo", h1, xp, w3_aug), reps=plain_reps,
                         warm=warm))
            if step < e:
                t.update(plain_edges=step, ms_at_plain_edges=cuda_ms(
                    lambda: pallas_mp.fused_edge_messages_cuda(hp, xp, w3,
                                                               b3)))
            del h1, w3_aug
        torch.cuda.empty_cache()
        # bound: every edge's (K+1) c_in c_out multiply-adds, float32-exact:
        # the lesser of float32 FMAs at their peak and six bf16 passes (the
        # split products) on the tensor cores, against h, x_src, w3, b3 read
        # once and the messages written once
        flops = 2 * e * (k + 1) * c_in * c_out
        nbytes = 4 * (e * k + e * c_in + w3.numel() + b3.numel() + e * c_out)
        t.update(bound(flops, nbytes, "float32", split=True),
                 max_abs_err=abs_err, k=k, c_in=c_in, c_out=c_out)
        log_times("messages", f"b5_{label}_k{k}", t, smi)
        out[label] = t
    return out


def phase_messages_checked(msg: tuple, shapes=MSG_CHECKED) -> dict:
    """B5 alone at each (K, c_in, c_out) of ``shapes`` on the leading
    ``MSG_SLICE`` edges of the chunk ``msg`` (fewer where the plain
    version's [E, c_in c_out] float32 array would pass ``PLAIN_BYTES``;
    ``messages_slice``, ``check_messages``); returns each shape's largest
    absolute error."""
    errs = {}
    for k, c_in, c_out in shapes:
        at = f"slice_k{k}_{c_in}x{c_out}"
        edges = min(MSG_SLICE, PLAIN_BYTES // (4 * c_in * c_out))
        errs[at] = check_messages(
            at, *messages_slice(msg, k, c_in, c_out, edges), edges)
        torch.cuda.empty_cache()
    return errs


def routing(cfg: dict) -> dict:
    """The routed path's encoder and classifier, built as the CLI builds
    them for ``--encoder=pca --classifier=kmeans`` from the exp config."""
    return dict(encoder=init_encoder("pca", **cfg),
                classifier=init_classifier("kmeans", **cfg))


def expert_batches(subset_size: int, batch_size: int) -> tuple:
    """(train, val) batches per epoch ``PartitionScheduler.train`` gives an
    expert of ``subset_size`` subdomains (seed 0): none for an expert with
    nothing to train on, which saves its initial weights."""
    tr, va = train_val_split(subset_size, 0.2, 0)
    if len(va) == 0:
        va = tr[-1:]
    if len(tr) == 0:
        return 0, 0
    bs = max(1, min(batch_size, len(tr)))
    return -(-len(tr) // bs), -(-len(va) // bs)


def phase_routed_train(root: str, ds, cfg: dict) -> dict:
    """Routed training end to end: ``train_graph_ALDD`` with ``n_clusters``
    experts routed by PCA + k-means on the full-size meshes (exp
    ``routed``): partition sizes, each expert's losses (finite, and falling
    for an expert with at least 4 train subdomains), B2 launched depth x
    steps summed over the experts and B1 depth x (steps + validations),
    every checkpoint and the routing state written."""
    log_dir = os.path.join(root, "logs")
    depth, n = cfg["num_layers"], cfg["n_clusters"]
    epochs = cfg["train_epochs"]
    train_cfg = load_yaml(cfg["train_config"])
    train_cfg.update(epochs=epochs, val_interval=1)
    fwd, bwd_k = FWD[False][0], BWD[False][0]
    reset_launches()
    t0 = time.time()
    sched = train_graph_ALDD("routed", make_model(cfg), ds, n, train_cfg,
                             log_dir=log_dir, **routing(cfg))
    torch.cuda.synchronize()
    wall = time.time() - t0
    n_fwd, n_bwd = fwd.launches, bwd_k.launches
    sizes = [len(sub) for sub in sched.subset_indices]
    per = [expert_batches(size, train_cfg["batch_size"]) for size in sizes]
    steps = epochs * sum(s for s, _ in per)
    evals = epochs * sum(v for _, v in per)
    log("routed_train", config=os.path.relpath(ROUTED_CONFIG, REPO),
        n_clusters=n, n_components=cfg["n_components"],
        encoder="pca", classifier="kmeans",
        partitions=",".join(map(str, sizes)), epochs=epochs, steps=steps,
        val_evals=evals, fwd_launches=n_fwd, bwd_launches=n_bwd,
        wall_s=f"{wall:.1f}")
    coll = os.path.join(log_dir, "models", "collection_routed")
    for i, size in enumerate(sizes):
        n_train = len(train_val_split(size, 0.2, 0)[0])
        if not os.path.exists(os.path.join(coll, f"partition_{i}.npz")):
            raise AssertionError(f"expert {i}: no checkpoint")
        if n_train == 0:
            log("routed_train", expert=i, subdomains=size, trained=False)
            continue
        with open(os.path.join(log_dir, "metrics",
                               f"routed_partition_{i}.jsonl")) as f:
            records = [json.loads(line) for line in f]
        losses = [r["train_loss"] for r in records if "train_loss" in r]
        vals = [r["val_loss"] for r in records if "val_loss" in r]
        log("routed_train", expert=i, subdomains=size, train=n_train,
            losses=",".join(f"{v:.5g}" for v in losses),
            val_losses=",".join(f"{v:.5g}" for v in vals))
        if len(losses) != epochs or not np.all(np.isfinite(losses + vals)):
            raise AssertionError(f"expert {i}: losses {losses}, val {vals}")
        if n_train >= 4 and not losses[-1] < losses[0]:
            raise AssertionError(f"expert {i}: loss did not fall: {losses}")
    for f in ("pca_encoder.npz", "kmeans_classifier.npz", "kmeans_scaler.npz"):
        if not os.path.exists(os.path.join(coll, f)):
            raise AssertionError(f"routing state {f} was not written")
    check_only("routed_train", {fwd: depth * (steps + evals),
                                bwd_k: depth * steps})
    return dict(fwd=n_fwd, bwd=n_bwd, steps=steps, evals=evals,
                subsets=sched.subset_indices)


def phase_routed_serve(root: str, datasets: dict, cfgs: dict) -> dict:
    """Routed serving from the trained experts: both full-size meshes (over
    the edge budget, so the routed predict: label groups cut into chunks,
    B1 launched depth x sum_k ceil(n_k / chunk_b) times); full mesh 0 again
    with a budget of one subdomain less than its largest label group
    (``full_padded``: every such group's tail chunk is padded by
    repetition) and with a budget that holds the whole request
    (``full_lane``: the routed lane, which must serve at least two label
    groups, B1 launched depth x groups times); and the small mesh (the
    routed lane).  Labels on the card equal the CPU's; each mesh-0 request
    on the card is held against the port's float32 plain one on the CPU
    from the same checkpoints."""
    log_dir = os.path.join(root, "logs")
    cfg = cfgs["full"]
    depth, n = cfg["num_layers"], cfg["n_clusters"]
    fwd = FWD[False][0]
    cases = [("full", "full", idx, None) for idx in cfg["idxs"]] + [
        ("full_padded", "full", 0, "padded"),
        ("full_lane", "full", 0, "lane"), ("small", "small", 0, None)]
    launches = {case: 0 for case, _, _, _ in cases}
    card = []
    for case, name, idx, budget_for in cases:
        ds = datasets[name]
        scheds = {dev: PartitionScheduler(
            "routed", n, ds, make_model(cfg), train=False, log_dir=log_dir,
            device=dev, **routing(cfg)) for dev in (None, "cpu")}
        x = ds.get_one_full_sample(idx)
        labels = scheds[None]._route(x)
        if not np.array_equal(labels, scheds["cpu"]._route(x)):
            raise AssertionError(f"routed {case} {idx}: card labels differ "
                                 "from the CPU's")
        counts = np.bincount(labels, minlength=n)
        b, _, e_pad = scheds[None]._request_shape(
            [_as_raw_graph(d) for d in x])
        budget = {None: None, "padded": (counts.max() - 1) * e_pad,
                  "lane": b * e_pad}[budget_for]
        with env_set("FESR_PREDICT_EDGE_BUDGET", budget):
            chunk_b = max(1, min(b, edge_budget() // e_pad))
            if b * e_pad > edge_budget():
                # routed predict: chunks of each label group
                lane, want = "general", depth * sum(-(-c // chunk_b)
                                                    for c in counts)
            else:  # routed lane: one launch per label group and layer
                lane, want = "routed", depth * np.count_nonzero(counts)
            if budget_for == "padded" and not np.any(counts % chunk_b):
                raise AssertionError(f"routed {case}: no label group pads "
                                     f"its tail chunk ({counts}, {chunk_b})")
            if budget_for == "lane" and np.count_nonzero(counts) < 2:
                raise AssertionError(f"routed {case}: one label group only")
            reset_launches()
            t0 = time.time()
            lanes, (f,) = serve(ds, make_model(cfg), [idx], log_dir,
                                "routed", None, n, **routing(cfg))
            torch.cuda.synchronize()
            got = fwd.launches
        log("routed_serve", mesh=name, case=case, idx=idx, lane=lanes[0][1],
            reason=repr(lanes[0][2]), labels=",".join(map(str, labels)),
            chunk_b=chunk_b, launches=got, expected=want,
            nodes=len(f["pressure"]), cold_s=f"{time.time() - t0:.3f}")
        if lanes[0][1] != lane:
            raise AssertionError(f"routed {case} took lane {lanes[0][1]}")
        check_only(f"routed_serve {case} request", {fwd: want})
        launches[case] += got
        if idx == 0:
            card.append((case, name, f))
    refs = {}
    for case, name, f in card:
        t0 = time.time()
        if name not in refs:
            refs[name] = serve(datasets[name], make_model(cfg), [0], log_dir,
                               "routed", "cpu", n, gemm_dtype="float32",
                               **routing(cfg))[1][0]
        for key in ("velocity", "pressure"):
            r, g = refs[name][key], f[key]
            rel = np.abs(g - r).max() / np.abs(r).max()
            log("routed_serve", mesh=name, case=case, field=key,
                vs_cpu_f32=f"{rel:.3e}", tol=SERVE_TOL,
                cpu_s=f"{time.time() - t0:.1f}")
            if not rel <= SERVE_TOL:
                raise AssertionError(f"routed {case} {key}: {rel:.3e}")
    return launches


def phase_routed_times(root: str, datasets: dict, cfgs: dict, smi) -> dict:
    """Warm wall times of a routed full-size request (predict + host
    overlap average) and of a routed-lane request on the small mesh
    (``predict_full``), each with one profile."""
    log_dir = os.path.join(root, "logs")
    cfg = cfgs["full"]
    ms, request = warm_request(datasets["full"], make_model(cfg), log_dir,
                               "routed", cfg["n_clusters"], **routing(cfg))
    t = {"request_ms": ms}
    t.update(profile_call(request, "routed_request"))
    log_times("routed_times", "request", t, smi)
    ds = datasets["small"]
    sched = PartitionScheduler("routed", cfg["n_clusters"], ds,
                               make_model(cfg), train=False, log_dir=log_dir,
                               **routing(cfg))
    x = ds.get_one_full_sample(0)
    num_nodes = len(ds.full_mesh(0)["points"])

    def lane_request():
        return sched.predict_full(x, num_nodes)

    lt = {"routed_lane_ms": warm_ms(lane_request)}
    if sched.last_lane[0] != "routed":
        raise AssertionError(f"small mesh took lane {sched.last_lane}")
    lt.update({f"routed_lane_{k}": v for k, v in
               profile_call(lane_request, "routed_lane_request").items()})
    log_times("routed_times", "routed_lane", lt, smi)
    return {**t, **lt}


def run_routed(root, smi, datasets, cfgs) -> dict:
    """The routed path: training, serving, B1 and B2 against their plain
    versions on a routed chunk's operands (the largest label group of full
    mesh 0, as the routed predict cuts it) and on the largest expert's
    train and val batches, and times.  Returns what the kernels' JSON
    entries need."""
    t0 = time.time()
    cfg = cfgs["full"]
    train = phase_routed_train(root, datasets["full"], cfg)
    serve_launches = phase_routed_serve(root, datasets, cfgs)
    sched = PartitionScheduler("routed", cfg["n_clusters"], datasets["full"],
                               make_model(cfg), train=False,
                               log_dir=os.path.join(root, "logs"),
                               **routing(cfg))
    labels = sched._route(datasets["full"].get_one_full_sample(0))
    k = int(np.bincount(labels).argmax())
    raw = [_as_raw_graph(d) for d in datasets["full"].get_one_full_sample(0)]
    chunk_b = max(1, edge_budget() // sched._request_shape(raw)[2])
    idx = np.flatnonzero(labels == k)[:chunk_b]
    idx = np.concatenate([idx, np.repeat(idx[-1:], chunk_b - len(idx))])
    op = dict(chunk_operands(datasets["full"], sched.experts[k], "cuda", idx),
              tag="routed_", msg=None)
    errs = phase_kernel(op, "routed_chunk")
    bop = bwd_operands(op)
    errs_bwd = check_bwd(bop, "routed_chunk")
    largest = max(train["subsets"], key=len)
    batches = train_batches(datasets["full"], cfg, largest)
    phase_train_kernels(batches, errs, errs_bwd, "routed_")
    t = fwd_times(op, smi)
    t.update(phase_routed_times(root, datasets, cfgs, smi))
    tb = phase_bwd_times(bop, smi)
    t.update(phase_train_times(batches, cfg, smi, "routed_"))
    del op, bop, batches
    torch.cuda.empty_cache()
    log("routed_path", depth=cfg["num_layers"], expert=k,
        chunk=",".join(map(str, idx)), wall_s=f"{time.time() - t0:.1f}")
    return dict(errs=errs, errs_bwd=errs_bwd, serve=serve_launches,
                train=train, t=t, tb=tb)


def phase_coalesced(root: str, ds, model, smi) -> dict:
    """The coalesced lane on the small mesh: R seeded payloads on one
    geometry through ``predict_full_batch`` (B1 launched R x depth times),
    each against its own ``predict_full``; the warm wall time of the batch
    against R single requests, each with one profile."""
    sched = PartitionScheduler("small", 1, ds, model, train=False,
                               log_dir=os.path.join(root, "logs"))
    x = ds.get_one_full_sample(0)
    num_nodes = len(ds.full_mesh(0)["points"])
    rng = np.random.default_rng(SEED)
    reqs = [[dict(d, x=np.asarray(d["x"]) * rng.uniform(0.5, 1.5),
                  y=np.asarray(d["y"]) * rng.uniform(0.5, 1.5)) for d in x]
            for _ in range(COALESCED_R)]
    depth = model.depth
    reset_launches()
    got = sched.predict_full_batch(reqs, num_nodes)
    torch.cuda.synchronize()
    launches = FWD[False][0].launches
    log("coalesced", requests=COALESCED_R, lane=sched.last_lane[0],
        reason=repr(sched.last_lane[1]), launches=launches,
        nodes=num_nodes)
    if sched.last_lane[0] != "coalesced" or got is None:
        raise AssertionError(f"coalesced lane not taken: {sched.last_lane}")
    check_only("coalesced", {FWD[False][0]: COALESCED_R * depth})
    for i, (pred, ref) in enumerate(got):
        one_pred, one_ref = sched.predict_full(reqs[i], num_nodes)
        rel = max(np.abs(pred - one_pred).max() / np.abs(one_pred).max(),
                  np.abs(ref - one_ref).max() / np.abs(one_ref).max())
        log("coalesced", request=i, vs_predict_full=f"{rel:.3e}",
            tol=COALESCED_TOL, finite=bool(np.isfinite(pred).all()))
        if not (rel <= COALESCED_TOL and np.isfinite(pred).all()):
            raise AssertionError(f"coalesced request {i}: {rel:.3e}")

    def batch():
        return sched.predict_full_batch(reqs, num_nodes)

    def singles():
        return [sched.predict_full(r, num_nodes) for r in reqs]

    t = {"batch_ms": warm_ms(batch), "singles_ms": warm_ms(singles)}
    t.update({f"batch_{k}": v for k, v in
              profile_call(batch, "coalesced_batch").items()})
    t.update({f"singles_{k}": v for k, v in
              profile_call(singles, "coalesced_singles").items()})
    log_times("coalesced_times", f"r{COALESCED_R}", t, smi)
    return dict(launches=launches, t=t)


# -- physics post-passes, powerseries and 'lut' (phases 12-18) -------------
CARD = torch.device("cuda")
PHYS_FULL = (48, 24, 24)    # the full mesh's duct: 27 648 nodes
PHYS_SMALL = (16, 8, 8)     # the small mesh's: 1 024 nodes
# benchmarks/projection_scale.py's 4:1:1 proportions, cut from the
# reference's 500k-1M nodes to fit the script's time limit: 97 556 nodes
PHYS_SCALE = (116, 29, 29)
PHYS_OP_TOL = 1e-5       # one float32 operator, card vs CPU, other sum orders
PHYS_CGNR_TOL = 5e-3     # 20 CGNR iterations (tests/test_torch_physics.py)
# the whole outer loop, card vs CPU: the tolerance the JAX package holds its
# two loops to (tests/test_physics.py), final norm rtol and field / max
PHYS_LOOP_RTOL = 2e-2
VCYCLE_TOL = 1e-4        # one V-cycle: ~10 float32 operator passes
WSS_TOL = 1e-5           # of the magnitude's max
GENERAL_TOL = 1e-4       # float32 general-lane request, card vs CPU
BF16_GENERAL_TOL = 5e-3  # bf16 per-edge matrices: a last-bit f32 difference
#                          can flip one bf16 rounding (2^-8 of that entry)


def noisy_duct(shape, seed: int = 0):
    """(mesh, edges, velocity, pressure): the analytic duct field plus
    noise 0.05 from ``seed``, as benchmarks/projection_scale.py builds it."""
    mesh = make_duct_mesh(*shape)
    v, p = duct_field(mesh.points)
    rng = np.random.default_rng(seed)
    v = v + 0.05 * rng.normal(size=v.shape).astype(np.float32)
    return mesh, cells_to_edges(mesh.cells), v, p[:, 0]


def rel_err(got, ref) -> float:
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = ref.detach().cpu().numpy() if torch.is_tensor(ref) else np.asarray(ref)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def hold(phase: str, what: str, got, ref, tol: float, **extra) -> float:
    """Logs ``got`` against ``ref`` relative to ref's max and raises past
    ``tol``."""
    err = rel_err(got, ref)
    log(phase, check=what, rel_err=f"{err:.3e}", tol=tol, **extra)
    if not err <= tol:
        raise AssertionError(f"{phase} {what}: {err:.3e} > {tol}")
    return err


def pair_bound_ms(proj) -> tuple[float, int]:
    """(bound ms, bytes) of one composite pair A^T (A q) on ``proj``'s
    mesh: each array it reads once (nbr int64, mask, the weights [N, 3, K];
    the transposed table's sources int64 and weights [N, KT, 3], the row
    sums [N, 3]; q) and its output written once, at 3.35 TB/s."""
    n, k = proj.nbr.shape
    kt = proj.table[0].shape[1]
    nbytes = n * k * (8 + 1 + 12) + n * kt * (8 + 12) + n * 12 + 2 * n * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def phase_physics_ops(smi) -> dict:
    """Every physics operator on the full mesh, card against the port's CPU
    result (float32, TF32 off): both weight operators (and the nodes on the
    fallback branch), both divergences, the Laplacian, the composite A and
    A^T in both forms, the pressure correction, one CGNR solve at 20
    iterations; the adjoint's dot-product test on the card; the composite
    pair's time against its bound and the masked CG's cost per inner
    iteration."""
    mesh, edges, v, p = noisy_duct(PHYS_FULL)
    t0 = time.time()
    card = DivergenceFreeProjection(mesh.points, edges, v, p, device=CARD)
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    cpu = DivergenceFreeProjection(mesh.points, edges, v, p, device="cpu")
    n, k = card.nbr.shape
    log("physics_ops", nodes=n, edges=len(edges), K=k,
        KT=card.table[0].shape[1], mean_neighbors=f"{cpu.mask.sum(1).float().mean():.2f}",
        setup_s=f"{setup_s:.3f}")
    cuda = CARD
    for faithful, fn in ((True, pdiv.compute_weights),
                         (False, pdiv.compute_gradient_weights)):
        args = (card.points, card.nbr, card.mask)
        cargs = (cpu.points, cpu.nbr, cpu.mask)
        if faithful:
            got, s_card = fn(*args, return_simple=True)
            ref, s_cpu = fn(*cargs, return_simple=True)
            log("physics_ops", simple_nodes_card=int(s_card.sum()),
                simple_nodes_cpu=int(s_cpu.sum()))
            if int(s_card.sum()) != int(s_cpu.sum()):
                raise AssertionError("simple-branch node counts differ")
        else:
            got, ref = fn(*args), fn(*cargs)
        hold("physics_ops", f"weights_faithful={faithful}", got, ref,
             PHYS_OP_TOL)
    # the operators on the same (the CPU's) weights on both sides
    for faithful in (True, False):
        w = (pdiv.compute_weights if faithful else pdiv.compute_gradient_weights)(
            cpu.points, cpu.nbr, cpu.mask)
        sides = {"cpu": (cpu.nbr, cpu.mask, w, cpu.table),
                 "card": (card.nbr, card.mask, w.to(cuda), card.table)}
        vel = {"cpu": cpu.velocity, "card": card.velocity}
        q = torch.as_tensor(np.random.default_rng(1).standard_normal(n)
                            .astype(np.float32))
        qs = {"cpu": q, "card": q.to(cuda)}
        out = {}
        for side, (nbr, mask, ws, table) in sides.items():
            mv, gf = pdiv.make_consistent_matvec(nbr, mask, ws,
                                                 trace=not faithful)
            rmv = pdiv.make_consistent_rmatvec(nbr, mask, ws, table,
                                               trace=not faithful)
            lw = pdiv.laplacian_weights(ws, mask)
            lmv, diag = pdiv.make_laplacian_matvec(nbr, mask, lw)
            out[side] = {
                "divergence": pdiv.compute_divergence(vel[side], nbr, mask, ws),
                "divergence_trace": pdiv.compute_divergence_trace(
                    vel[side], nbr, mask, ws),
                "laplacian": lmv(qs[side]), "laplacian_diag": diag,
                "composite": mv(qs[side]), "grad_field": gf(qs[side]),
                "adjoint": rmv(qs[side]),
                "pressure_correction": pdiv.apply_pressure_correction(
                    vel[side], qs[side], nbr, mask, ws, alpha=0.7)}
        for key in out["cpu"]:
            hold("physics_ops", f"{key}_faithful={faithful}", out["card"][key],
                 out["cpu"][key], PHYS_OP_TOL)
        # <y, A q> = <A^T y, q> on the card in float64
        w64 = w.double().to(cuda)
        mv, _ = pdiv.make_consistent_matvec(card.nbr, card.mask, w64,
                                            trace=not faithful)
        rmv = pdiv.make_consistent_rmatvec(card.nbr, card.mask, w64,
                                           card.table, trace=not faithful)
        y = torch.as_tensor(np.random.default_rng(2).standard_normal(n),
                            device=cuda)
        x = q.double().to(cuda)
        lhs, rhs = float(y @ mv(x)), float(rmv(y) @ x)
        gap = abs(lhs - rhs) / max(abs(lhs), 1.0)
        log("physics_ops", check=f"dot_product_faithful={faithful}",
            lhs=f"{lhs:.12e}", rhs=f"{rhs:.12e}", rel_gap=f"{gap:.2e}",
            tol=1e-10)
        if not gap <= 1e-10:
            raise AssertionError(f"adjoint dot-product test: {gap:.2e}")
    # one CGNR solve, each side on its own weights
    p_card = card.solve_pressure_poisson(card.calculate_divergence(),
                                         tol=1e-5, maxiter=20)
    p_cpu = cpu.solve_pressure_poisson(cpu.calculate_divergence(),
                                       tol=1e-5, maxiter=20)
    hold("physics_ops", "cgnr_maxiter=20", p_card, p_cpu, PHYS_CGNR_TOL,
         iterations=card.cg_iterations[-1])
    # the unit of cost of every inner iteration: A q then A^T y
    q = torch.randn(n, generator=torch.Generator().manual_seed(0)).to(cuda)
    pair_ms = cuda_ms(lambda: card.normal_matvec(q))
    bound_ms, nbytes = pair_bound_ms(card)
    div = card.calculate_divergence()
    per_iter = {}
    for every in (1, pproj.CHECK_EVERY):
        def solve():
            return pproj.cg(card.normal_matvec,
                            card.consistent_rmatvec(div), tol=1e-30,
                            maxiter=200, check_every=every)
        per_iter[every] = warm_ms(solve, reps=3) / 200
    log("physics_ops", pair_ms=f"{pair_ms:.4f}", pair_bound_ms=f"{bound_ms:.5f}",
        pair_bytes=nbytes, bound_by="bytes",
        cg_iter_ms_check_every_1=f"{per_iter[1]:.4f}",
        **{f"cg_iter_ms_check_every_{pproj.CHECK_EVERY}":
           f"{per_iter[pproj.CHECK_EVERY]:.4f}"}, card=repr(smi))
    return {"pair_ms": pair_ms, "pair_bound_ms": bound_ms,
            "cg_iter_ms": per_iter[pproj.CHECK_EVERY]}


class _Tee:
    """Writes to the real stdout and keeps a copy of the text."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _printed(text: str, prefix: str) -> list[str]:
    return [ln[len(prefix):].strip() for ln in text.splitlines()
            if ln.startswith(prefix)]


def phase_physics_smooth(root: str, datasets: dict, models: dict,
                         cfgs: dict, smi) -> int:
    """``pred_graph_ALDD(smooth=True)`` on both full meshes from the serve
    phase's KernelNN checkpoint (general lane, B1 8 times each): the
    projection's initial and final divergence and wall time; the .vtu
    velocity finite and moved off the unsmoothed prediction.  Two
    projections of one field on the card give the same bits, and on the
    small mesh the card's whole loop (host and device) agrees with the
    CPU's.  Returns B1's launches in the smoothed requests."""
    log_dir = os.path.join(root, "logs")
    launches = 0
    for idx in cfgs["full"]["idxs"]:
        _, (plain,) = serve(datasets["full"], models["full"], [idx], log_dir,
                            "full", None)
        reset_launches()
        tee = _Tee(sys.stdout)
        t0 = time.time()
        with contextlib.redirect_stdout(tee):
            lanes, (fields,) = serve(datasets["full"], models["full"], [idx],
                                     log_dir, "full", None, smooth=True)
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = fused_conv.fused_edge_conv.launches
        check_only(f"smooth request {idx}",
                   {fused_conv.fused_edge_conv: CHUNKS["full"]
                    * cfgs["full"]["num_layers"]})
        launches += got
        text = "".join(tee.parts)
        init = float(_printed(text, "Initial divergence:")[0])
        final_s, _, iters = _printed(text, "Final divergence:")[0].partition(" in ")
        final = float(final_s)
        smooth_s = float(_printed(text, "Smoothing time:")[0])
        moved = float(np.abs(fields["velocity"] - plain["velocity"]).max())
        log("physics_smooth", mesh="full", idx=idx, lane=lanes[0][1],
            b1_launches=got, initial=f"{init:.6f}", final=f"{final:.6f}",
            ratio=f"{init / max(final, 1e-30):.3f}", iterations=iters,
            smooth_s=f"{smooth_s:.3f}", request_s=f"{wall:.3f}",
            max_velocity_change=f"{moved:.4e}", card=repr(smi))
        if not final < init:
            raise AssertionError(f"smooth {idx}: final {final} >= initial {init}")
        if not (np.isfinite(fields["velocity"]).all() and moved > 0):
            raise AssertionError(f"smooth {idx}: velocity not finite or unmoved")
        if idx == 0:
            first = plain
    # two projections of one field on the card: the same bits
    full = datasets["full"].full_mesh(0)
    edges = cells_to_edges(full["cells"])
    runs = []
    for _ in range(2):
        proj = DivergenceFreeProjection(full["points"], edges,
                                        first["velocity"], first["pressure"],
                                        device=CARD)
        t0 = time.time()
        v, pr, final, _ = proj.apply_divergence_free_projection(
            max_iterations=20, tolerance=1e-2)
        torch.cuda.synchronize()
        runs.append((v.cpu().numpy(), pr.cpu().numpy(), final,
                     time.time() - t0, proj))
    same = all(np.array_equal(a, b) for a, b in zip(runs[0][:2], runs[1][:2]))
    proj = runs[0][4]
    log("physics_smooth", check="repeat_bits", identical=same,
        final=f"{runs[0][2]:.6f}", pair_calls=proj.pair_calls,
        inner_iterations=sum(proj.cg_iterations),
        outer_iterations=len(proj.cg_iterations),
        wall_s=f"{runs[0][3]:.3f},{runs[1][3]:.3f}")
    if not same:
        raise AssertionError("two projections of one field differ on the card")
    # the small mesh: the card's whole loop against the CPU's
    mesh, edges, v, p = noisy_duct(PHYS_SMALL)
    for loop in ("host", "device"):
        res = {}
        for dev in (CARD, "cpu"):
            proj = DivergenceFreeProjection(mesh.points, edges, v, p,
                                            device=dev)
            if loop == "host":
                vel, _, final, _ = proj.apply_divergence_free_projection(
                    max_iterations=20, tolerance=1e-2)
            else:
                vel, _, final, _ = proj.apply_divergence_free_projection_device(
                    max_iterations=20, tolerance=1e-2)
            res[dev] = (vel, final)
        rel = abs(res[CARD][1] - res["cpu"][1]) / res["cpu"][1]
        log("physics_smooth", mesh="small", loop=loop,
            final_card=f"{res[CARD][1]:.6f}", final_cpu=f"{res['cpu'][1]:.6f}",
            final_rel=f"{rel:.3e}", tol=PHYS_LOOP_RTOL)
        if not rel <= PHYS_LOOP_RTOL:
            raise AssertionError(f"small {loop} loop: final norms {rel:.3e}")
        hold("physics_smooth", f"small_{loop}_velocity", res[CARD][0],
             res["cpu"][0], PHYS_LOOP_RTOL)
    return launches


def phase_physics_amg(smi) -> None:
    """The AMG hierarchy on the full mesh: its host build's seconds and
    level sizes, one V-cycle on the card against the CPU on the same
    hierarchy and weights, and the device loop with ``precond='amg'``
    against ``'none'`` on the same noisy field."""
    mesh, edges, v, p = noisy_duct(PHYS_FULL)
    proj = DivergenceFreeProjection(mesh.points, edges, v, p, device=CARD)
    nbr, mask = proj.nbr.cpu().numpy(), proj.mask.cpu().numpy()
    w = proj.weights.cpu().numpy()
    t0 = time.time()
    N = pamg.assemble_normal(nbr, mask, w, a_drop=0.0)
    levels, cinv = pamg.build_hierarchy(N, implicit_level0=True)
    build_s = time.time() - t0
    log("physics_amg", nodes=len(nbr), normal_nnz=N.nnz,
        normal_nnz_per_row=f"{N.nnz / len(nbr):.1f}",
        levels=[lv["n"] for lv in levels] + [len(cinv)],
        host_build_s=f"{build_s:.2f}")
    r = np.random.default_rng(3).standard_normal(len(nbr)).astype(np.float32)
    out = {}
    for dev in (CARD, "cpu"):
        t = (lambda a, dev=dev: a.to(dev))
        mv, _ = pdiv.make_consistent_matvec(t(proj.nbr), t(proj.mask),
                                            t(proj.weights))
        rmv = pdiv.make_consistent_rmatvec(t(proj.nbr), t(proj.mask),
                                           t(proj.weights),
                                           [t(a) for a in proj.table])
        lv, ci = pamg.levels_from_arrays(levels, cinv, dev)
        vc = pamg.make_vcycle(lv, ci, cheb_degree=3, smooth_band=16.0,
                              matvec0=lambda q, mv=mv, rmv=rmv: rmv(mv(q)))
        rt = torch.as_tensor(r, device=dev)
        out[dev] = vc(rt)
        if dev == CARD:
            vcycle_ms = cuda_ms(lambda: vc(rt))
    hold("physics_amg", "vcycle", out[CARD], out["cpu"], VCYCLE_TOL,
         vcycle_ms=f"{vcycle_ms:.4f}", card=repr(smi))
    for precond in ("none", "amg"):
        proj = DivergenceFreeProjection(mesh.points, edges, v, p, device=CARD)
        init = float(torch.linalg.vector_norm(proj.calculate_divergence()))
        t0 = time.time()
        _, _, final, it = proj.apply_divergence_free_projection_device(
            max_iterations=20, tolerance=1e-2, cg_maxiter=200, precond=precond)
        torch.cuda.synchronize()
        log("physics_amg", precond=precond, initial=f"{init:.6f}",
            final=f"{final:.6f}", ratio=f"{init / max(final, 1e-30):.3f}",
            outer=it, inner=sum(proj.cg_iterations),
            pair_calls=proj.pair_calls, wall_s=f"{time.time() - t0:.3f}")
        if not final < init:
            raise AssertionError(f"amg phase {precond}: no reduction")


def phase_physics_scale(smi, max_iterations: int = 20) -> None:
    """The device loop at 97 556 nodes (benchmarks/projection_scale.py's
    field): setup seconds, then plain CGNR and ``precond='amg'``: the
    ratio, outer and inner iterations, wall seconds, and the composite
    pair's time against its bound."""
    t0 = time.time()
    mesh, edges, v, p = noisy_duct(PHYS_SCALE)
    mesh_s = time.time() - t0
    for precond in ("none", "amg"):
        t0 = time.time()
        proj = DivergenceFreeProjection(mesh.points, edges, v, p, device=CARD)
        init = float(torch.linalg.vector_norm(proj.calculate_divergence()))
        setup_s = time.time() - t0
        amg_s = 0.0
        if precond == "amg":
            t0 = time.time()
            proj._amg_preconditioner()
            amg_s = time.time() - t0
        t0 = time.time()
        _, _, final, it = proj.apply_divergence_free_projection_device(
            max_iterations=max_iterations, tolerance=1e-2, cg_maxiter=200,
            precond=precond)
        torch.cuda.synchronize()
        wall = time.time() - t0
        q = torch.randn(len(mesh.points)).to(CARD)
        pair_ms = cuda_ms(lambda: proj.normal_matvec(q))
        bound_ms, nbytes = pair_bound_ms(proj)
        log("physics_scale", precond=precond, nodes=len(mesh.points),
            edges=len(edges), K=proj.nbr.shape[1], mesh_s=f"{mesh_s:.2f}",
            setup_s=f"{setup_s:.2f}", amg_build_s=f"{amg_s:.2f}",
            amg_levels=proj.amg_sizes, initial=f"{init:.4f}",
            final=f"{final:.4f}", ratio=f"{init / max(final, 1e-30):.3f}",
            outer=it, inner=sum(proj.cg_iterations),
            max_outer=max_iterations, wall_s=f"{wall:.3f}",
            pair_ms=f"{pair_ms:.4f}", pair_bound_ms=f"{bound_ms:.5f}",
            pair_bytes=nbytes, card=repr(smi))
        if not final < init:
            raise AssertionError(f"scale {precond}: no reduction")


def _read_vtp(path: str) -> dict:
    """PointData arrays of a .vtp written by ``write_vtp_polydata``."""
    import xml.etree.ElementTree as ET

    from fast_eng_super_resolution_tpu_torch.data.vtu import _decode_data_array

    piece = ET.parse(path).getroot().find(".//Piece")
    return {el.get("Name"): _decode_data_array(el)
            for el in piece.find("PointData").findall("DataArray")}


def phase_wss(root: str, smi) -> None:
    """``python -m fast_eng_super_resolution_tpu_torch.compute_wss`` on the
    first smoothed full-mesh .vtu (a subprocess: the entry point itself,
    on the card), each field's .vtp against the port's CPU post-pass; and
    the analytic shear u = (gamma y, 0, 0) on the duct, |tau| = mu gamma on
    the bottom wall (tests/test_physics.py's check)."""
    src = os.path.join(root, "logs", "vtk", "full", "pred_0.vtu")
    work = os.path.join(root, "wss")
    os.makedirs(work, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    run = subprocess.run([sys.executable, "-m",
                          "fast_eng_super_resolution_tpu_torch.compute_wss",
                          "--input", src], cwd=work, env=env,
                         capture_output=True, text=True, timeout=300)
    if run.returncode != 0:
        raise AssertionError(f"compute_wss failed: {run.stderr[-2000:]}")
    log("wss", cli_s=f"{time.time() - t0:.2f}", input=os.path.basename(src))
    grid = read_vtu(src)
    cells = np.asarray(grid["cells"])
    edges = cells_to_edges(cells)
    for field, tag in (("velocity", "pred"),
                       ("interpolated_velocity", "interpolated"),
                       ("ref_velocity", "reference")):
        got = _read_vtp(os.path.join(work, f"wall_shear_stress_results_{tag}.vtp"))
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            _, tau, mag = compute_wall_shear_stress(
                grid["points"], cells, edges, grid["point_data"][field], 1e-3,
                device="cpu")
        scale = float(mag.max())
        err = max(np.abs(got["WallShearStressMagnitude"] - mag).max(),
                  np.abs(got["WallShearStressVector"] - tau).max()) / scale
        log("wss", field=field, surface_points=len(mag),
            max_magnitude=f"{scale:.6e}", card_vs_cpu=f"{err:.3e}", tol=WSS_TOL)
        if not err <= WSS_TOL:
            raise AssertionError(f"wss {field}: {err:.3e} > {WSS_TOL}")
    mesh = make_duct_mesh(10, 6, 6)
    gamma, mu = 2.0, 1e-3
    vel = np.stack([gamma * mesh.points[:, 1], 0 * mesh.points[:, 0],
                    0 * mesh.points[:, 0]], 1).astype(np.float32)
    with contextlib.redirect_stdout(open(os.devnull, "w")):
        ids, _, mag = compute_wall_shear_stress(
            mesh.points, mesh.cells, cells_to_edges(mesh.cells), vel, mu,
            device=CARD)
    pts = mesh.points[ids]
    bottom = (np.isclose(pts[:, 1], 0) & (pts[:, 0] > 0.3) & (pts[:, 0] < 1.7)
              & (pts[:, 2] > 0.15) & (pts[:, 2] < 0.35))
    err = float(np.abs(mag[bottom] / (mu * gamma) - 1).max())
    log("wss", check="analytic_shear", nodes=int(bottom.sum()),
        max_rel_err=f"{err:.3e}", tol=0.15, card=repr(smi))
    if not (bottom.sum() > 0 and err <= 0.15):
        raise AssertionError(f"analytic shear: {err:.3e}")


def general_request(label: str, phase: str, datasets: dict, model, tag: str,
                    root: str, tol: float) -> None:
    """One full-size request of ``model`` from exp ``full{tag}``'s
    checkpoint with FESR_FUSED_PREDICT=0 (general lane, plain ``apply``):
    no kernel launched; then the small mesh's request (exp
    ``small{tag}``) on the card against the CPU's within ``tol``."""
    log_dir = os.path.join(root, "logs")
    with env_set("FESR_FUSED_PREDICT", "0"):
        reset_launches()
        t0 = time.time()
        lanes, (f,) = serve(datasets["full"], model, [0], log_dir,
                            "full" + tag, None)
        torch.cuda.synchronize()
        log(phase, model=label, mesh="full", lane=lanes[0][1],
            reason=repr(lanes[0][2]), nodes=len(f["pressure"]),
            cold_s=f"{time.time() - t0:.3f}", **launches_of(*KERNELS))
        if lanes[0][1] != "general":
            raise AssertionError(f"{label} took lane {lanes[0][1]}")
        check_only(f"{label} request", {})
        _, (card,) = serve(datasets["small"], model, [0], log_dir,
                           "small" + tag, None)
        _, (cpu,) = serve(datasets["small"], model, [0], log_dir,
                          "small" + tag, "cpu")
        for key in ("velocity", "pressure"):
            hold(phase, f"{label}_small_{key}_vs_cpu", card[key], cpu[key], tol)


def phase_powerseries(root: str, datasets: dict, cfg: dict) -> None:
    """TEECNet at teecnet_ansys.yaml's width with the power-series kernel:
    no fused form, so the general lane; seeded checkpoints written for the
    full and small meshes."""
    model = TEECNet(cfg["in_channels"], cfg["width"], cfg["out_channels"],
                    cfg["num_layers"], kernel_type="powerseries", seed=SEED)
    for exp in ("full_ps", "small_ps"):
        ckpt.save_params(os.path.join(root, "logs", "models",
                                      f"collection_{exp}", "partition_0.npz"),
                         model.to_jax_params(), meta={"model": "TEECNet"})
    general_request("teecnet_powerseries", "powerseries", datasets, model,
                    "_ps", root, GENERAL_TOL)


def phase_lut(root: str, datasets: dict, cfg: dict) -> None:
    """KernelNN at full width from the serve phase's checkpoints in mode
    'lut' (512 knots), and with ``kernel_dtype='bfloat16'`` in mode
    'edge3d': both through the general lane's ``apply``."""
    w = cfg["width"]
    kw = dict(in_width=cfg["in_channels"], out_width=cfg["out_channels"],
              seed=SEED)
    general_request("kernelnn_lut", "lut", datasets,
                    KernelNN(w, w, cfg["num_layers"], mode="lut", **kw),
                    "", root, GENERAL_TOL)
    general_request("kernelnn_bf16_edge3d", "lut", datasets,
                    KernelNN(w, w, cfg["num_layers"], mode="edge3d",
                             kernel_dtype="bfloat16", **kw),
                    "", root, BF16_GENERAL_TOL)


# -- the grid family: FNO1d/2d/3d and DeepONet (no hand-written kernel) ----

def _make_grid_data(dataset: str, cfg: dict) -> float:
    """Generates (and caches under ``cfg['root']``) one grid dataset in a
    worker process; returns its seconds."""
    t0 = time.time()
    init_dataset(dataset, **cfg)
    return time.time() - t0


def grid_configs(root: str) -> dict:
    """Per grid path, (exp config, train config): the shipped configs with
    this run's root and sample cut, the recipe cut to GRID_EPOCHS epochs,
    and on the card."""
    out = {}
    for key, g in GRID.items():
        cfg = load_yaml(os.path.join(REPO, "configs", "exp_config", g["exp"]))
        n, k = g["num_samples"], g["train_samples"]
        cfg.update(root=os.path.join(root, "grid", key), num_samples=n,
                   train_samples=k, idxs=[k, (k + n) // 2, n - 1])
        cfg.setdefault("trunk_size", 2)  # as the JAX package's CLI test
        train = load_yaml(os.path.join(REPO, "configs", "train_config",
                                       g["train"]))
        out[key] = (cfg, dict(train, epochs=GRID_EPOCHS))
    return out


def start_data(jobs: dict):
    """Starts the host data generation (numpy, in DATA_WORKERS worker
    processes) so it overlaps the kernel phases; ``jobs``: key ->
    (function, args), each returning its seconds; returns (pool,
    futures)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    pool = cf.ProcessPoolExecutor(DATA_WORKERS,
                                  mp_context=mp.get_context("spawn"))
    return pool, {key: pool.submit(fn, *args)
                  for key, (fn, args) in jobs.items()}


def grid_model(key: str, cfg: dict):
    return init_model(GRID[key]["model"], seed=SEED, **cfg)


def phase_grid_spectral(cfgs: dict) -> dict:
    """One spectral conv of each FNO at its config's padded grid and its
    recipe's batch: 'fft' (cuFFT) against 'matmul' on the card, both
    against the port's CPU 'fft' on the first two samples (same weights,
    TF32 off); the warm CUDA-event medians of each form, forward and
    forward + backward, and the form 'auto' resolves to."""
    import copy
    from unittest import mock

    from fast_eng_super_resolution_tpu_torch.models import fno
    from fast_eng_super_resolution_tpu_torch.models.fno import spectral_conv

    out = {}
    for key in ("fno2d", "fno3d", "fno1d"):
        cfg, train = cfgs[key]
        model = grid_model(key, cfg).cuda()
        grid = [cfg["resolution"] + model.padding] * model.ndim
        shape = (int(train["batch_size"]), model.width, *grid)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn(shape, device="cuda", generator=gen)
        with torch.no_grad():
            fft = spectral_conv(model, 0, x, "fft")
            mm = spectral_conv(model, 0, x, "matmul")
            ref = spectral_conv(copy.deepcopy(model).cpu(), 0, x[:2].cpu(),
                                "fft")
            errs = {"err_fft_matmul": float((fft - mm).abs().max()
                                            / mm.abs().max()),
                    "err_fft_cpu": rel_err(fft[:2], ref),
                    "err_matmul_cpu": rel_err(mm[:2], ref)}
            # recorded, not held: cuFFT's C2R on the raw spectrum (the DC
            # and Nyquist columns' imaginary parts left in)
            with mock.patch.object(fno, "_irfft_last",
                                   lambda u, n: torch.fft.irfft(u, n=n)):
                raw = spectral_conv(model, 0, x, "fft")
            raw_err = float((raw - mm).abs().max() / mm.abs().max())
            del fft, mm, raw
            t = {f"{impl}_ms": cuda_ms(
                lambda impl=impl: spectral_conv(model, 0, x, impl))
                for impl in ("fft", "matmul")}
        xg = x.clone().requires_grad_(True)
        for impl in ("fft", "matmul"):
            t[f"{impl}_fwd_bwd_ms"] = cuda_ms(
                lambda impl=impl: spectral_conv(model, 0, xg, impl).sum()
                .backward())
        auto = model.resolve_impl(torch.device("cuda"))
        log("grid_spectral", model=key, shape="x".join(map(str, shape)),
            auto=auto, **{k: f"{v:.2e}" for k, v in errs.items()},
            err_raw_c2r_matmul=f"{raw_err:.2e}",
            **{k: f"{v:.4f}" for k, v in t.items()}, tol=GRID_SPECTRAL_TOL)
        for k, v in errs.items():
            if not v < GRID_SPECTRAL_TOL:
                raise AssertionError(f"grid_spectral {key} {k}={v}")
        out[key] = dict(t, auto=auto, **errs)
        del x, xg
        torch.cuda.empty_cache()
    return out


def _train_losses(log_dir: str, exp: str) -> list:
    """The train losses a MetricLogger wrote for ``exp``, in order."""
    with open(os.path.join(log_dir, "metrics", f"{exp}.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    return [r["train_loss"] for r in records if "train_loss" in r]


def phase_grid_train(cfgs: dict, log_dir: str, futures: dict) -> dict:
    """``train_grid`` of each grid model on the card from its cut recipe:
    finite losses (FNO2d's train loss falls from the first logged epoch to
    the last), a checkpoint with its task-spec stamp, the warm train step
    (recipe batch) and the phase's peak memory."""
    from fast_eng_super_resolution_tpu_torch.grid_runner import train_grid
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

    out = {}
    for key, (cfg, train) in cfgs.items():
        data_s = futures[key].result()
        ds = init_dataset(GRID[key]["dataset"], **cfg)
        model = grid_model(key, cfg)
        exp = f"grid_{key}"
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        res = train_grid(exp, model, ds, train, cfg, log_dir=log_dir)
        torch.cuda.synchronize()
        wall = time.time() - t0
        peak = torch.cuda.max_memory_allocated()
        losses = _train_losses(log_dir, exp)
        if not np.all(np.isfinite(losses)) or not np.isfinite(res["best_val"]):
            raise AssertionError(f"grid_train {key}: losses {losses}")
        if key == "fno2d" and not losses[-1] < losses[0]:
            raise AssertionError(f"grid_train fno2d: loss did not fall {losses}")
        meta = ckpt.load_meta(res["ckpt"])
        if meta.get("model") != type(model).__name__ or "task" not in meta:
            raise AssertionError(f"grid_train {key}: checkpoint meta {meta}")
        # the warm step: the trained weights, one recipe batch
        bs = min(int(train["batch_size"]), int(cfg["train_samples"]))
        xb = torch.as_tensor(ds.x[:bs], device="cuda")
        yb = torch.as_tensor(ds.y[:bs], device="cuda")
        tr = GridTrainer(model, lr=float(train["lr"]),
                         out_channels=int(ds.y.shape[-1]))
        tr.net.from_jax_params(ckpt.load_params(res["ckpt"]))
        opt = tr.optimizer()
        step_ms = warm_ms(lambda: tr.step(opt, xb, yb))
        impl, steps = "-", {}
        if hasattr(model, "resolve_impl"):  # the step in each spectral form
            impl = model.resolve_impl(torch.device("cuda"))
            for form in ("fft", "matmul"):
                model.spectral_impl = form
                ms = warm_ms(lambda: tr.step(opt, xb, yb))
                steps[f"step_ms_{form}"] = f"{ms:.3f}"
            model.spectral_impl = "auto"
        log("grid_train", model=key, impl=impl, data_s=f"{data_s:.1f}",
            train_s=f"{wall:.2f}", epochs=train["epochs"],
            steps_per_epoch=max(1, int(cfg["train_samples"]) // bs),
            first_loss=f"{losses[0]:.6f}", last_loss=f"{losses[-1]:.6f}",
            best_val=f"{res['best_val']:.6f}", step_ms=f"{step_ms:.3f}",
            **steps, peak_mib=f"{peak / 2**20:.0f}",
            ckpt=os.path.basename(res["ckpt"]))
        out[key] = dict(ds=ds, model=model, exp=exp, step_ms=step_ms,
                        peak_mib=peak / 2**20, impl=impl, losses=losses)
    return out


def phase_grid_parity() -> None:
    """Three Adam steps of FNO2d (fno_advected_256.yaml's width 16 and
    modes 12, at a 32x32 grid) from the same weights and batches on the
    card, in both spectral forms, and on the CPU: the losses agree."""
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

    rng = np.random.default_rng(SEED)
    x = rng.random((6, 32, 32, 1)).astype(np.float32)
    y = rng.random((6, 32, 32, 1)).astype(np.float32)
    order = rng.permutation(6).reshape(3, 2)
    losses = {}
    for dev, impl in (("cpu", "fft"), ("cuda", "fft"), ("cuda", "matmul")):
        model = init_model("fno", 12, 12, width=16, in_feats=1, seed=SEED)
        model.spectral_impl = impl
        tr = GridTrainer(model.to(dev), lr=1e-3, out_channels=1)
        opt = tr.init(SEED, x)
        losses[(dev, impl)] = tr.epoch(
            opt, torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev),
            order).cpu().numpy()
    ref = losses[("cpu", "fft")]
    for k, v in losses.items():
        err = float(np.max(np.abs(v - ref) / ref))
        log("grid_parity", device=k[0], impl=k[1],
            losses=",".join(f"{a:.7f}" for a in v), rel_err=f"{err:.2e}",
            tol=GRID_PARITY_TOL)
        if not err < GRID_PARITY_TOL:
            raise AssertionError(f"grid_parity {k}: {v} vs {ref}")


def phase_grid_serve(cfgs: dict, trained: dict, log_dir: str) -> dict:
    """``pred_grid`` of each checkpoint on the card: every ``pred_{idx}.npz``
    finite, the improvement factors (recorded, not held to a value after a
    handful of epochs), then the warm time of a one-sample request
    (``pred_grid``: checkpoint load, upload, forward, fetch, .npz) and of
    its predict alone (upload, forward, fetch)."""
    import io

    from fast_eng_super_resolution_tpu_torch.grid_runner import pred_grid
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

    out = {}
    for key, (cfg, _) in cfgs.items():
        r = trained[key]
        ds, model, exp = r["ds"], r["model"], r["exp"]
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            paths = pred_grid(cfg["idxs"], exp, model, ds, cfg,
                              log_dir=log_dir)
        for p in paths:
            with np.load(p) as z:
                if not np.all(np.isfinite(z["pred"])):
                    raise AssertionError(f"{p}: non-finite prediction")
        factors = [ln.rsplit("improvement ", 1)[1]
                   for ln in "".join(tee.parts).splitlines()
                   if "improvement" in ln]
        if len(factors) != len(cfg["idxs"]):
            raise AssertionError(f"grid_serve {key}: {factors}")
        idx = cfg["idxs"][0]
        with contextlib.redirect_stdout(io.StringIO()):
            request_ms = warm_ms(lambda: pred_grid([idx], exp, model, ds, cfg,
                                                   log_dir=log_dir))
        tr = GridTrainer(model, lr=0.0)
        tr.net.from_jax_params(ckpt.load_params(
            os.path.join(log_dir, "models", f"collection_{exp}",
                         "partition_0.npz")))
        x1 = ds[idx]["x"][None]
        predict_ms = warm_ms(
            lambda: tr.predict(torch.as_tensor(x1, device="cuda")).cpu())
        log("grid_serve", model=key, idxs=cfg["idxs"],
            improvement=",".join(factors), request_ms=f"{request_ms:.3f}",
            predict_ms=f"{predict_ms:.3f}")
        out[key] = dict(request_ms=request_ms, predict_ms=predict_ms,
                        improvement=factors)
    return out


def run_grid(cfgs: dict, root: str, futures: dict) -> dict:
    """The grid phases; the launch counters of B1-B5 stay at 0 (the grid
    path runs no hand-written kernel)."""
    t0 = time.time()
    reset_launches()
    log_dir = os.path.join(root, "grid_logs")
    spectral = phase_grid_spectral(cfgs)
    trained = phase_grid_train(cfgs, log_dir, futures)
    phase_grid_parity()
    served = phase_grid_serve(cfgs, trained, log_dir)
    check_only("grid phases", {})
    log("grid", launches=launches_of(*KERNELS), wall_s=f"{time.time() - t0:.1f}")
    return dict(spectral=spectral, served=served,
                train={k: {f: v[f] for f in ("step_ms", "peak_mib", "impl")}
                       for k, v in trained.items()})


# -- the grid rollout lane, .mat, GraphSAGE, host utilities (phases 20-23) --

def rollout_configs(root: str) -> dict:
    """Per rollout path, (exp config, train config): the shipped configs
    at their published sizes with this run's root (the two NS configs
    share one), the recipe cut to ROLLOUT_EPOCHS epochs, on the card."""
    out = {}
    for key, r in ROLLOUT.items():
        cfg = load_yaml(os.path.join(REPO, "configs", "exp_config", r["exp"]))
        cfg.update(root=os.path.join(root, "rollout", r["data"]))
        train = load_yaml(os.path.join(REPO, "configs", "train_config",
                                       r["train"]))
        out[key] = (cfg, dict(train, epochs=ROLLOUT_EPOCHS))
    return out


def _held_out_inputs(ds, cfg: dict, device) -> tuple:
    """The held-out trajectories' (first frames on ``device``, host
    guidance [T, B, *sp], static channels on ``device`` or None), as
    ``pred_rollout`` hands them to ``rollout``."""
    ev = list(range(int(cfg["train_samples"]) // ds.t_frames,
                    ds.trajectories.shape[0]))
    static = ds.static_fields
    return (torch.as_tensor(ds.trajectories[ev, 0], device=device),
            np.moveaxis(ds.coarse_frames[ev], 1, 0),
            None if static is None else torch.as_tensor(static[ev],
                                                        device=device))


def _rollout_artifacts(paths: list, guided: bool) -> dict:
    """Each ``pred_{idx}.npz``'s arrays, all finite, with the keys the JAX
    package writes."""
    want = {"pred", "ref", "input", "rollout"} | ({"coarse"} if guided
                                                  else set())
    out = {}
    for p in paths:
        with np.load(p) as z:
            arrays = {k: z[k] for k in z.files}
        if set(arrays) != want or not all(np.all(np.isfinite(a))
                                          for a in arrays.values()):
            raise AssertionError(f"{p}: keys {sorted(arrays)} or non-finite")
        out[os.path.basename(p)] = arrays
    return out


def phase_rollout(key: str, cfg: dict, train: dict, log_dir: str,
                  data_s: float) -> dict:
    """One rollout path: ``train_grid`` on the one-step pairs, then
    ``pred_rollout`` in both impls (the same bits) and on the CPU from the
    same checkpoint (within ROLLOUT_TOL); the warm train step, the warm
    rollout per impl (upload, T forwards, one fetch) and its peak memory,
    the warm request (``pred_rollout`` whole) and the improvement
    factors."""
    import copy
    import io

    from fast_eng_super_resolution_tpu_torch.grid_runner import (
        pred_rollout, rollout, train_grid)
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import GridTrainer

    r = ROLLOUT[key]
    ds = init_dataset(r["dataset"], **cfg)
    model = init_model(r["model"], seed=SEED, **cfg)
    exp = f"rollout_{key}"
    T, n_traj = ds.t_frames, ds.trajectories.shape[0]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    res = train_grid(exp, model, ds, train, cfg, log_dir=log_dir)
    torch.cuda.synchronize()
    train_s, train_peak = time.time() - t0, torch.cuda.max_memory_allocated()
    losses = _train_losses(log_dir, exp)
    if not np.all(np.isfinite(losses)) or not np.isfinite(res["best_val"]):
        raise AssertionError(f"rollout {key}: losses {losses}")
    bs = int(train["batch_size"])
    xb, yb = (torch.as_tensor(np.stack([ds[i][k] for i in range(bs)]),
                              device="cuda") for k in ("x", "y"))
    tr = GridTrainer(model, lr=float(train["lr"]),
                     out_channels=int(yb.shape[-1]))
    tr.net.from_jax_params(ckpt.load_params(res["ckpt"]))
    opt = tr.optimizer()
    step_ms = warm_ms(lambda: tr.step(opt, xb, yb))

    arts, means = {}, {}
    for impl in ("scan", "stepwise"):
        tee = _Tee(sys.stdout)
        with contextlib.redirect_stdout(tee):
            paths = pred_rollout(cfg["idxs"], exp, model, ds,
                                 dict(cfg, rollout_impl=impl),
                                 log_dir=log_dir)
        arts[impl] = _rollout_artifacts(paths, ds.guided)
        (line,) = [ln for ln in "".join(tee.parts).splitlines()
                   if "all-held-out mean" in ln]
        means[impl] = line.split(": ", 1)[1]
    for name, a in arts["scan"].items():
        for k, v in a.items():
            if not np.array_equal(v, arts["stepwise"][name][k]):
                raise AssertionError(f"rollout {key} {name} {k}: scan and "
                                     "stepwise differ")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = _rollout_artifacts(
            pred_rollout(cfg["idxs"], exp, copy.deepcopy(model).cpu(), ds,
                         cfg, log_dir=log_dir, device="cpu"), ds.guided)
    card_frames = np.stack([a["rollout"] for a in arts["scan"].values()])
    cpu_frames = np.stack([cpu[name]["rollout"] for name in arts["scan"]])
    err = hold(f"rollout_{key}", "frames_vs_cpu", card_frames, cpu_frames,
               ROLLOUT_TOL)

    net = GridTrainer(model.cuda(), lr=0.0).net
    net.from_jax_params(ckpt.load_params(res["ckpt"]))
    f0, coarse_tmaj, static = _held_out_inputs(ds, cfg, "cuda")
    times, peaks = {}, {}
    for impl in ("scan", "stepwise"):
        torch.cuda.reset_peak_memory_stats()
        times[impl] = warm_ms(lambda impl=impl: rollout(
            net, f0, coarse_tmaj, static, ds.guided, impl).cpu())
        peaks[impl] = torch.cuda.max_memory_allocated() / 2**20
    with contextlib.redirect_stdout(io.StringIO()):
        request_ms = warm_ms(lambda: pred_rollout(cfg["idxs"], exp, model,
                                                  ds, cfg, log_dir=log_dir))
    faster = min(times, key=times.get)
    log(f"rollout_{key}", config=ROLLOUT[key]["exp"],
        trajectories=n_traj, held_out=len(f0), t_frames=T,
        grid="x".join(map(str, ds.trajectories.shape[2:])),
        guided=ds.guided, data_s=f"{data_s:.1f}", train_s=f"{train_s:.2f}",
        epochs=train["epochs"], batch=bs, first_loss=f"{losses[0]:.6f}",
        last_loss=f"{losses[-1]:.6f}", step_ms=f"{step_ms:.3f}",
        train_peak_mib=f"{train_peak / 2**20:.0f}",
        scan_ms=f"{times['scan']:.3f}", stepwise_ms=f"{times['stepwise']:.3f}",
        scan_step_ms=f"{times['scan'] / T:.3f}",
        stepwise_step_ms=f"{times['stepwise'] / T:.3f}",
        scan_peak_mib=f"{peaks['scan']:.0f}",
        stepwise_peak_mib=f"{peaks['stepwise']:.0f}", faster=faster,
        request_ms=f"{request_ms:.3f}", err_vs_cpu=f"{err:.2e}",
        tol=ROLLOUT_TOL, mean=repr(means["scan"]), identical=True)
    return dict(step_ms=step_ms, times=times, peaks=peaks, err=err,
                request_ms=request_ms, mean=means["scan"])


def run_rollout(cfgs: dict, root: str, futures: dict, smi: str) -> dict:
    """Phase 20 over the four rollout paths; B1-B5 launched 0 times."""
    t0 = time.time()
    reset_launches()
    log_dir = os.path.join(root, "rollout_logs")
    for key, (cfg, train) in cfgs.items():
        phase_rollout(key, cfg, train, log_dir,
                      futures[ROLLOUT[key]["data"]].result())
    check_only("rollout phases", {})
    log("rollout", card=repr(smi), launches=launches_of(*KERNELS),
        wall_s=f"{time.time() - t0:.1f}")
    return launches_of(*KERNELS)


def mat_configs(root: str) -> dict:
    """(exp config, train config) of each ``mat_grid`` task: the shipped
    configs (the 'sr' one on the repo's fixture, the 'operator' one under
    this run's root), fno_advected.yaml cut to MAT_EPOCHS epochs."""
    train = load_yaml(os.path.join(REPO, "configs", "train_config",
                                   "fno_advected.yaml"))
    out = {}
    for key, name, base in (("sr", "fno_darcy_mat.yaml", REPO),
                            ("operator", "fno_darcy_mat_operator.yaml",
                             root)):
        cfg = load_yaml(os.path.join(REPO, "configs", "exp_config", name))
        cfg.update(root=os.path.join(base, cfg["root"]), config=name)
        out[key] = (cfg, dict(train, epochs=MAT_EPOCHS))
    return out


def mat_path(cfg: dict) -> str:
    return os.path.join(cfg["root"], cfg["mat_file"])


def _write_darcy_mat(path: str) -> float:
    """benchmarks/make_darcy_mat.py's recipe through the port's copies of
    its solver: MAT_OPERATOR's fields as a v5 ``.mat`` (coeff, sol)."""
    import scipy.io as sio

    from fast_eng_super_resolution_tpu_torch.data.grid_dataset import (
        _grf_threshold_coeff, solve_darcy)

    t0 = time.time()
    n, samples = MAT_OPERATOR["n"], MAT_OPERATOR["samples"]
    rng = np.random.default_rng(SEED)
    coeff = np.empty((samples, n, n), np.float32)
    sol = np.empty((samples, n, n), np.float32)
    for i in range(samples):
        coeff[i] = _grf_threshold_coeff(n, rng)
        sol[i] = solve_darcy(coeff[i])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    sio.savemat(path, {"coeff": coeff, "sol": sol})
    return time.time() - t0


def phase_mat(cfgs: dict, root: str, futures: dict) -> dict:
    """Phase 21: ``train_grid`` then ``pred_grid`` of each ``mat_grid``
    config on the card; finite predictions, B1-B5 at 0."""
    import io

    from fast_eng_super_resolution_tpu_torch.grid_runner import (pred_grid,
                                                                  train_grid)

    t0 = time.time()
    reset_launches()
    log_dir = os.path.join(root, "mat_logs")
    data_s = futures["mat_operator"].result()
    for key, (cfg, train) in cfgs.items():
        ds = init_dataset("mat_grid", **cfg)
        model = init_model("fno", seed=SEED, **cfg)
        exp = f"mat_{key}"
        t1 = time.time()
        res = train_grid(exp, model, ds, train, cfg, log_dir=log_dir)
        torch.cuda.synchronize()
        train_s = time.time() - t1
        losses = _train_losses(log_dir, exp)
        tee = _Tee(io.StringIO())
        with contextlib.redirect_stdout(tee):
            paths = pred_grid(cfg["idxs"], exp, model, ds, cfg,
                              log_dir=log_dir)
        for p in paths:
            with np.load(p) as z:
                if not np.all(np.isfinite(z["pred"])):
                    raise AssertionError(f"{p}: non-finite prediction")
        if not np.all(np.isfinite(losses)) or len(paths) != len(cfg["idxs"]):
            raise AssertionError(f"mat {key}: losses {losses}, {paths}")
        factors = [ln.rsplit("improvement ", 1)[1]
                   for ln in "".join(tee.parts).splitlines()
                   if "improvement" in ln]
        log("mat", task=key, config=cfg["config"],
            file=os.path.basename(mat_path(cfg)), samples=len(ds),
            grid="x".join(map(str, ds.x.shape[1:-1])), width=cfg["width"],
            written_s=f"{data_s:.1f}" if key == "operator" else "-",
            train_s=f"{train_s:.2f}", first_loss=f"{losses[0]:.6f}",
            last_loss=f"{losses[-1]:.6f}",
            best_val=f"{res['best_val']:.6f}",
            improvement=",".join(factors))
    check_only("mat phases", {})
    log("mat", launches=launches_of(*KERNELS),
        wall_s=f"{time.time() - t0:.1f}")
    return launches_of(*KERNELS)


def phase_graphsage(root: str, datasets: dict, cfgs: dict, smi: str) -> dict:
    """Phase 22: GraphSAGE through the general lane and the merged layout,
    then the power-series TEECNet's training on the card (the layout
    gate); returns the launch counts of both parts by path."""
    import layout_gate_check

    from fast_eng_super_resolution_tpu_torch.sched.scheduler import _train_layout

    t0 = time.time()
    log_dir = os.path.join(root, "logs")
    cfg = cfgs["full"]
    model = init_model("graphsage", cfg["in_channels"], cfg["out_channels"],
                       seed=SEED)
    if _train_layout(model, CARD) != "merged":
        raise AssertionError("graphsage: the gate would train it fused")
    for exp in ("full_sage", "small_sage"):
        ckpt.save_params(os.path.join(log_dir, "models", f"collection_{exp}",
                                      "partition_0.npz"),
                         model.to_jax_params(), meta={"model": "GraphSAGE"})
    reset_launches()
    t1 = time.time()
    lanes, (f,) = serve(datasets["full"], model, [0], log_dir, "full_sage",
                        None)
    torch.cuda.synchronize()
    cold_s = time.time() - t1
    if lanes[0][1] != "general":
        raise AssertionError(f"graphsage took lane {lanes[0][1]}")
    request_ms, _ = warm_request(datasets["full"], model, log_dir,
                                 "full_sage")
    _, (card,) = serve(datasets["small"], model, [0], log_dir, "small_sage",
                       None)
    _, (cpu,) = serve(datasets["small"], model, [0], log_dir, "small_sage",
                      "cpu")
    for key in ("velocity", "pressure"):
        hold("graphsage", f"small_{key}_vs_cpu", card[key], cpu[key],
             GENERAL_TOL)
    train_cfg = load_yaml(cfg["train_config"])
    train_cfg.update(epochs=SAGE_EPOCHS, val_interval=1)
    t1 = time.time()
    train_graph_ALDD("train_sage", model, datasets["full"], 1, train_cfg,
                     log_dir=log_dir)
    torch.cuda.synchronize()
    train_s = time.time() - t1
    losses = _train_losses(log_dir, "train_sage_partition_0")
    if len(losses) != SAGE_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"graphsage train losses {losses}")
    lanes, _ = serve(datasets["full"], model, [0], log_dir, "train_sage",
                     None)
    # three merged steps card vs CPU on the small mesh, same weights
    small = merged_subdomains(datasets["small"])
    steps = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(init_model("graphsage", 4, 4, seed=SEED).to(dev),
                     lr=train_cfg["lr"], layout="merged")
        opt = tr.init(SEED)
        batch = small.to_torch(dev)
        steps[dev] = [float(tr.step(opt, batch)) for _ in range(3)]
    rel = max(abs(a - b) / abs(b) for a, b in zip(steps["cuda"], steps["cpu"]))
    check_only("graphsage", {})
    log("graphsage", card=repr(smi), layers=model.num_layers,
        mesh="full", lane=lanes[0][1], nodes=len(f["pressure"]),
        cold_s=f"{cold_s:.3f}", request_ms=f"{request_ms:.3f}",
        train_layout="merged", train_s=f"{train_s:.2f}",
        losses=",".join(f"{v:.5g}" for v in losses),
        parity=",".join(f"{v:.8g}" for v in steps["cuda"]),
        parity_rel=f"{rel:.3e}", tol=PARITY_TOL,
        launches=launches_of(*KERNELS))
    if not rel <= PARITY_TOL:
        raise AssertionError(f"graphsage steps card {steps['cuda']} vs cpu "
                             f"{steps['cpu']}")
    sage = launches_of(*KERNELS)

    # the layout gate: the power-series TEECNet (teecnet_ansys.yaml's
    # width and layers, teecnet.yaml cut to SAGE_EPOCHS) trains merged
    tc = load_yaml(TEECNET_CONFIG)
    ps = TEECNet(tc["in_channels"], tc["width"], tc["out_channels"],
                 tc["num_layers"], kernel_type="powerseries", seed=SEED)
    if _train_layout(ps, CARD) != "merged":
        raise AssertionError("powerseries: the gate would train it fused")
    train_cfg = load_yaml(TEECNET_TRAIN)
    train_cfg.update(epochs=SAGE_EPOCHS, val_interval=1)
    reset_launches()
    t1 = time.time()
    train_graph_ALDD("train_ps", ps, datasets["full"], 1, train_cfg,
                     log_dir=log_dir)
    torch.cuda.synchronize()
    ps_train_s = time.time() - t1
    check_only("powerseries training", {})
    ps_losses = _train_losses(log_dir, "train_ps_partition_0")
    with tempfile.TemporaryDirectory(dir=root) as d:
        gate = layout_gate_check.compare(d)
    check_only("powerseries training", {})
    log("powerseries_train", card=repr(smi), layout="merged",
        full_train_s=f"{ps_train_s:.2f}",
        full_losses=",".join(f"{v:.5g}" for v in ps_losses),
        steps_card=",".join(f"{v:.8g}" for v in gate["card"]),
        steps_cpu=",".join(f"{v:.8g}" for v in gate["cpu"]),
        rel=f"{gate['max_rel']:.3e}", tol=PARITY_TOL,
        launches=launches_of(*KERNELS))
    if not np.all(np.isfinite(ps_losses)) or not gate["max_rel"] <= PARITY_TOL:
        raise AssertionError(f"powerseries training: {ps_losses}, {gate}")
    log("graphsage", wall_s=f"{time.time() - t0:.1f}")
    return {"graphsage": sage, "powerseries_train": launches_of(*KERNELS)}


def phase_host(root: str, datasets: dict, models: dict, cfgs: dict,
               smi: str) -> dict:
    """Phase 23: ``prefetch_to_device`` over the full KernelNN path's train
    batches, a traced full-size request, ``gaussian_interpolate_device``
    card vs CPU; returns the launch counts by path."""
    from fast_eng_super_resolution_tpu_torch.data.pipeline import prefetch_to_device
    from fast_eng_super_resolution_tpu_torch.ops import interpolate
    from fast_eng_super_resolution_tpu_torch.utils import tracing

    t0 = time.time()
    out = {}
    # the KernelNN path's train batches, as the scheduler merges them, over
    # two epochs of its shuffled order
    ds = datasets["full"]
    tr_idx, _ = train_val_split(len(ds), 0.2, 0)
    bs = 4
    host = [merged_subdomains(ds, tr_idx[i:i + bs])
            for i in range(0, len(tr_idx), bs)]
    rng = np.random.default_rng(SEED)
    order = np.concatenate([rng.permutation(len(host)) for _ in range(2)])
    model = models["full"].cuda()

    def consume(batches) -> tuple:
        """(wall s, the batches) of one plain forward per batch."""
        seen = []
        t1 = time.perf_counter()
        for g in batches:
            with torch.no_grad():
                model.apply(g.x, g.senders, g.receivers, g.edge_attr,
                            edge_mask=g.edge_mask)
            seen.append(g)
        torch.cuda.synchronize()
        return time.perf_counter() - t1, seen

    reset_launches()
    prefetch_s, got = consume(prefetch_to_device((host[i] for i in order),
                                                 size=2))
    plain_s, _ = consume(host[i].to_torch("cuda") for i in order)
    for g, i in zip(got, order):
        for name, leaf in vars(g).items():
            if leaf.device.type != "cuda" or not np.array_equal(
                    leaf.cpu().numpy(), getattr(host[i], name)):
                raise AssertionError(f"prefetch batch {i} {name}")
    if len(got) != len(order):
        raise AssertionError(f"prefetch: {len(got)} of {len(order)} batches")
    check_only("prefetch", {})
    out["host_prefetch"] = launches_of(*KERNELS)
    log("host_prefetch", card=repr(smi), batches=len(order),
        nodes=host[0].x.shape[0], in_order=True, bits_equal=True,
        device="cuda", prefetch_s=f"{prefetch_s:.4f}",
        sequential_s=f"{plain_s:.4f}")

    # one full-size KernelNN request under FESR_TRACE_DIR
    trace_root = os.path.join(root, "traces")
    reset_launches()
    with env_set("FESR_TRACE_DIR", trace_root), \
            tracing.trace_dir("kernelnn_request"):
        serve(ds, models["full"], [0], os.path.join(root, "logs"), "full",
              None)
        torch.cuda.synchronize()
    path = os.path.join(trace_root, "kernelnn_request", "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sorted({e["name"] for e in events
                      if e.get("cat") == "kernel" and "conv_fwd" in e["name"]})
    check_only("traced request", {fused_conv.fused_edge_conv:
                                  CHUNKS["full"] * cfgs["full"]["num_layers"]})
    out["host_trace"] = launches_of(*KERNELS)
    log("host_trace", card=repr(smi), file=os.path.relpath(path, root),
        bytes=os.path.getsize(path), events=len(events),
        b1_kernels=repr(kernels), launches=launches_of(*KERNELS))
    if not kernels:
        raise AssertionError(f"{path} names no B1 kernel")

    # the duct's low -> high Gaussian interpolation on tensors
    high, low = (make_duct_mesh(*FULL[k]) for k in ("n_high", "n_low"))
    v, p = duct_field(low.points)
    vals = np.concatenate([v, p.reshape(-1, 1)], 1).astype(np.float32)
    radius = ds.gauss_radius
    lists = interpolate.build_neighbor_lists(low.points, high.points, radius)
    reset_launches()
    res = {}
    for dev in ("cuda", "cpu"):
        args = [torch.as_tensor(a, device=dev) for a in (vals, *lists)]
        res[dev] = interpolate.gaussian_interpolate_device(*args, radius)
    err = hold("host_interp", "card_vs_cpu", res["cuda"].cpu().numpy(),
               res["cpu"].numpy(), INTERP_TOL)
    args = [torch.as_tensor(a, device="cuda") for a in (vals, *lists)]
    ms = cuda_ms(lambda: interpolate.gaussian_interpolate_device(*args,
                                                                 radius))
    nbytes = sum(a.nbytes for a in (vals, *lists)) + res["cpu"].numel() * 4
    check_only("interpolation", {})
    out["host_interp"] = launches_of(*KERNELS)
    log("host_interp", card=repr(smi), src=len(low.points),
        dst=len(high.points), k=lists[0].shape[1], radius=f"{radius:.4f}",
        err=f"{err:.2e}", ms=f"{ms:.4f}",
        bound_ms=f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f}", bound_by="bytes")
    log("host", wall_s=f"{time.time() - t0:.1f}")
    return out


# -- phase 24: multi ------------------------------------------------------------

MULTI_WORLD = 2  # gloo ranks sharing the one card
MULTI_STEPS = 3
MULTI_EPOCHS = 2  # the torchrun training's cut of synthetic_full.yaml
MULTI_TIMEOUT = 300  # seconds per spawned group
# The data-parallel fused step (each rank its group of 6 subdomains) against
# one process's fused step on the concatenated 12, from the same seed.
# float32 (TF32 off): the JAX package's tolerances for the same comparison
# (tests/test_train.py:281-284), losses rtol 1e-5 and parameters rtol 1e-3 /
# atol 1e-5.  bfloat16: the GEMM inputs are rounded from float32 values that
# other block geometries (and atomics) sum in other orders, so a rounding may
# flip by one bf16 ulp (2^-8): losses rtol 1e-3, and the update each run
# made to the parameters within 1e-2 of the single process's in L2.
MULTI_STEP_TOL = {"float32": dict(loss=1e-5, rtol=1e-3, atol=1e-5),
                  "bfloat16": dict(loss=1e-3, update=1e-2)}
# predict_full's data-parallel lanes against one process (relative to the
# max): fast_mc serves each rank the same 4-subdomain groups the general
# lane's chunks hold, so B1 sees the same operands and only the overlap sums
# change order (1e-5); routed_mc's label groups are the rank's, not the
# request's, so bf16 roundings may flip as above: the JAX package's routed
# fused-vs-plain tolerance, 2e-2 (1e-5 in float32, TF32 off).
MULTI_SERVE_TOL = {("fast_mc", "bfloat16"): 1e-5,
                   ("fast_mc", "float32"): 1e-5,
                   ("routed_mc", "bfloat16"): 2e-2,
                   ("routed_mc", "float32"): 1e-5}
# The FNO2d epoch, 16 + 16 per step against 32 (float32, TF32 off): the JAX
# package's tolerances (tests/test_train.py:321-325).
MULTI_GRID_TOL = dict(loss=1e-5, rtol=1e-4, atol=1e-6)
MULTI_GRID = dict(exp="fno_advected_256.yaml", train="fno_advected.yaml",
                  steps=2)
MULTI_DTYPES = ("bfloat16", "float32")
MULTI_TIMED = 5  # warm steps timed per rank and in one process


def multi_batch(ds):
    """The 12 training subdomains of the full meshes (seed 0's split) as one
    [12, ...] host batch, as the scheduler pads them."""
    tr_idx, _ = train_val_split(len(ds), 0.2, 0)
    raw = [_as_raw_graph(ds.get(int(i))) for i in tr_idx]
    (_, _, batch), = pad_and_bucket(raw, uniform=True)
    return batch


def multi_grid_data(cfg: dict) -> tuple:
    """Seeded inputs and targets of one epoch at the config's published
    shapes: [steps, batch, resolution, resolution, 1]."""
    rng = np.random.default_rng(SEED)
    n = cfg["resolution"]
    shape = (MULTI_GRID["steps"], cfg["batch_size"], n, n, cfg["in_feats"])
    return (rng.standard_normal(shape, dtype=np.float32),
            0.1 * rng.standard_normal(shape[:-1] + (1,), dtype=np.float32))


def multi_grid_config() -> dict:
    cfg = load_yaml(os.path.join(REPO, "configs", "exp_config",
                                 MULTI_GRID["exp"]))
    train = load_yaml(os.path.join(REPO, "configs", "train_config",
                                   MULTI_GRID["train"]))
    return dict(cfg, batch_size=train["batch_size"], lr=train["lr"])


def flat_params(model) -> dict:
    return {k: np.asarray(v) for k, v in
            ckpt.flatten_params(model.to_jax_params()).items()}


def multi_steps(model, batch, dtype: str, lr: float, dev, mesh=None,
                timed: int = 0) -> dict:
    """``MULTI_STEPS`` fused train steps from ``model``'s weights: on a
    ``mesh``, this rank's fused shard step over its group; without, one
    process's fused step on the whole batch merged.  Returns the losses, the
    parameters before and after, and B1's and B2's launches; with ``timed``,
    also the median wall ms of that many more steps (each ending in a
    device sync)."""
    p0 = flat_params(model)
    if mesh is None:
        fb, rows_blk, blk = make_fused_batch(merge_batch(batch)[0], model,
                                             device=dev)
        tr = Trainer(model, lr=lr, layout="fused", fused_rows_blk=rows_blk,
                     fused_blk=blk, fused_dtype=dtype)
        step = tr.step
    else:
        tr = Trainer(model, lr=lr, layout="batched", fused_dtype=dtype)
        replicate(model, mesh)
        fb, rows_blk, blk = make_fused_shard_batches(
            pad_batch_to_multiple(batch, mesh.size)[0], model, mesh.size,
            expand_s=False, mesh=mesh)
        step = tr.make_fused_shard_map_step(mesh, rows_blk, blk)
    opt = tr.init()
    reset_launches()
    losses = [float(step(opt, fb)) for _ in range(MULTI_STEPS)]
    out = dict(losses=np.array(losses), p0=p0, p=flat_params(model),
               launches=launches_of(fused_conv.fused_edge_conv,
                                    fused_conv.fused_edge_conv_bwd))
    if timed:
        out["step_ms"] = warm_ms(lambda: step(opt, fb), timed)
    return out


def multi_serve(ds, log_dir: str, exp: str, cfg: dict, dtype: str, dev,
                mesh=None) -> dict:
    """Full mesh 0 through ``predict_full``: on a ``mesh``, its
    data-parallel lane; without, one process's lane (the routed lane with
    the budget of the whole request, or the general lane's ``predict`` and
    the host overlap average)."""
    n_part = cfg["n_clusters"]
    sched = PartitionScheduler(exp, n_part, ds, make_model(cfg), train=False,
                               log_dir=log_dir, device=dev, gemm_dtype=dtype,
                               **(routing(cfg) if n_part > 1 else {}))
    x = ds.get_one_full_sample(0)
    n = len(ds.full_mesh(0)["points"])
    b, _, e_pad = sched._request_shape([_as_raw_graph(d) for d in x])
    budget = b * e_pad if (mesh is None and n_part > 1) else None
    reset_launches()
    with env_set("FESR_PREDICT_EDGE_BUDGET", budget):
        got = sched.predict_full(x, n)
    lane = sched.last_lane[0]
    if got is None:  # one process over the budget: the general lane
        p_list, r_list, _, _ = sched.predict(x)
        gids = [d["global_node_ids"] for d in x]
        got = (overlap_average(p_list, gids, n),
               overlap_average(r_list, gids, n))
    return dict(pred=np.asarray(got[0]), ref=np.asarray(got[1]), lane=lane,
                launches=fused_conv.fused_edge_conv.launches)


def multi_grid(cfg: dict, dev, mesh=None) -> dict:
    """One FNO2d epoch from seed 0 on the seeded data: on a ``mesh``, this
    rank's half of every batch, gradients averaged over the ranks."""
    from fast_eng_super_resolution_tpu_torch.parallel.grid_train import (
        GridTrainer, shard_grid_epoch)

    xb, yb = multi_grid_data(cfg)
    model = init_model("fno", seed=SEED, **cfg).to(dev)
    tr = GridTrainer(model, lr=cfg["lr"], out_channels=1)
    opt = tr.init(SEED, xb[0])
    p0 = flat_params(tr.net)
    if mesh is None:
        xs, ys = (torch.as_tensor(a, device=dev) for a in (xb, yb))
    else:
        replicate(tr.net, mesh)
        xs, ys = shard_grid_epoch(xb, yb, mesh)
    reset_launches()
    losses = tr.epoch_stacked(opt, xs, ys, mesh).cpu().numpy()
    return dict(losses=losses, p0=p0, p=flat_params(tr.net),
                per_rank=int(xs.shape[1]),
                launches=sum(launches_of(*KERNELS).values()))


def multi_rank(rank: int, work: str) -> None:
    """One gloo rank of phase 24 on the card (``--multi-rank``): the fused
    shard steps, both data-parallel serving lanes and the FNO2d epoch, its
    results to ``work/rank{rank}.npz``."""
    from fast_eng_super_resolution_tpu_torch.parallel.mesh import make_mesh
    from fast_eng_super_resolution_tpu_torch.utils.env import init_distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    init_distributed(rank, MULTI_WORLD, f"file://{work}/pg", backend="gloo",
                     device=spec["device"])
    mesh = make_mesh(spec["device"])
    dev = mesh.device
    out = {"mesh": np.array([mesh.size, mesh.rank])}
    cfg = spec["cfg"]
    ds = init_dataset("synthetic", **cfg)
    batch = multi_batch(ds)
    lr = load_yaml(cfg["train_config"])["lr"]
    for dtype in MULTI_DTYPES:
        r = multi_steps(make_model(cfg).to(dev), batch, dtype, lr, dev, mesh,
                        timed=MULTI_TIMED if dev.type == "cuda" else 0)
        out.update(_prefixed(f"steps/{dtype}", r))
        for exp, c in (("full", cfg), ("routed", spec["cfg_routed"])):
            r = multi_serve(ds, spec["log_dir"], exp, c, dtype, dev, mesh)
            out.update(_prefixed(f"serve/{exp}/{dtype}", r))
    out.update(_prefixed("grid", multi_grid(spec["grid"], dev, mesh)))
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)


def _prefixed(prefix: str, r: dict) -> dict:
    """A result dict flattened to npz keys under ``prefix``."""
    out = {}
    for k, v in r.items():
        if isinstance(v, dict):
            out.update({f"{prefix}/{k}/{kk}": np.asarray(vv)
                        for kk, vv in v.items()})
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _unprefixed(arrays: dict, prefix: str) -> dict:
    out = {}
    for k, v in arrays.items():
        if not k.startswith(prefix + "/"):
            continue
        head, _, tail = k[len(prefix) + 1:].partition("/")
        if tail:
            out.setdefault(head, {})[tail] = v
        else:
            out[head] = v if v.ndim else v.item()
    return out


def _param_errs(got: dict, want: dict, p0: dict) -> tuple:
    """(the L2 of the update difference relative to the single run's update,
    the max abs error) of parameter trees ``got`` and ``want`` from
    ``p0``."""
    du = sum(float(np.sum(((got[k] - p0[k]) - (want[k] - p0[k])) ** 2))
             for k in want)
    u = sum(float(np.sum((want[k] - p0[k]) ** 2)) for k in want)
    abs_err = max(float(np.abs(got[k] - want[k]).max()) for k in want)
    return (du / max(u, 1e-30)) ** 0.5, abs_err


def _hold_params(label: str, got: dict, want: dict, p0: dict, tol: dict,
                 **extra) -> dict:
    """Logs and holds ``got`` against ``want`` (elementwise rtol/atol, or
    the relative L2 of the update) and the losses."""
    if got["p"].keys() != want["p"].keys():
        raise AssertionError(f"{label}: parameter keys differ")
    upd, abs_err = _param_errs(got["p"], want["p"], p0)
    loss_rel = float(np.max(np.abs(got["losses"] - want["losses"])
                            / np.abs(want["losses"])))
    ok = loss_rel <= tol["loss"]
    if "update" in tol:
        ok &= upd <= tol["update"]
    else:
        ok &= all(np.allclose(got["p"][k], want["p"][k], rtol=tol["rtol"],
                              atol=tol["atol"]) for k in want["p"])
    log("multi", what=label, loss_rel=f"{loss_rel:.3e}",
        param_max_abs_err=f"{abs_err:.3e}", update_rel_l2=f"{upd:.3e}",
        tol=tol, losses=",".join(f"{v:.6g}" for v in got["losses"]), **extra)
    if not ok:
        raise AssertionError(f"{label}: losses {got['losses']} vs "
                             f"{want['losses']}, update rel {upd:.3e}, "
                             f"param max abs err {abs_err:.3e}")
    return dict(loss_rel=loss_rel, param_max_abs_err=abs_err,
                update_rel_l2=upd)


def _run(cmd: list, label: str, cwd: str, env: dict) -> str:
    """Runs ``cmd`` to its end (raising on a non-zero exit, with its
    output's tail); returns its output."""
    t0 = time.time()
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=MULTI_TIMEOUT)
    text = proc.stdout + proc.stderr
    log("multi", what=label, rc=proc.returncode,
        wall_s=f"{time.time() - t0:.1f}")
    if proc.returncode:
        raise AssertionError(f"{label} exited {proc.returncode}:\n"
                             f"{text[-4000:]}")
    return text


def multi_nccl(work: str) -> None:
    """Phase 24 (b)'s direct calls, under ``torchrun --nproc-per-node=1``
    (``--multi-nccl``): the process joins its NCCL group of one
    (``maybe_init_distributed``), and the fused shard step and the
    explicit-collective step over that group (their collectives through
    NCCL) are held against the single-device steps."""
    from fast_eng_super_resolution_tpu_torch.parallel.mesh import make_mesh
    from fast_eng_super_resolution_tpu_torch.utils.env import (
        finalize_distributed, maybe_init_distributed)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    on_card = spec["device"].startswith("cuda")
    # on the card: the rank's own card and NCCL, as the CLI joins
    if not maybe_init_distributed(device=None if on_card else "cpu"):
        raise AssertionError("FESR_MULTIHOST=1 did not join a group")
    mesh = make_mesh(None if on_card else "cpu")
    dev = mesh.device
    cfg = spec["cfg"]
    ds = init_dataset("synthetic", **cfg)
    batch = multi_batch(ds)
    lr = load_yaml(cfg["train_config"])["lr"]
    out = {"mesh": [mesh.size, mesh.rank, mesh.backend, str(mesh.device)]}
    for dtype in MULTI_DTYPES:
        one = multi_steps(make_model(cfg).to(dev), batch, dtype, lr, dev)
        grp = multi_steps(make_model(cfg).to(dev), batch, dtype, lr, dev,
                          mesh)
        out[f"fused_{dtype}"] = _hold_params(
            f"nccl_fused_{dtype}", grp, one, one["p0"],
            MULTI_STEP_TOL[dtype], launches=grp["launches"])
        out[f"fused_{dtype}"]["launches"] = grp["launches"]
    # the explicit-collective step (plain apply) against the merged step
    res = {}
    for m in (None, mesh):
        model = make_model(cfg).to(dev)
        p0 = flat_params(model)
        tr = Trainer(model, lr=lr, layout="merged" if m is None else "batched")
        opt = tr.init()
        if m is None:
            data, step = merge_batch(batch)[0].to_torch(dev), tr.step
        else:
            data = shard_batch(pad_batch_to_multiple(batch, m.size)[0], m)
            step = tr.make_shard_map_step(m)
        res[m is None] = dict(losses=np.array([float(step(opt, data))
                                               for _ in range(MULTI_STEPS)]),
                              p=flat_params(model))
    out["shard_map"] = _hold_params("nccl_shard_map", res[False], res[True],
                                    p0, MULTI_STEP_TOL["float32"])
    finalize_distributed()
    with open(os.path.join(work, "nccl.json"), "w") as f:
        json.dump(out, f)


def phase_multi(root: str, datasets: dict, cfgs: dict, cfgs_rt: dict,
                smi: str, dev=torch.device("cuda", 0)) -> dict:
    """Phase 24: multi-device training and serving through
    ``torch.distributed`` on the one card.  (a) Two gloo ranks, spawned
    processes on the same card, against one process: the fused shard step
    (B1/B2 on each rank's group of 6 of the 12 training subdomains, bf16
    and float32), ``predict_full``'s lanes fast_mc and routed_mc on full
    mesh 0, and one FNO2d data-parallel epoch.  (b) NCCL at world size 1:
    ``torchrun`` trains (``FESR_STEP_IMPL=shard_map_fused``) and serves
    through the CLI, and the shard steps run over that group.  Returns the
    B1/B2 launches by path."""
    t0 = time.time()
    work = os.path.join(root, "multi")
    os.makedirs(work, exist_ok=True)
    log_dir = os.path.join(root, "logs")
    cfg, ds = cfgs["full"], datasets["full"]
    grid = multi_grid_config()
    spec = dict(cfg=cfg, cfg_routed=cfgs_rt["full"], log_dir=log_dir,
                grid=grid, device=str(dev))
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="4")
    me = os.path.abspath(__file__)
    # (a) the references of one process first, then the two ranks alone on
    # the card (their step times are not shared with this process's work)
    lr = load_yaml(cfg["train_config"])["lr"]
    batch = multi_batch(ds)
    refs = {}
    for dtype in MULTI_DTYPES:
        refs[("steps", dtype)] = multi_steps(
            make_model(cfg).to(dev), batch, dtype, lr, dev,
            timed=MULTI_TIMED if dev.type == "cuda" else 0)
        for exp, c in (("full", cfg), ("routed", cfgs_rt["full"])):
            refs[(exp, dtype)] = multi_serve(ds, log_dir, exp, c, dtype, dev)
    refs["grid"] = multi_grid(grid, dev)
    logs = [open(os.path.join(work, f"rank{r}.log"), "w")
            for r in range(MULTI_WORLD)]
    procs = [subprocess.Popen([sys.executable, me, "--multi-rank", str(r),
                               work], env=env, stdout=f,
                              stderr=subprocess.STDOUT)
             for r, f in enumerate(logs)]
    try:
        codes = [p.wait(timeout=MULTI_TIMEOUT) for p in procs]
    finally:  # a failed rank leaves its peer waiting in a collective
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, code in enumerate(codes):
        if code:
            with open(os.path.join(work, f"rank{r}.log")) as f:
                text = f.read()
            raise AssertionError(f"multi rank {r} exited {code}:\n"
                                 f"{text[-4000:]}")
    outs = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
            for r in range(MULTI_WORLD)]
    by_path = {}
    for r, o in enumerate(outs):
        if tuple(o["mesh"]) != (MULTI_WORLD, r):
            raise AssertionError(f"rank {r}: mesh {o['mesh']}")
        b1 = b2 = 0
        for dtype in MULTI_DTYPES:
            got = _unprefixed(o, f"steps/{dtype}")
            want = refs[("steps", dtype)]
            # every rank must hold the parameters the single process does
            _hold_params(f"fused_step_{dtype}_rank{r}", got, want,
                         want["p0"], MULTI_STEP_TOL[dtype],
                         b1=got["launches"]["fused_edge_conv"],
                         b2=got["launches"]["fused_edge_conv_bwd"],
                         step_ms=got.get("step_ms"),
                         single_step_ms=want.get("step_ms"), card=repr(smi))
            depth_steps = cfg["num_layers"] * MULTI_STEPS
            if dev.type == "cuda" and (
                    got["launches"]["fused_edge_conv"] != depth_steps
                    or got["launches"]["fused_edge_conv_bwd"] != depth_steps):
                raise AssertionError(f"rank {r} {dtype}: launches "
                                     f"{got['launches']}, want {depth_steps}")
            b1 += int(got["launches"]["fused_edge_conv"])
            b2 += int(got["launches"]["fused_edge_conv_bwd"])
            for exp, lane in (("full", "fast_mc"), ("routed", "routed_mc")):
                got = _unprefixed(o, f"serve/{exp}/{dtype}")
                want = refs[(exp, dtype)]
                tol = MULTI_SERVE_TOL[(lane, dtype)]
                err = rel_err(got["pred"], want["pred"])
                ref_err = rel_err(got["ref"], want["ref"])
                log("multi", what=f"{lane}_{dtype}_rank{r}",
                    lane=got["lane"], single_lane=want["lane"],
                    max_rel_err=f"{err:.3e}", ref_rel_err=f"{ref_err:.3e}",
                    tol=tol, b1=int(got["launches"]))
                if (got["lane"] != lane or not err <= tol
                        or not ref_err <= 1e-6
                        or (dev.type == "cuda" and not got["launches"])):
                    raise AssertionError(f"{lane} {dtype} rank {r}: lane "
                                         f"{got['lane']}, err {err:.3e}")
                b1 += int(got["launches"])
        got = _unprefixed(o, "grid")
        _hold_params(f"fno2d_epoch_rank{r}", got, refs["grid"],
                     refs["grid"]["p0"], MULTI_GRID_TOL,
                     per_rank=got["per_rank"],
                     batch=grid["batch_size"], launches=got["launches"])
        if got["launches"]:
            raise AssertionError(f"rank {r}: the grid epoch launched B1-B5")
        by_path[f"multi_gloo_rank{r}"] = (b1, b2)
    log("multi", what="gloo_ranks", card=repr(smi), world=MULTI_WORLD,
        launches={k: v for k, v in by_path.items()})

    # (b) NCCL at world size 1 through torchrun
    exp_cfg = {k: v for k, v in cfg.items()
               if k not in ("model", "train_config", "train_epochs")}
    if dev.type == "cpu":
        exp_cfg["device"] = "cpu"
    train_cfg = dict(load_yaml(cfg["train_config"]), epochs=MULTI_EPOCHS,
                     val_interval=1)
    for name, c in (("exp.yaml", exp_cfg), ("train.yaml", train_cfg)):
        with open(os.path.join(work, name), "w") as f:
            json.dump(c, f)  # JSON is YAML
    run = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node=1"]
    cli = ["-m", "fast_eng_super_resolution_tpu_torch", "--model=neuralop",
           "--dataset=synthetic", "--exp_name=multi_nccl",
           "--exp_config=exp.yaml", "--train_config=train.yaml"]
    env = dict(env, FESR_MULTIHOST="1", FESR_STEP_IMPL="shard_map_fused")
    # the direct calls (a group of their own) run beside the CLI's two
    t1 = time.time()
    direct_log = open(os.path.join(work, "direct.log"), "w")
    direct = subprocess.Popen(run + [me, "--multi-nccl", work], cwd=work,
                              env=env, stdout=direct_log,
                              stderr=subprocess.STDOUT)
    try:
        _run(run + cli + ["--mode=train"], "torchrun_train", work, env)
        logs = os.path.join(work, "logs")
        for path in (os.path.join(logs, "models", "collection_multi_nccl",
                                  "partition_0.npz"),
                     os.path.join(logs, "metrics",
                                  "multi_nccl_partition_0.jsonl")):
            if not os.path.exists(path):
                raise AssertionError(f"torchrun train wrote no {path}")
        _run(run + cli + ["--mode=pred"], "torchrun_pred", work, env)
        for idx in cfg["idxs"]:
            fields = read_vtu(os.path.join(logs, "vtk", "multi_nccl",
                                           f"pred_{idx}.vtu"))["point_data"]
            if not all(np.all(np.isfinite(v)) for v in fields.values()):
                raise AssertionError(f"torchrun pred_{idx}.vtu not finite")
        log("multi", what="torchrun_cli", vtu=len(cfg["idxs"]), finite=True)
        code = direct.wait(timeout=MULTI_TIMEOUT)
    finally:
        if direct.poll() is None:
            direct.kill()
            direct.wait()
        direct_log.close()
    log("multi", what="torchrun_direct", rc=code,
        wall_s=f"{time.time() - t1:.1f}")
    if code:
        with open(os.path.join(work, "direct.log")) as f:
            raise AssertionError(f"torchrun direct calls exited {code}:\n"
                                 f"{f.read()[-4000:]}")
    with open(os.path.join(work, "nccl.json")) as f:
        nccl = json.load(f)
    log("multi", what="nccl_group", mesh=nccl["mesh"],
        **{k: v for k, v in nccl.items() if k != "mesh"})
    if nccl["mesh"][:3] != [1, 0, "nccl" if dev.type == "cuda" else "gloo"]:
        raise AssertionError(f"torchrun's group: {nccl['mesh']}")
    b1 = sum(nccl[f"fused_{d}"]["launches"]["fused_edge_conv"]
             for d in MULTI_DTYPES)
    b2 = sum(nccl[f"fused_{d}"]["launches"]["fused_edge_conv_bwd"]
             for d in MULTI_DTYPES)
    by_path["multi_nccl_direct"] = (b1, b2)
    log("multi", wall_s=f"{time.time() - t0:.1f}")
    return by_path


# -- phase 25: closing ----------------------------------------------------------

# 'edge' against 'edge3d' (float32, TF32 off): the same per-edge matrices
# contracted as c_in slice-MACs or as one batched einsum, through 4-5 layers
# and the overlap average: the conv modes' tolerance, 1e-4 of the max.
EDGE_TOL = 1e-4
# FESR_LOSS_VJP=custom against autograd on the card: the JAX package's bounds
# for the same comparison (tests/test_ops.py), the value within 1e-4
# relative and both gradients within 1e-5 in relative L2.
LOSS_VALUE_TOL, LOSS_GRAD_TOL = 1e-4, 1e-5
# Three fused float32 train steps with the custom backward against the same
# steps with autograd's: the JAX package's step tolerances (losses rtol
# 1e-5, parameters rtol 1e-3 / atol 1e-5); the card against the CPU's merged
# steps as phase 7 holds them (1e-4).
CUSTOM_STEP_TOL = dict(loss=1e-5, rtol=1e-3, atol=1e-5)
CLOSING_STEPS = 3


def closing_edge(root: str, datasets: dict, paths: dict, smi: str) -> None:
    """Conv mode 'edge' end to end: for each (label -> (cfg, exp tag)) of
    ``paths`` the model in 'edge' and in 'edge3d' serves full mesh 0 from
    exp ``full{tag}``'s checkpoint through the general lane (float32), no
    kernel launched; the fields agree; each mode's warm request time."""
    log_dir = os.path.join(root, "logs")
    with env_set("FESR_FUSED_PREDICT", "0"):
        for label, (cfg, tag) in paths.items():
            fields = {}
            for mode in ("edge", "edge3d"):
                model = make_mode_model(cfg, mode)
                reset_launches()
                lanes, (f,) = serve(datasets["full"], model, [0], log_dir,
                                    "full" + tag, None)
                ms, _ = warm_request(datasets["full"], model, log_dir,
                                     "full" + tag)
                if lanes[0][1] != "general":
                    raise AssertionError(f"{label} {mode} took lane "
                                         f"{lanes[0][1]}")
                check_only(f"closing {label} {mode} requests", {})
                fields[mode] = f
                log("closing", model=label, mode=mode, lane=lanes[0][1],
                    nodes=len(f["pressure"]), request_ms=f"{ms:.4f}",
                    card=repr(smi), **launches_of(*KERNELS))
            for key in ("velocity", "pressure"):
                hold("closing", f"{label}_edge_vs_edge3d_{key}",
                     fields["edge"][key], fields["edge3d"][key], EDGE_TOL)


def closing_edge_train(small_merged, cfg: dict) -> None:
    """Three merged float32 train steps of KernelNN in mode 'edge' on the
    small mesh, on the card and on the CPU from the same seeded weights: the
    losses agree, and no kernel is launched."""
    lr = load_yaml(cfg["train_config"])["lr"]
    losses = {}
    reset_launches()
    for dev in ("cuda", "cpu"):
        trainer = Trainer(make_mode_model(cfg, "edge").to(dev), lr=lr)
        opt = trainer.init()
        batch = small_merged.to_torch(dev)
        losses[dev] = np.array([float(trainer.step(opt, batch))
                                for _ in range(CLOSING_STEPS)])
    check_only("closing edge train steps", {})
    hold("closing", "kernelnn_edge_merged_steps_card_vs_cpu",
         losses["cuda"], losses["cpu"], PARITY_TOL,
         losses=",".join(f"{v:.8g}" for v in losses["cuda"]))


def closing_loss(ds, smi: str) -> None:
    """``gradient_weight_scalar`` with the training call's arguments on the
    full request's chunk (a seeded perturbation of its target as the
    prediction), custom backward against autograd on the card, and the
    forward + backward ms of each."""
    merged, n_sub = request_chunk(ds)
    g = merged.to_torch("cuda")
    rng = np.random.default_rng(SEED)
    y = np.asarray(merged.y)
    pred = torch.as_tensor(
        (y + 0.1 * y.std() * rng.standard_normal(y.shape)).astype(np.float32),
        device="cuda")

    def fwd_bwd():
        p = pred.clone().requires_grad_(True)
        t = g.y.clone().requires_grad_(True)
        w = gradient_weight_scalar(p, t, g.senders, g.receivers, g.edge_attr,
                                   g.edge_mask, g.node_mask, min_weight=0.0)
        w.backward()
        return w.detach(), p.grad, t.grad

    got, ms = {}, {}
    for impl in ("xla", "custom"):
        with env_set("FESR_LOSS_VJP", impl):
            got[impl] = fwd_bwd()
            ms[impl] = cuda_ms(fwd_bwd)
    (va, *ga), (vb, *gb) = got["xla"], got["custom"]
    value_rel = abs(float(vb) - float(va)) / max(abs(float(va)), 1.0)
    grad_rel = [float(torch.linalg.norm(b - a) / torch.linalg.norm(a))
                for a, b in zip(ga, gb)]
    log("closing", check="loss_custom_vs_autograd", subdomains=n_sub,
        nodes=merged.x.shape[0], edges=merged.senders.shape[0],
        real_edges=int(np.asarray(merged.edge_mask).sum()),
        value=f"{float(vb):.8g}", value_rel=f"{value_rel:.3e}",
        grad_pred_rel_l2=f"{grad_rel[0]:.3e}",
        grad_target_rel_l2=f"{grad_rel[1]:.3e}",
        tol=(LOSS_VALUE_TOL, LOSS_GRAD_TOL),
        autograd_ms=f"{ms['xla']:.4f}", custom_ms=f"{ms['custom']:.4f}",
        card=repr(smi))
    if not (value_rel <= LOSS_VALUE_TOL
            and max(grad_rel) <= LOSS_GRAD_TOL
            and float(torch.linalg.norm(ga[0])) > 0):
        raise AssertionError(f"custom loss backward: value {value_rel:.3e}, "
                             f"gradients {grad_rel}")


def closing_fused_custom(ds, cfg: dict, smi: str) -> list:
    """Three fused float32 train steps (B1 forward, B2 backward) of the
    train cell's batch (the 12 training subdomains merged) with
    ``FESR_LOSS_VJP=custom`` against the same steps without it; B1 and B2
    launched depth times per step in each; then the same custom steps in the
    merged layout on the CPU ('edge3d', plain torch: ``closing_cpu_steps``,
    from the reference worker where it ran them) against the card's.
    Returns B1's and B2's launches."""
    model0, (fb, _), rows_blk, blk = train_batches(ds, cfg)
    depth = cfg["num_layers"]
    lr = load_yaml(cfg["train_config"])["lr"]
    p0 = flat_params(model0)
    del model0
    runs, launches, wall_ms = {}, [0, 0], {}
    for impl in ("xla", "custom"):
        with env_set("FESR_LOSS_VJP", impl):
            model = make_model(cfg).cuda()
            tr = Trainer(model, lr=lr, layout="fused", fused_rows_blk=rows_blk,
                         fused_blk=blk, fused_dtype="float32")
            opt = tr.init()
            reset_launches()
            t0 = time.perf_counter()
            losses = np.array([float(tr.step(opt, fb))
                               for _ in range(CLOSING_STEPS)])
            # the steps' mean wall time, the first (cold) step included
            wall_ms[impl] = (time.perf_counter() - t0) / CLOSING_STEPS * 1e3
            want = depth * CLOSING_STEPS
            check_only(f"closing fused steps ({impl})",
                       {fused_conv.fused_edge_conv: want,
                        fused_conv.fused_edge_conv_bwd: want})
            launches[0] += fused_conv.fused_edge_conv.launches
            launches[1] += fused_conv.fused_edge_conv_bwd.launches
            runs[impl] = dict(losses=losses, p=flat_params(model))
            del tr, opt, model
    got, ref = runs["custom"], runs["xla"]
    loss_rel = float(np.max(np.abs(got["losses"] - ref["losses"])
                            / np.abs(ref["losses"])))
    upd, abs_err = _param_errs(got["p"], ref["p"], p0)
    ok = loss_rel <= CUSTOM_STEP_TOL["loss"] and all(
        np.allclose(got["p"][k], ref["p"][k], rtol=CUSTOM_STEP_TOL["rtol"],
                    atol=CUSTOM_STEP_TOL["atol"]) for k in ref["p"])
    log("closing", check="fused_custom_vs_autograd_steps",
        nodes=fb["graph"].x.shape[0], loss_rel=f"{loss_rel:.3e}",
        param_max_abs_err=f"{abs_err:.3e}", update_rel_l2=f"{upd:.3e}",
        tol=CUSTOM_STEP_TOL, b1_launches=launches[0],
        b2_launches=launches[1],
        losses=",".join(f"{v:.8g}" for v in got["losses"]),
        wall_ms_per_step_autograd=f"{wall_ms['xla']:.2f}",
        wall_ms_per_step_custom=f"{wall_ms['custom']:.2f}", card=repr(smi))
    if not ok:
        raise AssertionError(f"fused custom steps: losses {got['losses']} vs "
                             f"{ref['losses']}, param max abs err "
                             f"{abs_err:.3e}")
    ref = CPU_REFS.pop("closing", None)
    cpu, cpu_s = (ref.result() if ref is not None else
                  closing_cpu_steps(fb["graph"].map(lambda a: a.cpu()), cfg))
    del fb
    torch.cuda.empty_cache()
    hold("closing", "fused_custom_card_vs_merged_custom_cpu", got["losses"],
         cpu, PARITY_TOL, cpu_s=f"{cpu_s:.1f}",
         cpu="worker" if ref is not None else "here")
    return launches


def closing_timing(ds, cfg: dict) -> None:
    """One ``make_fused_shard_batches`` of the 12 training subdomains under
    ``FESR_TIMING=1``: its ``[fesr-timing]`` line is printed."""
    buf = io.StringIO()
    with env_set("FESR_TIMING", "1"), contextlib.redirect_stdout(buf):
        make_fused_shard_batches(multi_batch(ds), make_model(cfg).cuda(), 1,
                                 expand_s=False, device="cuda")
    text = buf.getvalue()
    print(text, end="", flush=True)
    lines = [ln for ln in text.splitlines() if ln.startswith(
        "[fesr-timing] make_fused_shard_batches: ")]
    stages = ("device_get=", "merge=", "scatter_build=", "stack_upload=")
    if len(lines) != 1 or not all(k in lines[0] for k in stages):
        raise AssertionError(f"FESR_TIMING=1 printed {text!r}")
    log("closing", check="fesr_timing", printed=True)


def phase_closing(root: str, datasets: dict, cfgs: dict, cfgs_tc: dict,
                  smi: str) -> list:
    """Phase 25: conv mode 'edge' (KernelNN and TEECNet requests, KernelNN
    merged training), the custom loss backward (alone at the full chunk,
    and inside fused training with B1/B2), and ``FESR_TIMING``.  Returns
    B1's and B2's launches."""
    t0 = time.time()
    walls = []

    def part(name, fn, *args):
        t1 = time.time()
        out = fn(*args)
        walls.append(f"{name}:{time.time() - t1:.1f}")
        return out

    part("edge", closing_edge, root, datasets,
         {"kernelnn": (cfgs["full"], ""),
          "teecnet": (cfgs_tc["full"], "_teecnet")}, smi)
    part("edge_train", closing_edge_train,
         merged_subdomains(datasets["small"]), cfgs["small"])
    part("loss", closing_loss, datasets["full"], smi)
    launches = part("fused_custom", closing_fused_custom, datasets["full"],
                    cfgs["full"], smi)
    part("timing", closing_timing, datasets["full"], cfgs["full"])
    log("closing", wall_s=f"{time.time() - t0:.1f}", parts=",".join(walls))
    return launches


def kernel_entries(r: dict, smi: str, rank, path: str) -> list:
    """The forward's and the backward's entries of the kernels JSON line,
    tagged with the ``path`` that ran them."""
    pkg = "fast_eng_super_resolution_tpu_torch/csrc/"
    # each type's numbers are its own source's: csrc/<name>_wgmma.cu
    # (bfloat16) or csrc/<name>_f32_wgmma.cu (float32)
    suffix = {"bfloat16": "_wgmma", "float32": "_f32_wgmma"}
    design = {dt: fused_conv.design(getattr(torch, dt), rank)
              for dt in suffix}
    if rank is None:
        names, lines = ("fused_edge_conv", "fused_edge_conv_bwd"), (322, 442)
    else:
        names = ("fused_edge_conv_lowrank", "fused_edge_conv_lowrank_bwd")
        lines = (637, 717)
    train, t, tb = r["train"], r["t"], r["tb"]
    entries = []
    for name, line, errs, times, launches, by_path, extra in (
            (names[0], lines[0], r["errs"], t,
             r["launches"] + train["fwd"] + train["served"],
             {"serve": r["launches"], "train": train["fwd"],
              "serve_trained": train["served"]},
             {key: t[key] for key in ("request_ms",) if key in t}),
            (names[1], lines[1], r["errs_bwd"], tb, train["bwd"],
             {"train": train["bwd"]},
             {key: t[key] for key in ("train_step_ms",) if key in t})):
        entries.append({
            "name": name,
            "path": path,
            "route": "cuda",
            "source": pkg + name + suffix["bfloat16"] + ".cu",
            "design": design["bfloat16"],
            "replaces": f"fast_eng_super_resolution_tpu/ops/fused_conv.py:{line}",
            "launches": launches,
            "launches_by_path": by_path,
            "max_abs_err": errs["bfloat16"],
            "ms": times["ms_bfloat16"],
            "plain_ms": times["plain_ms_bfloat16"],
            "bound_ms": times["bound_ms_bfloat16"],
            "bound_by": times["bound_by_bfloat16"],
            "library_ms": None,
            "float32": {"source": pkg + name + suffix["float32"] + ".cu",
                        "design": design["float32"],
                        "max_abs_err": errs["float32"],
                        **{key: times[f"{key}_float32"] for key in (
                            "ms", "plain_ms", "bound_ms", "bound_by",
                            "bound_basis", "bound_fma_ms")
                           if f"{key}_float32" in times}},
            **extra,
            "card": smi,
        })
    return entries


def rank12_entries(r: dict, smi: str) -> list:
    """B3's and B4's entries for the rank-12 path: its launches by phase
    and, under ``by_rank``, each timed rank's numbers in both types (time,
    plain time, bound and its basis, the padded rank and the ceiling r / rp
    of the bound's share a padded instance can reach)."""
    entries = kernel_entries(r, smi, RANK12, f"kernelnn_rank{RANK12}")
    trained = r["trained"]
    entries[0]["launches_by_path"] = {
        "serve": r["launches"],
        **{f"train_{dt}": n for dt, (n, _) in trained.items()}}
    entries[1]["launches_by_path"] = {
        f"train_{dt}": n for dt, (_, n) in trained.items()}
    for entry, key, errs in ((entries[0], "fwd", "max_abs_err"),
                             (entries[1], "bwd", "max_abs_err_bwd")):
        entry["by_rank"] = {
            str(rank): {"padded_rank": v["padded_rank"],
                        "ceiling": v["ceiling"],
                        **{f"{k}_{dt}": v[key][f"{k}_{dt}"]
                           for dt in ("bfloat16", "float32")
                           for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by")},
                        "max_abs_err": v[errs]}
            for rank, v in r["by_rank"].items()}
    return entries


def wide_entries(r: dict, smi: str) -> list:
    """B1's and B2's entries for a wide path (``kernelnn_w128``,
    ``kernelnn_w256``, ``kernelnn_w320``): launches by phase (KernelNN's
    serving and training in each type; at width 128 also TEECNet's request
    and epoch), the
    shapes held against the plain versions, and the plain versions' times
    on the chunk's leading slice beside the kernels'.  Past width 128
    TEECNet has entries of its own (``teecnet_w256``), with its B1's and
    B2's errors and times at its chunk (K 128; ``teecnet_w320`` too)."""
    width = r["width"]
    entries = kernel_entries(r, smi, None, f"kernelnn_w{width}")
    trained = r["trained"]
    entries[0]["launches_by_path"] = {
        "serve": r["launches"],
        **{f"train_{dt}": n for dt, (n, _) in trained.items()}}
    entries[1]["launches_by_path"] = {
        f"train_{dt}": n for dt, (_, n) in trained.items()}
    tc_by = ({"teecnet_serve": r["tc_served"],
              "teecnet_train_bfloat16": r["tc_trained"][0]},
             {"teecnet_train_bfloat16": r["tc_trained"][1]})
    if "tc" in r:
        tc = r["tc"]
        tc_entries = kernel_entries(
            dict(errs=tc["errs"], errs_bwd=tc["errs_bwd"],
                 launches=r["tc_served"], t=tc["t"], tb=tc["tb"],
                 train=dict(fwd=r["tc_trained"][0], bwd=r["tc_trained"][1],
                            served=0)), smi, None, f"teecnet_w{width}")
        for entry, by, times in zip(tc_entries, tc_by, (tc["t"], tc["tb"])):
            entry.update(launches_by_path=by, width=width, k=tc["k"],
                         plain_slots=times["plain_slots"],
                         ms_at_plain_slots=times["ms_at_plain_slots_bfloat16"])
            entry["float32"]["ms_at_plain_slots"] = times[
                "ms_at_plain_slots_float32"]
    else:
        tc_entries = []
        for entry, by, n in zip(entries, tc_by, (r["tc_served"]
                                                 + r["tc_trained"][0],
                                                 r["tc_trained"][1])):
            entry["launches"] += n
            entry["launches_by_path"].update(by)
    for entry, times in ((entries[0], r["t"]), (entries[1], r["tb"])):
        entry.update(width=width, k=width,
                     checked=[list(shape) for shape in r["checked"]],
                     plain_slots=times["plain_slots"],
                     ms_at_plain_slots=times["ms_at_plain_slots_bfloat16"])
        entry["float32"]["ms_at_plain_slots"] = times[
            "ms_at_plain_slots_float32"]
    entries[1]["train_step_ms_float32"] = r["t"]["train_step_ms_float32"]
    entries[1]["parity"] = r["parity"]
    return entries + tc_entries


def wide_rank_entries(r: dict, smi: str) -> list:
    """B3's and B4's entries for a wide rank-r path
    (``kernelnn_w128_rank32``, ``kernelnn_w256_rank32``): launches by phase
    (serving and training in each type at rank ``WIDE_RANK``, the top
    rank's request, if any), the shapes held against the plain versions with their
    errors, and under ``by_rank`` each timed rank's numbers in both types
    (the plain versions' on the chunk's leading slice)."""
    width = r["width"]
    entries = kernel_entries(r, smi, WIDE_RANK,
                             f"kernelnn_w{width}_rank{WIDE_RANK}")
    trained = r["trained"]
    entries[0]["launches"] += r["top_served"]
    entries[0]["launches_by_path"] = {
        "serve": r["launches"],
        **{f"train_{dt}": n for dt, (n, _) in trained.items()}}
    if r["top"] is not None:
        entries[0]["launches_by_path"][f"serve_rank{r['top']}"] = r["top_served"]
    entries[1]["launches_by_path"] = {
        f"train_{dt}": n for dt, (_, n) in trained.items()}
    for entry, key, times in ((entries[0], "fwd", r["t"]),
                              (entries[1], "bwd", r["tb"])):
        entry.update(width=width, k=width, rank=WIDE_RANK,
                     checked={at: e[key] for at, e in r["slice_errs"].items()},
                     plain_slots=times["plain_slots"],
                     ms_at_plain_slots=times["ms_at_plain_slots_bfloat16"])
        entry["float32"]["ms_at_plain_slots"] = times[
            "ms_at_plain_slots_float32"]
        entry["by_rank"] = {
            str(rank): {"padded_rank": v["padded_rank"],
                        "ceiling": v["ceiling"], "slabs": v["slabs"],
                        **{f"{k}_{dt}": v[key][f"{k}_{dt}"]
                           for dt in ("bfloat16", "float32")
                           for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "ms_at_plain_slots")}}
            for rank, v in r["by_rank"].items()}
    entries[1]["train_step_ms_float32"] = r["t"]["train_step_ms_float32"]
    entries[1]["parity"] = r["parity"]
    return entries


def routed_entries(r: dict, smi: str) -> list:
    """B1's and B2's entries for the routed path: B1's launches by phase
    (full-size routed predicts, the small mesh's routed lane, training)
    and the routed lane's warm time beside the full-size request's."""
    serve, train = r["serve"], r["train"]
    entries = kernel_entries(dict(r, launches=0, train=dict(train, served=0)),
                             smi, None, "kernelnn_routed")
    entries[0].update(
        launches=sum(serve.values()) + train["fwd"],
        launches_by_path={"serve_full": serve["full"],
                          "serve_full_padded": serve["full_padded"],
                          "serve_full_routed_lane": serve["full_lane"],
                          "serve_routed_lane": serve["small"],
                          "train": train["fwd"]},
        routed_lane_ms=r["t"]["routed_lane_ms"])
    return entries


def messages_entries(t: dict, launches: dict, requests: dict, smi: str,
                     small_b5: int, widest_small_b5: int) -> list:
    """B5's entries: the first with the numbers at KernelNN's chunk (K 48)
    at the top, those at TEECNet's (K 128) under ``teecnet_k128``, and each
    model's warm request time in modes 'pallas' and 'edge3d'; then one for
    each width-128 and width-256 path (``kernelnn_w128``, ``teecnet_w128``,
    ``kernelnn_w256``, ``teecnet_w256``: K = c_in = c_out = width, K 128
    for TEECNet) with its own launches, numbers and request times, the
    plain version's and the einsum's times on the chunk's first
    ``plain_edges`` edges (the kernel's there: ``ms_at_plain_edges``); the
    width-256 KernelNN's also counts the small mesh's ``small_b5`` launches
    and holds B5's errors at ``MSG_CHECKED`` (``checked``); the same for
    the width-320 paths (``kernelnn_w320``, ``teecnet_w320``: pieces of at
    most 256, launches counted one per piece), whose KernelNN counts
    ``widest_small_b5`` and holds B5's errors at ``WIDEST_CHECKED``."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bound_basis", "bound_fma_ms", "k")
    base = {
        "name": "fused_edge_messages",
        "route": "cuda",
        "source": "fast_eng_super_resolution_tpu_torch/csrc/"
                  "fused_edge_messages_wgmma.cu",
        "design": pallas_mp.design(),
        "replaces": "fast_eng_super_resolution_tpu/ops/pallas_mp.py:41",
        "card": smi,
    }
    entries = [dict(
        base, path="kernelnn_pallas",
        launches=launches["kernelnn"] + launches["teecnet"],
        launches_by_path={f"{k}_pallas": launches[k]
                          for k in ("kernelnn", "teecnet")},
        **{key: t["kernelnn"][key] for key in keys},
        teecnet_k128={key: t["teecnet"][key] for key in keys},
        request_ms={k: requests[k] for k in ("kernelnn", "teecnet")})]
    for width, small, checked in ((WIDE, None, None),
                                  (WIDER, small_b5, "checked"),
                                  (WIDEST, widest_small_b5, "checked_widest")):
        for label in (f"kernelnn_w{width}", f"teecnet_w{width}"):
            entries.append(dict(
                base, path=label, launches=launches[label],
                launches_by_path={f"{label}_pallas": launches[label]},
                **{key: t[label][key] for key in keys + (
                    "c_in", "c_out", "plain_edges", "ms_at_plain_edges")},
                request_ms=requests[label]))
        if small is not None:
            kernelnn = entries[-2]
            kernelnn["launches"] += small
            kernelnn["launches_by_path"]["small_pallas"] = small
            kernelnn["checked"] = dict(t[checked])
    return entries


def main() -> int:
    name, smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = PARITY_WORKER["t0"] = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root, \
            contextlib.ExitStack() as workers:
        cfgs = {"full": make_config(os.path.join(root, "full"), FULL),
                "small": make_config(os.path.join(root, "small"), SMALL)}
        # the rank-16 path: the same config with kernel_rank added, at a
        # smaller depth
        cfgs_lr = {k: dict(v, kernel_rank=RANK, num_layers=RANK_DEPTH)
                   for k, v in cfgs.items()}
        # the rank-12 path: the rank-16 path's config at kernel_rank 12
        cfgs_r12 = {k: dict(v, kernel_rank=RANK12)
                    for k, v in cfgs_lr.items()}
        # TEECNet: teecnet_ansys.yaml with the same synthetic meshes, hence
        # the same datasets
        cfgs_tc = {k: make_config(os.path.join(root, k), sizes,
                                  TEECNET_CONFIG, "teecnet", TEECNET_TRAIN,
                                  TEECNET_EPOCHS)
                   for k, sizes in (("full", FULL), ("small", SMALL))}
        # the width-128 path: neuralop_synthetic_w64.yaml at width 128 and
        # depth 2, and TEECNet's config at width 128, on the same meshes
        cfgs_w = {k: dict(make_config(os.path.join(root, k), sizes,
                                      W64_CONFIG),
                          width=WIDE, num_layers=WIDE_DEPTH)
                  for k, sizes in (("full", FULL), ("small", SMALL))}
        cfgs_wtc = {k: dict(v, width=WIDE) for k, v in cfgs_tc.items()}
        # the width-128 rank-r path: the width-128 path's config at
        # kernel_rank WIDE_RANK
        cfgs_wr = {k: dict(v, kernel_rank=WIDE_RANK) for k, v in cfgs_w.items()}
        # the width-256 path: the width-128 path's configs at width 256
        cfgs_w2 = {k: dict(v, width=WIDER) for k, v in cfgs_w.items()}
        cfgs_w2tc = {k: dict(v, width=WIDER) for k, v in cfgs_tc.items()}
        # the width-256 rank-r path: the width-256 path's config at
        # kernel_rank WIDE_RANK (and, for one request, WIDER_RANK_TOP)
        cfgs_w2r = {k: dict(v, kernel_rank=WIDE_RANK)
                    for k, v in cfgs_w2.items()}
        # the width-320 path: the width-128 path's configs at width 320
        cfgs_w3 = {k: dict(v, width=WIDEST) for k, v in cfgs_w.items()}
        cfgs_w3tc = {k: dict(v, width=WIDEST) for k, v in cfgs_tc.items()}

        # the build (nvcc processes, from a thread) while this thread makes
        # the meshes and the checkpoints, which need no kernel
        with concurrent.futures.ThreadPoolExecutor(1) as build_pool:
            build = build_pool.submit(locked_build)
            t1 = time.time()
            datasets = {"small": init_dataset("synthetic", **cfgs["small"])}
            log("data", mesh="small", subdomains=len(datasets["small"]),
                etl_s=f"{time.time() - t1:.1f}")
            cfgs_w2top = {k: dict(v, kernel_rank=WIDER_RANK_TOP)
                          for k, v in cfgs_w2.items()}
            models, models_lr, models_r12, models_tc = ({} for _ in range(4))
            models_w, models_wtc, models_wr = {}, {}, {}
            models_w2, models_w2tc, models_w2r, models_w2top = {}, {}, {}, {}
            models_w3, models_w3tc = {}, {}
            for key, cfg in cfgs.items():
                t1 = time.time()
                if key not in datasets:
                    datasets[key] = init_dataset("synthetic", **cfg)
                # the same seeded weights for the card's and the CPU's run
                logs = os.path.join(root, "logs")
                for exp, c, into in ((key, cfg, models),
                                     (key + "_r16", cfgs_lr[key], models_lr),
                                     (f"{key}_r{RANK12}", cfgs_r12[key],
                                      models_r12),
                                     (key + "_teecnet", cfgs_tc[key], models_tc),
                                     (f"{key}_w{WIDE}", cfgs_w[key], models_w),
                                     (f"{key}_w{WIDE}_teecnet", cfgs_wtc[key],
                                      models_wtc),
                                     (f"{key}_w{WIDE}r{WIDE_RANK}", cfgs_wr[key],
                                      models_wr),
                                     (f"{key}_w{WIDER}", cfgs_w2[key], models_w2),
                                     (f"{key}_w{WIDER}_teecnet", cfgs_w2tc[key],
                                      models_w2tc),
                                     (f"{key}_w{WIDER}r{WIDE_RANK}",
                                      cfgs_w2r[key], models_w2r),
                                     (f"{key}_w{WIDER}r{WIDER_RANK_TOP}",
                                      cfgs_w2top[key], models_w2top),
                                     (f"{key}_w{WIDEST}", cfgs_w3[key], models_w3),
                                     (f"{key}_w{WIDEST}_teecnet", cfgs_w3tc[key],
                                      models_w3tc)):
                    into[key] = write_checkpoint(logs, exp, c)
                    write_checkpoint(logs, exp + "_cpu", c)
                for k in ("root", "partition", "sub_size", "n_high", "n_low",
                          "num_cases"):
                    for other in (cfgs_tc, cfgs_w):
                        if other[key].get(k) != cfg.get(k):
                            raise AssertionError(f"path config {k} differs")
                log("data", mesh=key, subdomains=len(datasets[key]),
                    checkpoints_s=f"{time.time() - t1:.1f}")
            libs, build_s = build.result()
        log("build", seconds=f"{build_s:.1f}",
            libs=",".join(os.path.relpath(lib, REPO) for lib in libs),
            cpus=os.cpu_count(), affinity=len(os.sched_getaffinity(0)),
            torch_threads=torch.get_num_threads())
        log_ptxas()
        # phase 7's CPU side of every path, in the order they need it, on
        # the small mesh: started right after the build, so that the plain
        # steps (the longest host work of the run) overlap every phase
        small = {"kernelnn": cfgs["small"], f"rank{RANK}": cfgs_lr["small"],
                 f"rank{RANK12}": cfgs_r12["small"]}
        for w, c, ranks in ((WIDE, cfgs_w, (WIDE_RANK,)),
                            (WIDER, cfgs_w2, (WIDE_RANK, WIDER_RANK_TOP))):
            small[f"w{w}"] = c["small"]
            for r in ranks:
                small[f"w{w}r{r}"] = dict(c["small"], kernel_rank=r)
        small[f"w{WIDEST}"] = cfgs_w3["small"]
        small["teecnet"] = cfgs_tc["small"]
        parity_pool, parity = start_parity(
            merged_subdomains(datasets["small"]), small, root)
        workers.callback(parity_pool.shutdown, wait=True,
                         cancel_futures=True)
        workers.push(stop_on_error(PARITY_WORKER["pid"]))

        # the CPU references of the phases after the first path, in the
        # order they need them (the first path's own are computed in it)
        logs = os.path.join(root, "logs")
        refs = {}
        for mesh in ("full", "small"):
            refs[f"{mesh}_r16_cpu"] = (_ref_prediction,
                                       (mesh, cfgs_lr[mesh], logs,
                                        f"{mesh}_r16_cpu"))
        for mesh, cfg, exp in (
                ("full", cfgs_r12["full"], f"full_r{RANK12}_cpu"),
                ("small", cfgs_w["small"], f"small_w{WIDE}_cpu"),
                ("small", cfgs_wr["small"], f"small_w{WIDE}r{WIDE_RANK}_cpu"),
                ("small", cfgs_w2["small"], f"small_w{WIDER}_cpu"),
                ("small", cfgs_w2r["small"],
                 f"small_w{WIDER}r{WIDE_RANK}_cpu"),
                ("small", cfgs_w3["small"], f"small_w{WIDEST}_cpu"),
                ("full", cfgs_tc["full"], "full_teecnet_cpu"),
                ("small", cfgs_tc["small"], "small_teecnet_cpu")):
            refs[exp] = (_ref_prediction, (mesh, cfg, logs, exp))
        refs["closing"] = (_ref_closing, (cfgs["full"],))
        ref_pool = start_references(datasets, refs)
        workers.callback(ref_pool.shutdown, wait=True, cancel_futures=True)

        # the grid datasets are host numpy: generated in worker processes
        # while the kernel phases run (stopped before the directory goes)
        grid_cfgs = grid_configs(root)
        roll_cfgs = rollout_configs(root)
        mat_cfgs = mat_configs(root)
        jobs = {key: (_make_grid_data, (GRID[key]["dataset"], cfg))
                for key, (cfg, _) in grid_cfgs.items()}
        for key, (cfg, _) in roll_cfgs.items():
            jobs[ROLLOUT[key]["data"]] = (_make_grid_data,
                                          (ROLLOUT[key]["dataset"], cfg))
        jobs["mat_operator"] = (_write_darcy_mat,
                                (mat_path(mat_cfgs["operator"][0]),))
        data_pool, data_futures = start_data(jobs)
        workers.callback(data_pool.shutdown, wait=True, cancel_futures=True)
        workers.callback(QUIET.clear)  # runs first
        full = run_path(root, name, smi, datasets, models, cfgs,
                        parity["kernelnn"])
        lowrank = run_path(root, name, smi, datasets, models_lr, cfgs_lr,
                           parity[f"rank{RANK}"], "_r16")
        rank12 = run_rank12(root, smi, datasets, models_r12, cfgs_r12,
                            parity[f"rank{RANK12}"])
        wide = run_wide(root, smi, datasets, models_w, cfgs_w, models_wtc,
                        cfgs_wtc, parity=parity[f"w{WIDE}"])
        wide_rank = run_wide_rank(
            root, smi, datasets, models_wr, cfgs_wr,
            parity={WIDE_RANK: parity[f"w{WIDE}r{WIDE_RANK}"]})
        wider = run_wide(root, smi, datasets, models_w2, cfgs_w2, models_w2tc,
                         cfgs_w2tc, WIDER, WIDER_CHECKED, WIDER_EPOCHS,
                         parity=parity[f"w{WIDER}"])
        wider_rank = run_wide_rank(
            root, smi, datasets, models_w2r, cfgs_w2r, WIDER,
            WIDER_RANK_CHECKED, WIDER_RANK_TIMED, WIDER_RANK_TOP,
            models_w2top["full"],
            parity={r: parity[f"w{WIDER}r{r}"]
                    for r in (WIDE_RANK, WIDER_RANK_TOP)})
        widest = run_wide(root, smi, datasets, models_w3, cfgs_w3,
                          models_w3tc, cfgs_w3tc, WIDEST, WIDEST_CHECKED,
                          WIDER_EPOCHS, parity=parity[f"w{WIDEST}"])
        teecnet = run_path(root, name, smi, datasets, models_tc, cfgs_tc,
                           parity["teecnet"], "_teecnet")
        t1 = time.time()
        wide_labels = (f"kernelnn_w{WIDE}", f"teecnet_w{WIDE}")
        wider_labels = (f"kernelnn_w{WIDER}", f"teecnet_w{WIDER}")
        widest_labels = (f"kernelnn_w{WIDEST}", f"teecnet_w{WIDEST}")
        pallas_launches, pallas_requests = phase_pallas(
            root, datasets, {"kernelnn": (cfgs["full"], ""),
                             "teecnet": (cfgs_tc["full"], "_teecnet"),
                             wide_labels[0]: (cfgs_w["full"], f"_w{WIDE}"),
                             wide_labels[1]: (cfgs_wtc["full"],
                                              f"_w{WIDE}_teecnet"),
                             wider_labels[0]: (cfgs_w2["full"], f"_w{WIDER}"),
                             wider_labels[1]: (cfgs_w2tc["full"],
                                               f"_w{WIDER}_teecnet"),
                             widest_labels[0]: (cfgs_w3["full"],
                                                f"_w{WIDEST}"),
                             widest_labels[1]: (cfgs_w3tc["full"],
                                                f"_w{WIDEST}_teecnet")}, smi)
        msg_ops = {"kernelnn": full["msg"], "teecnet": teecnet["msg"],
                   wide_labels[0]: wide.pop("msg"),
                   wide_labels[1]: wide.pop("tc_msg"),
                   wider_labels[0]: wider.pop("msg"),
                   wider_labels[1]: wider.pop("tc_msg"),
                   widest_labels[0]: widest.pop("msg"),
                   widest_labels[1]: widest.pop("tc_msg")}
        msg_t = phase_messages(
            msg_ops, smi, sliced=wide_labels + wider_labels + widest_labels)
        msg_t["checked"] = phase_messages_checked(msg_ops[wider_labels[0]])
        # B5 past 256 as pieces at the width-320 path's shapes, as (K,
        # c_in, c_out)
        msg_t["checked_widest"] = phase_messages_checked(
            msg_ops[widest_labels[0]],
            [(k, c_in, c_out) for c_in, c_out, k in WIDEST_CHECKED])
        del msg_ops
        log("pallas", wall_s=f"{time.time() - t1:.1f}")
        routed_cfg = load_yaml(ROUTED_CONFIG)
        cfgs_rt = {k: dict(v, n_clusters=routed_cfg["n_clusters"],
                           n_components=routed_cfg["n_components"])
                   for k, v in cfgs.items()}
        routed = run_routed(root, smi, datasets, cfgs_rt)
        coalesced = phase_coalesced(root, datasets["small"], models["small"],
                                    smi)
        t1 = time.time()
        phase_physics_ops(smi)
        smooth_launches = phase_physics_smooth(root, datasets, models, cfgs,
                                               smi)
        phase_physics_amg(smi)
        phase_physics_scale(smi)
        phase_wss(root, smi)
        log("physics", wall_s=f"{time.time() - t1:.1f}")
        t1 = time.time()
        phase_powerseries(root, datasets, cfgs_tc["full"])
        phase_lut(root, datasets, cfgs["full"])
        log("general_modes", wall_s=f"{time.time() - t1:.1f}")
        run_grid(grid_cfgs, root, data_futures)
        new_paths = {"rollout": run_rollout(roll_cfgs, root, data_futures,
                                            smi),
                     "mat": phase_mat(mat_cfgs, root, data_futures)}
        new_paths.update(phase_graphsage(root, datasets, cfgs, smi))
        new_paths.update(phase_host(root, datasets, models, cfgs, smi))
        multi = phase_multi(root, datasets, cfgs, cfgs_rt, smi)
        closing = phase_closing(root, datasets, cfgs, cfgs_tc, smi)
        # phase 7's card side of every path, the worker's steps ready by now
        run_parities()
        log("parity_worker", stopped_s=f"{PARITY_WORKER['stopped_s']:.1f}",
            unused_references=",".join(sorted(CPU_REFS)) or None)

    kernels = (kernel_entries(full, smi, None, "kernelnn")
               + kernel_entries(lowrank, smi, RANK, "kernelnn_rank16")
               + rank12_entries(rank12, smi)
               + wide_entries(wide, smi)
               + wide_rank_entries(wide_rank, smi)
               + wide_entries(wider, smi)
               + wide_rank_entries(wider_rank, smi)
               + wide_entries(widest, smi)
               + kernel_entries(teecnet, smi, None, "teecnet")
               + messages_entries(msg_t, pallas_launches, pallas_requests,
                                  smi, wider["small_b5"], widest["small_b5"])
               + routed_entries(routed, smi))
    # the coalesced lane serves the KernelNN path's small-mesh checkpoint
    kernels[0]["launches"] += coalesced["launches"]
    kernels[0]["launches_by_path"]["coalesced"] = coalesced["launches"]
    kernels[0]["coalesced_ms"] = {k: coalesced["t"][k]
                                  for k in ("batch_ms", "singles_ms")}
    # smooth: true serves through the same B1 lane before the projection
    kernels[0]["launches"] += smooth_launches
    kernels[0]["launches_by_path"]["smooth"] = smooth_launches
    # phases 20-23, each kernel's count under the first entry of its name
    # (0 everywhere but the traced KernelNN request's B1)
    first = {}
    for e in kernels:
        first.setdefault(e["name"], e)
    for path, counts in new_paths.items():
        for kernel, n in counts.items():
            first[kernel]["launches"] += n
            first[kernel]["launches_by_path"][path] = n
    # phase 24: B1/B2 in the ranks' own processes, counted there; phase
    # 25: the fused train steps with and without the custom loss backward
    for path, counts in dict(multi, closing=closing).items():
        for kernel, n in zip(("fused_edge_conv", "fused_edge_conv_bwd"),
                             counts):
            first[kernel]["launches"] += n
            first[kernel]["launches_by_path"][path] = n
    log("done", seconds=f"{time.time() - t0:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # phase 24's ranks run this file again, each in its own process
    if sys.argv[1:2] == ["--multi-rank"]:
        multi_rank(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1:2] == ["--multi-nccl"]:
        multi_nccl(sys.argv[2])
    else:
        sys.exit(main())
