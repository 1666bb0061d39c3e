#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``unet_bssfp_tpu_torch``) on one GPU.

  python3 chip_smoke.py

Phases (any failure → nonzero exit, no ``ok`` line):
1. The card's name and power limit; build of every kernel from the
   repository's sources (``nvcc`` for ``csrc/*.cu``, all at once).
2. Kernel checks: each kernel against its plain PyTorch version at the
   serving path's shapes, f32 and bf16, with its time, its bound (bytes over
   3.35 TB/s or operations over the peak of their type), the plain version's
   time and one PyTorch library call's time. In bf16 K1 is the wgmma kernel
   (``csrc/conv3x3_wgmma.cu``); beside it, its ``wguard`` form K1W at
   8 × 64 × 32 × 64·66 (W 64 + 2 guard columns, the flattened-lanes map;
   launched into memory just filled with NaN, its guards then exactly zero)
   and the ``mma.sync`` loop's check-only entry point
   (``conv3x3_packed_mma``) at K1's heaviest shape. The relayouts at the
   generator's 24-, 64- and 6-channel sides (K3a and K3b at C 6 take the
   kernel's narrow path). K4 (one cooperative launch, ``csrc/norm_act.cu``)
   at the 8 plain-layer stage shapes of serving under ``use_pallas``, f32
   and bf16, a rerun bit for bit, with its device time (profiler) beside
   its time per call.
3. Serving path: the full-width pc-bSSFP generator with seeded random
   weights serves one (96, 128, 128, 24) volume through ``predict_volume``,
   patch-stitched (8 × 64³) and whole-volume, with ``use_pallas`` off and
   on; launch counts of every serving kernel in that run; ms per volume
   (the four ways in turns, ``use_pallas`` on beside off); the
   f32 output of the packed kernel path against the same model on plain
   PyTorch/cuDNN, and the bf16 output's error against f32.
4. Training kernels: K2 (wgrad) and K1's dgrad against their plain versions
   at the training step's shapes (8 × 64³; forward convs 24/32/96 → 32),
   f32 and bf16, with time, bound, plain and library
   (``aten.convolution_backward``) times. In bf16 K2 is the wgmma kernel
   (``csrc/conv3x3_wgrad_wgmma.cu``); beside it, at 96 → 32, the
   ``mma.sync`` loop it replaced, through its check-only entry point
   ``conv3x3_wgrad_mma``. Then K10 (``csrc/packed_norm_act.cu``), the
   packed stages' norm → dropout → activation → cast chain, forward and
   backward, at the cases of ``scripts/torch_port_norm_act_times.py`` (the
   cells' shapes: GAN train 16 rows, serving 32 rows eval, the multi-stage
   PReLU widths 48 and 24, a whole volume, guards, f32 and odd rows), held
   to the plain chain's error against f64 on the card, reruns bit-equal,
   with time, device time, bound, plain and library (``F.instance_norm``
   + ``F.dropout`` + ``F.leaky_relu``) times.
5. Training path: full-width GAN training steps (``create_gan_state`` +
   ``make_train_step``, default config: bf16, packed, batch 8 × 64³);
   launch counts of one step against the expected ones; ms/step, patches/s
   and peak memory over 10 steps after 3 warm-ups, and the same with
   ``packed`` off (cuDNN); every loss finite. Before the timing, one bf16
   step through the kernels and one on cuDNN, each held against the f32
   cuDNN step (losses, BatchNorm running stats, every gradient). Then an f32
   gradient check (batch 2 × 64³, TF32 off): one generator-phase backward
   through the kernels (``packed``, ``use_pallas``) against plain
   PyTorch/cuDNN from the same weights and batch, every parameter's gradient.
   The serving, training and mesh runs send no conv and no weight gradient
   to an ``mma.sync`` loop (``conv3x3_packed_mma``,
   ``conv3x3_packed_mma_routed``, ``conv3x3_wgrad_mma`` and
   ``conv3x3_wgrad_mma_routed`` count 0).
6. K8 (scalar maps) against its plain version on brain-like tensors (30 %
   zero background, isotropic and planar voxels) at the full (96, 128, 128)
   volume and at (5, 7, 3), at the bound derived in
   ``ops/scalar_maps_check.py`` (bit-equality with the plain version is
   recorded, not required: the kernel contracts a·b + c into FMAs); a
   second launch bit for bit; time per call and device time, the bound (the
   largest of bytes, f32 operations and special-function operations at the
   SM clock read under load), plain time and ``torch.linalg.eigh``'s time.
7. Evaluation path: ``make_synthetic_bids`` writes 4 subjects at (96, 128,
   128) through the native NIfTI codec (subjects 01 and 02 in one thread,
   as this phase always had them, 03 and 04 in another; the tree is phase
   12's too); the full-width generator (seeded random weights, bf16,
   patch-stitched) predicts each subject's DT; ``eval_dwi_tensors`` (with
   ``constants/rescale_args_dwi.txt``) and ``calc_error_table`` run on the
   card with the launch counts reset before them (K8: 2 subjects × pred and
   target), then once more on subject 01's pair with one worker and the
   NIfTI I/O timed (its share of the chain recorded beside the codec in
   use), and on the CPU (plain versions); every file of the card's chain
   and its table against the CPU's, at the maps' bound carried through the
   chain.
8. ``predict --scalar-maps --rescale-args`` once on the card: 1 K8 launch,
   7 map files, held against the plain maps of the written prediction.
9. Halo kernels (with phase 4): K5 (``conv3x3_packed_halo``), its input
   gradient and its weight gradient against their plain versions at the
   mesh path's shard shapes (B 8 × D_local 32 × 64² and B 1 × D_local 48 ×
   128², 24/32/96 → 32), f32 and bf16, under the bounds of K1, K1's dgrad
   and K2, on halo slices that differ from every body slice; K5 on a zero
   halo bit-equal to K1; time, bound, plain and library times.
10. Mesh serving path: the same generator and volume served through
    ``make_predict_fn(gen, mesh)`` on (data, space) meshes whose positions
    all lie on ``cuda:0``: whole-volume on (1, 2) and (1, 1), patch-stitched
    on (2, 2). Exact launch counts of each; in f32 the sharded output against
    the unsharded port's and against plain PyTorch/cuDNN; bf16 against f32;
    ms per volume beside the unsharded path's, and peak memory. Then a
    full-width ``PackedTwoConv`` forward + backward on mesh (1, 2) against
    the same block unsharded (every gradient, exact counts of the three halo
    kernels). With two or more cards, the (1, 2) case once more over two of
    them; with one, a line says that it did not run.
11. The pfold and probe kernels: K7a (forward, dgrad and their halo forms)
    and K7b (and its halo form) against their plain versions at the four
    cases of ``scripts/pfold_probe.py`` in bf16 (B 8; 24/32/96 → 32 at 64³,
    24 → 32 at 96 × 128²), the first also in f32, the halo forms at a
    D_local-32 shard (96 → 32 bf16, 24 → 32 f32), and odd shapes (Cin 3
    and 5, W/4 2, 3 and 9, H 3) in both dtypes, under K1's and K2's bounds,
    each timed beside its library call and its bound. K7a is bit for bit the
    packed kernel its folded shape routes to on the same volume (bf16: K1's
    wgmma kernel at the probe cases, the ``mma.sync`` loop through
    ``conv3x3_packed_mma`` at the odd shapes; f32: K1's FMA kernel), K7b
    within K2's bound at its own plan's chain (bit for bit
    ``conv3x3_wgrad_mma`` or K2's FMA kernel where it runs those); K9a
    against its plain version and ``torch.roll`` (also past the 12,288
    elements its first kernel took), with both device times from the
    profiler; K9b's three modes (K1's wgmma kernel with template ``MODE``)
    against theirs at the conv0 shape, ``full`` bit for bit K1 with K1's
    time in its row. Then the two probe paths, each with the counts reset
    just before it and exact launch counts after it (``*_mma_routed`` 0 on
    both):
    ``scripts/torch_port_pfold_probe.py`` (``pfold_probe``) and
    ``scripts/torch_port_pallas_probe.py`` (``pallas_probe``).
12. The training data path: on phase 7's tree (4 subjects, val and test
    splits 0.25: 2 / 1 / 1 subjects), the codec's seconds per file (load
    and save of one 24-channel volume, native and pure-Python, their arrays
    bit-equal, ``nifti.codec()`` native); ``DoveDataModule`` with the
    default ``DataConfig`` otherwise (batch 8 × 64³, 8 patches a volume,
    ``augment_prob`` 0.1, 8 workers, seed 42) on ``cuda``: two epochs of
    ``train_batches`` (cold, then from ``cache_volumes``; ms per batch),
    every batch a CUDA tensor of (8, 64, 64, 64, 24) / (…, 6) with
    ``dwi-tensor_orig`` the clean patch at the stream's corners, one
    ``val_batches(augment=False)`` and one ``test_volumes`` pass; default
    GAN steps fed from ``train_batches``, the pristine ``dwi-tensor_orig``
    as the target as the JAX loop takes it (one step's launch counts reset
    just before it and held to ``TRAIN_STEP_LAUNCHES``: the
    ``train_from_data`` path; losses finite; ms per step; the device's busy
    share over a profiled window of steps); each of the seven augmentation
    applies on one (96, 128, 128, 24) volume on the card against its CPU
    apply on the same drawn parameters (1e-5·max|ref| for noise, gamma,
    blur, bias field and the rotation, 1e-4·max|ref| for spike, ghosting
    and motion), with each one's ms and the chain's at p = 1 and p = 0.1;
    the same seed's batches bit-identical with prefetch on and off, at the
    default p and at p = 1.
13. The training loop, on phase 12's tree (2 / 1 / 1 subjects), the
    default config at full width (bf16, 8 × 64³, ``packed``) with
    ``max_epochs`` 2 (3 made the phase take over a minute: every epoch's
    loads are cold, ≈ 7 s), ``checkpoint_top_k`` 2, ``log_clean_val`` on
    and the split of phase 12 (val and test 0.25): ``Trainer.fit`` on ``cuda`` from
    the data module (no volume cache: every epoch's loads are cold), with
    the launch counts reset just before it (the ``train_loop`` path):
    ``metrics.csv`` a row an epoch, every column finite; at most 2 step
    directories and ``config.json`` on disk; the counts exactly the train
    steps × ``TRAIN_STEP_LAUNCHES`` plus the eval steps ×
    ``EVAL_STEP_LAUNCHES`` (``*_mma_routed`` 0). Recorded: ms per epoch,
    each synchronised step beside its loop iteration (data wait included),
    each checkpoint's seconds and MB, the load's seconds, the device's busy
    share over one profiled epoch (the resume's below, its Trainer build
    and load included). The best checkpoint loaded into a fresh state gives
    the eval step's metrics on the fit's last val batch bit for bit the
    in-memory state's where the best is the last epoch, else finite ones;
    ``train_model(ckpt_path="auto", max_epochs=1)`` continues the step
    counter of the newest checkpoint. One default step with ``remat`` off
    and one on, from the same seed and the fit's last train batch, dropout
    on, cuDNN deterministic: every
    gradient, parameter and BatchNorm buffer and the dropout generator
    bit-equal, the remat step's launches ``REMAT_STEP_LAUNCHES`` (the
    ``train_step_remat`` path), each one's ms and peak MiB. Last, the
    ``CANONICAL_CPU`` regime (``scripts/torch_port_convergence.py``, from
    the JAX package's ``PRNGKey(42)`` weights) through the port's Trainer
    on the card, held to the band 6.487 ± 1.0 dB.
14. Evaluation from a checkpoint, on phase 13's best step and phase 12's
    tree (1 test subject at (96, 128, 128)), before both are deleted:
    ``python -m unet_bssfp_tpu_torch.eval PRED BIDS --checkpoint
    pc-bssfp=<best> --config <run>/config.json --rescale-args …`` in-process
    on ``cuda`` with the counts reset before it (the
    ``eval_from_checkpoint`` path: per test volume K1 4, K3a 2, K3b 1 and
    K8 2, nothing else); ``test_metrics.csv`` with finite PSNR, SSIM, L1
    and ``FID_random_features``, and a table with rows; its parts timed per
    test volume (load, inference, FID, saves, ``eval_model`` in all, the
    chain). With cuDNN deterministic: the written ``pred-0_…`` bit-equal to
    ``predict_volume`` of the step's generator on the same volume, and
    ``predict --checkpoint`` on the written ``input-0_…`` (no ``--config``;
    ``--scalar-maps``) bit-equal to it (the ``predict_checkpoint`` path: K1
    4, K3a 2, K3b 1, K8 1; 7 maps). The FID of those two files on the card
    (TF32 off) within 1e-3 relative of the CPU's, its ms. One default GAN
    step with ``with_perceptual: true`` (random features, bf16, no chunk)
    on phase 13's last train batch: exactly ``TRAIN_STEP_LAUNCHES`` (the
    ``train_step_perceptual`` path), a finite Perceptual term; its ms and
    peak MiB beside the plain step's.
15. The multi-stage regime (``train/multistage.py``), on phase 12's tree
    with the default config (bf16, ``packed``, the thesis widths 48 … 768,
    24; batch 8 × 64³), the runs cut to 1 epoch a stage and top-k 2. First
    K1 (with the N-24 form at 144 → 24), its dgrad (two N tiles of 72 at
    24 → 144) and K2 (two co tiles at Cout 48) at the MultiInputUNet's four
    full-resolution convs (24 → 48, 48 → 48, 144 → 24, 24 → 24), bf16,
    under K1's and K2's bounds, each rerun bit for bit, timed beside their
    bounds and library calls. Then ``run_multistage`` on pc-bssfp (PRETRAIN
    on dwi-tensor, TRANSFER, FINE_TUNE) with the counts reset before it (the
    ``multistage_run`` path: each stage's train steps ×
    ``MULTISTAGE_STAGE_LAUNCHES`` + its val steps × ``EVAL_STEP_LAUNCHES``,
    ``*_mma_routed`` 0): every stage's ``metrics.csv`` finite, its
    checkpoint on disk, TRANSFER's backbone bit-equal to PRETRAIN's. Then
    each stage's step on one resident batch with the counts reset (the
    ``multistage_{stage}_step`` paths: K1 4, K1's dgrad 4, K2 4 — 0 in
    TRANSFER, whose backbone stays bit for bit —, K3a 3, K3b 3): ms per step
    (median of 10) and peak MiB beside the same step on cuDNN, the epoch's
    seconds. Last, one f32 FINE_TUNE step through the kernels held per leaf
    to the same step on plain PyTorch/cuDNN (5e-2 relative L2, as the GAN
    step's check).
16. The sharded training step (``make_train_step(mesh=…)``) on (data,
    space) meshes whose positions all lie on ``cuda:0``: (2, 1), (2, 2) and
    (1, 2), the default config (bf16, ``packed``, full width, batch 8 ×
    64³) with dropout 0 (a mesh draws its masks per shard). In f32 through
    the kernels each mesh's step against the unsharded step from the same
    weights and batch: the losses within 1e-4 relative (the discriminator
    loss, which sees the updated generator, 1e-2), every generator-phase
    gradient within 5e-2 relative L2 (a conv bias before a norm: 1e-4 of
    the largest); after one train-mode forward of G and D, every BatchNorm
    statistic within 1e-5·max|ref|. In bf16 each mesh's first step with the
    counts reset just before it (the ``sharded_train_step`` path: every
    shard launches ``TRAIN_STEP_LAUNCHES``, in the halo forms K5, K5-dgrad
    and K5-wgrad on a space split, ``sharded_launches``), its losses no
    further from f32 than 3× the unsharded bf16 step's distance + 2^-8,
    then ms per step (median of 10 after 3), peak MiB and the device's busy
    share over 3 profiled steps beside the unsharded step; ``ddp_parity`` on (2, 1) likewise, its losses and
    statistics other than the global mode's. One f32 eval step on (2, 2)
    (``sharded_eval_step``): exact launches, metrics within 1e-5 relative
    of the unsharded step's. ``Trainer(mesh=(2, 2))`` fits one epoch on
    phase 12's tree (``sharded_trainer_fit``: train steps × the (2, 2)
    step's launches + eval steps × the (2, 2) eval step's); its checkpoint
    loads into an unsharded state bit for bit. One supervised step of each
    multi-stage stage on (2, 2) at the thesis widths
    (``sharded_multistage_step``: K5-wgrad 0 in TRANSFER, whose backbone
    stays bit for bit), timed.
17. The serving artifact and the public surface, on phase 12's tree and
    phase 14's outputs. ``export_generator`` of the full-width generator
    (seeded random weights) at (1, 96, 128, 128, 24) on the card, bf16 (the
    default config) and f32, saved and loaded (seconds, MB); ``predict
    --exported --scalar-maps`` of the bf16 artifact on subject 01's input
    with the counts reset just before it (the ``predict_exported`` path: K8
    once and nothing else, the artifact holding ATen ops only; 7 maps); its
    prediction against ``predict_volume`` (whole volume, packed) of the same
    weights: in f32 within 1e-3·max|ref|, in bf16 no further from the f32
    output than 3× the packed bf16 output's distance + 2^-8; ms per volume
    of each, bf16 and f32 (median of 5 rounds in turns after a warm-up).
    ``bSSFPToDWITensorModel(...).init(SEED)`` takes 3 steps on resident 8 ×
    64³ batches (``surface_gan_step``: each exactly ``TRAIN_STEP_LAUNCHES``),
    its losses bit for bit ``make_train_step``'s on a state of the same seed
    (cuDNN deterministic), then ms per step. ``MultiInputUNetModel``:
    PRETRAIN step → TRANSFER to pc-bSSFP, step → FINE_TUNE, step
    (``surface_multistage_{stage}_step``: each
    ``MULTISTAGE_STAGE_LAUNCHES``; the backbone bit for bit over the
    TRANSFER step; FINE_TUNE at ``finetune_lr``), each timed. Last the
    plots CLI on phase 14's ``relative_errors`` table and
    ``test_metrics.csv``, which must write its 11 files (where pandas or
    matplotlib is not installed, a line says that it did not run).
18. The wguard layout (``UNET_BSSFP_WGUARD=1``, set for this phase alone
    and put back after it, also on a failure): 2 zero guard columns a
    w-row at 64² (row width 66) and at 128² (130). First K1W (the wgmma
    kernel's flattened-lanes map) and its dgrad at every guarded shape of
    the paths below: the GAN step's 24/32/96 → 32 and their dgrads, the
    multi-stage step's 24 → 48, 48 → 48, 144 → 24 (N 24), 24 → 24 and their
    dgrads (24 → 144 on two N-72 tiles) at width 66, whole-volume serving's
    24/32/96 → 32 at width 130 (and the dgrad 32 → 96 there: the N-96
    form's two data tiles a row); then K2W, the guarded weight gradient as
    K2 on the guard-stripped operands, at 24/32/96 → 32, beside the
    ``mma.sync`` loop it replaces at 96 → 32. Each under K1's or K2's bound
    against its plain version, rerun bit for bit, timed beside its bound,
    the library call and the unguarded kernel on the unguarded tensor; each
    K1W and K1W-dgrad launched first into memory just filled with NaN (a
    freed tensor of the output's size, which ``torch.empty`` hands back),
    its guard columns then exactly zero and no voxel NaN. Then
    with the counts reset before each: ``predict_volume`` of the (96, 128,
    128, 24) volume patch-stitched and whole (``wguard_serving_patch``,
    ``_whole``: K1 4, K3a 2, K3b 1), f32 within 1e-3·max|ref| of
    PyTorch/cuDNN, bf16 no further from f32 than 3× the unguarded bf16 +
    2^-8, ms per volume (median of 5 in turns with the variable unset); a
    GAN step (``wguard_train_step``: ``TRAIN_STEP_LAUNCHES``) and a FINE_TUNE
    step at the thesis widths (``wguard_finetune_step``), each with its ms
    and peak MiB (median of 5 after 2) beside the unguarded step; phase 5's
    f32 backward check, guarded; one GAN step on (1, 2), dropout 0
    (``wguard_sharded_step``: ``sharded_launches``; in f32 phase 16's
    bounds against the unguarded unsharded step). No path sends a conv or a
    weight gradient to an ``mma.sync`` loop.
19. The quality path (``scripts/torch_port_{multistage_bench,
    oracle_ceiling,quality_record}.py``' functions in process), at full
    width on cohorts cut in size only, before phase 12's tree and phase
    13's run are deleted; nothing is written to the repository's records.
    The A/B of ``multistage_bench --two-cohort``: ``build`` with the
    pretrain cohort phase 12's tree (3/1/0 subjects at the scripts' splits
    of 0.2) and a target cohort of 3 linked subjects at (96, 128, 128),
    seed 1, ``link_tag_offset`` 10 (2/1/0), written by a child process
    while phases 15-17 run; 1 epoch a stage at 8 patches a volume (cut from
    32), MultiInputUNet at features (32, …, 32) in bf16 (its full-resolution
    convs the GAN generator's 24/32/96 → 32). With the counts reset before
    each arm: the multistage arm (``quality_ab_multistage``: each stage's
    train steps × ``MULTISTAGE_STAGE_LAUNCHES`` + val steps ×
    ``EVAL_STEP_LAUNCHES``) and the direct arm (``quality_ab_direct``: 3
    epochs of PRETRAIN-stage steps and val steps), both entries finite with
    the JAX script's keys. The oracle (``measure``, 1 augmented pass and
    the clean one) on phase 12's tree on the card: the map within 1e-5 of
    the fixture's numpy ``_linked_map`` on a val batch, the clean pass's
    PSNR, SSIM and L1 sums within 1e-4 relative of the same pass on the CPU.
    The judged summary (``judged_artifact`` without the denormalised second
    table) from phase 13's best step on phase 12's tree
    (``quality_judged``: K1 4, K3a 2, K3b 1 and K8 2 per test volume), its
    keys the JAX script's, its test metrics and diagonal median finite.
20. Training over distinct devices: meshes whose positions lie on cuda:0
    and on the host, ``Mesh([[cuda:0], [cpu]], ('data',))`` (2, 1) and
    ``Mesh([[cuda:0, cpu]], ('data', 'space'))`` (1, 2), one replica of the
    models on each, the replicas' gradients summed onto the card's masters
    and the new weights copied back. Full-width models, f32, TF32 off,
    ``packed=True``, dropout 0, batch 2 × 64³. With the counts reset before
    each: one GAN step on each mesh (``distinct_gan_step_2x1``, ``_1x2``)
    against the same mesh on cuda:0 alone from the same weights and batch
    (phase 16's f32 bounds, ``f32_step_failures``); the cuda:0 position
    launches one shard's kernels (``sharded_launches`` of one position: K1
    8, K1-dgrad 4, K2 4, K3a 5, K3b 4, in the K5 forms on (1, 2)), the host
    position none, cuda:0 alone two shards'; every replica bit-equal to its
    master after the step. One FINE_TUNE step at the thesis widths on (2, 1)
    (``distinct_finetune_step_2x1``), held the same way. One GAN step with
    the default dropout on (2, 1) (``distinct_dropout_step_2x1``), cuDNN
    deterministic: finite losses, replicas bit-equal, a rerun from the seed
    bit for bit (weights, buffers, both dropout generators); its checkpoint
    loads into a state on cuda:0 alone, the generator bit-equal to the
    master. The phase's seconds and the card's name and power limit on a
    line of their own.
21. Training across processes (``parallel/distributed.py``): two worker
    processes (``scripts/torch_port_multiprocess_step.py``) on cuda:0
    under gloo, device and backend named, each on 4 rows of one seeded
    8 × 64³ batch, the full-width model packed; this process steps on the
    whole batch as the one-process reference. (a) f32, dropout 0, lr 1e-6:
    one step's global metrics on every process within rtol 2e-5 (D's loss
    2e-2), atol 2e-6 of the reference's; (b) bf16, the default config, 3
    steps: the weights and buffers bit-equal across the processes, every
    step's launches on each process the one-process step's
    (``TRAIN_STEP_LAUNCHES``), the step's ms beside the reference's with
    the card's name and power limit, and a line saying the processes share
    one card. With two cards or more, the same with NCCL and a card each;
    else a line saying NCCL did not run. The capacity probe
    (``scripts/torch_port_capacity_probe.py``) for 1 epoch on its smoke
    fixture, its record written to a file of the phase.
22. The SwinUNETR generator (``models/swin_unetr.py``) at MONAI's BTCV
    widths behind the GAN's head: K1, K1's dgrad and K2 at its 96³
    instances (4 × 96 × C × 96·96, 24 → 48 and 48 → 48, bf16) and K10 as its
    residual blocks call it (no affine, no dropout, slope 0.01 and 1.0,
    forward and backward) against their plain versions; the generator on
    1 × 64³ against ``portbench/reference/swin_unetr.py`` in f32 and bf16;
    one GAN step on 4 × 96³ crops with its exact launches (``SWIN_STEP_LAUNCHES``: K1, K2 and K10 at the 96³
    48-channel instances, 16 window attention calls), ms a step and the
    peak, finite losses, the attention kernels SDPA picks, by name, with
    their device ms, and the device ops a step the Swin encoder adds (the
    step against one whose encoder answers from a cache).

Each phase's seconds go to a line of their own, ``{"phase": "seconds",
"name": ..., "s": ...}``, as it ends, and their sum to one more before the
``kernels`` line. The last line of standard output is ``{"ok": true,
"device": {...}}``; the line before it is the ``kernels`` JSON
(``launches_by_path``: the serving run's, one training step's, the eval
chain's, the mesh serving run's, the sharded block backward's, the two
probe paths', one data-fed training step's, the training loop's, one remat
step's, the evaluation from a checkpoint's, ``predict --checkpoint``'s, one
perceptual step's, the multi-stage run's and each of its stages' one step's
counts, and phase 16's: the sharded steps', eval step's, fit's and
supervised steps', phase 17's: ``predict --exported``'s, the GAN wrapper's 3
steps' and the multi-stage wrapper's steps', and phase 18's: the guarded
serving runs', GAN step's, FINE_TUNE step's and (1, 2) step's, phase
19's: the A/B's two arms' and the judged summary's, phase 20's: the
steps on the meshes over cuda:0 and the host, phase 21's: process 0's
f32 step and its 3 bf16 steps, and phase 22's Swin step;
``launches``: their sum); details go to ``perf_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3
PEAK_OPS = {"bfloat16": 989e12,           # dense tensor-core bf16
            "float32": 67e12}             # f32 outside the tensor cores
VOLUME = (96, 128, 128)
MODALITY = "pc-bssfp"
SEED = 0
TRAIN_BATCH, TRAIN_PATCH = 8, 64
SERVING_KERNELS = ("conv3x3_packed", "pack_hw", "unpack_hw",
                   "fused_instance_norm_leaky_relu", "packed_norm_act")
# Launches of one training step with the default config (use_pallas off,
# reuse_fake off): the generator runs twice (4 packed convs, 4 K10 chains
# after them, 2 packs and 1 unpack each) and back once (4 dgrad, 4 wgrad,
# 4 K10 backwards, 1 pack, 2 unpacks).
# The pfold and probe kernels run on the probe paths of phase 11 only.
PFOLD_KERNELS = ("conv3x3_pfold", "conv3x3_pfold_dgrad", "conv3x3_pfold_wgrad",
                 "conv3x3_pfold_halo", "conv3x3_pfold_halo_dgrad", "conv3x3_pfold_wgrad_halo")
PROBE_KERNELS = ("lane_roll", "conv3x3_probe_full", "conv3x3_probe_centre",
                 "conv3x3_probe_fixed")
TRAIN_STEP_LAUNCHES = {"conv3x3_packed": 8, "conv3x3_packed_dgrad": 4,
                       "conv3x3_wgrad": 4, "conv3x3_packed_halo": 0,
                       "conv3x3_packed_mma": 0, "conv3x3_packed_mma_routed": 0,
                       "conv3x3_wgrad_mma": 0, "conv3x3_wgrad_mma_routed": 0,
                       "conv3x3_packed_halo_dgrad": 0, "conv3x3_wgrad_halo": 0,
                       "pack_hw": 5, "unpack_hw": 4,
                       "fused_instance_norm_leaky_relu": 0, "scalar_maps": 0,
                       "packed_norm_act": 8, "packed_norm_act_backward": 4,
                       "window_attention": 0,
                       **dict.fromkeys(PFOLD_KERNELS + PROBE_KERNELS, 0)}
# Launches of one eval step (the generator's packed forward, no gradient):
# 4 packed convs, 4 K10 chains, 2 packs, 1 unpack.
EVAL_STEP_LAUNCHES = dict(dict.fromkeys(TRAIN_STEP_LAUNCHES, 0), conv3x3_packed=4,
                          pack_hw=2, unpack_hw=1, packed_norm_act=4)
# A step with ModelConfig.remat: the generator phase's backward recomputes
# the blocks it wraps (models/layers.py:remat); of those only the packed
# conv_0 and upcat_1 launch kernels, their 4 convs, 4 K10 chains and 2 packs
# once more.
REMAT_STEP_LAUNCHES = dict(TRAIN_STEP_LAUNCHES, conv3x3_packed=8 + 4, pack_hw=5 + 2,
                           packed_norm_act=8 + 4)
# Phase 22: a GAN step with the SwinUNETR generator (models/swin_unetr.py)
# at MONAI's BTCV widths on 4 × 96³ crops. A generator forward: 5 K1
# (encoder1's two convs; decoder1's conv1 as two 48 → 48 calls on the up
# and skip halves, and its conv2), 6 K10 (three norms a residual block), 2
# packs (the head's output, the upsample), 1 unpack and 8 window attention
# calls; a step runs it twice and back once (5 dgrad, 5 wgrad, 6 K10
# backwards, 1 pack, 2 unpacks; SDPA's backward is autograd's).
SWIN_BATCH, SWIN_PATCH = 4, 96
SWIN_STEP_LAUNCHES = dict(dict.fromkeys(TRAIN_STEP_LAUNCHES, 0), conv3x3_packed=10,
                          conv3x3_packed_dgrad=5, conv3x3_wgrad=5, pack_hw=5, unpack_hw=4,
                          packed_norm_act=12, packed_norm_act_backward=6,
                          window_attention=16)
# Phase 13: the fit's epochs and the checkpoints it keeps. 3 epochs made
# the phase take 64-68 s (cold loads ≈ 7 s an epoch); cut to 2.
LOOP_EPOCHS, LOOP_TOP_K = 2, 2
# Phase 15: the multi-stage regime. Its MultiInputUNet at the thesis widths
# runs the two full-resolution stages packed: conv_0 24 → 48 → 48 and
# upcat_1 (48 + 96 =) 144 → 24 → 24 (Cin, Cout). One supervised step: the
# forward's 4 packed convs, 2 packs (the head's output, the upsample) and 1
# unpack; back, every conv's dgrad and, where its weights train, its weight
# gradient, the unpack's pack and the packs' unpacks. TRANSFER trains the
# head alone: no weight gradient of the backbone. An eval step is the GAN
# eval step's: 4 convs, 2 packs, 1 unpack. The run: 1 epoch a stage (cut
# from 50), top-k 2 (cut from 10).
MULTISTAGE_CONVS = ((24, 48), (48, 48), (144, 24), (24, 24))
MULTISTAGE_STEP_LAUNCHES = dict(dict.fromkeys(TRAIN_STEP_LAUNCHES, 0), conv3x3_packed=4,
                                conv3x3_packed_dgrad=4, conv3x3_wgrad=4, pack_hw=3,
                                unpack_hw=3, packed_norm_act=4, packed_norm_act_backward=4)
MULTISTAGE_STAGE_LAUNCHES = {"pretrain": MULTISTAGE_STEP_LAUNCHES,
                             "transfer": dict(MULTISTAGE_STEP_LAUNCHES, conv3x3_wgrad=0),
                             "finetune": MULTISTAGE_STEP_LAUNCHES}
MULTISTAGE_EPOCHS, MULTISTAGE_TOP_K = 1, 2
# The mesh serving runs: (mesh shape, whole volume?). One generator forward
# has 4 packed convs, 2 packs and 1 unpack; every shard runs them (the 8
# patches of a volume are one batch). A mesh with a space split sends the
# convs through K5, one without through K1.
MESH_RUNS = (((1, 2), True), ((1, 1), True), ((2, 2), False))


def mesh_launches(shape):
    n = shape[0] * shape[1]
    out = dict.fromkeys(TRAIN_STEP_LAUNCHES, 0)
    out["conv3x3_packed_halo" if shape[1] > 1 else "conv3x3_packed"] = 4 * n
    out["pack_hw"], out["unpack_hw"] = 2 * n, n
    out["packed_norm_act"] = 0 if shape[1] > 1 else 4 * n  # a space split: the sharded norm
    return out


# Phase 16: the sharded training step on (data, space) meshes on cuda:0.
# Every shard launches what the unsharded step launches; on a space split
# K5, its dgrad and its wgrad take the places of K1, K1's dgrad and K2.
SHARDED_MESHES = ((2, 1), (2, 2), (1, 2))
SHARDED_DDP, SHARDED_EVAL, SHARDED_FIT = (2, 1), (2, 2), (2, 2)
SPACE_PLAIN = ("packed_norm_act", "packed_norm_act_backward")
HALO_FORMS = {"conv3x3_packed": "conv3x3_packed_halo",
              "conv3x3_packed_dgrad": "conv3x3_packed_halo_dgrad",
              "conv3x3_wgrad": "conv3x3_wgrad_halo"}


def sharded_launches(shape, per_step=None, positions=None):
    """One step's launches on a mesh of ``shape``: ``per_step`` (default
    ``TRAIN_STEP_LAUNCHES``) once per position (or per one of
    ``positions`` of them: those on the card), in the halo forms where the
    mesh splits d, where the norm chain takes its moments over the shards
    in plain PyTorch instead of K10."""
    n = shape[0] * shape[1] if positions is None else positions
    out = dict.fromkeys(TRAIN_STEP_LAUNCHES, 0)
    for k, v in (per_step or TRAIN_STEP_LAUNCHES).items():
        if shape[1] > 1 and k in SPACE_PLAIN:
            continue
        out[HALO_FORMS.get(k, k) if shape[1] > 1 else k] += n * v
    return out


# The sharded PackedTwoConv forward + backward on mesh (1, 2): 2 convs × 2
# shards forward; back, each conv's dx and dw per shard; the pack of the
# input per shard and, its input wanting a gradient, the pack's backward.
BLOCK_BACKWARD_LAUNCHES = dict(
    dict.fromkeys(TRAIN_STEP_LAUNCHES, 0), conv3x3_packed_halo=4,
    conv3x3_packed_halo_dgrad=4, conv3x3_wgrad_halo=4, pack_hw=2, unpack_hw=2)
# Phase 11: the cases of scripts/pfold_probe.py (B 8; D, H = W, Cin, Cout)
# and odd shapes (B, D, H, W, Cin, Cout); K9b at pallas_probe.py's conv0.
PFOLD_CASES = ((64, 64, 24, 32), (64, 64, 32, 32), (64, 64, 96, 32), (96, 128, 24, 32))
PFOLD_ODD = ((2, 3, 3, 8, 3, 4), (1, 4, 7, 12, 5, 36), (1, 2, 3, 36, 24, 32))
PROBE_CONV = (8, 64, 64, 64, 24, 32)
RESCALE_ARGS = str(Path(__file__).resolve().parent / "constants" / "rescale_args_dwi.txt")
EVAL_SUBJECTS = ("01", "02")
# Phase 12: the tree's subjects (phase 7 evaluates the first two), the
# modalities the data path feeds the pc-bSSFP GAN, and each augmentation
# apply's tolerance on the card against the CPU, a share of max|ref|: the
# elementwise ones and the rotation differ only in exp/pow/sin/cos
# roundings, the k-space ones also in cuFFT against pocketfft.
DATA_SUBJECTS = ("01", "02", "03", "04")
DATA_KEYS = ("pc-bssfp", "dwi-tensor")
REPEAT = 4  # the train samples repeated for the steady-state epochs
AUG_TOL = {"noise": 1e-5, "gamma": 1e-5, "blur": 1e-5, "bias_field": 1e-5,
           "rotate_trilinear": 1e-5, "spike": 1e-4, "ghosting": 1e-4, "motion": 1e-4}
# K8's work per voxel, counted from csrc/scalar_maps.cu with each add,
# multiply, divide, square root, abs, max, atan2 and acos as one operation:
# the scaling 18; 15 Jacobi rotations of 42 (14 for c, s and t, 10 for the
# matrix, 18 for the eigenvectors); the unscaling 3; the sign 8; FA, MD, AD
# and RD 22; the angles and RGB 14. Bytes: 6 f32 in, 9 f32 out.
SCALAR_MAPS_OPS_PER_VOXEL = 18 + 15 * 42 + 3 + 8 + 22 + 14
SCALAR_MAPS_BYTES_PER_VOXEL = (6 + 9) * 4
# The special-function (MUFU) operations of the same work: at least one for
# each division (or correctly rounded reciprocal), square root, reciprocal
# square root and angle. 15 rotations of 4 (theta's division, sqrt(theta² +
# 1), t's reciprocal, c's reciprocal square root); the scaling's reciprocal
# 1; md's division, the two square roots of FA and its division, atan2,
# the eigenvector's length, its division and acos 8. An H100 SM issues 16
# of them a clock.
SCALAR_MAPS_MUFU_PER_VOXEL = 15 * 4 + 1 + 8
MUFU_PER_CLOCK_PER_SM = 16


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int) -> float:
    """CUDA-event time per call over ``iters`` calls, after two warm-ups."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Checks:
    def __init__(self):
        self.failures = []
        self.rows = []

    def record(self, ok: bool, row: dict):
        row["ok"] = bool(ok)
        self.rows.append(row)
        print(json.dumps(row), flush=True)
        if not ok:
            self.failures.append(row)


class PhaseClock:
    """Each phase's seconds: ``lap(name)`` prints the seconds since the last
    lap (or the start) as ``{"phase": "seconds", "name": ..., "s": ...}`` on
    a line of its own and keeps them."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def lap(self, name: str) -> None:
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now
        print(json.dumps({"phase": "seconds", "name": name, "s": self.laps[name]}), flush=True)


def phase_build(torch, K, _build, native):
    t0 = time.perf_counter()
    shutil.rmtree(_build.BUILD_DIR, ignore_errors=True)
    _build.build_all()
    nvcc_s = time.perf_counter() - t0
    each = dict(sorted(_build.BUILD_SECONDS.items(), key=lambda kv: -kv[1]))
    t0 = time.perf_counter()
    codec_built = native.is_available()  # g++ of the NIfTI codec into _build/
    codec_s = time.perf_counter() - t0
    print(f"build: nvcc {nvcc_s:.1f}s (csrc/*.cu in parallel: "
          f"{', '.join(f'{k} {v:.1f}s' for k, v in each.items())}); native NIfTI codec "
          f"{'built' if codec_built else 'NOT built'} in {codec_s:.1f}s", flush=True)
    if not codec_built:
        raise RuntimeError("the native NIfTI codec did not build (g++ and zlib needed)")
    return {"nvcc_s": nvcc_s, "nvcc_s_each": each, "native_codec_s": codec_s}


def check_conv(torch, F, K, checks, b, d, h, w, cin, cout, dtype, halo=False, fold=False,
               wguard=0, mma=False, rerun=False):
    """K1, or with ``halo`` K5 on an input of d + 2 slices whose two halo
    slices are random like the rest (so an off-by-one in d shows), and K5 on
    a zero halo against K1 on the body. With ``fold``: K7a (or its halo
    form) on the same volume folded, and bit for bit the result of the
    kernel its shape routes to (bf16: K1's (K5's) wgmma kernel where the
    fold plan takes the shape, else the ``mma.sync`` loop through
    ``conv3x3_packed_mma``; f32: K1's (K5's) FMA kernel). ``wguard``: K1W,
    ``w`` then the row width with its guard columns (zero in the input).
    ``mma``: the check-only entry point ``conv3x3_packed_mma`` itself.
    ``rerun``: a second launch must be bit for bit the first. With
    ``wguard`` the library call and K1 beside it (``unguarded_ms``) take the
    same volume without its guard columns, and the first launch writes into
    memory filled with NaN just before (:func:`nan_filled`, held by
    :func:`guards_zero`)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(cin * 1000 + d)
    xk = torch.randn(b, d + 2 * halo, cin, h * w, device="cuda", generator=g).to(dt)
    xk = K.guard_mask(xk, w, wguard).contiguous()
    wt = torch.randn(3, 3, 3, cin, cout, device="cuda", generator=g) / (27 * cin) ** 0.5
    bias = 0.1 * torch.randn(cout, device="cuda", generator=g)
    kern, plain = ((K.conv3x3_packed_halo, K.conv3x3_packed_halo_plain) if halo
                   else (K.conv3x3_packed, K.conv3x3_packed_plain))
    xin, dim, extra, args = xk, w, {}, ()
    if wguard:
        args, extra = (wguard,), {"wguard": wguard}
    if mma:
        kern, plain = K.conv3x3_packed_mma, K.conv3x3_packed_plain
    if fold:
        from unet_bssfp_tpu_torch.ops.kernels.pfold import _to_folded
        xin, dim = _to_folded(xk, w), w // 4
        route = pfold_route(K, xin, cout, dim, dt, "conv")
        packed = (K.conv3x3_packed_mma(xk, wt, bias, w, -2 if halo else 0)
                  if route == "mma_loop" else kern(xk, wt, bias, w))
        kern, plain = ((K.conv3x3_pfold_halo, K.conv3x3_pfold_halo_plain) if halo
                       else (K.conv3x3_pfold, K.conv3x3_pfold_plain))
    nan_at = nan_filled(torch, b * d * cout * h * w) if wguard else None
    got = kern(xin, wt, bias, dim, *args)
    guards = {"guards_zero_after_nan_fill": guards_zero(torch, got, nan_at, w, wguard)
              } if wguard else {}
    if fold:
        extra = {"route": route,
                 "bit_equal_to_packed_kernel": bool(torch.equal(got, _to_folded(packed, w))),
                 "bit_identical_rerun": bool(torch.equal(got, kern(xin, wt, bias, dim)))}
        del packed
    if rerun:
        extra["bit_identical_rerun"] = bool(torch.equal(got, kern(xin, wt, bias, dim, *args)))
    got = got.float()
    ref = plain(xin, wt, bias, dim, *args).float()
    if halo and not fold:
        # zero halo slices add only zero products, in K1's order: bit-equal
        body = xk[:, 1:-1].contiguous()
        zero = torch.zeros_like(xk[:, :1])
        same = torch.equal(kern(torch.cat([zero, body, zero], 1), wt, bias, w),
                           K.conv3x3_packed(body, wt, bias, w))
        extra = {"zero_halo_bit_equal_to_k1": bool(same)}
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    # f32: the two differ only in summation order over 27·Cin ≤ 2592 terms;
    # bf16: both round the f32 sum once, so they may land one bf16 ulp
    # (2^-7 relative) apart.
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    atol = 1e-4 * scale
    ok = (bool((err <= atol + rtol * ref.abs()).all()) and all(extra.values())
          and all(guards.values()))
    wd = w - wguard
    xu = K.strip_guards(xk, w, wguard)
    xn = xu.reshape(b, d + 2 * halo, cin, h, wd).permute(0, 2, 1, 3, 4)
    wl = wt.to(dt).permute(4, 3, 0, 1, 2).contiguous()
    bl = bias.to(dt)
    pad = (0, 1, 1) if halo else 1
    iters = 5 if b * d * h * w >= 1 << 20 else 20
    ms = time_ms(torch, lambda: kern(xin, wt, bias, dim, *args), iters)
    plain_ms = time_ms(torch, lambda: plain(xin, wt, bias, dim, *args), iters)
    lib_ms = time_ms(torch, lambda: F.conv3d(xn, wl, bl, padding=pad), iters)
    info = {}
    if wguard:
        info["unguarded_ms"] = time_ms(torch, lambda: kern(xu, wt, bias, wd), iters)
        info["lanes_map"] = K.conv_plan(xk, cout, w, -2 * halo, wguard).lanes_map
    nbytes = (xk.numel() * xk.element_size() + wt.numel() * 4 + cout * 4
              + b * d * cout * h * w * xk.element_size())
    # the bytes at the guarded width (the layout moves the guard columns),
    # the products at the data width (a guard output is 0 by definition)
    bms, by = bound(nbytes, 2 * 27 * cin * cout * b * d * h * wd, dtype)
    checks.record(ok, dict(
        kernel=kern.__name__, shape=list(xin.shape), cout=cout,
        dtype=dtype, max_abs_err=float(err.max()), ref_max_abs=scale,
        rtol=rtol, atol=atol, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms, **extra, **guards, **info))


def nan_filled(torch, numel):
    """The address of a freed tensor of ``numel`` bf16 NaNs, after the
    caching allocator's unused blocks went back to the card: the block the
    next ``torch.empty`` of that size gets (:func:`guards_zero` holds that
    it did)."""
    torch.cuda.empty_cache()
    return torch.full((numel,), float("nan"), dtype=torch.bfloat16, device="cuda").data_ptr()


def guards_zero(torch, y, nan_at, w, wguard):
    """``y`` (…, H·w) lies in the NaN-filled block at ``nan_at``, holds no
    NaN, and its last ``wguard`` columns of every row are exactly zero:
    every voxel, guards included, was written by the launch."""
    rows = y.reshape(*y.shape[:-1], -1, w)
    return bool(y.data_ptr() == nan_at and not y.isnan().any()
                and (rows[..., w - wguard:] == 0).all())


def pfold_route(K, xf, cout, w4, dt, what):
    """The kernel a folded launch routes to: ``wgmma`` (bf16 shapes the fold
    plan takes), ``mma_loop`` (other bf16 shapes) or ``fma`` (f32)."""
    import torch
    if dt != torch.bfloat16:
        return "fma"
    if what == "conv":
        plan = K.conv_plan(xf, cout, w4, fold=True)
    else:
        dy = torch.empty(xf.shape[0], xf.shape[1], 4 * cout, xf.shape[3], dtype=dt)
        plan = K.wgrad_plan(xf, dy, w4, fold=True)
    return "mma_loop" if plan is None else "wgmma"


def check_layout(torch, K, checks, b, d, h, w, c, dtype, direction):
    dt = getattr(torch, dtype)
    if direction == "pack":
        x = torch.randn(b, d, h, w, c, device="cuda").to(dt)
        kern, plain = (lambda: K.pack_hw(x)), (lambda: K.pack_hw_plain(x))
        lib = lambda: x.permute(0, 1, 4, 2, 3).contiguous()  # noqa: E731
        name = "pack_hw"
    else:
        x = torch.randn(b, d, c, h * w, device="cuda").to(dt)
        kern, plain = (lambda: K.unpack_hw(x, w)), (lambda: K.unpack_hw_plain(x, w))
        lib = lambda: x.reshape(b, d, c, h, w).permute(0, 1, 3, 4, 2).contiguous()  # noqa: E731
        name = "unpack_hw"
    got, ref = kern(), plain()
    ok = torch.equal(got, ref)  # a permutation: exact
    iters = 10
    nbytes = 2 * x.numel() * x.element_size()
    bms, by = bound(nbytes, 0, dtype)
    checks.record(ok, dict(
        kernel=name, shape=list(x.shape), dtype=dtype,
        max_abs_err=float((got.float() - ref.float()).abs().max()),
        rtol=0.0, atol=0.0, ms=time_ms(torch, kern, iters),
        plain_ms=time_ms(torch, plain, iters), bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lib, iters)))


def check_norm(torch, F, K, checks, shape, dtype):
    dt = getattr(torch, dtype)
    c = shape[-1]
    g = torch.Generator(device="cuda").manual_seed(c)
    x = torch.randn(shape, device="cuda", generator=g).to(dt)
    s = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
    bb = 0.1 * torch.randn(c, device="cuda", generator=g)
    fn = lambda: K.fused_instance_norm_leaky_relu(x, s, bb, 0.1)  # noqa: E731
    launches = K.fused_instance_norm_leaky_relu.launches
    out = fn()
    one_launch = K.fused_instance_norm_leaky_relu.launches == launches + 1
    repeats = bool(torch.equal(out, fn()))  # every sum in the plan's fixed order
    got = out.float()
    ref = K.instance_norm_leaky_relu_plain(x, s, bb, 0.1).float()
    err = (got - ref).abs()
    # f32: moments summed in another order over ≤ 196608 voxels; bf16: the
    # output rounds once, so the two may land one bf16 ulp apart.
    rtol, atol = (1e-5, 1e-4) if dtype == "float32" else (2 ** -7, 1e-2)
    ok = bool((err <= atol + rtol * ref.abs()).all()) and repeats and one_launch
    max_err = float(err.max())
    del out, got, ref, err
    xn = x.permute(0, 4, 1, 2, 3)
    sl, bl = s.to(dt), bb.to(dt)
    iters = 10
    nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
    bms, by = bound(nbytes, 9 * x.numel(), "float32")
    ms = time_ms(torch, fn, iters)
    dev = device_ms(torch, fn, "norm_act_kernel")
    print(f"K4 {dtype} {tuple(shape)}: {ms:.4f} ms per call, device {dev} ms "
          f"(bound {bms:.4f}, {by})", flush=True)
    checks.record(ok, dict(
        kernel="fused_instance_norm_leaky_relu", shape=list(shape),
        dtype=dtype, max_abs_err=max_err, rtol=rtol, atol=atol,
        bit_identical_rerun=repeats, one_launch_per_call=one_launch,
        ms=ms, device_ms=dev,
        plain_ms=time_ms(torch, lambda: K.instance_norm_leaky_relu_plain(x, s, bb, 0.1), iters),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.leaky_relu(
            F.instance_norm(xn, weight=sl, bias=bl, eps=1e-5), 0.1), iters)))


def check_wgrad(torch, K, checks, b, d, h, w, cin, cout, dtype, halo=False, fold=False,
                mma=False):
    """K2 at the training step's shape of the forward conv cin → cout; with
    ``halo`` its variant for K5 (x of d + 2 slices, every one random); with
    ``fold`` K7b on the same operands folded: on the wgmma kernel (bf16
    shapes the fold plan takes) held to K2's bound at its own plan's chain,
    on a loop bit for bit that loop's result on the packed operands (bf16:
    the ``mma.sync`` loop through ``conv3x3_wgrad_mma``; f32: K2's FMA
    kernel). ``mma``: the check-only entry point ``conv3x3_wgrad_mma``
    itself."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(cin * 7 + d)
    xk = torch.randn(b, d + 2 * halo, cin, h * w, device="cuda", generator=g).to(dt)
    dy = torch.randn(b, d, cout, h * w, device="cuda", generator=g).to(dt)
    kern, plain = ((K.conv3x3_wgrad_halo, K.conv3x3_wgrad_halo_plain) if halo
                   else (K.conv3x3_wgrad, K.conv3x3_wgrad_plain))
    xin, dyin, dim, chain_fn, extra, args = xk, dy, w, K.conv3x3_wgrad_chain, {}, ()
    if mma:
        kern, chain_fn, args = K.conv3x3_wgrad_mma, K.conv3x3_wgrad_mma_chain, (int(halo),)
    if fold:
        from unet_bssfp_tpu_torch.ops.kernels.pfold import _to_folded
        xin, dyin, dim = _to_folded(xk, w), _to_folded(dy, w), w // 4
        route = pfold_route(K, xin, cout, dim, dt, "wgrad")
        packed = (None if route == "wgmma" else K.conv3x3_wgrad_mma(xk, dy, w, int(halo))
                  if route == "mma_loop" else kern(xk, dy, w))
        kern, plain = ((K.conv3x3_pfold_wgrad_halo, K.conv3x3_pfold_wgrad_halo_plain) if halo
                       else (K.conv3x3_pfold_wgrad, K.conv3x3_pfold_wgrad_plain))
        chain_fn = K.conv3x3_pfold_wgrad_chain
    got = kern(xin, dyin, dim, *args)
    if fold:
        extra = {"route": route}
        if packed is not None:
            extra["bit_equal_to_packed_kernel"] = bool(torch.equal(got, packed))
        del packed
    ref = plain(xin, dyin, dim)
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    # Both sum exact products of the same values in f32, in other orders
    # (the plain version: cuDNN, TF32 off). A round-to-nearest chain of L
    # adds whose partial sums stay below max|ref| strays about
    # sqrt(L)·2^-24·max|ref|; L is K2's longest chain (an item's products,
    # the split's items, the splits), and the factor 16 covers the plain
    # side's own order, which is not known.
    chain = chain_fn(xin, dyin, dim)
    rtol, atol = 0.0, 16 * math.sqrt(chain) * 2 ** -24 * scale
    ok = bool((err <= atol).all()) and all(extra.values())
    repeats = bool(torch.equal(got, kern(xin, dyin, dim, *args)))
    xn = xk.reshape(b, d + 2 * halo, cin, h, w).permute(0, 2, 1, 3, 4).contiguous()
    dyn = dy.reshape(b, d, cout, h, w).permute(0, 2, 1, 3, 4).contiguous()
    wn = torch.zeros(cout, cin, 3, 3, 3, device="cuda", dtype=dt)
    iters = 5
    lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        dyn, xn, wn, None, [1, 1, 1], [0 if halo else 1, 1, 1], [1, 1, 1], False,
        [0, 0, 0], 1, [False, True, False])
    nbytes = (xk.numel() + dy.numel()) * xk.element_size() + 27 * cin * cout * 4
    bms, by = bound(nbytes, 2 * 27 * cin * cout * b * d * h * w, dtype)
    checks.record(ok and repeats, dict(
        kernel=kern.__name__, shape=list(xin.shape), cout=cout, dtype=dtype,
        max_abs_err=float(err.max()), ref_max_abs=scale, rtol=rtol, atol=atol,
        chain=chain, bit_identical_rerun=repeats,
        ms=time_ms(torch, lambda: kern(xin, dyin, dim, *args), iters),
        plain_ms=time_ms(torch, lambda: plain(xin, dyin, dim), iters),
        bound_ms=bms, bound_by=by, library_ms=time_ms(torch, lib, iters), **extra))


def check_dgrad(torch, K, checks, b, d, h, w, cin, cout, dtype, halo=False, fold=False,
                rerun=False, wguard=0):
    """K1's dgrad launch for the forward conv cin → cout: dy (cout) → dx
    (cin); with ``halo`` K5's: dy of d slices → dxp of d + 2; with ``fold``
    K7a's on the same dy folded, and bit for bit the dgrad of the kernel its
    shape routes to (bf16: K1's (K5's) wgmma dgrad where the fold plan takes
    it, else ``conv3x3_packed_mma`` on the flipped weights; f32: K1's (K5's)
    FMA kernel). ``rerun``: a second launch must be bit for bit the first.
    ``wguard``: K1W's dgrad, ``w`` the row width with its guard columns
    (zero in dy, as the conv's backward leaves them), the library call and
    K1's dgrad beside it (``unguarded_ms``) on dy without them, its first
    launch into memory just filled with NaN (:func:`guards_zero`)."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(cin * 11 + d)
    dy = torch.randn(b, d, cout, h * w, device="cuda", generator=g).to(dt)
    dy = K.guard_mask(dy, w, wguard).contiguous()
    wt = torch.randn(3, 3, 3, cin, cout, device="cuda", generator=g) / (27 * cout) ** 0.5
    wflip = wt.flip(0, 1, 2).transpose(3, 4)
    zero = torch.zeros(cin, device="cuda")
    dyin, dim, extra, args = dy, w, {}, ((wguard,) if wguard else ())
    if halo:
        kern = K.conv3x3_packed_halo_dgrad
        plain = lambda: K.conv3x3_packed_halo_dgrad_plain(dy, wt, w, wguard)  # noqa: E731
    else:
        kern = K.conv3x3_packed_dgrad
        plain = lambda: K.conv3x3_packed_plain(dy, wflip, zero, w, wguard)  # noqa: E731
    if fold:
        from unet_bssfp_tpu_torch.ops.kernels.pfold import _to_folded
        dyin, dim = _to_folded(dy, w), w // 4
        route = pfold_route(K, dyin, cin, dim, dt, "conv")
        packed = (K.conv3x3_packed_mma(dy, wflip.to(dt).contiguous(), zero, w, 2 if halo else 0)
                  if route == "mma_loop" else kern(dy, wt, w))
        kern = K.conv3x3_pfold_halo_dgrad if halo else K.conv3x3_pfold_dgrad
        pfn = K.conv3x3_pfold_halo_dgrad_plain if halo else K.conv3x3_pfold_dgrad_plain
        plain = lambda: pfn(dyin, wt, dim)  # noqa: E731
    nan_at = nan_filled(torch, b * (d + 2 * halo) * cin * h * w) if wguard else None
    got = kern(dyin, wt, dim, *args)
    guards = {"guards_zero_after_nan_fill": guards_zero(torch, got, nan_at, w, wguard)
              } if wguard else {}
    if fold:
        extra = {"route": route,
                 "bit_equal_to_packed_kernel": bool(torch.equal(got, _to_folded(packed, w))),
                 "bit_identical_rerun": bool(torch.equal(got, kern(dyin, wt, dim)))}
        del packed
    if rerun:
        extra["bit_identical_rerun"] = bool(torch.equal(got, kern(dyin, wt, dim, *args)))
    got = got.float()
    ref = plain().float()
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    # K1's forward tolerance: f32 sums in another order; bf16 one output
    # rounding on either side.
    rtol = 1e-5 if dtype == "float32" else 2 ** -7
    atol = 1e-4 * scale
    ok = (bool((err <= atol + rtol * ref.abs()).all()) and all(extra.values())
          and all(guards.values()))
    f = 4 if fold else 1
    ok = ok and tuple(got.shape) == (b, d + 2 * halo, f * cin, h * w // f)
    wd = w - wguard
    dyu = K.strip_guards(dy, w, wguard)
    dyn = dyu.reshape(b, d, cout, h, wd).permute(0, 2, 1, 3, 4).contiguous()
    xn = torch.empty(b, cin, d + 2 * halo, h, wd, device="cuda", dtype=dt)
    wn = wt.to(dt).permute(4, 3, 0, 1, 2).contiguous()
    iters = 5
    lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        dyn, xn, wn, None, [1, 1, 1], [0 if halo else 1, 1, 1], [1, 1, 1], False,
        [0, 0, 0], 1, [True, False, False])
    info = {}
    if wguard:
        info["unguarded_ms"] = time_ms(torch, lambda: kern(dyu, wt, wd), iters)
        info["lanes_map"] = K.conv_plan(dy, cin, w, 2 * halo, wguard).lanes_map
    nbytes = ((dy.numel() + got.numel()) * dy.element_size()
              + 27 * cin * cout * dy.element_size())
    # halo: every one of the 3·d (kd, dy slice) products is real, as forward;
    # wguard: the bytes at the guarded width, the products at the data width
    bms, by = bound(nbytes, 2 * 27 * cin * cout * b * d * h * wd, dtype)
    checks.record(ok, dict(
        kernel=kern.__name__, shape=list(dyin.shape), cout=cin,
        dtype=dtype, max_abs_err=float(err.max()), ref_max_abs=scale, rtol=rtol,
        atol=atol, ms=time_ms(torch, lambda: kern(dyin, wt, dim, *args), iters),
        plain_ms=time_ms(torch, plain, iters), bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lib, iters), **extra, **guards, **info))


def phase_train_kernels(torch, K, checks):
    b, d, h, w = TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, TRAIN_PATCH
    for dtype in ("bfloat16", "float32"):
        for cin in (24, 32, 96):  # conv_0.conv_0, *.conv_1, upcat_1.conv_0
            check_wgrad(torch, K, checks, b, d, h, w, cin, 32, dtype)
            check_dgrad(torch, K, checks, b, d, h, w, cin, 32, dtype)
    # the mma.sync loop the wgmma kernel replaced, at K2's heaviest shape
    check_wgrad(torch, K, checks, b, d, h, w, 96, 32, "bfloat16", mma=True)
    from scripts import torch_port_norm_act_times as nat

    for case in nat.CASES:
        check_packed_norm_act(torch, K, checks, nat, case)


def check_packed_norm_act(torch, K, checks, nat, case):
    """K10 forward and backward at one case of
    ``scripts/torch_port_norm_act_times.py`` (its bounds and times): a row
    each, the backward's plain and library ms the forward and backward's
    less the forward's."""
    import torch.nn.functional as F

    r = nat.run_case(torch, F, K, case)
    common = dict(shape=r["shape"], dtype=r["dtype"], case=case, wguard=r["wguard"],
                  prelu=r["prelu"], bit_identical_rerun=r["bit_identical_rerun"],
                  errors=r["errors"], bound_by="bytes")
    checks.record(r["ok"], dict(
        kernel="packed_norm_act", **common, launches=r["launches"],
        max_abs_err=r["errors"]["y"]["kernel"], ms=r["fwd_ms"], device_ms=r["fwd_device_ms"],
        bound_ms=r["bound_fwd_ms"], plain_ms=r["plain_fwd_ms"],
        library_ms=r["library_fwd_ms"], draw_ms=r.get("draw_ms")))
    if r["train"]:
        checks.record(r["ok"], dict(
            kernel="packed_norm_act_backward", **common,
            max_abs_err=r["errors"]["dx"]["kernel"], ms=r["bwd_ms"],
            device_ms=r["bwd_device_ms"], bound_ms=r["bound_bwd_ms"],
            plain_ms=r["plain_ms"] - r["plain_fwd_ms"],
            library_ms=r["library_ms"] - r["library_fwd_ms"]))
    torch.cuda.empty_cache()


def phase_halo_kernels(torch, F, K, checks):
    """K5, its dgrad and its wgrad at the shard shapes of the mesh path: a
    batch of 8 patches with d split in two, the whole volume with d split
    in two."""
    for dtype in ("bfloat16", "float32"):
        for b, d, h, w in ((8, 32, 64, 64), (1, 48, 128, 128)):
            for cin in (24, 32, 96):
                check_conv(torch, F, K, checks, b, d, h, w, cin, 32, dtype, halo=True)
                check_dgrad(torch, K, checks, b, d, h, w, cin, 32, dtype, halo=True)
                check_wgrad(torch, K, checks, b, d, h, w, cin, 32, dtype, halo=True)


def phase_kernels(torch, F, K, checks):
    patch = (8, 64, 64, 64)          # 8 patches of 64³ per batch
    whole = (1,) + VOLUME
    for dtype in ("bfloat16", "float32"):
        for b, d, h, w in (patch, whole):
            for cin in (24, 32, 96):  # conv_0.conv_0, *.conv_1, upcat_1.conv_0
                check_conv(torch, F, K, checks, b, d, h, w, cin, 32, dtype)
            check_layout(torch, K, checks, b, d, h, w, 24, dtype, "pack")   # head → conv_0
            check_layout(torch, K, checks, b, d, h, w, 64, dtype, "pack")   # upcat_1 upsample
            check_layout(torch, K, checks, b, d, h, w, 6, dtype, "unpack")  # final conv
            check_layout(torch, K, checks, b, d, h, w, 6, dtype, "pack")    # its gradient
    # K1W: guard columns as guard_cols(64, 64) gives them under
    # UNET_BSSFP_WGUARD=1; the mma.sync loop's entry point at K1's heaviest
    # shape, beside K1
    check_conv(torch, F, K, checks, 8, 64, 64, 66, 32, 32, "bfloat16", wguard=2)
    check_conv(torch, F, K, checks, 8, 64, 64, 64, 96, 32, "bfloat16", mma=True)
    torch.cuda.empty_cache()
    for dtype in ("bfloat16", "float32"):
        # The plain-layer stages: down_1 … down_4 (and their upcats) at
        # patch (B 8) and whole-volume (B 1) sizes.
        for n, base in ((8, (32, 32, 32)), (1, (48, 64, 64))):
            for level, c in enumerate((64, 128, 256, 512)):
                sp = tuple(s >> level for s in base)
                check_norm(torch, F, K, checks, (n,) + sp + (c,), dtype)


def run_volume(torch, predict_volume, fn, vol, whole):
    out = predict_volume(fn, vol, patch_size=64, whole_volume=whole)
    torch.cuda.synchronize()
    return out


def phase_main_path(torch, K, checks, pkg):
    Config, build_models, make_predict_fn, weights, predict_volume = pkg
    cfg = Config()
    mcfg = cfg.model
    if tuple(cfg.data.volume_shape) != VOLUME or cfg.data.patch_size != 64:
        raise RuntimeError(f"default config serves {cfg.data.volume_shape} / "
                           f"{cfg.data.patch_size}, not {VOLUME} / 64")
    device = torch.device("cuda")
    probe, _ = build_models(MODALITY, mcfg, device)
    sd = weights.random_state_dict(probe, SEED)
    del probe

    def model(**over):
        gen, _ = build_models(MODALITY, dataclasses.replace(mcfg, **over),
                              device, state_dict=sd)
        return make_predict_fn(gen)

    g = torch.Generator().manual_seed(SEED)
    vol = torch.randn(VOLUME + (24,), generator=g).to(device)
    runs = {}
    for use_pallas in (False, True):
        fn = model(use_pallas=use_pallas)
        for whole in (False, True):
            runs[(whole, use_pallas)] = fn
    for (whole, _), fn in runs.items():           # warm-up (cuDNN plans)
        run_volume(torch, predict_volume, fn, vol, whole)

    K.reset_launches()
    outs = {key: run_volume(torch, predict_volume, fn, vol, key[0])
            for key, fn in runs.items()}
    counts = K.launches()
    print("serving-path launches: " + json.dumps(counts), flush=True)
    # K4: the 14 plain-layer norms of a volume (down_1 … down_4, upcat_4 …
    # upcat_2, two each), once patch-stitched and once whole under use_pallas
    checks.record(all(counts[k] > 0 for k in SERVING_KERNELS)
                  and counts["fused_instance_norm_leaky_relu"] == 2 * 14
                  and counts["conv3x3_packed_mma"] == counts["conv3x3_packed_mma_routed"] == 0,
                  dict(phase="main_path_launches", launches=counts))

    # peak memory of each way alone, then 5 rounds of the four ways in turns
    # (use_pallas on beside off, so that both see the same card state)
    timing, ts = {}, {key: [] for key in runs}
    for (whole, use_pallas), fn in runs.items():
        torch.cuda.reset_peak_memory_stats()
        run_volume(torch, predict_volume, fn, vol, whole)
        key = f"{'whole' if whole else 'patch'}_use_pallas_{use_pallas}"
        timing[key] = {"peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    for _ in range(5):
        for (whole, use_pallas), fn in runs.items():
            t0 = time.perf_counter()
            run_volume(torch, predict_volume, fn, vol, whole)
            ts[(whole, use_pallas)].append((time.perf_counter() - t0) * 1e3)
    for (whole, use_pallas), t in ts.items():
        key = f"{'whole' if whole else 'patch'}_use_pallas_{use_pallas}"
        timing[key].update(ms_per_volume_median=statistics.median(t), ms_all=t)
        print(f"ms/volume {key} (bf16): {statistics.median(t):.3f} "
              f"(runs {', '.join(f'{v:.3f}' for v in t)}); peak "
              f"{timing[key]['peak_mib']:.0f} MiB allocated", flush=True)
    for mode in ("patch", "whole"):
        on, off = (timing[f"{mode}_use_pallas_{v}"]["ms_per_volume_median"] for v in (True, False))
        print(f"serving {mode}: use_pallas on {on:.3f} ms / off {off:.3f} ms per volume "
              f"(on/off {on / off:.3f})", flush=True)
    del runs

    # f32: packed kernel path (K1, K3, K4) vs the same weights on plain
    # PyTorch/cuDNN (TF32 off). Tolerance 1e-3 of max|ref|: f32 summation
    # order differs in every conv and norm, compounded over 23 conv layers.
    f32_kern = model(compute_dtype="float32", packed=True, use_pallas=True)
    f32_plain = model(compute_dtype="float32", packed=False, use_pallas=False)
    for whole in (False, True):
        got = run_volume(torch, predict_volume, f32_kern, vol, whole).float()
        ref = run_volume(torch, predict_volume, f32_plain, vol, whole).float()
        rel = float((got - ref).abs().max() / ref.abs().max())
        mode = "whole" if whole else "patch"
        checks.record(rel <= 1e-3 and bool(torch.isfinite(got).all())
                      and tuple(got.shape) == VOLUME + (6,),
                      dict(phase="main_path_f32_vs_plain", mode=mode,
                           rel_max_err=rel, tol=1e-3))
        for use_pallas in (False, True):
            out = outs[(whole, use_pallas)].float()
            rel_bf16 = float((out - ref).abs().max() / ref.abs().max())
            # bf16 vs f32 is reported; the 0.1 bound only catches a layout
            # or indexing fault, which gives errors of order 1.
            checks.record(bool(torch.isfinite(out).all()) and rel_bf16 < 0.1
                          and tuple(out.shape) == VOLUME + (6,),
                          dict(phase="main_path_bf16_vs_f32", mode=mode,
                               use_pallas=use_pallas, rel_max_err=rel_bf16))
    return counts, timing


def time_steps(torch, step, state, x, y, warmup=3, timed=10):
    """ms per step (host clock, each step synchronised), peak MiB and the
    metrics of every timed step."""
    for _ in range(warmup):
        step(state, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts, metrics = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        m = step(state, x, y)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    return ts, torch.cuda.max_memory_allocated() / 2 ** 20, metrics


def check_swin_norm_act(torch, K, checks, slope):
    """K10 as the Swin generator's residual blocks call it, at 4 × 96³ and
    48 channels: no affine (scale 1, shift 0), no dropout, LeakyReLU 0.01,
    or the identity slope 1.0 that comes before the residual add. Forward
    and backward in bf16, against the plain chain in bf16 and both against
    it in f64: y and dx each within twice the plain chain's error or
    2^-8·max|ref| (phase 4's bound; a wrong mean, rstd or slope misses it
    by whole units). One launch each way; a rerun bit for bit."""
    shape = (SWIN_BATCH, SWIN_PATCH, 48, SWIN_PATCH * SWIN_PATCH)
    g = torch.Generator(device="cuda").manual_seed(7)
    off = 2 * torch.randn(1, 1, shape[2], 1, device="cuda", generator=g)
    x = (torch.randn(shape, device="cuda", generator=g) + off).bfloat16()
    dy = torch.randn(shape, device="cuda", generator=g).bfloat16()
    scale, shift = torch.ones(shape[2], device="cuda"), torch.zeros(shape[2], device="cuda")

    def run(fn, xin, out_dtype):
        xl = xin.detach().requires_grad_(True)
        y = fn(xl, scale, shift, slope, SWIN_PATCH, 0, None, 1.0, 1e-5, out_dtype)
        y.backward(dy.to(y.dtype))
        return [y.detach(), xl.grad]

    K.reset_launches()
    got = run(K.packed_norm_act, x, torch.bfloat16)
    launches = (K.packed_norm_act.launches, K.packed_norm_act_backward.launches)
    repeats = all(torch.equal(a, b) for a, b in zip(got, run(K.packed_norm_act, x,
                                                             torch.bfloat16)))
    plain = run(K.packed_norm_act_plain, x, torch.bfloat16)
    ref = run(K.packed_norm_act_plain, x.double(), torch.float64)
    errs, ok = {}, repeats and launches == (1, 1)
    for name, a, p, r in zip(("y", "dx"), got, plain, ref):
        floor = 2 ** -8 * float(r.abs().max())
        ek, ep = (float((t.double() - r).abs().max()) for t in (a, p))
        errs[name] = {"kernel": ek, "plain": ep, "floor": floor}
        ok = ok and ek <= max(2 * ep, floor)
    del got, plain, ref
    ms = time_ms(torch, lambda: run(K.packed_norm_act, x, torch.bfloat16), 5)
    plain_ms = time_ms(torch, lambda: run(K.packed_norm_act_plain, x, torch.bfloat16), 5)
    checks.record(ok, dict(
        kernel="packed_norm_act", case=f"swin slope {slope}", shape=list(shape),
        dtype="bfloat16", launches=launches, bit_identical_rerun=repeats, errors=errs,
        max_abs_err=errs["y"]["kernel"], fwd_bwd_ms=ms, plain_fwd_bwd_ms=plain_ms))
    torch.cuda.empty_cache()


def check_swin_generator(torch, K, checks, dtype):
    """The CUDA generator at MONAI's BTCV widths on 1 × 64³ (train-mode
    BatchNorm in the head, packed encoder1/decoder1, 8 window attention
    launches) against the plain f32 reference with TF32 off, by
    ‖out − ref‖₂ / ‖ref‖₂: f32 1e-4 (the kernels and SDPA differ from the
    reference in summation order only), bf16 0.05 (every layer rounds to 8
    bits over some 60 layers on the longest path; the GAN cell's serving
    readings of such a network reach 0.0178). The bounds of
    ``tests/test_torch_port_gpu.py::test_gpu_swin_generator_matches_reference``."""
    from portbench.drivers import swin_gan_train as drv
    from portbench.reference import swin_unetr as R
    from unet_bssfp_tpu_torch.train.state import build_models

    cfg = json.loads((Path(__file__).resolve().parent / "portbench" / "configs"
                      / "swin-unetr-gan-btcv.json").read_text())
    gen, _ = build_models(MODALITY, drv.model_config(dict(cfg, compute_dtype=dtype,
                                                          packed=True)), "cuda")
    w, _ = drv.weights(cfg, 11, "cuda")
    gen.load_state_dict(w)
    x = torch.randn(1, 64, 64, 64, 24, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    K.reset_launches()
    with torch.no_grad():
        got = gen(x).float()
    counts = {k: v for k, v in K.launches().items() if v}
    with torch.no_grad():
        ref = R.generator(w, x, cfg, True)
    rel = float((got - ref).norm() / ref.norm())
    bound = 1e-4 if dtype == "float32" else 0.05
    want = {"window_attention": 8, "conv3x3_packed": 5, "packed_norm_act": 6}
    checks.record(rel <= bound and all(counts.get(k) == v for k, v in want.items()), dict(
        phase="swin_generator_vs_reference", dtype=dtype, shape=list(x.shape), rel_l2=rel,
        bound=bound, launches=counts))
    del gen, w, got, ref
    torch.cuda.empty_cache()


def phase_swin(torch, K, checks, pkg):
    """Phase 22: the SwinUNETR generator behind the GAN's head. K1, its
    dgrad and K2 at the 96³ instances, K10 at the residual blocks' (each
    against its plain version), the generator against the plain reference,
    then one step on 4 × 96³ crops: its exact launches, ms a step (5
    synchronised, after a warm-up), the peak, finite losses, the attention
    kernels SDPA picks (by name, one profiled step) with their device ms,
    and the device ops a step that the Swin encoder adds."""
    Config, create_gan_state, make_train_step = pkg
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from portbench.drivers.swin_gan_train import ATTENTION_KEYS

    b, d = SWIN_BATCH, SWIN_PATCH
    for cin in (24, 48):  # encoder1's conv1; its conv2 and decoder1's calls
        check_conv(torch, F, K, checks, b, d, d, d, cin, 48, "bfloat16", rerun=True)
        check_dgrad(torch, K, checks, b, d, d, d, cin, 48, "bfloat16", rerun=True)
        check_wgrad(torch, K, checks, b, d, d, d, cin, 48, "bfloat16")
        torch.cuda.empty_cache()
    for slope in (0.01, 1.0):
        check_swin_norm_act(torch, K, checks, slope)
    for dtype in ("float32", "bfloat16"):
        check_swin_generator(torch, K, checks, dtype)
    cfg = Config()
    mcfg = dataclasses.replace(cfg.model, backbone="swin_unetr", dropout=0.0)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand((SWIN_BATCH,) + (SWIN_PATCH,) * 3 + (24,), device="cuda", generator=g)
    y = torch.rand((SWIN_BATCH,) + (SWIN_PATCH,) * 3 + (6,), device="cuda", generator=g)
    state = create_gan_state(SEED, MODALITY, mcfg, cfg.train, "cuda")
    step = make_train_step(state.gen, state.disc, cfg.train)
    step(state, x, y)
    torch.cuda.synchronize()
    K.reset_launches()
    step(state, x, y)
    torch.cuda.synchronize()
    counts = K.launches()
    print("swin training-step launches: " + json.dumps({k: v for k, v in counts.items() if v}),
          flush=True)
    checks.record(counts == SWIN_STEP_LAUNCHES,
                  dict(phase="swin_step_launches", launches=counts, expected=SWIN_STEP_LAUNCHES))
    ts, peak, metrics = time_steps(torch, step, state, x, y, warmup=1, timed=5)
    med = statistics.median(ts)
    checks.record(all(math.isfinite(v) for m in metrics for v in m.values()),
                  dict(phase="swin_step_losses_finite", last_metrics=metrics[-1]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, x, y)
        torch.cuda.synchronize()
    attn = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if us > 0 and any(k in e.key.lower() for k in ATTENTION_KEYS):
            attn[e.key[:160]] = us / 1e3
    checks.record(bool(attn), dict(phase="swin_attention_kernels", device_ms=attn))
    # the Swin encoder's device ops a step: the step's against the same step
    # with the encoder's forward answering its hidden states from a cache
    # (no forward, no backward of it)
    enc = state.gen.swin_unetr.swin
    with torch.no_grad():
        cached = [h.detach() for h in enc(getattr(state.gen, state.gen.head_name)(x))]
    ops = {}
    for stub in (False, True):
        if stub:
            enc.forward = lambda _x: list(cached)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, x, y)
            torch.cuda.synchronize()
        ops["stub" if stub else "step"] = sum(
            1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    del enc.forward
    encoder_ops = ops["step"] - ops["stub"]
    checks.record(encoder_ops > 0, dict(phase="swin_encoder_device_ops", step=ops["step"],
                                        without_encoder=ops["stub"], encoder=encoder_ops))
    out = {"ms_per_step_median": med, "ms_all": ts, "crops_per_s": SWIN_BATCH * 1e3 / med,
           "peak_mib": peak, "last_metrics": metrics[-1], "attention_device_ms": attn,
           "device_ops": ops, "encoder_device_ops": encoder_ops}
    print(f"swin train step (bf16, 4 × 96³): {med:.3f} ms/step median; peak {peak:.0f} MiB; "
          f"attention kernels {json.dumps(attn)}; device ops {json.dumps(ops)}", flush=True)
    del state, step
    torch.cuda.empty_cache()
    return counts, out


def f32_step_failures(ref_m, ref_g, got_m, got_g, zero_grad_biases=(".conv.bias",)):
    """One f32 training step against a reference step from the same weights
    and batch: each loss within 1e-4 relative (D's 1e-2), each generator
    gradient leaf within 5e-2 relative L2, a conv bias before a norm (true
    gradient 0; named by ``zero_grad_biases``) within 1e-4 of the largest
    reference gradient. Returns the losses' relative errors, the worst
    non-bias leaf and the failures."""
    gmax = max(float(v.abs().max()) for v in ref_g.values())
    loss_rel = {k: abs(got_m[k] - r) / abs(r) for k, r in ref_m.items()}
    bad = [k for k, e in loss_rel.items() if not e <= (1e-2 if k == "train_discr_loss" else 1e-4)]
    for name, r in ref_g.items():
        if name.endswith(zero_grad_biases):
            err, tol = float((got_g[name] - r).abs().max()) / gmax, 1e-4
        else:
            err, tol = rel_l2(got_g[name], r), 5e-2
        if not err <= tol:
            bad.append((name, err, tol))
    worst = max(((n, rel_l2(got_g[n], r)) for n, r in ref_g.items()
                 if not n.endswith(zero_grad_biases)), key=lambda t: t[1])
    return loss_rel, worst, bad


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


def one_step(torch, pkg, x, y, **over):
    """One default training step (dropout 0) from SEED with ``over`` on the
    model config → (metrics, BN running-stat changes, every gradient)."""
    Config, create_gan_state, make_train_step = pkg
    cfg = Config()
    mcfg = dataclasses.replace(cfg.model, dropout=0.0, **over)
    state = create_gan_state(SEED, MODALITY, mcfg, cfg.train, "cuda")
    models = (("gen", state.gen), ("disc", state.disc))
    before = {f"{k}.{n}": b.detach().clone() for k, m in models
              for n, b in m.named_buffers()}
    metrics = make_train_step(state.gen, state.disc, cfg.train)(state, x, y)
    stats = {f"{k}.{n}": b.detach().float() - before[f"{k}.{n}"]
             for k, m in models for n, b in m.named_buffers()}
    # after the step: gen holds its phase's gradients, disc its own
    grads = {f"{k}.{n}": p.grad.detach().float() for k, m in models
             for n, p in m.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, stats, grads


def phase_train_compare(torch, checks, pkg, x, y):
    """The bf16 step at batch 8 × 64³ through the kernels (packed) and on
    cuDNN (packed off), each held against the f32 cuDNN step, from one seed
    and batch, dropout 0 (the two layouts draw different masks). Every loss,
    every BatchNorm running-stat change and every gradient of the kernels'
    bf16 step must be no further from f32 than 3× how far cuDNN's bf16 step
    is, plus 2^-8 (one bf16 rounding): the kernels' bf16 training is to be
    as good as the library's. A graph cut in bf16 only, or a wrong dy cast,
    moves its leaves by ~1."""
    runs = {key: one_step(torch, pkg, x, y, **over) for key, over in (
        ("kernels", dict(packed=True)), ("cudnn", dict(packed=False)),
        ("f32", dict(packed=False, compute_dtype="float32")))}
    torch.cuda.empty_cache()
    (mk, sk, gk), (mc, sc, gc), (mf, sf, gf) = (runs[k] for k in ("kernels", "cudnn", "f32"))
    # conv biases feeding a norm (every ``.conv.bias`` of the generator, the
    # discriminator's d2…d5) have true gradient 0: their distance is taken
    # against the largest gradient of the net instead
    gmax = max(float(v.abs().max()) for v in gf.values())

    def dist(a, ref, name):
        if name.endswith(".conv.bias") and not name.startswith("disc.d1_"):
            return float((a - ref).abs().max()) / gmax
        return rel_l2(a, ref)

    rows = [(f"loss {n}", abs(mk[n] - mf[n]) / abs(mf[n]), abs(mc[n] - mf[n]) / abs(mf[n]))
            for n in mf]
    rows += [(f"stat {n}", rel_l2(sk[n], sf[n]), rel_l2(sc[n], sf[n])) for n in sf]
    rows += [(f"grad {n}", dist(gk[n], gf[n], n), dist(gc[n], gf[n], n)) for n in gf]
    bad = [r for r in rows if not r[1] <= 3 * r[2] + 2 ** -8]
    worst = max(rows, key=lambda r: r[1] - 3 * r[2])
    ratio = max(r[1] / r[2] for r in rows if r[2] > 0)
    # leaves whose limit lies below 1, where a cut graph would fail the check
    leaves = [r for r in rows if r[0].startswith("grad ")]
    guarded = sum(3 * r[2] + 2 ** -8 < 1 for r in leaves)
    print(f"bf16 step vs f32 ({len(rows)} quantities): worst kernels {worst[1]:.2e} "
          f"vs cudnn {worst[2]:.2e} at {worst[0]}; largest kernels "
          f"{max(r[1] for r in rows):.2e}, largest cudnn {max(r[2] for r in rows):.2e}; "
          f"largest kernels/cudnn ratio {ratio:.2f}; a cut leaf would fail at "
          f"{guarded} of {len(leaves)} leaves; failures {bad}", flush=True)
    checks.record(not bad and sk.keys() == sc.keys() and gk.keys() == gc.keys(),
                  dict(phase="train_bf16_step_vs_cudnn", quantities=len(rows),
                       worst=worst, failures=bad, max_ratio=ratio,
                       cut_leaf_fails_at=guarded, leaves=len(leaves),
                       unguarded=[r for r in leaves if not 3 * r[2] + 2 ** -8 < 1],
                       largest=sorted(rows, key=lambda r: -r[1])[:5],
                       losses={"kernels": mk, "cudnn": mc, "f32": mf}))


def phase_train(torch, K, checks, pkg):
    Config, create_gan_state, make_train_step = pkg
    cfg = Config()
    mcfg, tcfg = cfg.model, cfg.train
    if cfg.data.batch_size != TRAIN_BATCH or cfg.data.patch_size != TRAIN_PATCH:
        raise RuntimeError("default config does not train on 8 × 64³")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (24,), device="cuda", generator=g)
    y = torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (6,), device="cuda", generator=g)
    phase_train_compare(torch, checks, pkg, x, y)
    out = {}
    counts = None
    for packed in (True, False):  # packed off: the same step on cuDNN
        state = create_gan_state(SEED, MODALITY, dataclasses.replace(mcfg, packed=packed),
                                 tcfg, "cuda")
        step = make_train_step(state.gen, state.disc, tcfg)
        step(state, x, y)  # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        if packed:
            K.reset_launches()
            step(state, x, y)
            torch.cuda.synchronize()
            counts = K.launches()
            print("training-step launches: " + json.dumps(counts), flush=True)
            checks.record(counts == TRAIN_STEP_LAUNCHES,
                          dict(phase="train_step_launches", launches=counts,
                               expected=TRAIN_STEP_LAUNCHES))
        ts, peak, metrics = time_steps(torch, step, state, x, y)
        finite = all(math.isfinite(v) for m in metrics for v in m.values())
        med = statistics.median(ts)
        key = "packed" if packed else "cudnn"
        out[key] = {"ms_per_step_median": med, "ms_all": ts,
                    "patches_per_s": TRAIN_BATCH * 1e3 / med, "peak_mib": peak,
                    "last_metrics": metrics[-1]}
        print(f"train step {key} (bf16, 8 × 64³): {med:.3f} ms/step median "
              f"({TRAIN_BATCH * 1e3 / med:.1f} patches/s; runs "
              f"{', '.join(f'{t:.2f}' for t in ts)}); peak {peak:.0f} MiB; "
              f"last losses {json.dumps(metrics[-1])}", flush=True)
        checks.record(finite, dict(phase="train_step_losses_finite", mode=key,
                                   last_metrics=metrics[-1]))
        del state, step
        torch.cuda.empty_cache()
    return counts, out


def phase_train_grad_check(torch, checks, pkg, phase="train_f32_grad_check"):
    """One generator-phase backward (BCE(D(x, G(x)), 1) + L1·rf), batch
    2 × 64³, dropout 0, from the same weights and batch: the kernels (f32,
    packed, use_pallas) against plain PyTorch/cuDNN in f32, both TF32 off;
    recorded as ``phase``."""
    Config, build_models, weights, losses = pkg
    cfg = Config()
    rf = cfg.train.recon_factor
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn((2,) + (TRAIN_PATCH,) * 3 + (24,), device="cuda", generator=g)
    # L1 sign fixed: the target sits above every prediction
    y = 10.0 + torch.rand((2,) + (TRAIN_PATCH,) * 3 + (6,), device="cuda", generator=g)
    grads, loss_vals, sds = {}, {}, None
    for key, over in (("plain", dict(packed=False, use_pallas=False)),
                      ("kernels", dict(packed=True, use_pallas=True))):
        mcfg = dataclasses.replace(cfg.model, compute_dtype="float32", dropout=0.0,
                                   **over)
        gen, disc = build_models(MODALITY, mcfg, "cuda")
        if sds is None:
            sds = (weights.random_state_dict(gen, SEED),
                   weights.random_state_dict(disc, SEED + 1))
        gen.load_state_dict(sds[0])
        disc.load_state_dict(sds[1])
        gen.train()
        disc.train()
        disc.requires_grad_(False)
        y_hat = gen(x)
        logits = disc(x, y_hat)
        loss = (losses.bce_with_logits(logits, torch.ones_like(logits))
                + losses.l1_loss(y_hat, y) * rf)
        loss.backward()
        loss_vals[key] = float(loss.detach())
        grads[key] = {n: p.grad.detach().clone() for n, p in gen.named_parameters()}
        del gen, disc
    ref, got = grads["plain"], grads["kernels"]
    scale = max(float(v.abs().max()) for v in ref.values())
    bad, rows = [], []
    for name, r in ref.items():
        if name.endswith(".conv.bias"):
            # true gradient 0 (the following norm removes the bias): f32
            # cancellation noise, bounded against the net's largest gradient
            err, tol = float((got[name] - r).abs().max()), 1e-4 * scale
        else:
            # Relative L2 per leaf. The f32 gradient of this net is itself
            # ill-conditioned: max-pool routing and LeakyReLU kinks flip when
            # a forward value moves by one rounding, so plain f32 strays from
            # f64 by up to 1.0e-2 here (PERF.md), and two f32 paths differ by
            # as much. 5e-2 is five times that, and a twentieth of the 1.0 of
            # a leaf whose graph was cut.
            err, tol = rel_l2(got[name], r), 5e-2
            rows.append((name, err))
        if not err <= tol:
            bad.append((name, err, tol))
    worst = max(rows, key=lambda t: t[1])
    loss_rel = abs(loss_vals["kernels"] - loss_vals["plain"]) / abs(loss_vals["plain"])
    print(f"{phase}: {len(ref)} leaves; worst kernels-vs-plain rel L2 "
          f"{worst[1]:.2e} at {worst[0]}; loss rel err {loss_rel:.2e}; "
          f"failures {bad}", flush=True)
    checks.record(not bad and loss_rel <= 1e-5 and got.keys() == ref.keys(),
                  dict(phase=phase, leaves=len(ref),
                       worst_leaf=worst, loss_rel_err=loss_rel, failures=bad))


def device_ms(torch, fn, kernel: str, iters: int = 20):
    """Device time per call of the CUDA kernel named ``kernel`` under
    ``torch.profiler`` (None if the trace shows no such kernel): the time
    the card spends in it, without the wrapper's host work between launches,
    which CUDA events around back-to-back calls include when it is longer."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
                if kernel in e.key)
    return total / 1e3 / iters if total else None


def sm_clock_under_load(torch, fn, seconds: float = 0.8):
    """The SM clock (MHz) ``nvidia-smi`` reads every 20 ms while the card
    runs ``fn`` back to back for ``seconds`` (the median of those samples,
    the first three dropped), and the card's maximum: for the
    special-function bound."""
    top = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, timeout=60).stdout.split()[0])
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
                            "-lms", "20"], stdout=subprocess.PIPE, text=True)
    try:
        smi.stdout.readline()  # sampling has started
        t0, n = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            fn()
            n += 1
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=60)
    samples = [float(v) for v in out.split()][3:]
    return {"mhz": statistics.median(samples) if samples else top, "max_mhz": top,
            "samples": len(samples), "launches": n}


def load_dir(nifti, path):
    """Every NIfTI file of ``path`` by name, read in 8 threads."""
    from concurrent.futures import ThreadPoolExecutor

    names = sorted(os.listdir(path))
    with ThreadPoolExecutor(8) as pool:
        arrays = pool.map(lambda fn: nifti.load_volume(str(path / fn))[0], names)
        return dict(zip(names, arrays))


def eigh_batch_limit(torch, mats) -> int:
    """The largest batch (V halved until it is taken) that cuSOLVER's
    batched eigh accepts: it refuses a whole (96, 128, 128) volume."""
    chunk = mats.shape[0]
    while True:
        try:
            torch.linalg.eigh(mats[:chunk])
            torch.cuda.synchronize()
            return chunk
        except RuntimeError:
            if chunk < 2048:
                raise
            chunk = -(-chunk // 2)


def check_scalar_maps(torch, K, chk, checks, fields, shape, seed):
    """K8 against its plain version (ATen on the card) at the per-voxel
    bound of ``compare_scalar_maps`` (derived in ops/scalar_maps_check.py:
    angles and RGB only where the principal eigenvector is defined, zero
    voxels exactly)."""
    d6 = torch.from_numpy(chk.sample_dt_volume(shape, seed)).to("cuda")
    got = K.scalar_maps(d6)
    ref = K.scalar_maps_plain(d6)
    res = chk.compare_scalar_maps(got, ref, d6)
    repeats = all(torch.equal(a, b) for a, b in zip(got, K.scalar_maps(d6)))
    zero = (d6 == 0).all(-1)
    zeros_exact = all(bool((f[zero] == 0).all()) for f in got)
    bitwise = {k: bool(torch.equal(a, b)) for k, a, b in zip(fields, got, ref)}
    nvox = d6.numel() // 6
    mats = torch.empty(nvox, 3, 3, device="cuda")
    flat = d6.reshape(nvox, 6)
    for c, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))):
        mats[:, i, j] = mats[:, j, i] = flat[:, c]
    big = nvox >= 1 << 20
    ms = time_ms(torch, lambda: K.scalar_maps(d6), 50 if big else 200)
    plain_ms = time_ms(torch, lambda: K.scalar_maps_plain(d6), 5 if big else 20)
    kern_ms = device_ms(torch, lambda: K.scalar_maps(d6), "scalar_maps_kernel")
    chunk = eigh_batch_limit(torch, mats)
    lib_ms = time_ms(torch, lambda: [torch.linalg.eigh(mats[i:i + chunk])
                                     for i in range(0, nvox, chunk)], 3 if big else 20)
    clock = sm_clock_under_load(torch, lambda: K.scalar_maps(d6))
    t_bytes = nvox * SCALAR_MAPS_BYTES_PER_VOXEL / HBM_BYTES_PER_S * 1e3
    t_ops = nvox * SCALAR_MAPS_OPS_PER_VOXEL / PEAK_OPS["float32"] * 1e3
    t_mufu = nvox * SCALAR_MAPS_MUFU_PER_VOXEL / (
        MUFU_PER_CLOCK_PER_SM * torch.cuda.get_device_properties(0).multi_processor_count
        * clock["mhz"] * 1e6) * 1e3
    bms = max(t_bytes, t_ops, t_mufu)
    by = "bytes" if bms == t_bytes else "operations"
    binding = {t_bytes: "bytes", t_ops: "f32 operations", t_mufu: "special functions"}[bms]
    print(f"K8 scalar_maps {tuple(shape)}: {ms:.4f} ms per call, device {kern_ms} ms; "
          f"bound {bms:.4f} ({binding}: bytes {t_bytes:.4f}, "
          f"f32 operations {t_ops:.4f}, special functions {t_mufu:.4f} at "
          f"{clock['mhz']} MHz); plain "
          f"{plain_ms:.3f}; torch.linalg.eigh {lib_ms:.3f} in {-(-nvox // chunk)} "
          f"call(s)); max err per field "
          f"{ {k: res[k]['max_abs_err'] for k in fields} }; bit-equal to plain "
          f"{bitwise}; angles/RGB left out at {res['gated_out']} of {nvox} voxels; "
          f"rerun bit-identical {repeats}", flush=True)
    checks.record(res["ok"] and repeats and zeros_exact, dict(
        kernel="scalar_maps", shape=list(d6.shape), dtype="float32",
        max_abs_err=max(res[k]["max_abs_err"] for k in fields),
        fields={k: res[k] for k in fields}, gated_out=res["gated_out"],
        voxels=nvox, bitwise_equal_to_plain=bitwise, zeros_exact=zeros_exact,
        bit_identical_rerun=repeats, ms=ms, device_ms=kern_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, binding=binding,
        bound_terms={"bytes_ms": t_bytes, "f32_operations_ms": t_ops,
                     "special_functions_ms": t_mufu, "sm_clock": clock},
        library_ms=lib_ms,
        library="torch.linalg.eigh on (V, 3, 3): the eigendecomposition alone",
        library_calls=-(-nvox // chunk)))


def phase_scalar_maps(torch, K, chk, checks, fields):
    """K8 at both shapes: within ``compare_scalar_maps``' bound of its plain
    version, and a second launch bit for bit the first."""
    check_scalar_maps(torch, K, chk, checks, fields, VOLUME, SEED)
    check_scalar_maps(torch, K, chk, checks, fields, (5, 7, 3), SEED + 1)


def make_tree(make_synthetic_bids, root: Path) -> float:
    """The synthetic BIDS tree of phases 7 and 12 at full size: subjects 01
    and 02 from SEED (the arrays phase 7 always had) and 03 and 04 from
    SEED + 1, written in two threads (the native codec releases the GIL).
    Returns its seconds."""
    from concurrent.futures import ThreadPoolExecutor

    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futures = [pool.submit(make_synthetic_bids, str(root), subjects=subs, sessions=("1",),
                               volume_shape=VOLUME, seed=seed)
                   for subs, seed in ((EVAL_SUBJECTS, SEED), (DATA_SUBJECTS[2:], SEED + 1))]
        for f in futures:
            f.result()
    return time.perf_counter() - t0


def phase_eval(torch, K, checks, pkg, bids: str, synth_s: float):
    """The evaluation path at full size on the card, its launches, its wall
    time (and, with one worker, its NIfTI I/O share), the CPU chain's table
    against the card's, then ``predict --scalar-maps``."""
    work = Path("perf_out") / "eval_smoke"
    shutil.rmtree(work, ignore_errors=True)
    try:
        return _phase_eval(torch, K, checks, pkg, work, bids, synth_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_eval(torch, K, checks, pkg, work, bids, synth_s):
    (Config, build_models, make_predict_fn, weights, predict_volume, nifti,
     evaluate, predict_main, compute_scalar_maps, invert_dwi_tensor_norm,
     load_rescale_args, chk) = pkg
    cfg = Config()
    gen, _ = build_models(MODALITY, cfg.model, "cuda")
    sd = weights.random_state_dict(gen, SEED)
    gen.load_state_dict(sd)
    fn = make_predict_fn(gen)
    roots = {k: work / k for k in ("card", "card_1worker", "host")}
    pred_dir = roots["card"] / MODALITY
    pred_dir.mkdir(parents=True)
    inputs = []
    t0 = time.perf_counter()
    for i, sub in enumerate(EVAL_SUBJECTS):
        pre = Path(bids) / "derivatives" / "preproc-dove" / f"sub-{sub}" / "ses-1" / "dwi" / f"sub-{sub}_ses-1"
        inputs.append(f"{pre}_desc-normflatbet_bssfp.nii.gz")
        x, aff = nifti.load_volume(inputs[-1])
        y, _ = nifti.load_volume(f"{pre}_desc-normtensor_dwi.nii.gz")
        pred = predict_volume(fn, torch.from_numpy(x).to("cuda"), patch_size=cfg.data.patch_size)
        name = f"mod-{MODALITY}_sub-{sub}_ses-1.nii.gz"
        nifti.save_volume(str(pred_dir / f"pred-{i}_{name}"), pred.float().cpu().numpy(), aff)
        nifti.save_volume(str(pred_dir / f"target-{i}_{name}"), y, aff)
    predict_s = time.perf_counter() - t0
    del gen, fn
    torch.cuda.empty_cache()
    shutil.copytree(roots["card"], roots["host"])
    # the one-worker run times the chain on subject 01's pair alone: its
    # NIfTI I/O share is a share per volume
    shutil.copytree(roots["card"], roots["card_1worker"], ignore=lambda _, names: [
        n for n in names if n.endswith(".nii.gz") and "-0_" not in n])

    def chain(key, device, workers):
        root = roots[key]
        t = time.perf_counter()
        evaluate.eval_dwi_tensors(str(root / MODALITY), RESCALE_ARGS, workers, device)
        rows = evaluate.calc_error_table(str(root), bids, str(root / "relative_errors.csv"),
                                         num_workers=workers, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        return rows, time.perf_counter() - t

    K.reset_launches()
    rows, wall = chain("card", "cuda", 8)
    counts = K.launches()
    print("eval-chain launches: " + json.dumps(counts), flush=True)
    expected = dict.fromkeys(counts, 0)
    expected["scalar_maps"] = 2 * len(EVAL_SUBJECTS)
    checks.record(counts == expected, dict(phase="eval_launches", launches=counts,
                                           expected=expected))

    cols = evaluate.table_columns(rows)
    want_cols = (["modality", "pred_id", "roi", "sub", "ses"] + list(evaluate.BASE_COLS)
                 + [f"{c}_floored" for c in evaluate.BASE_COLS
                    if c not in ("azimuth", "inclination")])
    values = [v for r in rows for v in r.values() if not isinstance(v, str)]
    checks.record(len(rows) == 3 * len(EVAL_SUBJECTS) and cols == want_cols
                  and all(math.isfinite(v) for v in values),
                  dict(phase="eval_table", rows=len(rows), columns=cols,
                       first_row=rows[0] if rows else None))

    io = [0.0]

    def timed(f):
        def call(*a, **kw):
            t = time.perf_counter()
            try:
                return f(*a, **kw)
            finally:
                io[0] += time.perf_counter() - t
        return call

    load, save = evaluate.load_volume, evaluate.save_volume
    evaluate.load_volume, evaluate.save_volume = timed(load), timed(save)
    try:
        _, wall_1 = chain("card_1worker", "cuda", 1)
    finally:
        evaluate.load_volume, evaluate.save_volume = load, save
    cpu_rows, cpu_wall = chain("host", "cpu", 8)
    # K8 contracts a·b + c into FMAs, so the card's maps are not the CPU's
    # bit for bit: every file is held to the maps' bound carried through the
    # chain, and each table cell to its share of its diff map's bound
    t0 = time.perf_counter()
    files = {k: load_dir(nifti, roots[k] / MODALITY) for k in ("card", "host")}
    bounds = chk.chain_bounds(files["host"], load_rescale_args(RESCALE_ARGS))
    chain_res = chk.compare_chain_files(files["card"], files["host"], bounds)
    masks, probsegs = evaluate._load_masks(bids, EVAL_SUBJECTS, "derivatives/preproc-dove",
                                           torch.device("cpu"))
    cells = chk.table_cell_bounds(cpu_rows, files["card"], files["host"], bounds, masks,
                                  probsegs)
    del files, bounds
    checks.record(chain_res["ok"], dict(phase="eval_files_cuda_vs_cpu",
                                        failures=chain_res["failures"][:20],
                                        most_left_out=max(chain_res["left_out"].values(),
                                                          default=0),
                                        seconds=time.perf_counter() - t0))
    bad = chk.compare_error_tables(rows, cpu_rows, cells)
    worst = max(((k, abs(g[k] - c[k]) / max(abs(c[k]), 1e-300)) for g, c in zip(rows, cpu_rows)
                 for k in c if not isinstance(c[k], str)), key=lambda kv: kv[1], default=None)
    nvol = 2 * len(EVAL_SUBJECTS)
    timing = {"synthetic_tree_s": synth_s, "synthetic_tree_subjects": len(DATA_SUBJECTS),
              "predict_2_volumes_s": predict_s,
              "chain_s_8_workers": wall, "chain_s_1_worker": wall_1,
              "chain_1_worker_volumes": 2,
              "chain_1_worker_nifti_io_s": io[0], "chain_1_worker_rest_s": wall_1 - io[0],
              "chain_1_worker_nifti_io_share": io[0] / wall_1, "nifti_codec": nifti.codec(),
              "cpu_chain_s_8_workers": cpu_wall, "volumes": nvol,
              "s_per_volume_8_workers": wall / nvol}
    print(f"eval chain (2 subjects × pred+target at {VOLUME}): {wall:.2f} s with 8 "
          f"workers ({wall / nvol:.2f} s per volume); 1 worker on subject 01's pair "
          f"{wall_1:.2f} s, of which "
          f"NIfTI I/O {io[0]:.2f} s ({100 * io[0] / wall_1:.1f} %, {nifti.codec()} codec); "
          f"CPU chain {cpu_wall:.2f} s; synthetic tree of {len(DATA_SUBJECTS)} subjects "
          f"{synth_s:.1f} s; card vs CPU table: largest relative difference {worst}, "
          f"cells past their bound {bad}", flush=True)
    checks.record(not bad, dict(phase="eval_table_cuda_vs_cpu", failures=bad[:20],
                                largest_rel_diff=worst, timing=timing))

    wpath = str(work / "w.pt")
    weights.save(sd, wpath)
    out_dir = work / "predict"
    K.reset_launches()
    predict_main([inputs[0], "--weights", wpath, "--out-dir", str(out_dir), "--device",
                  "cuda", "--scalar-maps", "--rescale-args", RESCALE_ARGS])
    torch.cuda.synchronize()
    pcounts = K.launches()
    base = Path(inputs[0]).name.split(".nii")[0]
    pred, _ = nifti.load_volume(str(out_dir / f"{base}_pred-dt.nii.gz"))
    d6 = invert_dwi_tensor_norm(torch.from_numpy(pred), load_rescale_args(RESCALE_ARGS))
    plain = compute_scalar_maps(d6)  # the CPU's plain version
    got = []
    for name, ref in zip(plain._fields, plain):
        arr, _ = nifti.load_volume(str(out_dir / f"{base}_{name}.nii.gz"))
        got.append(torch.from_numpy(arr).reshape(ref.shape))
    res = chk.compare_scalar_maps(got, plain, d6)
    print(f"predict --scalar-maps: launches {json.dumps(pcounts)}; maps vs CPU plain "
          f"ok={res['ok']} (angles/RGB left out at {res['gated_out']} voxels)", flush=True)
    checks.record(pcounts["scalar_maps"] == 1 and pcounts["conv3x3_packed"] > 0 and res["ok"],
                  dict(phase="predict_scalar_maps", launches=pcounts, maps=res))
    return counts, timing


def timed_volumes(torch, predict_volume, fn, vol, whole, mesh=None, runs=5):
    """ms per volume (host clock, each run synchronised) over ``runs`` runs
    after a warm-up, and the peak MiB allocated."""
    call = lambda: predict_volume(fn, vol, patch_size=64, whole_volume=whole,  # noqa: E731
                                  mesh=mesh)
    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for _ in range(runs):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return {"ms_per_volume_median": statistics.median(ts), "ms_all": ts,
            "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}


def mesh_case(torch, K, checks, pkg, devices, shape, whole, vol, sd, label):
    """One mesh: exact launch counts of a served volume (bf16), the f32
    sharded output against the unsharded port's and plain PyTorch/cuDNN's,
    bf16 against f32. Returns the bf16 predict function and its mesh."""
    Config, build_models, make_predict_fn, predict_volume, make_mesh = pkg
    mcfg = Config().model
    mesh = make_mesh(devices, ("data", "space"), shape)

    def model(use_mesh, **over):
        gen, _ = build_models(MODALITY, dataclasses.replace(mcfg, **over),
                              None if use_mesh else "cuda", state_dict=sd,
                              mesh=mesh if use_mesh else None)
        return make_predict_fn(gen, mesh if use_mesh else None)

    def run(fn, use_mesh):
        out = predict_volume(fn, vol, patch_size=64, whole_volume=whole,
                             mesh=mesh if use_mesh else None)
        torch.cuda.synchronize()
        return out

    fn = model(True)
    run(fn, True)                                      # warm-up
    K.reset_launches()
    out = run(fn, True).float()
    counts, expected = K.launches(), mesh_launches(shape)
    checks.record(counts == expected,
                  dict(phase="mesh_serving_launches", mesh=label, whole=whole,
                       launches=counts, expected=expected))
    got = run(model(True, compute_dtype="float32", packed=True), True).float()
    flat = run(model(False, compute_dtype="float32", packed=True), False).float()
    ref = run(model(False, compute_dtype="float32", packed=False), False).float()
    top = float(ref.abs().max())
    rel_flat = float((got - flat).abs().max()) / top
    rel_plain = float((got - ref).abs().max()) / top
    rel_bf16 = float((out - ref).abs().max()) / top
    # sharded vs unsharded, f32: the same kernels on the same values; only
    # the norms' moments are summed in another order (per shard, then over
    # space). vs cuDNN: the bound of main_path_f32_vs_plain; bf16 as there.
    shape_ok = tuple(got.shape) == VOLUME + (6,) and tuple(out.shape) == VOLUME + (6,)
    checks.record(rel_flat <= 1e-5 and rel_plain <= 1e-3 and rel_bf16 < 0.1 and shape_ok
                  and bool(torch.isfinite(got).all()) and bool(torch.isfinite(out).all()),
                  dict(phase="mesh_serving_f32", mesh=label, whole=whole,
                       rel_max_err_vs_unsharded=rel_flat, tol_vs_unsharded=1e-5,
                       rel_max_err_vs_plain=rel_plain, tol_vs_plain=1e-3,
                       bf16_rel_max_err_vs_f32=rel_bf16))
    return fn, mesh


def phase_mesh_serving(torch, K, checks, pkg, weights):
    """The generator on (data, space) meshes whose positions all lie on
    cuda:0, then the counted and timed runs of all three."""
    Config, build_models, make_predict_fn, predict_volume, make_mesh = pkg
    probe, _ = build_models(MODALITY, Config().model, "cuda")
    sd = weights.random_state_dict(probe, SEED)
    g = torch.Generator().manual_seed(SEED)
    vol = torch.randn(VOLUME + (24,), generator=g).to("cuda")
    cases = []
    for shape, whole in MESH_RUNS:
        label = f"{shape[0]}x{shape[1]}"
        fn, mesh = mesh_case(torch, K, checks, pkg, ["cuda:0"], shape, whole, vol, sd, label)
        cases.append((label, whole, fn, mesh))
        torch.cuda.empty_cache()

    K.reset_launches()
    for _, whole, fn, mesh in cases:
        predict_volume(fn, vol, patch_size=64, whole_volume=whole, mesh=mesh)
    torch.cuda.synchronize()
    counts = K.launches()
    expected = {k: sum(mesh_launches(s)[k] for s, _ in MESH_RUNS) for k in counts}
    print("mesh-serving launches: " + json.dumps(counts), flush=True)
    checks.record(counts == expected and counts["conv3x3_packed_halo"] > 0,
                  dict(phase="mesh_path_launches", launches=counts, expected=expected))

    timing = {}
    flat = make_predict_fn(probe)
    probe.load_state_dict(sd)
    for whole in (True, False):
        key = f"unsharded_{'whole' if whole else 'patch'}"
        timing[key] = timed_volumes(torch, predict_volume, flat, vol, whole)
    for label, whole, fn, mesh in cases:
        key = f"mesh_{label}_{'whole' if whole else 'patch'}"
        timing[key] = timed_volumes(torch, predict_volume, fn, vol, whole, mesh)
    for key, t in timing.items():
        print(f"ms/volume {key} (bf16): {t['ms_per_volume_median']:.3f} (runs "
              f"{', '.join(f'{x:.3f}' for x in t['ms_all'])}); peak "
              f"{t['peak_mib']:.0f} MiB allocated", flush=True)

    if torch.cuda.device_count() >= 2:
        mesh_case(torch, K, checks, pkg, ["cuda:0", "cuda:1"], (1, 2), True, vol, sd,
                  "1x2_two_cards")
        print(json.dumps({"phase": "mesh_multi_card", "ran": True,
                          "devices": torch.cuda.device_count()}), flush=True)
    else:
        print(json.dumps({"phase": "mesh_multi_card", "ran": False,
                          "devices": torch.cuda.device_count()}), flush=True)
    return counts, timing


def phase_mesh_block_backward(torch, K, checks, PackedTwoConv, mesh_pkg):
    """A full-width PackedTwoConv (24 → 32 → 32, B 2 × 64³, f32) forward +
    backward on mesh (1, 2) against the same block unsharded: dx and every
    parameter gradient, for a non-uniform upstream gradient (the boundary
    taps matter), under the bound of ``train_f32_grad_check``."""
    make_mesh, shard_batch, gather_batch = mesh_pkg
    torch.manual_seed(SEED)
    block = PackedTwoConv(24, 32, dropout=0.0, compute_dtype=torch.float32).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = torch.randn((2,) + (TRAIN_PATCH,) * 3 + (24,), device="cuda", generator=g)
    up = torch.rand((2, TRAIN_PATCH, 32, TRAIN_PATCH ** 2), device="cuda", generator=g)
    mesh = make_mesh(["cuda:0"], ("data", "space"), (1, 2))

    def grads(sharded):
        xi = x.clone().requires_grad_(True)
        block.zero_grad(set_to_none=True)
        if sharded:
            y = gather_batch(block.forward_packed(shard_batch(mesh, xi)))
        else:
            y = block.forward_packed(xi)
        (y * up).sum().backward()
        out = {n: p.grad.detach().clone() for n, p in block.named_parameters()}
        out["dx"] = xi.grad.detach().clone()
        return out

    ref = grads(False)
    K.reset_launches()
    got = grads(True)
    torch.cuda.synchronize()
    counts = K.launches()
    scale = max(float(v.abs().max()) for v in ref.values())
    rows = []
    for name, r in ref.items():
        if name.endswith(".conv.bias"):  # true gradient 0: against the largest
            rows.append((name, float((got[name] - r).abs().max()) / scale, 1e-4))
        else:
            rows.append((name, rel_l2(got[name], r), 5e-2))
    bad = [r for r in rows if not r[1] <= r[2]]
    worst = max((r for r in rows if r[2] == 5e-2), key=lambda r: r[1])
    print(f"sharded block backward (1, 2): launches {json.dumps(counts)}; worst "
          f"sharded-vs-unsharded rel L2 {worst[1]:.2e} at {worst[0]}; failures {bad}",
          flush=True)
    checks.record(not bad and counts == BLOCK_BACKWARD_LAUNCHES,
                  dict(phase="mesh_block_backward", launches=counts,
                       expected=BLOCK_BACKWARD_LAUNCHES, distances=rows, failures=bad))
    return counts


def phase_pfold_kernels(torch, F, K, checks):
    """K7a's four entries and K7b's two against their plain versions: K7a
    bit for bit the packed kernel its folded shape routes to (bf16: K1's
    wgmma kernel at the probe cases, the ``mma.sync`` loop at ``PFOLD_ODD``),
    K7b within K2's bound at its plan's chain (bit for bit the loop it runs
    where it is routed there)."""
    def all_three(b, d, h, w, cin, cout, dtype, halo):
        check_conv(torch, F, K, checks, b, d, h, w, cin, cout, dtype, halo=halo, fold=True)
        check_dgrad(torch, K, checks, b, d, h, w, cin, cout, dtype, halo=halo, fold=True)
        check_wgrad(torch, K, checks, b, d, h, w, cin, cout, dtype, halo=halo, fold=True)
        torch.cuda.empty_cache()

    for d, hw, cin, cout in PFOLD_CASES:
        all_three(8, d, hw, hw, cin, cout, "bfloat16", False)
    all_three(8, 64, 64, 64, 24, 32, "float32", False)
    all_three(8, 32, 64, 64, 96, 32, "bfloat16", True)   # a D_local-32 shard
    all_three(8, 32, 64, 64, 24, 32, "float32", True)
    for shape in PFOLD_ODD:
        for dtype in ("bfloat16", "float32"):
            for halo in (False, True):
                all_three(*shape, dtype, halo)


def phase_probe_kernels(torch, F, K, checks):
    """K9a against its plain version and ``torch.roll``, with its device time
    from the profiler beside its per-call time (CUDA events around 200
    back-to-back calls, host work included, the median of 7 runs alternating
    with ``torch.roll``'s); K9b's three modes against
    theirs at the conv0 shape, under K1's bf16 bound, ``full`` bit for bit
    K1 (``conv3x3_packed``), timed beside it."""
    x = torch.randn(8, 128, device="cuda")
    got = K.lane_roll(x, 1)
    big = torch.randn(1000, 129, device="cuda")  # past the old 12,288-element cap
    big_ok = all(torch.equal(K.lane_roll(big, s), torch.roll(big, s, 1)) for s in (-1, 0, 129))
    ok = (torch.equal(got, K.lane_roll_plain(x, 1)) and torch.equal(got, torch.roll(x, 1, 1))
          and big_ok)
    bms, by = bound(2 * x.numel() * 4, 0, "float32")
    # per call: 200 back-to-back calls between CUDA events, host work
    # included, 7 runs alternating with torch.roll's, the medians (the
    # host's clock moves by tens of percent from run to run)
    runs = [(time_ms(torch, lambda: K.lane_roll(x, 1), 200),
             time_ms(torch, lambda: torch.roll(x, 1, 1), 200)) for _ in range(7)]
    ms, lib_ms = (statistics.median(r[i] for r in runs) for i in (0, 1))
    ratio_quartiles = statistics.quantiles([a / b for a, b in runs], n=4)
    dev = device_ms(torch, lambda: K.lane_roll(x, 1), "lane_roll_kernel", 200)
    lib_dev = device_ms(torch, lambda: torch.roll(x, 1, 1), "roll", 200)
    checks.record(ok, dict(
        kernel="lane_roll", shape=list(x.shape), cout=None, dtype="float32",
        max_abs_err=float((got - K.lane_roll_plain(x, 1)).abs().max()), rtol=0.0, atol=0.0,
        big_tile_bit_equal=big_ok, ms=ms, device_ms=dev,
        plain_ms=time_ms(torch, lambda: K.lane_roll_plain(x, 1), 200), bound_ms=bms,
        bound_by=by, library_ms=lib_ms, library_device_ms=lib_dev,
        per_call_over_library=ms / lib_ms, per_call_runs=runs,
        per_call_ratio_quartiles=ratio_quartiles,
        device_over_library=dev / lib_dev if dev and lib_dev else None))

    b, d, h, w, cin, cout = PROBE_CONV
    g = torch.Generator(device="cuda").manual_seed(cin)
    xk = torch.randn(b, d, cin, h * w, device="cuda", generator=g).bfloat16()
    wt = torch.randn(3, 3, 3, cin, cout, device="cuda", generator=g) / (27 * cin) ** 0.5
    bias = 0.1 * torch.randn(cout, device="cuda", generator=g)
    xn = xk.reshape(b, d, cin, h, w).permute(0, 2, 1, 3, 4)
    wl = wt.bfloat16().permute(4, 3, 0, 1, 2).contiguous()
    wc = wl.float().sum(dim=(3, 4), keepdim=True).bfloat16()
    vox = b * d * h * w
    k1_out = K.conv3x3_packed(xk, wt, bias, w)
    k1_ms = time_ms(torch, lambda: K.conv3x3_packed(xk, wt, bias, w), 10)
    # each mode's function (csrc/conv3x3_wgmma.cuh's MODE note): the input
    # bytes it reads (fixed: min(16, Cin) channels of slice 0 of each
    # batch), its multiply-adds per output (fixed: 27·min(16, Cin), the
    # chunk-summed weights), one PyTorch call computing it if any
    work = {"full": (vox * cin * 2, 27 * cin,
                     lambda: F.conv3d(xn, wl, bias.bfloat16(), padding=1)),
            "centre": (vox * cin * 2, 3 * cin,
                       lambda: F.conv3d(xn, wc, bias.bfloat16(), padding=(1, 0, 0))),
            "fixed": (b * min(16, cin) * h * w * 2, 27 * min(16, cin), None)}
    cin_pad = -(-cin // 16) * 16
    for mode, fn in K.PROBE_MODES.items():
        out = fn(xk, wt, bias, w)
        got = out.float()
        ref = K.conv3x3_probe_plain(xk, wt, bias, w, mode).float()
        err = (got - ref).abs()
        scale = float(ref.abs().max())
        rtol, atol = 2 ** -7, 1e-4 * scale  # K1's bf16 bound
        in_bytes, macs, lib = work[mode]
        bms, by = bound(in_bytes + vox * cout * 2 + 27 * cin * cout * 2,
                        2 * macs * cout * vox, "bfloat16")
        extra = {}
        if mode == "full":  # K1's own kernel: bit for bit, and its time
            extra = {"bit_equal_to_k1": bool(torch.equal(out, k1_out)), "k1_ms": k1_ms}
        if mode == "fixed":  # the products the kernel runs: full's, at cin_pad
            extra = {"padded_products_bound_ms": bound(
                0, 2 * 27 * cin_pad * cout * vox, "bfloat16")[0]}
        checks.record(bool((err <= atol + rtol * ref.abs()).all())
                      and extra.get("bit_equal_to_k1", True), dict(
            kernel=fn.__name__, shape=list(xk.shape), cout=cout, dtype="bfloat16",
            max_abs_err=float(err.max()), ref_max_abs=scale, rtol=rtol, atol=atol,
            ms=time_ms(torch, lambda: fn(xk, wt, bias, w), 10),
            plain_ms=time_ms(torch, lambda: K.conv3x3_probe_plain(xk, wt, bias, w, mode), 5),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(torch, lib, 10) if lib is not None else None, **extra))


def phase_probe_paths(torch, K, checks, pfold_probe, pallas_probe):
    """The two probe scripts' ``run`` as the paths ``pfold_probe`` and
    ``pallas_probe``: counts reset just before each, read just after, held
    to the exact counts each script states (the pfold cases' ``*_mma_routed``
    0: every launch on the wgmma kernels). pfold: K7a's output is K1's bit
    for bit (max |diff| 0), K7b's dW within K2's bound of the plain version
    at its plan's chain and within both kernels' bounds of the wgrad loop's
    (``conv3x3_wgrad_mma``, the loop K7b ran before the wgmma kernel took
    it); pallas: the
    roll's direction, the tiny conv, every mode within K1's bf16 bound of
    its plain version, ``full`` bit for bit K1, no routed launch."""
    K.reset_launches()
    rows, pf_counts = pfold_probe.run("cuda")
    expected = pfold_probe.expected_launches()
    print("pfold_probe launches: " + json.dumps(pf_counts), flush=True)
    checks.record(pf_counts == expected
                  and all(r["max_abs_diff"] == 0 and r["wgrad_max_abs_err"] <= r["wgrad_atol"]
                          and r["wgrad_loop_max_abs_diff"] <= r["wgrad_loop_atol"]
                          for r in rows if "max_abs_diff" in r),
                  dict(phase="pfold_probe_path", launches=pf_counts, expected=expected,
                       rows=rows))
    torch.cuda.empty_cache()
    K.reset_launches()
    prows, pa_counts = pallas_probe.run("cuda")
    expected = pallas_probe.expected_launches()
    print("pallas_probe launches: " + json.dumps(pa_counts), flush=True)
    roll, tiny = prows[0], prows[1]
    ok = (pa_counts == expected and pa_counts["conv3x3_packed_mma_routed"] == 0
          and roll["same_as_torch_roll_plus_1"]
          and not roll["same_as_torch_roll_minus_1"] and tiny["max_abs_err"] <= 1e-4
          and all(r["max_abs_err"] <= (2 ** -7 + 1e-4) * r["ref_max_abs"]
                  and r.get("bit_equal_to_k1", True)
                  for r in prows if r.get("probe") == "ablation"))
    checks.record(ok, dict(phase="pallas_probe_path", launches=pa_counts,
                           expected=expected, rows=prows))
    return pf_counts, pa_counts, rows, prows


def busy_share(prof, wall_s: float):
    """The union of the CUDA kernels' intervals in a profile (two streams'
    kernels overlapping counted once) over the window's wall time, and the
    kernels' summed time; (None, None) where the trace holds no kernel."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e.device_type, "name", "") == "CUDA")
    if not spans:
        return None, None
    union, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            union += b - max(a, end)
            end = b
    return union / 1e6 / wall_s, sum(b - a for a, b in spans) / 1e6


def codec_times(nifti, native, path: str, work: Path):
    """Seconds to load and save one volume with each codec, and whether the
    four reads (each codec on each codec's file) give the same array."""
    import numpy as np

    out = {}
    t0 = time.perf_counter()
    x, aff = native.read_volume(path)
    out["native_load_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    py, _ = nifti._python_load(path)
    out["python_load_s"] = time.perf_counter() - t0
    files = {"native": str(work / "native.nii.gz"), "python": str(work / "python.nii.gz")}
    t0 = time.perf_counter()
    native.write_volume(files["native"], x, aff)
    out["native_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nifti._python_save(files["python"], x, aff)
    out["python_save_s"] = time.perf_counter() - t0
    reads = [x.reshape(py.shape), py] + [
        r(f)[0].reshape(py.shape) for f in files.values()
        for r in (native.read_volume, nifti._python_load)]
    out["bit_equal"] = all(np.array_equal(reads[0], r) for r in reads[1:])
    out["shape"] = list(py.shape)
    return out


def clean_patches(torch, dm, seed: int, key: str, patch_fns):
    """The un-augmented patches of ``key`` in a train stream's order: the
    stream's sample order and corners, cut from the loaded volumes."""
    sample_generator, uniform_patch_starts, extract_patches = patch_fns
    cfg, samples = dm.config, dm.train_samples
    parts = []
    for i in torch.randperm(len(samples), generator=torch.Generator().manual_seed(seed)).tolist():
        vol = torch.from_numpy(dm.load_subject(samples[i], (key,))[key])
        starts = uniform_patch_starts(sample_generator(seed, i, 1), cfg.volume_shape,
                                      cfg.patch_size, cfg.samples_per_vol)
        parts.append(extract_patches(vol, starts, cfg.patch_size))
    return torch.cat(parts)


def epoch(torch, dm, seed, prefetch=True):
    """One train stream on the card → (its batches, wall seconds)."""
    t0 = time.perf_counter()
    batches = list(dm.train_batches(seed, keys=DATA_KEYS, device="cuda", prefetch=prefetch))
    torch.cuda.synchronize()
    return batches, time.perf_counter() - t0


def batch_shapes_ok(torch, batches, batch, patch):
    want = {"pc-bssfp": 24, "dwi-tensor": 6, "dwi-tensor_orig": 6}
    return bool(batches) and all(
        set(b) == set(want) and all(
            b[k].is_cuda and b[k].dtype == torch.float32
            and tuple(b[k].shape) == (batch,) + (patch,) * 3 + (c,) for k, c in want.items())
        for b in batches)


def phase_data(torch, K, checks, pkg, tree: str):
    """Phase 12: the training data path on the card (see the docstring)."""
    work = Path("perf_out") / "data_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        return _phase_data(torch, K, checks, pkg, tree, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _phase_data(torch, K, checks, pkg, tree, work):
    (Config, DoveDataModule, aug, nifti, native, patch_fns, create_gan_state,
     make_train_step) = pkg
    from torch.profiler import ProfilerActivity, profile

    cfg = Config()
    out = {}
    # 1. the codecs on one 24-channel volume of the tree
    pc_file = str(Path(tree) / "derivatives" / "preproc-dove" / "sub-01" / "ses-1" / "dwi"
                  / "sub-01_ses-1_desc-normflatbet_bssfp.nii.gz")
    out["codec"] = dict(codec_times(nifti, native, pc_file, work), in_use=nifti.codec())
    print(f"NIfTI codec ({out['codec']['in_use']}) on one {out['codec']['shape']} volume: "
          f"load native {out['codec']['native_load_s']:.3f} s / python "
          f"{out['codec']['python_load_s']:.3f} s, save native "
          f"{out['codec']['native_save_s']:.3f} s / python {out['codec']['python_save_s']:.3f} s;"
          f" arrays bit-equal {out['codec']['bit_equal']}", flush=True)
    checks.record(out["codec"]["bit_equal"] and nifti.codec() == "native",
                  dict(phase="data_codec", **out["codec"]))

    # 2. the data module: two epochs, cold then from the cache
    dcfg = dataclasses.replace(cfg.data, val_split=0.25, test_split=0.25, cache_volumes=True)
    dm = DoveDataModule(tree, config=dcfg)
    dm.prepare_data()
    splits = [len(dm.train_samples), len(dm.val_samples), len(dm.test_samples)]
    b, p = dcfg.batch_size, dcfg.patch_size
    seed = dcfg.seed
    cold, cold_s = epoch(torch, dm, seed)
    warm, warm_s = epoch(torch, dm, seed + 1)
    want_batches = len(dm.train_samples) * dcfg.samples_per_vol // b
    orig_ok = all(torch.equal(torch.cat([x["dwi-tensor_orig"] for x in batches]).cpu(),
                              clean_patches(torch, dm, s, "dwi-tensor", patch_fns))
                  for batches, s in ((cold, seed), (warm, seed + 1)))
    val = list(dm.val_batches(seed, keys=DATA_KEYS, augment=False, device="cuda"))
    val_ok = batch_shapes_ok(torch, val, b, p) and all(
        torch.equal(x["dwi-tensor"], x["dwi-tensor_orig"]) for x in val)
    tests = list(dm.test_volumes(keys=DATA_KEYS, device="cuda"))
    test_ok = len(tests) == len(dm.test_samples) and all(
        v["pc-bssfp"].is_cuda and tuple(v["pc-bssfp"].shape) == VOLUME + (24,)
        for _, v in tests)
    out["module"] = {"splits": splits, "batches_per_epoch": len(cold),
                     "ms_per_batch_cold": cold_s * 1e3 / max(len(cold), 1),
                     "ms_per_batch_warm": warm_s * 1e3 / max(len(warm), 1),
                     "val_batches": len(val), "test_volumes": len(tests)}
    print(f"data module (splits {splits}): {len(cold)} batches an epoch, "
          f"{out['module']['ms_per_batch_cold']:.1f} ms per batch cold, "
          f"{out['module']['ms_per_batch_warm']:.1f} warm (cache_volumes); clean targets "
          f"{orig_ok}; val {len(val)} batches ok {val_ok}; test volumes {len(tests)} ok "
          f"{test_ok}", flush=True)
    checks.record(splits == [2, 1, 1] and len(cold) == len(warm) == want_batches
                  and batch_shapes_ok(torch, cold + warm, b, p) and orig_ok and val_ok
                  and test_ok, dict(phase="data_module", **out["module"]))
    del cold, warm, val, tests

    # 3. default GAN steps fed from the stream, the pristine DT the target
    # (unet_bssfp_tpu/train/loop.py:207). Two train subjects make a
    # two-batch epoch, all start-up; the steady state is read on epochs of
    # the train samples repeated (REPEAT × 2 batches, volumes cached): the
    # stream alone, then one epoch of steps (the second step's launches
    # counted), then one epoch of steps under the profiler
    base = dm.train_samples
    dm.train_samples = base * REPEAT
    try:
        produced, produce_s = epoch(torch, dm, seed + 2)
        n_batches = len(produced)
        del produced
        state = create_gan_state(SEED, MODALITY, cfg.model, cfg.train, "cuda")
        step = make_train_step(state.gen, state.disc, cfg.train)
        counts, loop_ms, step_ms, metrics = None, [], [], []
        t_prev = time.perf_counter()
        for batch in dm.train_batches(seed + 10, keys=DATA_KEYS, device="cuda"):
            n = len(metrics)
            if n == 1:
                torch.cuda.synchronize()
                K.reset_launches()
            t0 = time.perf_counter()
            m = step(state, batch["pc-bssfp"], batch["dwi-tensor_orig"])
            torch.cuda.synchronize()
            now = time.perf_counter()
            if n == 1:
                counts = K.launches()
            step_ms.append((now - t0) * 1e3)
            loop_ms.append((now - t_prev) * 1e3)
            t_prev = now
            metrics.append({k: float(v) for k, v in m.items()})
        # the profiled epoch: the stream's background thread included
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in dm.train_batches(seed + 20, keys=DATA_KEYS, device="cuda"):
                m = step(state, batch["pc-bssfp"], batch["dwi-tensor_orig"])
                metrics.append({k: float(v) for k, v in m.items()})
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
    finally:
        dm.train_samples = base
    n_prof = len(metrics) - len(step_ms)
    busy, kernel_s = busy_share(prof, prof_wall)
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    out["train"] = {"steps": len(metrics), "batches_per_epoch": n_batches,
                    "stream_alone_ms_per_batch": produce_s * 1e3 / n_batches,
                    "ms_per_step_median": statistics.median(step_ms[1:]),
                    "ms_per_loop_iteration_median": statistics.median(loop_ms[1:]),
                    "ms_per_step_all": step_ms, "ms_per_loop_iteration_all": loop_ms,
                    "profiled_steps": n_prof, "profiled_wall_ms_per_step": prof_wall * 1e3 / n_prof,
                    "device_busy_share": busy,
                    "kernel_ms_per_step_summed": None if kernel_s is None
                    else kernel_s * 1e3 / n_prof, "last_metrics": metrics[-1]}
    print("training-from-data launches (one step): " + json.dumps(counts), flush=True)
    print(f"train from data: epochs of {n_batches} batches (the stream alone "
          f"{out['train']['stream_alone_ms_per_batch']:.1f} ms per batch); {len(metrics)} steps, "
          f"{out['train']['ms_per_step_median']:.2f} ms per step, "
          f"{out['train']['ms_per_loop_iteration_median']:.2f} ms per loop iteration (data "
          f"wait included; all {', '.join(f'{t:.1f}' for t in loop_ms)}); profiled epoch "
          f"{out['train']['profiled_wall_ms_per_step']:.2f} ms a step, device busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}; last losses "
          f"{json.dumps(metrics[-1])}", flush=True)
    checks.record(counts == TRAIN_STEP_LAUNCHES, dict(phase="train_from_data_launches",
                                                      launches=counts,
                                                      expected=TRAIN_STEP_LAUNCHES))
    checks.record(finite and len(metrics) >= 4, dict(phase="train_from_data", **out["train"]))
    del state, step, prof
    torch.cuda.empty_cache()

    # 4. the seven applies on the card against the CPU, same parameters
    vol_cpu = torch.from_numpy(dm.load_subject(dm.train_samples[0], ("pc-bssfp",))["pc-bssfp"])
    vol = vol_cpu.to("cuda")
    g = torch.Generator().manual_seed(SEED)
    draws = {name: draw(g, VOLUME) for name, draw, _ in aug.CHAIN}
    field = aug.noise_field(draws["noise"]["seed"], vol)
    cases = {name: (lambda v, f=fn, kw=draws[name]: f(v, **kw))
             for name, _, fn in aug.CHAIN if name != "noise"}
    cases["noise"] = lambda v: aug.apply_noise(v, draws["noise"]["std"],
                                               field if v.is_cuda else field.cpu())
    cases["rotate_trilinear"] = lambda v: aug.rotate_trilinear(v, draws["motion"]["angles"][0])
    rows = {}
    for name, fn in cases.items():
        got = fn(vol)
        ref = fn(vol_cpu)
        err = float((got.cpu() - ref).abs().max())
        scale = float(ref.abs().max())
        ms = time_ms(torch, lambda: fn(vol), 5)
        rows[name] = {"max_abs_err": err, "max_abs_ref": scale, "tol": AUG_TOL[name] * scale,
                      "ms": ms, "ok": err <= AUG_TOL[name] * scale}
    chain = {}
    g1 = torch.Generator().manual_seed(SEED)
    chain["p1_ms"] = time_ms(torch, lambda: aug.augment_volume(g1, vol, 1.0), 3)
    g01 = torch.Generator().manual_seed(SEED)
    chain["p0.1_ms"] = time_ms(torch, lambda: aug.augment_volume(g01, vol, 0.1), 40)
    out["augment"] = {"transforms": rows, "chain": chain}
    print("augmentation on the card vs CPU at " + str(VOLUME + (24,)) + ": " + ", ".join(
        f"{k} {r['ms']:.2f} ms err/max {r['max_abs_err'] / max(r['max_abs_ref'], 1e-30):.1e}"
        for k, r in rows.items()) + f"; chain p=1 {chain['p1_ms']:.2f} ms, p=0.1 "
        f"{chain['p0.1_ms']:.2f} ms", flush=True)
    checks.record(all(r["ok"] for r in rows.values()), dict(phase="augment_cuda_vs_cpu",
                                                             **out["augment"]))
    del vol, vol_cpu, field

    # 5. the same seed's batches with prefetch on and off
    same = {}
    for prob in (dcfg.augment_prob, 1.0):
        dmp = DoveDataModule(tree, config=dataclasses.replace(dcfg, augment_prob=prob))
        dmp.prepare_data()
        on, _ = epoch(torch, dmp, seed + 30, prefetch=True)
        off, _ = epoch(torch, dmp, seed + 30, prefetch=False)
        same[str(prob)] = len(on) == len(off) > 0 and all(
            x.keys() == y.keys() and all(torch.equal(x[k], y[k]) for k in x)
            for x, y in zip(on, off))
        del on, off
    out["determinism"] = same
    print(f"batches bit-identical with prefetch on and off: {same}", flush=True)
    checks.record(all(same.values()), dict(phase="data_prefetch_determinism", by_prob=same))
    return counts, out


def phase_loop(torch, K, checks, pkg, tree: str, work: Path):
    """Phase 13: the training loop on phase 12's tree (see the docstring),
    its runs under ``work``, which the caller deletes after phase 14.
    Returns the fit's launches, the remat step's, the records, and the run
    phase 14 evaluates: the fit's best step and its last train batch."""
    (Config, DoveDataModule, Trainer, train_model, ckpt, create_gan_state, make_train_step,
     flops, conv) = pkg
    from torch.profiler import ProfilerActivity, profile

    base = Config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, val_split=0.25, test_split=0.25),
        train=dataclasses.replace(base.train, max_epochs=LOOP_EPOCHS,
                                  checkpoint_top_k=LOOP_TOP_K, log_clean_val=True,
                                  log_dir=str(work / "logs"),
                                  checkpoint_dir=str(work / "ckpts")))
    dm = DoveDataModule(tree, config=cfg.data)
    dm.prepare_data()
    out = {}

    # 1. Trainer.fit, its steps timed (each synchronised: the step, and the
    # loop iteration from the last step's end, data wait included), its
    # checkpoint writes timed and sized, the launch counts of the whole fit
    trainer = Trainer(cfg, MODALITY, device="cuda")
    state = trainer.init_state()
    train_step, eval_step, save = trainer.train_step, trainer.eval_step, trainer.ckpt.save
    calls = {"train": 0, "eval": 0}
    step_ms, loop_ms, saves, sizes, last_end = [], [], [], [], [None]
    seen = {}  # the last train and eval batches, for the checks after the fit

    def timed_train(st, x, y):
        seen["train"] = (x, y)
        t0 = time.perf_counter()
        m = train_step(st, x, y)
        torch.cuda.synchronize()
        now = time.perf_counter()
        step_ms.append((now - t0) * 1e3)
        if last_end[0] is not None:
            loop_ms.append((now - last_end[0]) * 1e3)
        last_end[0] = now
        calls["train"] += 1
        return m

    def counted_eval(st, x, y):
        seen["eval"] = (x, y)
        calls["eval"] += 1
        last_end[0] = None  # the next epoch's first step follows the val passes
        return eval_step(st, x, y)

    def timed_save(step, st, row):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(step, st, row)
        saves.append(time.perf_counter() - t0)

    real_write = ckpt.atomic_save

    def sized_write(obj, path):
        real_write(obj, path)
        sizes.append(os.path.getsize(path) / 1e6)

    trainer.train_step, trainer.eval_step, trainer.ckpt.save = timed_train, counted_eval, timed_save
    ckpt.atomic_save = sized_write
    try:
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        state, best = trainer.fit(dm, state)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = K.launches()
    finally:
        ckpt.atomic_save = real_write
    with open(os.path.join(trainer.logger.log_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    per_epoch = {s: -(-n * cfg.data.samples_per_vol // cfg.data.batch_size)
                 for s, n in (("train", len(dm.train_samples)), ("val", len(dm.val_samples)))}
    want_calls = {"train": LOOP_EPOCHS * per_epoch["train"], "eval": LOOP_EPOCHS * 2 * per_epoch["val"]}
    expected = {k: calls["train"] * TRAIN_STEP_LAUNCHES[k] + calls["eval"] * EVAL_STEP_LAUNCHES[k]
                for k in TRAIN_STEP_LAUNCHES}
    on_disk = sorted(os.listdir(trainer.ckpt.directory))
    steps_on_disk = [int(d) for d in on_disk if d.isdigit()]
    finite = len(rows) == LOOP_EPOCHS and all(
        math.isfinite(float(v)) for r in rows for v in r.values())
    disk_ok = ("config.json" in on_disk and 1 <= len(steps_on_disk) <= LOOP_TOP_K
               and sorted(steps_on_disk) == sorted(trainer.ckpt.steps)
               and set(on_disk) == {"config.json", *map(str, steps_on_disk)})
    out["fit"] = {"rows": len(rows), "columns": list(rows[0]) if rows else [],
                  "calls": calls, "expected_calls": want_calls,
                  "steps_on_disk": steps_on_disk, "best_step": trainer.ckpt.best_step,
                  "fit_s": fit_s, "last_row": rows[-1] if rows else None}
    print("training-loop launches (the whole fit): " + json.dumps(counts), flush=True)
    print(f"Trainer.fit: {len(rows)} epochs, {calls['train']} train and {calls['eval']} eval steps "
          f"in {fit_s:.1f} s; checkpoints kept {steps_on_disk} (best {trainer.ckpt.best_step}); "
          f"last row {json.dumps(rows[-1] if rows else None)}", flush=True)
    checks.record(finite and disk_ok and calls == want_calls and counts == expected,
                  dict(phase="train_loop_fit", launches=counts, expected=expected,
                       finite=finite, disk_ok=disk_ok, **out["fit"]))

    # 2. what the fit took
    step_flops = flops.gan_step_flops(batch=cfg.data.batch_size, patch=cfg.data.patch_size)
    step_med = statistics.median(step_ms)
    out["timing"] = {
        "ms_per_epoch": [float(r["epoch_seconds"]) * 1e3 for r in rows],
        "ms_per_step_median": step_med, "ms_per_step_all": step_ms,
        "ms_per_loop_iteration_median": statistics.median(loop_ms) if loop_ms else None,
        "ms_per_loop_iteration_all": loop_ms,
        "step_tflops_per_s": step_flops / step_med / 1e9,
        "checkpoint_save_s": saves, "checkpoint_mb": sizes}

    # 3. the best checkpoint into a fresh state: the eval step's metrics on
    # a val batch, bit for bit the in-memory state's where the best is the
    # last epoch (cuDNN held to deterministic algorithms for the two calls)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fresh = trainer.init_state(seed=SEED + 7)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.load_checkpoint(best, fresh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        got = {k: float(v) for k, v in eval_step(fresh, *seen["eval"])[0].items()}
        ref = {k: float(v) for k, v in eval_step(state, *seen["eval"])[0].items()}
    finally:
        torch.backends.cudnn.deterministic = det
    last = trainer.ckpt.best_step == LOOP_EPOCHS - 1
    restore_ok = (got == ref and fresh.step == state.step) if last else all(
        math.isfinite(v) for v in got.values())
    out["timing"]["checkpoint_load_s"] = load_s
    out["restore"] = {"best_step": trainer.ckpt.best_step, "best_is_last": last,
                      "restored_step": fresh.step, "metrics": got, "in_memory": ref}
    print(f"restore: best {best} (step {fresh.step}) loaded in {load_s:.3f} s; eval metrics "
          f"{'bit-equal to the in-memory state' if got == ref else 'differ from it'}"
          f"{'' if last else ' (best is not the last epoch: finite held)'}", flush=True)
    checks.record(restore_ok, dict(phase="train_loop_restore", **out["restore"]))
    del fresh

    # 4. --ckpt auto: the newest whole checkpoint, one more epoch, under the
    # profiler (the loop's one profiled epoch: the resume's Trainer build
    # and load are inside its wall too)
    latest = ckpt.find_latest_checkpoint(cfg.train.checkpoint_dir, MODALITY)
    s0 = torch.load(os.path.join(latest, ckpt.STATE_FILE), map_location="cpu",
                    weights_only=True)["step"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        best2 = train_model(dm, MODALITY, ckpt_path="auto", config=cfg, max_epochs=1,
                            device="cuda")
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    busy, kernel_s = busy_share(prof, prof_wall)
    del prof
    s2 = torch.load(os.path.join(best2, ckpt.STATE_FILE), map_location="cpu",
                    weights_only=True)["step"]
    out["resume"] = {"from": latest, "from_step": s0, "to": best2, "to_step": s2,
                     "expected_step": s0 + per_epoch["train"]}
    out["timing"].update(profiled_epoch_ms=prof_wall * 1e3, device_busy_share=busy,
                         kernel_ms_summed=None if kernel_s is None else kernel_s * 1e3)
    print(f"resume auto: from {latest} (step {s0}) to {best2} (step {s2})", flush=True)
    checks.record(s2 == s0 + per_epoch["train"] and os.path.dirname(best2) != os.path.dirname(
        latest), dict(phase="train_loop_resume", **out["resume"]))
    t = out["timing"]
    print(f"loop timing: epochs {', '.join(f'{v:.0f}' for v in t['ms_per_epoch'])} ms; step "
          f"{step_med:.2f} ms ({t['step_tflops_per_s']:.1f} TFLOP/s), loop iteration "
          f"{t['ms_per_loop_iteration_median']} ms (data wait included; all "
          f"{', '.join(f'{v:.1f}' for v in loop_ms)}); checkpoint save "
          f"{', '.join(f'{v:.3f}' for v in saves)} s of {', '.join(f'{v:.1f}' for v in sizes)} MB, "
          f"load {load_s:.3f} s; profiled resume epoch {prof_wall * 1e3:.0f} ms, device busy "
          f"{'not measured' if busy is None else f'{100 * busy:.1f} %'}", flush=True)
    checks.record(True, dict(phase="train_loop_timing", **t))

    # 5. remat off and on: one default step each from the same seed and
    # batch (the fit's last), dropout on, cuDNN deterministic; then each
    # one's ms and peak
    remat = {}
    x, y = seen.pop("train")
    del seen
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for on in (False, True):
            st = create_gan_state(SEED, MODALITY, dataclasses.replace(cfg.model, remat=on),
                                  cfg.train, "cuda")
            step = make_train_step(st.gen, st.disc, cfg.train)
            torch.cuda.synchronize()
            K.reset_launches()
            m = step(st, x, y)
            torch.cuda.synchronize()
            r = {"launches": K.launches(), "metrics": {k: float(v) for k, v in m.items()},
                 "grads": {f"{n}.{k}": p.grad.cpu() for n in ("gen", "disc")
                           for k, p in getattr(st, n).named_parameters()},
                 "state": {f"{n}.{k}": v.cpu() for n in ("gen", "disc")
                           for k, v in getattr(st, n).state_dict().items()},
                 "rng": st.rng.get_state()}
            step(st, x, y)
            step(st, x, y)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            for _ in range(5):
                step(st, x, y)
            torch.cuda.synchronize()
            r["ms"] = (time.perf_counter() - t0) * 1e3 / 5
            r["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
            r["step_peak_over_resident_mib"] = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
            remat[on] = r
            del st, step, m
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = det
    off, on = remat[False], remat[True]
    same = {"metrics": off["metrics"] == on["metrics"],
            "grads": off["grads"].keys() == on["grads"].keys() and all(
                torch.equal(off["grads"][k], on["grads"][k]) for k in off["grads"]),
            "params_and_buffers": off["state"].keys() == on["state"].keys() and all(
                torch.equal(off["state"][k], on["state"][k]) for k in off["state"]),
            "dropout_generator": torch.equal(off["rng"], on["rng"])}
    out["remat"] = {"bit_equal": same, "launches_off": off["launches"],
                    "launches_on": on["launches"], "expected_on": REMAT_STEP_LAUNCHES,
                    **{f"{k}_{w}": remat[o][k] for o, w in ((False, "off"), (True, "on"))
                       for k in ("ms", "peak_mib", "step_peak_over_resident_mib")}}
    print(f"remat: one step off/on bit-equal {same}; ms {off['ms']:.2f} / {on['ms']:.2f}; "
          f"peak {off['peak_mib']:.0f} / {on['peak_mib']:.0f} MiB (over the resident state "
          f"{off['step_peak_over_resident_mib']:.0f} / {on['step_peak_over_resident_mib']:.0f})",
          flush=True)
    checks.record(all(same.values()) and off["launches"] == TRAIN_STEP_LAUNCHES
                  and on["launches"] == REMAT_STEP_LAUNCHES,
                  dict(phase="train_step_remat", **out["remat"]))

    # 6. CANONICAL_CPU through the port's Trainer on the card
    rec = conv.run_port("cuda", seed=42, root=str(work / "convergence"))
    out["convergence"] = rec
    print(f"CANONICAL_CPU on the card: val PSNR {rec['val_psnr_last']:.3f} dB (band "
          f"{rec['band'][0]:.3f} .. {rec['band'][1]:.3f}), train L1 {rec['train_L1_first']:.4f} "
          f"-> {rec['train_L1_last']:.4f}, {rec['wall_seconds']:.1f} s", flush=True)
    checks.record(rec["in_band"] and rec["train_L1_last"] < rec["train_L1_first"],
                  dict(phase="train_loop_convergence", **rec))
    return counts, on["launches"], out, {"best": best, "batch": (x, y)}


def phase_eval_checkpoint(torch, K, checks, tree: str, run: dict, work: Path):
    """Phase 14: evaluation from phase 13's best checkpoint on phase 12's tree
    (see the docstring). Returns the launches of its three paths and the
    records."""
    import numpy as np

    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.data import nifti
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.eval import evaluate, inference
    from unet_bssfp_tpu_torch.eval.__main__ import main as eval_main
    from unet_bssfp_tpu_torch.models.medicalnet import load_medicalnet
    from unet_bssfp_tpu_torch.predict import main as predict_main
    from unet_bssfp_tpu_torch.train.checkpoint import generator_state_dict
    from unet_bssfp_tpu_torch.train.loop import build_perceptual_fn
    from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
    from unet_bssfp_tpu_torch.train.steps import (
        make_medicalnet_fid_fn,
        make_predict_fn,
        make_train_step,
    )

    best, (x, y) = run["best"], run["batch"]
    cfg_path = os.path.join(os.path.dirname(best), "config.json")
    with open(cfg_path) as f:
        cfg = Config.from_json(f.read())
    pred_root, out = work / "eval_checkpoint", {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # the three predictions bit for bit
    try:
        # 1. the eval CLI from the checkpoint, in-process on cuda, its parts
        # timed (each synchronised) through wrappers of what run_test calls
        parts = {k: 0.0 for k in ("eval_model", "load", "inference", "fid", "saves", "chain")}

        def timed(key, fn, sync=True):
            def call(*a, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    if sync:
                        torch.cuda.synchronize()
                    parts[key] += time.perf_counter() - t0
            return call

        def timed_volumes(self, *a, **kw):
            it = real["test_volumes"](self, *a, **kw)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                torch.cuda.synchronize()
                parts["load"] += time.perf_counter() - t0
                yield item

        def timed_fid_fn(*a, **kw):
            fid_fn = real["make_medicalnet_fid_fn"](*a, **kw)
            wrapped = timed("fid", fid_fn)
            wrapped.label = fid_fn.label
            return wrapped

        real = {"test_volumes": DoveDataModule.test_volumes,
                "predict_volume": inference.predict_volume,
                "save_predictions": inference.save_predictions,
                "make_medicalnet_fid_fn": evaluate.make_medicalnet_fid_fn,
                "eval_model": evaluate.eval_model, "eval_dwi_tensors": evaluate.eval_dwi_tensors}
        DoveDataModule.test_volumes = timed_volumes
        inference.predict_volume = timed("inference", real["predict_volume"])
        inference.save_predictions = timed("saves", real["save_predictions"], sync=False)
        evaluate.make_medicalnet_fid_fn = timed_fid_fn
        evaluate.eval_model = timed("eval_model", real["eval_model"])
        evaluate.eval_dwi_tensors = timed("chain", real["eval_dwi_tensors"])
        table_csv = work / "relative_errors_checkpoint.csv"
        try:
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            eval_main([str(pred_root), tree, "--checkpoint", f"{MODALITY}={best}",
                       "--config", cfg_path, "--rescale-args", RESCALE_ARGS,
                       "--out-csv", str(table_csv), "--device", "cuda"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            eval_counts = K.launches()
        finally:
            DoveDataModule.test_volumes = real["test_volumes"]
            inference.predict_volume = real["predict_volume"]
            inference.save_predictions = real["save_predictions"]
            evaluate.make_medicalnet_fid_fn = real["make_medicalnet_fid_fn"]
            evaluate.eval_model = real["eval_model"]
            evaluate.eval_dwi_tensors = real["eval_dwi_tensors"]
        dm = DoveDataModule(tree, config=cfg.data)
        dm.prepare_data()
        n_test = len(dm.test_samples)
        expected = dict(dict.fromkeys(eval_counts, 0), conv3x3_packed=4 * n_test,
                        pack_hw=2 * n_test, unpack_hw=n_test, scalar_maps=2 * n_test,
                        packed_norm_act=4 * n_test)
        pred_dir = pred_root / MODALITY
        with open(pred_dir / "test_metrics.csv") as f:
            (metrics_row,) = list(csv.DictReader(f))
        want_cols = ["modality", "test_metric_PSNR", "test_metric_SSIM", "test_metric_L1",
                     "test_metric_FID_random_features"]
        metrics_ok = (list(metrics_row) == want_cols and metrics_row["modality"] == MODALITY
                      and all(math.isfinite(float(metrics_row[c])) for c in want_cols[1:]))
        with open(table_csv) as f:
            table = list(csv.reader(f))
        out["eval"] = {"test_volumes": n_test, "cli_s": cli_s, "metrics": metrics_row,
                       "table_rows": len(table) - 1, "launches": eval_counts,
                       "expected": expected,
                       "s_per_test_volume": {k: v / n_test for k, v in parts.items()}}
        print(f"eval --checkpoint ({n_test} test volume(s)): launches {json.dumps(eval_counts)}; "
              f"{cli_s:.2f} s in all; per volume " + ", ".join(
                  f"{k} {v / n_test:.3f} s" for k, v in parts.items())
              + f"; metrics {json.dumps(metrics_row)}; {len(table) - 1} table rows", flush=True)
        checks.record(eval_counts == expected and metrics_ok and len(table) > 1,
                      dict(phase="eval_from_checkpoint", **out["eval"]))

        # 2. the written prediction against predict_volume of the same
        # generator on the same test volume
        gen, _ = build_models(MODALITY, cfg.model, "cuda", state_dict=generator_state_dict(best))
        spec, vols = next(dm.test_volumes(keys=(MODALITY, "dwi-tensor"), device="cuda"))
        direct = inference.predict_volume(make_predict_fn(gen), vols[MODALITY],
                                          patch_size=cfg.data.patch_size,
                                          out_channels=cfg.model.out_channels).float().cpu().numpy()
        del gen, vols
        name = next(fn for fn in sorted(os.listdir(pred_dir))
                    if (evaluate.parse_pred_name(fn) or {}).get("kind") == "pred"
                    and evaluate.parse_pred_name(fn)["idx"] == "0"
                    and evaluate.parse_pred_name(fn)["deriv"] == "")
        written, _ = nifti.load_volume(str(pred_dir / name))
        same_direct = bool(np.array_equal(written, direct))

        # 3. predict --checkpoint on the written input, no --config
        inp = pred_dir / name.replace("pred-0_", "input-0_")
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        pred_path = predict_main([str(inp), "--checkpoint", best, "--out-dir",
                                  str(work / "predict_checkpoint"), "--scalar-maps",
                                  "--rescale-args", RESCALE_ARGS, "--device", "cuda"])
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        predict_counts = K.launches()
        served, _ = nifti.load_volume(pred_path)
        same_served = bool(np.array_equal(served, written))
        n_maps = sum(fn.endswith(".nii.gz") for fn in os.listdir(work / "predict_checkpoint")) - 1
        p_expected = dict(dict.fromkeys(predict_counts, 0), conv3x3_packed=4, pack_hw=2,
                          unpack_hw=1, scalar_maps=1, packed_norm_act=4)
        out["predict"] = {"launches": predict_counts, "expected": p_expected, "s": predict_s,
                          "maps": n_maps, "bit_equal_to_eval": same_served,
                          "eval_bit_equal_to_predict_volume": same_direct}
        print(f"predict --checkpoint: launches {json.dumps(predict_counts)}; {predict_s:.2f} s; "
              f"eval's pred bit-equal to predict_volume {same_direct}, predict's to eval's "
              f"{same_served}; {n_maps} maps", flush=True)
        checks.record(same_direct, dict(phase="eval_pred_vs_predict_volume",
                                        file=name, bit_equal=same_direct))
        checks.record(predict_counts == p_expected and same_served and n_maps == 7,
                      dict(phase="predict_checkpoint", **out["predict"]))

        # 4. the FID on the card (TF32 off) against the CPU's, on the two files
        target, _ = nifti.load_volume(str(pred_dir / name.replace("pred-0_", "target-0_")))
        pair = [torch.from_numpy(a)[None] for a in (written, target)]
        fid_card = make_medicalnet_fid_fn(load_medicalnet(cfg.train.medicalnet_weights,
                                                          device="cuda"))
        card_pair = [a.to("cuda") for a in pair]
        fid_ms = time_ms(torch, lambda: fid_card(*card_pair), 5)
        got = float(fid_card(*card_pair))
        t0 = time.perf_counter()
        ref = float(make_medicalnet_fid_fn(load_medicalnet(cfg.train.medicalnet_weights))(*pair))
        cpu_s = time.perf_counter() - t0
        in_csv = float(metrics_row["test_metric_FID_random_features"])
        rel = abs(got - ref) / max(abs(ref), 1e-30)
        out["fid"] = {"card": got, "cpu": ref, "rel_diff": rel, "in_test_metrics_csv": in_csv,
                      "card_ms": fid_ms, "cpu_s": cpu_s, "slabs": 2 * written.shape[-1],
                      "shape": list(written.shape)}
        print(f"FID of pred-0 against target-0: card {got!r}, CPU {ref!r} (relative "
              f"{rel:.2e}); test_metrics.csv {in_csv!r}; {fid_ms:.2f} ms on the card, "
              f"{cpu_s:.2f} s on the CPU", flush=True)
        checks.record(rel <= 1e-3 and math.isfinite(got), dict(phase="fid_cuda_vs_cpu", **out["fid"]))
        del fid_card, card_pair
    finally:
        torch.backends.cudnn.deterministic = det

    # 5. one default step with the perceptual term (random features, bf16,
    # perceptual_chunk unset) on phase 13's last train batch, its launches;
    # then its ms and peak beside the plain step's
    base = Config()
    pcfg = dataclasses.replace(base, train=dataclasses.replace(base.train, with_perceptual=True))
    steps = {}
    for name, pf in (("perceptual", build_perceptual_fn(pcfg, "cuda")), ("plain", None)):
        st = create_gan_state(SEED, MODALITY, pcfg.model, pcfg.train, "cuda")
        step = make_train_step(st.gen, st.disc, pcfg.train, pf)
        torch.cuda.synchronize()
        K.reset_launches()
        m = step(st, x, y)
        torch.cuda.synchronize()
        r = {"launches": K.launches(), "metrics": {k: float(v) for k, v in m.items()}}
        step(st, x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(5):
            step(st, x, y)
        torch.cuda.synchronize()
        r["ms"] = (time.perf_counter() - t0) * 1e3 / 5
        r["peak_mib"] = torch.cuda.max_memory_allocated() / 2 ** 20
        steps[name] = r
        del st, step, m, pf
        torch.cuda.empty_cache()
    perc = steps["perceptual"]
    term = perc["metrics"].get("train_gen_loss_recon_Perceptual", math.nan)
    out["perceptual_step"] = {k: {"ms": v["ms"], "peak_mib": v["peak_mib"],
                                  "launches": v["launches"]} for k, v in steps.items()}
    out["perceptual_step"]["perceptual_term"] = term
    print(f"perceptual step: {perc['ms']:.2f} ms, peak {perc['peak_mib']:.0f} MiB, term "
          f"{term!r}; plain step {steps['plain']['ms']:.2f} ms, peak "
          f"{steps['plain']['peak_mib']:.0f} MiB", flush=True)
    checks.record(perc["launches"] == TRAIN_STEP_LAUNCHES and math.isfinite(term) and term > 0
                  and all(math.isfinite(v) for v in perc["metrics"].values()),
                  dict(phase="train_step_perceptual", **out["perceptual_step"]))
    return eval_counts, predict_counts, perc["launches"], out


def phase_multistage(torch, F, K, checks, pkg, tree: str, work: Path):
    """Phase 15: the multi-stage regime on phase 12's tree (see the
    docstring), its runs under ``work``. Returns the run's launches, each
    stage's one step's, and the records."""
    Config, DoveDataModule, ms, weights, TrainingState = pkg
    b, p = TRAIN_BATCH, TRAIN_PATCH
    # 1. K1, its dgrad and K2 at the four convs: the N-24 forward (144 → 24),
    # the dgrad on two N tiles (24 → 144), K2 on two co tiles (Cout 48)
    for cin, cout in MULTISTAGE_CONVS:
        check_conv(torch, F, K, checks, b, p, p, p, cin, cout, "bfloat16", rerun=True)
        check_dgrad(torch, K, checks, b, p, p, p, cin, cout, "bfloat16", rerun=True)
        check_wgrad(torch, K, checks, b, p, p, p, cin, cout, "bfloat16")
        torch.cuda.empty_cache()
    out = {}

    # 2. run_multistage on the card, the counts reset just before it
    base = Config()
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, val_split=0.25, test_split=0.25),
        train=dataclasses.replace(base.train, max_epochs=MULTISTAGE_EPOCHS,
                                  checkpoint_top_k=MULTISTAGE_TOP_K,
                                  log_dir=str(work / "logs"), checkpoint_dir=str(work / "ckpts")))
    dm = DoveDataModule(tree, config=cfg.data)
    dm.prepare_data()
    K.reset_launches()
    t0 = time.perf_counter()
    states, row = ms.run_multistage(dm, MODALITY, cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_counts = K.launches()
    val_steps = -(-len(dm.val_samples) * cfg.data.samples_per_vol // cfg.data.batch_size)
    expected = dict.fromkeys(run_counts, 0)
    rows, files = {}, {}
    for stage, st in states.items():
        for k, v in MULTISTAGE_STAGE_LAUNCHES[stage.value].items():
            expected[k] += st.step * v
        for k, v in EVAL_STEP_LAUNCHES.items():
            expected[k] += val_steps * v
        name = f"multistage-{MODALITY}-{stage.value}"
        with open(work / "logs" / name / "metrics.csv") as f:
            rows[stage.value] = list(csv.DictReader(f))
        files[stage.value] = sorted(os.listdir(work / "ckpts" / name))
    finite = all(math.isfinite(float(v)) for rs in rows.values() for r in rs
                 for k, v in r.items() if k != "epoch")
    saved = all(os.path.isfile(work / "ckpts" / f"multistage-{MODALITY}-{s}" / "0" /
                               "state.pt") for s in rows)
    pre = states[TrainingState.PRETRAIN].net.state_dict()
    kept = all(torch.equal(v, pre[k]) for k, v in
               states[TrainingState.TRANSFER].net.state_dict().items() if k.startswith("unet."))
    out["run"] = {"seconds": run_s, "launches": run_counts, "expected": expected,
                  "train_steps": {s.value: st.step for s, st in states.items()},
                  "val_steps_per_stage": val_steps,
                  "epoch_seconds": {s.value: st.epoch_seconds for s, st in states.items()},
                  "rows": rows, "files": files, "last_row": row}
    print(f"run_multistage ({MODALITY}, 1 epoch a stage): {run_s:.1f} s; epoch seconds "
          f"{json.dumps(out['run']['epoch_seconds'])}; launches exact "
          f"{run_counts == expected}; files {json.dumps(files)}", flush=True)
    checks.record(run_counts == expected and finite and saved and kept and
                  len(rows) == 3, dict(phase="multistage_run", launches=run_counts,
                                       expected=expected, finite=finite, saved=saved,
                                       transfer_backbone_bit_equal=kept))

    # 3. each stage's step on one resident batch: exact launches (counts
    # reset just before it), TRANSFER's backbone bit-equal, ms per step
    # (median of 10) and peak MiB beside the same stage on cuDNN
    step_counts = {}
    for stage, st in states.items():
        modality = st.net.modality
        keys = tuple(dict.fromkeys((modality, "dwi-tensor")))
        batch = next(iter(dm.train_batches(SEED, keys=keys, device="cuda")))
        x, y = batch[modality], batch["dwi-tensor_orig"]
        del batch
        step = ms.make_supervised_train_step(st.net, cfg.train)
        step(st, x, y)  # warm-up
        torch.cuda.synchronize()
        before = {k: v.clone() for k, v in st.net.state_dict().items() if k.startswith("unet.")}
        K.reset_launches()
        step(st, x, y)
        torch.cuda.synchronize()
        counts = K.launches()
        step_counts[stage.value] = counts
        frozen = all(torch.equal(v, before[k]) for k, v in st.net.state_dict().items()
                     if k.startswith("unet."))
        del before
        want = MULTISTAGE_STAGE_LAUNCHES[stage.value]
        checks.record(counts == want and frozen == (stage == TrainingState.TRANSFER),
                      dict(phase="multistage_step_launches", stage=stage.value,
                           launches=counts, expected=want, backbone_unchanged=frozen))
        timing = {}
        for key, packed in (("packed", True), ("cudnn", False)):
            if packed:
                net, state = st.net, st
            else:
                sd = st.net.state_dict()
                net = ms.build_multi_input_unet(
                    modality, dataclasses.replace(cfg.model, packed=False), "cuda")
                state = ms.create_supervised_state(SEED, net, cfg.train, stage, state_dict=sd)
                del sd
            fn = ms.make_supervised_train_step(net, cfg.train)
            ts, peak, metrics = time_steps(torch, fn, state, x, y)
            timing[key] = {"ms_per_step_median": statistics.median(ts), "ms_all": ts,
                           "peak_mib": peak, "last_metrics": metrics[-1]}
            checks.record(all(math.isfinite(v) for m in metrics for v in m.values()),
                          dict(phase="multistage_step_losses_finite", stage=stage.value,
                               mode=key, last_metrics=metrics[-1]))
            del net, state, fn
        timing["epoch_seconds"] = st.epoch_seconds
        out[stage.value] = timing
        print(f"multistage {stage.value} step (bf16, 8 × 64³): packed "
              f"{timing['packed']['ms_per_step_median']:.3f} ms, cuDNN "
              f"{timing['cudnn']['ms_per_step_median']:.3f} ms; peak "
              f"{timing['packed']['peak_mib']:.0f} / {timing['cudnn']['peak_mib']:.0f} MiB; "
              f"epoch {st.epoch_seconds[0]:.2f} s; launches {json.dumps(counts)}", flush=True)
        del x, y, step
        torch.cuda.empty_cache()
    del states
    torch.cuda.empty_cache()

    # 4. one f32 step (FINE_TUNE: every leaf trains), batch 2 × 64³, dropout
    # 0, through the kernels (packed) and on plain PyTorch/cuDNN (TF32 off)
    # from the same seeded random weights (PReLU slopes 0.25 ± N(0, 0.1²))
    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    x = torch.randn((2,) + (p,) * 3 + (24,), device="cuda", generator=g)
    y = 10.0 + torch.rand((2,) + (p,) * 3 + (6,), device="cuda", generator=g)  # L1 sign fixed
    grads, losses, sd = {}, {}, None
    for key, packed in (("plain", False), ("kernels", True)):
        mcfg = dataclasses.replace(cfg.model, compute_dtype="float32", dropout=0.0,
                                   packed=packed)
        net = ms.build_multi_input_unet(MODALITY, mcfg, "cuda")
        sd = sd or weights.random_state_dict(net, SEED)
        state = ms.create_supervised_state(SEED, net, cfg.train, TrainingState.FINE_TUNE,
                                           state_dict=sd)
        losses[key] = float(ms.make_supervised_train_step(net, cfg.train)(state, x, y)[
            "train_loss"])
        grads[key] = {n: q.grad.detach().clone() for n, q in net.named_parameters()}
        del net, state
    ref, got = grads["plain"], grads["kernels"]
    scale = max(float(v.abs().max()) for v in ref.values())
    bad, leaves = [], []
    for name, r in ref.items():
        if name.endswith((".conv.bias", "conv_in.bias", "conv_mid.bias", "conv_out.bias")):
            # a conv bias before an InstanceNorm: true gradient 0, as in the
            # GAN step's check
            err, tol = float((got[name] - r).abs().max()), 1e-4 * scale
        else:
            err, tol = rel_l2(got[name], r), 5e-2  # the GAN step's check's bound
            leaves.append((name, err))
        if not err <= tol:
            bad.append((name, err, tol))
    worst = max(leaves, key=lambda t: t[1])
    loss_rel = abs(losses["kernels"] - losses["plain"]) / abs(losses["plain"])
    out["f32_grad_check"] = {"leaves": len(ref), "worst_leaf": worst, "loss_rel_err": loss_rel,
                             "failures": bad}
    print(f"multistage f32 grad check: {len(ref)} leaves; worst rel L2 {worst[1]:.2e} at "
          f"{worst[0]}; loss rel err {loss_rel:.2e}; failures {bad}", flush=True)
    checks.record(not bad and loss_rel <= 1e-5 and got.keys() == ref.keys(),
                  dict(phase="multistage_f32_grad_check", **out["f32_grad_check"]))
    del grads, got, ref
    torch.cuda.empty_cache()
    return run_counts, step_counts, out


def phase_sharded(torch, K, checks, pkg, tree: str, work: Path):
    """Phase 16: the sharded training step on meshes whose positions all lie
    on cuda:0 (see the docstring). Returns each path's launch counts and
    the records."""
    (Config, create_gan_state, make_train_step, make_eval_step, mesh_pkg, Trainer,
     DoveDataModule, ckpt, ms, TrainingState) = pkg
    from torch.profiler import ProfilerActivity, profile

    make_mesh, shard_batch, gather_batch = mesh_pkg
    base = Config()
    g = torch.Generator(device="cuda").manual_seed(SEED + 4)
    x = torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (24,), device="cuda", generator=g)
    y = torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (6,), device="cuda", generator=g)
    meshes = {s: make_mesh(["cuda:0"], ("data", "space"), s) for s in SHARDED_MESHES}
    label = lambda s: "unsharded" if s is None else f"{s[0]}x{s[1]}"  # noqa: E731
    out, paths = {}, {}

    def state_on(shape, **over):
        mcfg = dataclasses.replace(base.model, dropout=0.0, **over)
        mesh = None if shape is None else meshes[shape]
        return create_gan_state(SEED, MODALITY, mcfg, base.train, "cuda", mesh=mesh), mesh

    # 1. f32 through the kernels (packed, TF32 off), dropout 0: one step on
    # each mesh against the unsharded step from the same weights and batch
    f32 = {}
    for shape in (None,) + SHARDED_MESHES:
        st, mesh = state_on(shape, compute_dtype="float32", packed=True)
        m = make_train_step(st.gen, st.disc, base.train, mesh=mesh)(st, x, y)
        f32[shape] = ({k: float(v) for k, v in m.items()},
                      {n: p.grad.detach().clone() for n, p in st.gen.named_parameters()})
        del st
        torch.cuda.empty_cache()
    ref_m = f32[None][0]
    rows = {}
    for shape in SHARDED_MESHES:
        loss_rel, worst, bad = f32_step_failures(*f32[None], *f32[shape])
        rows[label(shape)] = {"loss_rel_err": loss_rel, "worst_leaf": worst, "failures": bad}
        print(f"sharded f32 step {label(shape)} vs unsharded: losses "
              f"{json.dumps(loss_rel)}; worst leaf {worst}; failures {bad}", flush=True)
    checks.record(all(not r["failures"] for r in rows.values()),
                  dict(phase="sharded_step_f32_vs_unsharded", meshes=rows))
    # the BatchNorm running statistics after one train-mode forward of G and
    # D: updated once, with the global batch's moments
    stats = {}
    for shape in (None,) + SHARDED_MESHES:
        st, mesh = state_on(shape, compute_dtype="float32", packed=True)
        st.gen.train()
        st.disc.train()
        with torch.no_grad():
            xs, ys = (v if mesh is None else shard_batch(mesh, v) for v in (x, y))
            st.disc(xs, st.gen(xs))
            st.disc(xs, ys)
        stats[shape] = {f"{k}.{n}": b.clone() for k, mod in (("gen", st.gen), ("disc", st.disc))
                        for n, b in mod.named_buffers()}
        del st
    stat_err = {label(s): max(float((stats[s][k] - r).abs().max()) / float(r.abs().max())
                              for k, r in stats[None].items()) for s in SHARDED_MESHES}
    checks.record(all(e <= 1e-5 for e in stat_err.values()),
                  dict(phase="sharded_batchnorm_stats", rel_max_err=stat_err, tol=1e-5))
    del f32, stats
    torch.cuda.empty_cache()

    # 2. bf16 (the default config, dropout 0): each mesh's first step with the
    # counts reset just before it, its losses against the unsharded bf16
    # step's distance from f32 (3× + 2^-8, phase 5's rule), then ms per step
    # (median of 10 after 3 warm-ups) and peak MiB beside the unsharded step
    counts_by_mesh, timing, first = {}, {}, {}
    for shape in (None,) + SHARDED_MESHES + ("ddp",):
        ddp = shape == "ddp"
        st, mesh = state_on(SHARDED_DDP if ddp else shape)
        step = make_train_step(st.gen, st.disc, base.train, mesh=mesh, ddp_parity=ddp)
        key = f"ddp_{label(SHARDED_DDP)}" if ddp else label(shape)
        torch.cuda.synchronize()
        K.reset_launches()
        m = step(st, x, y)
        torch.cuda.synchronize()
        counts = K.launches()
        first[key] = {k: float(v) for k, v in m.items()}
        if shape in ("ddp", SHARDED_DDP):  # the statistics after the first step
            first[key + "_stats"] = {n: b.float().clone() for n, b in st.disc.named_buffers()}
        if shape is not None:
            want = sharded_launches(SHARDED_DDP if ddp else shape)
            counts_by_mesh[key] = counts
            checks.record(counts == want, dict(phase="sharded_step_launches", mesh=key,
                                               launches=counts, expected=want))
        ts, peak, metrics = time_steps(torch, step, st, x, y)
        # the device's busy share over 3 profiled steps, and its ops a step
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                step(st, x, y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, _ = busy_share(prof, wall)
        ops = sum(getattr(e.device_type, "name", "") == "CUDA" for e in prof.events()) / 3
        finite = all(math.isfinite(v) for mm in metrics + [first[key]] for v in mm.values())
        med = statistics.median(ts)
        timing[key] = {"ms_per_step_median": med, "ms_all": ts, "peak_mib": peak,
                       "patches_per_s": TRAIN_BATCH * 1e3 / med, "device_busy_share": busy,
                       "device_ops_per_step": ops, "profiled_ms_per_step": wall * 1e3 / 3}
        print(f"sharded train step {key} (bf16, 8 × 64³, dropout 0): {med:.3f} ms/step "
              f"median (runs {', '.join(f'{t:.2f}' for t in ts)}); peak {peak:.0f} MiB; "
              f"busy {'none' if busy is None else f'{busy:.3f}'} of {wall * 1e3 / 3:.1f} ms "
              f"profiled, {ops:.0f} device ops "
              f"a step; first losses {json.dumps(first[key])}", flush=True)
        checks.record(finite, dict(phase="sharded_step_losses_finite", mesh=key))
        del st, step
        torch.cuda.empty_cache()
    bf16_rows = {}
    for key in [label(s) for s in SHARDED_MESHES]:
        row = {}
        for k, r in ref_m.items():
            got, flat = first[key][k], first["unsharded"][k]
            row[k] = (abs(got - r) / abs(r), 3 * abs(flat - r) / abs(r) + 2 ** -8)
        bf16_rows[key] = row
    checks.record(all(e <= tol for row in bf16_rows.values() for e, tol in row.values()),
                  dict(phase="sharded_step_bf16_losses", meshes=bf16_rows))
    ddp_key = f"ddp_{label(SHARDED_DDP)}"
    stats_differ = any(not torch.allclose(first[ddp_key + "_stats"][n], b, rtol=1e-3, atol=1e-4)
                       for n, b in first[label(SHARDED_DDP) + "_stats"].items())
    checks.record(first[ddp_key]["train_discr_loss"] != first[label(SHARDED_DDP)]["train_discr_loss"]
                  and stats_differ,
                  dict(phase="sharded_ddp_parity_differs_from_global",
                       ddp=first[ddp_key], glob=first[label(SHARDED_DDP)],
                       disc_stats_differ=stats_differ))
    out["steps"] = {"timing": timing, "first_losses": {k: v for k, v in first.items()
                                                       if not k.endswith("stats")},
                    "f32": rows, "bf16": bf16_rows, "bn_stats_rel_err": stat_err}
    paths["sharded_train_step"] = {k: sum(c[k] for c in counts_by_mesh.values())
                                   for k in TRAIN_STEP_LAUNCHES}

    # 3. one sharded eval step (f32) on (2, 2): its launches, its metrics
    # against the unsharded eval step's
    evals = {}
    for shape in (None, SHARDED_EVAL):
        st, mesh = state_on(shape, compute_dtype="float32", packed=True)
        fn = make_eval_step(st.gen, st.disc, base.train, mesh=mesh)
        torch.cuda.synchronize()
        K.reset_launches()
        m, y_hat = fn(st, x, y)
        torch.cuda.synchronize()
        evals[shape] = ({k: float(v) for k, v in m.items()}, K.launches(), tuple(y_hat.shape))
        del st, fn, y_hat
    (ref_e, _, _), (got_e, ecounts, eshape) = evals[None], evals[SHARDED_EVAL]
    erel = {k: abs(got_e[k] - r) / max(abs(r), 1e-30) for k, r in ref_e.items()}
    ewant = sharded_launches(SHARDED_EVAL, EVAL_STEP_LAUNCHES)
    paths["sharded_eval_step"] = ecounts
    checks.record(ecounts == ewant and all(e <= 1e-5 for e in erel.values())
                  and eshape == tuple(y.shape),
                  dict(phase="sharded_eval_step", mesh=label(SHARDED_EVAL), launches=ecounts,
                       expected=ewant, rel_err=erel))
    out["eval"] = {"rel_err": erel}
    torch.cuda.empty_cache()

    # 4. Trainer(mesh=(2, 2)).fit for one epoch on phase 12's tree, the
    # counts reset just before it; its checkpoint loads into an unsharded state
    cfg = dataclasses.replace(
        base, data=dataclasses.replace(base.data, val_split=0.25, test_split=0.25),
        train=dataclasses.replace(base.train, max_epochs=1, log_dir=str(work / "logs"),
                                  checkpoint_dir=str(work / "ckpts")))
    dm = DoveDataModule(tree, config=cfg.data)
    dm.prepare_data()
    fit_mesh = make_mesh(["cuda:0"], ("data", "space"), SHARDED_FIT)
    trainer = Trainer(cfg, MODALITY, mesh=fit_mesh)
    calls = {"train": 0, "eval": 0}
    train_step, eval_step = trainer.train_step, trainer.eval_step

    def counted(kind, fn):
        def call(*a):
            calls[kind] += 1
            return fn(*a)
        return call

    trainer.train_step, trainer.eval_step = counted("train", train_step), counted("eval", eval_step)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    state, best = trainer.fit(dm)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fcounts = K.launches()
    trainer.logger.finish()
    step_want, eval_want = (sharded_launches(SHARDED_FIT, p)
                            for p in (TRAIN_STEP_LAUNCHES, EVAL_STEP_LAUNCHES))
    fwant = {k: calls["train"] * step_want[k] + calls["eval"] * eval_want[k] for k in fcounts}
    plain = create_gan_state(SEED + 9, MODALITY, cfg.model, cfg.train, "cuda")
    ckpt.load_checkpoint(best, plain)
    same = all(torch.equal(a, b) for mod, twin in ((state.gen, plain.gen), (state.disc, plain.disc))
               for a, b in zip(mod.state_dict().values(), twin.state_dict().values()))
    with open(os.path.join(trainer.logger.log_dir, "metrics.csv")) as f:
        fit_rows = list(csv.DictReader(f))
    finite = len(fit_rows) == 1 and all(math.isfinite(float(v)) for v in fit_rows[0].values())
    paths["sharded_trainer_fit"] = fcounts
    out["fit"] = {"seconds": fit_s, "calls": calls, "row": fit_rows[0] if fit_rows else None,
                  "epoch_seconds": float(fit_rows[0]["epoch_seconds"]) if fit_rows else None}
    print(f"Trainer(mesh={label(SHARDED_FIT)}).fit, 1 epoch: {fit_s:.1f} s, {calls}; "
          f"checkpoint loads unsharded bit for bit {same}", flush=True)
    checks.record(fcounts == fwant and same and finite and calls["train"] > 0,
                  dict(phase="sharded_trainer_fit", launches=fcounts, expected=fwant,
                       checkpoint_loads_unsharded=same, finite=finite, **out["fit"]))
    del state, plain, trainer
    torch.cuda.empty_cache()

    # 5. one supervised step of each multi-stage stage on (2, 2), thesis
    # widths, bf16: exact launches (K5-wgrad 0 in TRANSFER, whose backbone
    # stays bit for bit), finite losses, ms (median of 3 after 1)
    ms_mesh = make_mesh(["cuda:0"], ("data", "space"), SHARDED_EVAL)
    ms_counts, ms_rows = {}, {}
    total = dict.fromkeys(TRAIN_STEP_LAUNCHES, 0)
    for i, stage in enumerate(TrainingState):
        modality = "dwi-tensor" if stage == TrainingState.PRETRAIN else MODALITY
        xs = torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (6 if i == 0 else 24,),
                        device="cuda", generator=g)
        net = ms.build_multi_input_unet(modality, base.model, mesh=ms_mesh)
        st = ms.create_supervised_state(SEED + i, net, base.train, stage)
        fn = ms.make_supervised_train_step(net, base.train, mesh=ms_mesh)
        before = {k: v.clone() for k, v in net.state_dict().items() if k.startswith("unet.")}
        torch.cuda.synchronize()
        K.reset_launches()
        m = fn(st, xs, y)
        torch.cuda.synchronize()
        counts = K.launches()
        frozen = all(torch.equal(v, before[k]) for k, v in net.state_dict().items()
                     if k.startswith("unet."))
        want = sharded_launches(SHARDED_EVAL, MULTISTAGE_STAGE_LAUNCHES[stage.value])
        ts, peak, metrics = time_steps(torch, fn, st, xs, y, warmup=1, timed=3)
        finite = all(math.isfinite(v) for mm in metrics + [{k: float(v) for k, v in m.items()}]
                     for v in mm.values())
        ms_counts[stage.value] = counts
        ms_rows[stage.value] = {"ms_per_step_median": statistics.median(ts), "ms_all": ts,
                                "peak_mib": peak}
        for k in total:
            total[k] += counts[k]
        print(f"sharded multistage {stage.value} step ({label(SHARDED_EVAL)}, bf16, 8 × 64³): "
              f"{statistics.median(ts):.3f} ms; peak {peak:.0f} MiB; launches "
              f"{json.dumps(counts)}", flush=True)
        checks.record(counts == want and finite
                      and frozen == (stage == TrainingState.TRANSFER),
                      dict(phase="sharded_multistage_step", stage=stage.value, launches=counts,
                           expected=want, backbone_unchanged=frozen, finite=finite))
        del net, st, fn, before, xs
        torch.cuda.empty_cache()
    paths["sharded_multistage_step"] = total
    out["multistage"] = ms_rows
    return paths, out


# Phase 20: training over distinct devices, cuda:0 and the host: the mesh
# shapes, the batch (2 × 64³) and the names of the multi-stage net's conv
# biases that feed a norm.
DISTINCT_SHAPES = ((2, 1), (1, 2))
DISTINCT_BATCH = 2
MS_NORM_BIASES = (".conv.bias", "conv_in.bias", "conv_mid.bias", "conv_out.bias")


def phase_distinct(torch, K, checks, pkg, work: Path):
    """Phase 20: training on meshes over cuda:0 and the host (see the
    docstring). Returns each path's launch counts and the records."""
    (Config, create_gan_state, make_train_step, mesh_pkg, ckpt, ms, TrainingState) = pkg
    Mesh, make_mesh, replicas = mesh_pkg
    base = Config()
    card, host = torch.device("cuda", 0), torch.device("cpu")
    mcfg = dataclasses.replace(base.model, compute_dtype="float32", dropout=0.0, packed=True)
    g = torch.Generator(device="cuda").manual_seed(SEED + 20)
    lead = (DISTINCT_BATCH,) + (TRAIN_PATCH,) * 3
    x = torch.rand(lead + (24,), device="cuda", generator=g)
    y = torch.rand(lead + (6,), device="cuda", generator=g)
    mixed = {(2, 1): Mesh([[card], [host]], ("data",)),
             (1, 2): Mesh([[card, host]], ("data", "space"))}
    alone = {(2, 1): make_mesh(["cuda:0"], ("data",), (2,)),
             (1, 2): make_mesh(["cuda:0"], ("data", "space"), (1, 2))}
    label = lambda s: f"{s[0]}x{s[1]}"  # noqa: E731
    paths, out = {}, {}

    def bit_equal(*modules):
        """Each replica's parameters and buffers bit-equal to its master's."""
        pairs = [(replicas(m)[0].state_dict(), twin.state_dict())
                 for m in modules for twin in replicas(m)[1:]]
        return bool(pairs) and all(a.keys() == b.keys() and all(
            torch.equal(v.cpu(), b[k].cpu()) for k, v in a.items()) for a, b in pairs)

    def counted(step, state, xs, ys):
        """One step with the counts reset just before it: (metrics, counts, s)."""
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        m = step(state, xs, ys)
        torch.cuda.synchronize()
        return {k: float(v) for k, v in m.items()}, K.launches(), time.perf_counter() - t0

    def held(key, runs, want, biases=(".conv.bias",)):
        """The mixed mesh's step against cuda:0 alone's: f32 bounds, exact
        launches on both, replicas bit-equal."""
        (ref_m, ref_g, ref_c, ref_s, _), (m, grads, c, sec, same) = runs["alone"], runs["mixed"]
        loss_rel, worst, bad = f32_step_failures(ref_m, ref_g, m, grads, biases)
        row = {"loss_rel_err": loss_rel, "worst_leaf": worst, "failures": bad,
               "launches": c, "expected": want[1], "alone_launches": ref_c,
               "alone_expected": want[0], "replicas_bit_equal": same, "s": sec,
               "alone_s": ref_s}
        print(f"distinct devices {key}: {sec:.1f} s (cuda:0 alone {ref_s:.2f} s); losses "
              f"{json.dumps(loss_rel)}; worst leaf {worst}; failures {bad}; launches "
              f"{json.dumps(c)}; replicas bit-equal {same}", flush=True)
        checks.record(not bad and c == want[1] and ref_c == want[0] and same,
                      dict(phase="distinct_devices_step", step=key, **row))
        paths[f"distinct_{key}"] = c
        out[key] = row

    # 1. one f32 GAN step on each mixed mesh against cuda:0 alone
    for shape in DISTINCT_SHAPES:
        runs = {}
        for key, mesh in (("alone", alone[shape]), ("mixed", mixed[shape])):
            st = create_gan_state(SEED, MODALITY, mcfg, base.train, "cuda", mesh=mesh)
            m, c, sec = counted(make_train_step(st.gen, st.disc, base.train, mesh=mesh),
                                st, x, y)
            runs[key] = (m, {n: p.grad.detach().clone() for n, p in st.gen.named_parameters()},
                         c, sec, key == "alone" or (len(replicas(st.gen)) == 2
                                                    and bit_equal(st.gen, st.disc)))
            del st
            torch.cuda.empty_cache()
        held(f"gan_step_{label(shape)}", runs,
             (sharded_launches(shape), sharded_launches(shape, positions=1)))

    # 2. one f32 FINE_TUNE step at the thesis widths on (2, 1)
    xs = torch.rand(lead + (24,), device="cuda", generator=g)
    ys = 10.0 + torch.rand(lead + (6,), device="cuda", generator=g)  # L1's sign fixed
    runs = {}
    for key, mesh in (("alone", alone[(2, 1)]), ("mixed", mixed[(2, 1)])):
        net = ms.build_multi_input_unet(MODALITY, mcfg, mesh=mesh)
        st = ms.create_supervised_state(SEED, net, base.train, TrainingState.FINE_TUNE)
        m, c, sec = counted(ms.make_supervised_train_step(net, base.train, mesh=mesh), st, xs, ys)
        runs[key] = (m, {n: p.grad.detach().clone() for n, p in net.named_parameters()}, c, sec,
                     key == "alone" or (len(replicas(net)) == 2 and bit_equal(net)))
        del net, st
        torch.cuda.empty_cache()
    per_step = MULTISTAGE_STAGE_LAUNCHES["finetune"]
    held("finetune_step_2x1", runs, (sharded_launches((2, 1), per_step),
                                     sharded_launches((2, 1), per_step, positions=1)),
         MS_NORM_BIASES)
    del xs, ys, runs

    # 3. the default dropout on (2, 1), cuDNN deterministic: two runs from
    # the seed bit for bit; the second's checkpoint loads on cuda:0 alone
    dcfg = dataclasses.replace(mcfg, dropout=base.model.dropout)
    mesh = mixed[(2, 1)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            st = create_gan_state(SEED, MODALITY, dcfg, base.train, "cuda", mesh=mesh)
            m, c, sec = counted(make_train_step(st.gen, st.disc, base.train, mesh=mesh),
                                st, x, y)
            runs.append((m, c, sec, {f"{n}.{k}": v.cpu() for n in ("gen", "disc")
                                     for k, v in getattr(st, n).state_dict().items()},
                         [r.get_state() for r in (st.rng,) + st.replica_rngs],
                         bit_equal(st.gen, st.disc)))
    finally:
        torch.backends.cudnn.deterministic = det
    (m0, c0, s0, sd0, rng0, same0), (m1, _, _, sd1, rng1, same1) = runs
    rerun = (m0 == m1 and sd0.keys() == sd1.keys() and all(torch.equal(sd0[k], sd1[k])
                                                           for k in sd0)
             and len(rng0) == len(rng1) == 2 and all(torch.equal(a, b)
                                                      for a, b in zip(rng0, rng1)))
    finite = all(math.isfinite(v) for v in m0.values())
    mgr = ckpt.CheckpointManager(str(work / "ckpts"), top_k=1)
    mgr.save(0, st, {"val_loss": m0["train_gen_loss"]})
    plain = create_gan_state(SEED + 9, MODALITY, dcfg, base.train, "cuda")
    ckpt.load_checkpoint(str(work / "ckpts" / "0"), plain)
    loads = (all(torch.equal(a, b) for mod, twin in ((st.gen, plain.gen), (st.disc, plain.disc))
                 for a, b in zip(mod.state_dict().values(), twin.state_dict().values()))
             and torch.equal(plain.rng.get_state(), st.rng.get_state()))
    want = sharded_launches((2, 1), positions=1)
    row = {"losses": m0, "launches": c0, "expected": want, "s": s0, "rerun_bit_equal": rerun,
           "replicas_bit_equal": same0 and same1, "finite": finite,
           "checkpoint_loads_on_cuda0": loads}
    print(f"distinct devices dropout step 2x1: {s0:.1f} s; rerun bit for bit {rerun}; "
          f"replicas bit-equal {same0 and same1}; checkpoint loads on cuda:0 alone {loads}",
          flush=True)
    checks.record(rerun and same0 and same1 and finite and loads and c0 == want,
                  dict(phase="distinct_devices_dropout_step", **row))
    paths["distinct_dropout_step_2x1"] = c0
    out["dropout_step_2x1"] = row
    del st, plain, runs
    torch.cuda.empty_cache()
    return paths, out


# Phase 21: training across processes (parallel/distributed.py). The
# processes run scripts/torch_port_multiprocess_step.py, each on its rows of
# one global batch of 8 × 64³ drawn from MP_DATA_SEED (4 a process), with
# the full-width model, packed; this process steps on the whole batch as
# the one-process reference. (a) f32, dropout 0, lr 1e-6: one step's global
# metrics at tests/test_multihost.py's tolerances; (b) bf16, the default
# config: MP_BF16_STEPS steps, the weights bit-equal across the processes,
# each step's launches those of one process's step.
MP_DATA_SEED = SEED + 21
MP_GLOBAL_BATCH, MP_BF16_STEPS, MP_LR = 8, 3, 1e-6
MP_WORKER = Path(__file__).resolve().parent / "scripts" / "torch_port_multiprocess_step.py"


def mp_group(work: Path, name: str, n: int, device, backend, timeout: float = 300.0):
    """``n`` worker processes of phase 21 on ``device`` (None: each its own
    card) with ``backend`` (None: the rule's); returns each process's
    record, or raises with the failing process's output."""
    args = ["--num-processes", str(n), "--coordinator-address", f"file://{work / name}.rdv",
            "--data", f"random:{MP_DATA_SEED}", "--global-batch", str(MP_GLOBAL_BATCH),
            "--patch", str(TRAIN_PATCH), "--width", "full", "--timeout", str(timeout),
            "--run", f"float32:1:{MP_LR}:0", "--run", f"bfloat16:{MP_BF16_STEPS}",
            "--out", str(work / name)]
    args += ["--device", device] if device else []
    args += ["--backend", backend] if backend else []
    logs = [open(work / f"{name}{r}.log", "w") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, str(MP_WORKER), "--process-id", str(r)] + args,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n)]
    try:
        for p in procs:
            p.wait(timeout=timeout + 60)
    finally:
        for p, f in zip(procs, logs):
            stop_process(p)
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (work / f"{name}{r}.log").read_text()[-4000:]
            raise RuntimeError(f"phase 21 worker {name}/{r} exited {p.returncode}:\n{tail}")
    return [json.loads((work / name / f"rank{r}.json").read_text()) for r in range(n)]


def mp_held(ranks, ref_f32, ref_counts):
    """The f32 step's metrics of every process against the one-process
    reference (rtol 2e-5, D's loss 2e-2, atol 2e-6) and alike on every
    process; the bf16 runs' weights bit-equal; every step's launches the
    one-process step's. Returns the failures."""
    bad = []
    f32 = [r["runs"][0]["steps"][0]["metrics"] for r in ranks]
    if any(m != f32[0] for m in f32):
        bad.append("f32 metrics differ between processes")
    for k, v in ref_f32.items():
        tol = (2e-2 if k == "train_discr_loss" else 2e-5) * abs(v) + 2e-6
        if not abs(f32[0][k] - v) <= tol:
            bad.append((k, f32[0][k], v))
    if len({r["runs"][1]["digest"] for r in ranks}) != 1:
        bad.append("bf16 weights differ between processes")
    for r in ranks:
        for run in r["runs"]:
            for i, st in enumerate(run["steps"]):
                if st["launches"] != ref_counts:
                    bad.append((r["rank"], run["spec"], i, st["launches"]))
    return bad


def phase_multiprocess(torch, K, checks, pkg, card: str, work: Path):
    """Phase 21: training across processes on one card under gloo, with
    NCCL where the machine has two cards, and the cut capacity probe (see
    the docstring). Returns the processes' launch counts and the records."""
    import numpy as np

    Config, create_gan_state, make_train_step = pkg
    base = Config()
    rng = np.random.default_rng(MP_DATA_SEED)
    lead = (MP_GLOBAL_BATCH,) + (TRAIN_PATCH,) * 3
    x = torch.from_numpy(rng.random(lead + (24,), dtype=np.float32)).cuda()
    y = torch.from_numpy(rng.random(lead + (6,), dtype=np.float32)).cuda()

    def one_process(mcfg, tcfg, steps):
        st = create_gan_state(SEED, MODALITY, mcfg, tcfg, "cuda")
        step = make_train_step(st.gen, st.disc, tcfg)
        rows = []
        for _ in range(steps):
            torch.cuda.synchronize()
            K.reset_launches()
            t0 = time.perf_counter()
            m = step(st, x, y)
            torch.cuda.synchronize()
            rows.append(({k: float(v) for k, v in m.items()}, K.launches(),
                         time.perf_counter() - t0))
        del st
        torch.cuda.empty_cache()
        return rows

    f32_cfg = dataclasses.replace(base.model, compute_dtype="float32", dropout=0.0)
    (ref_f32, ref_c32, _), = one_process(f32_cfg, dataclasses.replace(base.train, lr=MP_LR), 1)
    ref_bf16 = one_process(base.model, base.train, MP_BF16_STEPS)
    out, paths = {}, {}
    ranks = mp_group(work, "gloo", 2, "cuda:0", "gloo")
    bad = mp_held(ranks, ref_f32, ref_c32)
    if any(c != TRAIN_STEP_LAUNCHES for _, c, _ in ref_bf16) or ref_c32 != TRAIN_STEP_LAUNCHES:
        bad.append("the one-process step's launches")
    two_ms = [statistics.median(st["s"] for st in r["runs"][1]["steps"][1:]) * 1e3 for r in ranks]
    one_ms = statistics.median(s for _, _, s in ref_bf16[1:]) * 1e3
    out["gloo_one_card"] = {
        "backends": [r["backend"] for r in ranks], "f32": ranks[0]["runs"][0]["steps"][0],
        "f32_one_process": ref_f32, "bf16_digest_equal": len({r["runs"][1]["digest"]
                                                            for r in ranks}) == 1,
        "bf16_ms_per_step": two_ms, "bf16_one_process_ms": one_ms,
        "batch_per_process": MP_GLOBAL_BATCH // 2, "failures": bad, "card": card}
    print(f"multiprocess gloo, 2 processes on cuda:0 (4 patches each): f32 step "
          f"{json.dumps(ranks[0]['runs'][0]['steps'][0]['metrics'])} against one process's "
          f"{json.dumps(ref_f32)}; bf16 weights bit-equal "
          f"{out['gloo_one_card']['bf16_digest_equal']}; failures {bad}", flush=True)
    print(f"multiprocess bf16 step: {two_ms[0]:.2f} / {two_ms[1]:.2f} ms a process (4 patches "
          f"each, gloo) against one process's {one_ms:.2f} ms (8 patches), median of steps "
          f"2-{MP_BF16_STEPS}; {card}", flush=True)
    print("multiprocess: the two processes share one card and reduce through the host "
          "(gloo); these times are no multi-card speed", flush=True)
    checks.record(not bad and all(r["backend"] == "gloo" for r in ranks),
                  dict(phase="multiprocess_gloo_one_card", **out["gloo_one_card"]))
    paths["multiprocess_f32_step_rank0"] = ranks[0]["runs"][0]["steps"][0]["launches"]
    paths["multiprocess_bf16_steps_rank0"] = {
        k: sum(st["launches"][k] for st in ranks[0]["runs"][1]["steps"])
        for k in TRAIN_STEP_LAUNCHES}

    if torch.cuda.device_count() >= 2:
        ranks = mp_group(work, "nccl", 2, None, None)
        bad = mp_held(ranks, ref_f32, ref_c32)
        nccl = [r["backend"] for r in ranks]
        out["nccl_two_cards"] = {"ran": True, "backends": nccl, "failures": bad,
                                 "f32": ranks[0]["runs"][0]["steps"][0],
                                 "bf16_ms_per_step": [statistics.median(
                                     st["s"] for st in r["runs"][1]["steps"][1:]) * 1e3
                                     for r in ranks]}
        print(f"multiprocess nccl, one card each: {json.dumps(out['nccl_two_cards'])}",
              flush=True)
        checks.record(not bad and nccl == ["nccl", "nccl"],
                      dict(phase="multiprocess_nccl_two_cards", **out["nccl_two_cards"]))
    else:
        out["nccl_two_cards"] = {"ran": False,
                                 "reason": f"{torch.cuda.device_count()} card visible"}
        print(json.dumps({"phase": "multiprocess_nccl", "ran": False,
                          "reason": "NCCL was not run: one card visible"}), flush=True)

    # the capacity probe cut to 1 epoch on the smoke fixture, its record
    # written to a file of this phase
    from scripts import torch_port_capacity_probe as cp

    before = os.environ.get("CONVBENCH_DATA")
    os.environ["CONVBENCH_DATA"] = str(work / "probe_fixture")
    try:
        t0 = time.perf_counter()
        entry = cp.run(cp.parser().parse_args([
            "--smoke", "--epochs", "1", "--workdir", str(work / "probe"),
            "--record", str(work / "probe.json")]))
        probe_s = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("CONVBENCH_DATA")
        else:
            os.environ["CONVBENCH_DATA"] = before
    saved = json.loads((work / "probe.json").read_text())
    ok = (saved == [entry] and entry["kind"] == "capacity_probe" and entry["device"] == card
          and math.isfinite(entry["val_psnr_last"]))
    out["capacity_probe"] = {"entry": entry, "s": probe_s}
    print(f"capacity probe (1 epoch, smoke fixture): val PSNR {entry['val_psnr_last']} dB "
          f"in {probe_s:.1f} s", flush=True)
    checks.record(ok, dict(phase="multiprocess_capacity_probe", **out["capacity_probe"]))
    return paths, out


# Phase 17: the serving artifact and the public surface. The artifact is
# frozen at the whole volume, batch 1; the wrapper GAN takes 3 steps; the
# plots' files from the evaluation's table and test_metrics.csv.
SURFACE_SHAPE = (1,) + VOLUME + (24,)
SURFACE_GAN_STEPS = 3
PLOT_FILES = ("test_psnr.pdf", "sample_stats.csv", "stats.pdf", "diag_tensor_errs.pdf",
              "offdiag_tensor_errs.pdf", "fa_errs.pdf", "md_errs.pdf", "ad_errs.pdf",
              "rd_errs.pdf", "azimuth_errs.pdf", "inclination_errs.pdf")


def phase_surface(torch, K, checks, pkg, tree: str, work: Path, table_csv, log_dir):
    """Phase 17: the serving artifact (``export_generator`` on the card,
    ``predict --exported --scalar-maps``), the two wrappers' steps and the
    plots CLI (see the docstring). ``table_csv`` None leaves the plots out.
    Returns each path's launch counts and the records."""
    import importlib.util

    (Config, build_models, make_predict_fn, make_train_step, create_gan_state, weights,
     predict_volume, nifti, export, predict_main, model, TrainingState) = pkg
    cfg = Config()
    probe, _ = build_models(MODALITY, cfg.model, "cuda")
    sd = weights.random_state_dict(probe, SEED)
    del probe
    out, paths = {}, {}

    # 1. the artifact, bf16 (the default config) and f32, exported on the
    # card at the whole volume, saved and loaded
    arts = {}
    for dtype in ("bfloat16", "float32"):
        mcfg = dataclasses.replace(cfg.model, compute_dtype=dtype)
        t0 = time.perf_counter()
        program, meta = export.export_generator(MODALITY, mcfg, sd, SURFACE_SHAPE,
                                                device="cuda")
        export_s = time.perf_counter() - t0
        path = work / f"generator_{dtype}.ubt"
        t0 = time.perf_counter()
        export.save_exported(program, meta, str(path))
        save_s = time.perf_counter() - t0
        del program
        t0 = time.perf_counter()
        call, meta = export.load_exported(str(path), "cuda")
        load_s = time.perf_counter() - t0
        arts[dtype] = {"path": str(path), "call": call}
        out[f"export_{dtype}"] = {"export_s": export_s, "save_s": save_s, "load_s": load_s,
                                  "mb": os.path.getsize(path) / 1e6, "meta": meta}
        print(f"export_generator {dtype} {list(SURFACE_SHAPE)} on the card: {export_s:.2f} s; "
              f"save {save_s:.2f} s, {os.path.getsize(path) / 1e6:.1f} MB; load "
              f"{load_s:.2f} s", flush=True)

    # 2. predict --exported --scalar-maps on subject 01's input, the counts
    # reset just before it: K8 once and no other kernel (the artifact holds
    # ATen ops only)
    pre = Path(tree) / "derivatives" / "preproc-dove" / "sub-01" / "ses-1" / "dwi"
    inp = str(pre / "sub-01_ses-1_desc-normflatbet_bssfp.nii.gz")
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    pred_path = predict_main([inp, "--exported", arts["bfloat16"]["path"], "--device", "cuda",
                              "--out-dir", str(work / "predict"), "--scalar-maps",
                              "--rescale-args", RESCALE_ARGS])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    pcounts = K.launches()
    paths["predict_exported"] = pcounts
    pwant = dict(dict.fromkeys(pcounts, 0), scalar_maps=1)
    maps = [f for f in os.listdir(work / "predict") if not f.endswith("_pred-dt.nii.gz")]
    checks.record(pcounts == pwant and len(maps) == 7,
                  dict(phase="predict_exported_launches", launches=pcounts, expected=pwant,
                       map_files=len(maps), seconds=cli_s))

    # the prediction against predict_volume (whole volume, packed) on the
    # same volume: in f32 within serving's 1e-3·max|ref|; in bf16 no further
    # from the f32 packed output than 3× the packed bf16 output's distance
    # + 2^-8 (phase 5's rule)
    data, _ = nifti.load_volume(inp)
    vol = torch.from_numpy(data).to("cuda")
    fns = {}
    for dtype in ("bfloat16", "float32"):
        gen, _ = build_models(MODALITY, dataclasses.replace(cfg.model, compute_dtype=dtype),
                              "cuda", state_dict=sd)
        fns[dtype] = make_predict_fn(gen)
    ref = {d: predict_volume(f, vol, whole_volume=True).float() for d, f in fns.items()}
    got_b = torch.from_numpy(nifti.load_volume(pred_path)[0]).to("cuda")
    got_f = arts["float32"]["call"](vol[None])[0]
    scale = float(ref["float32"].abs().max())
    err = {"f32_exported_vs_packed": float((got_f - ref["float32"]).abs().max()) / scale,
           "bf16_exported_vs_f32_packed": float((got_b - ref["float32"]).abs().max()) / scale,
           "bf16_packed_vs_f32_packed": float((ref["bfloat16"] - ref["float32"]).abs().max())
           / scale,
           "bf16_exported_vs_bf16_packed": float((got_b - ref["bfloat16"]).abs().max())
           / float(ref["bfloat16"].abs().max())}
    bf16_tol = 3 * err["bf16_packed_vs_f32_packed"] + 2 ** -8
    ok = (err["f32_exported_vs_packed"] <= 1e-3
          and err["bf16_exported_vs_f32_packed"] <= bf16_tol
          and tuple(got_b.shape) == VOLUME + (6,) and bool(torch.isfinite(got_b).all()))
    out["agreement"] = dict(err, bf16_tol=bf16_tol, f32_tol=1e-3)
    print(f"predict --exported vs predict_volume (whole, packed): {json.dumps(err)}; "
          f"bf16 bound {bf16_tol:.3e}", flush=True)
    checks.record(ok, dict(phase="predict_exported_vs_packed", **out["agreement"]))

    # ms per volume, bf16 and f32: the artifact beside predict_volume (whole,
    # packed), one warm-up each, then 5 rounds in turns
    ways = {}
    for dtype in ("bfloat16", "float32"):
        call, fn = arts[dtype]["call"], fns[dtype]
        ways[f"exported_{dtype}"] = lambda call=call: call(vol[None])
        ways[f"packed_{dtype}"] = lambda fn=fn: predict_volume(fn, vol, whole_volume=True)
    ts = {k: [] for k in ways}
    for f in ways.values():
        f()
    torch.cuda.synchronize()
    for _ in range(5):
        for k, f in ways.items():
            t0 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            ts[k].append((time.perf_counter() - t0) * 1e3)
    out["ms_per_volume"] = {k: {"median": statistics.median(v), "all": v} for k, v in ts.items()}
    print("ms/volume (whole volume, 5 rounds in turns): " + ", ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in ts.items()), flush=True)
    del arts, fns, ref, got_b, got_f, ways
    torch.cuda.empty_cache()

    # 3. bSSFPToDWITensorModel on the card: 3 steps, each launching exactly
    # TRAIN_STEP_LAUNCHES, its losses bit for bit make_train_step's on a
    # state drawn from the same seed (cuDNN deterministic); then ms per step
    g = torch.Generator(device="cuda").manual_seed(SEED + 5)
    batches = [(torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (24,), device="cuda",
                           generator=g),
                torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (6,), device="cuda",
                           generator=g)) for _ in range(SURFACE_GAN_STEPS)]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        wrapper = model.bSSFPToDWITensorModel(MODALITY, config=cfg)
        wrapper.init(SEED)
        twin = create_gan_state(SEED, MODALITY, cfg.model, cfg.train, "cuda")
        twin_step = make_train_step(twin.gen, twin.disc, cfg.train)
        step_counts, same, losses = [], [], []
        for x, y in batches:
            torch.cuda.synchronize()
            K.reset_launches()
            m = wrapper.train_step(wrapper.state, x, y)
            torch.cuda.synchronize()
            step_counts.append(K.launches())
            r = twin_step(twin, x, y)
            losses.append({k: float(v) for k, v in m.items()})
            same.append(m.keys() == r.keys() and all(float(m[k]) == float(r[k]) for k in m))
    finally:
        torch.backends.cudnn.deterministic = det
    paths["surface_gan_step"] = {k: sum(c[k] for c in step_counts) for k in step_counts[0]}
    exact = all(c == TRAIN_STEP_LAUNCHES for c in step_counts)
    ts, peak, metrics = time_steps(torch, wrapper.train_step, wrapper.state, *batches[0])
    finite = all(math.isfinite(v) for mm in metrics + losses for v in mm.values())
    out["gan_wrapper"] = {"ms_per_step_median": statistics.median(ts), "ms_all": ts,
                          "peak_mib": peak, "losses": losses, "bit_equal": same}
    print(f"bSSFPToDWITensorModel: {SURFACE_GAN_STEPS} steps, launches exact {exact}, losses "
          f"bit-equal to make_train_step's {same}; {statistics.median(ts):.3f} ms/step median "
          f"(bf16, 8 × 64³), peak {peak:.0f} MiB", flush=True)
    checks.record(exact and all(same) and finite,
                  dict(phase="surface_gan_step", launches=step_counts[0],
                       expected=TRAIN_STEP_LAUNCHES, bit_equal=same, finite=finite))
    del wrapper, twin, twin_step, batches
    torch.cuda.empty_cache()

    # 4. MultiInputUNetModel on the card: PRETRAIN step → TRANSFER to
    # pc-bSSFP, step → FINE_TUNE, step; each step's launches the supervised
    # step's, the backbone bit for bit over the TRANSFER step; ms per step
    mw = model.MultiInputUNetModel(config=cfg)
    y = torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (6,), device="cuda", generator=g)
    stage_rows = {}
    for stage in (TrainingState.PRETRAIN, TrainingState.TRANSFER, TrainingState.FINE_TUNE):
        if stage != TrainingState.PRETRAIN:
            mw.change_training_state(stage, MODALITY)
        cin = 6 if stage == TrainingState.PRETRAIN else 24
        x = torch.rand((TRAIN_BATCH,) + (TRAIN_PATCH,) * 3 + (cin,), device="cuda",
                       generator=g)
        before = {k: v.clone() for k, v in mw.params.items() if k.startswith("unet.")}
        torch.cuda.synchronize()
        K.reset_launches()
        m = mw.step(x, y)
        torch.cuda.synchronize()
        counts = K.launches()
        paths[f"surface_multistage_{stage.value}_step"] = counts
        frozen = all(torch.equal(v, before[k]) for k, v in mw.params.items()
                     if k.startswith("unet."))
        want = MULTISTAGE_STAGE_LAUNCHES[stage.value]
        lr = [grp["lr"] for grp in mw.sup_state.opt.param_groups]
        ts, peak, metrics = time_steps(torch, mw.train_step, mw.sup_state, x, y,
                                       warmup=1, timed=3)
        finite = all(math.isfinite(v) for mm in metrics + [{k: float(v) for k, v in m.items()}]
                     for v in mm.values())
        stage_rows[stage.value] = {"ms_per_step_median": statistics.median(ts), "ms_all": ts,
                                   "peak_mib": peak, "lr": lr}
        print(f"MultiInputUNetModel {stage.value} ({mw.modality}): launches "
              f"{json.dumps(counts)}; backbone unchanged {frozen}; lr {lr}; "
              f"{statistics.median(ts):.3f} ms/step", flush=True)
        want_lr = [cfg.train.finetune_lr if stage == TrainingState.FINE_TUNE else cfg.train.lr]
        checks.record(counts == want and frozen == (stage == TrainingState.TRANSFER)
                      and finite and lr == want_lr,
                      dict(phase="surface_multistage_step", stage=stage.value, launches=counts,
                           expected=want, backbone_unchanged=frozen, lr=lr))
        del before, x
    out["multistage_wrapper"] = stage_rows
    del mw, y
    torch.cuda.empty_cache()

    # 5. the plots CLI on the evaluation's table and test_metrics.csv (host
    # work on pandas and matplotlib)
    if table_csv is None:
        print("plot_metrics_errors: no evaluation table in this run; not run", flush=True)
    elif not all(importlib.util.find_spec(m) for m in ("pandas", "matplotlib")):
        out["plots"] = "not run: pandas or matplotlib is not installed on this machine"
        print(f"plot_metrics_errors: {out['plots']}", flush=True)
    else:
        from unet_bssfp_tpu_torch.plot_metrics_errors import main as plots_main

        t0 = time.perf_counter()
        plots_main([str(table_csv), "--log-dirs", str(log_dir), "--out-dir",
                    str(work / "plots")])
        plots_s = time.perf_counter() - t0
        files = sorted(os.listdir(work / "plots"))
        out["plots"] = {"seconds": plots_s, "files": files}
        print(f"plot_metrics_errors: {plots_s:.2f} s, {len(files)} files", flush=True)
        checks.record(set(PLOT_FILES) <= set(files),
                      dict(phase="surface_plots", files=files, expected=sorted(PLOT_FILES)))
    return paths, out


# K1, K1's dgrad, K5 and K5's dgrad: the wgmma conv kernel in bf16 (the
# rows of the summary line); the mma.sync loop it replaced stays as the
# check-only conv3x3_packed_mma (and under K7a's routed shapes). K2 and K5's wgrad:
# the wgmma wgrad kernel in bf16; its mma.sync loop stays as the check-only
# conv3x3_wgrad_mma (and under K7b).
KERNEL_META = {
    "conv3x3_packed": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgmma.cu",
                       "unet_bssfp_tpu/ops/pallas/conv3d.py:388"),
    "conv3x3_packed_mma": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_packed.cu",
                           "unet_bssfp_tpu/ops/pallas/conv3d.py:388"),
    "pack_hw": ("cuda", "unet_bssfp_tpu_torch/csrc/layout.cu",
                "unet_bssfp_tpu/ops/pallas/conv3d.py:1259"),
    "unpack_hw": ("cuda", "unet_bssfp_tpu_torch/csrc/layout.cu",
                  "unet_bssfp_tpu/ops/pallas/conv3d.py:1287"),
    "fused_instance_norm_leaky_relu": (
        "cuda", "unet_bssfp_tpu_torch/csrc/norm_act.cu",
        "unet_bssfp_tpu/ops/pallas/fused_norm_act.py:150"),
    "conv3x3_packed_dgrad": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgmma.cu",
                             "unet_bssfp_tpu/ops/pallas/conv3d.py:388"),
    "conv3x3_wgrad": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgrad_wgmma.cu",
                      "unet_bssfp_tpu/ops/pallas/conv3d.py:507"),
    "conv3x3_wgrad_mma": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgrad.cu",
                          "unet_bssfp_tpu/ops/pallas/conv3d.py:507"),
    "scalar_maps": ("cuda", "unet_bssfp_tpu_torch/csrc/scalar_maps.cu",
                    "unet_bssfp_tpu/ops/pallas/scalar_maps_kernel.py:112"),
    # K10: no TPU kernel; XLA fused the packed stages' norm chain
    **{name: ("cuda", "unet_bssfp_tpu_torch/csrc/packed_norm_act.cu",
              "none (XLA's fusion: unet_bssfp_tpu/models/packed_layers.py:76-135)")
       for name in ("packed_norm_act", "packed_norm_act_backward")},
    # K5: the TPU kernel of K1 with pad_d=False (conv3x3_packed_halo, :595),
    # again on the padded dy in its VJP (:619), and the dw kernel with
    # pad_d=False (:624)
    "conv3x3_packed_halo": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgmma.cu",
                            "unet_bssfp_tpu/ops/pallas/conv3d.py:388"),
    "conv3x3_packed_halo_dgrad": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgmma.cu",
                                  "unet_bssfp_tpu/ops/pallas/conv3d.py:388"),
    "conv3x3_wgrad_halo": ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgrad_wgmma.cu",
                           "unet_bssfp_tpu/ops/pallas/conv3d.py:507"),
    # K7a: _pfold_fwd_impl, reached by conv3x3_pfold, its dx, the halo form
    # and its dx; K7b: _pfold_dw_impl and its halo form (the wgmma kernels
    # with FOLD in bf16; the mma.sync loops of conv3x3_packed.cu and
    # conv3x3_wgrad.cu stay for the shapes the fold plans do not take)
    **{name: ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgmma.cu",
              "unet_bssfp_tpu/ops/pallas/conv3d.py:866")
       for name in ("conv3x3_pfold", "conv3x3_pfold_dgrad", "conv3x3_pfold_halo",
                    "conv3x3_pfold_halo_dgrad")},
    **{name: ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgrad_wgmma.cu",
              "unet_bssfp_tpu/ops/pallas/conv3d.py:913")
       for name in ("conv3x3_pfold_wgrad", "conv3x3_pfold_wgrad_halo")},
    # K9a, K9b: the probe kernels of scripts/pallas_probe.py; K9b is K1's
    # wgmma kernel with template MODE, instanced in probe.cu's library
    "lane_roll": ("cuda", "unet_bssfp_tpu_torch/csrc/probe.cu", "scripts/pallas_probe.py:45"),
    **{name: ("cuda", "unet_bssfp_tpu_torch/csrc/conv3x3_wgmma.cu",
              "scripts/pallas_probe.py:144")
       for name in PROBE_KERNELS[1:]},
}
# The kernel body of conv3x3_wgmma.cu's kernels, and the library K9b's
# instances are built in
WGMMA_HEADER = "unet_bssfp_tpu_torch/csrc/conv3x3_wgmma.cuh"
BUILT_IN = dict.fromkeys(PROBE_KERNELS[1:], "unet_bssfp_tpu_torch/csrc/probe.cu")
# The row of each kernel in the summary line: its heaviest shape (output
# channels, dtype) on the patch-stitched serving path, the training step or
# the eval chain; the halo kernels at a shard of the patch batch on a mesh
# with a two-way space split.
SUMMARY_SHAPE = {
    "conv3x3_packed_halo": ([8, 34, 96, 4096], 32, "bfloat16"),
    "conv3x3_packed_halo_dgrad": ([8, 32, 32, 4096], 96, "bfloat16"),
    "conv3x3_wgrad_halo": ([8, 34, 96, 4096], 32, "bfloat16"),
    "conv3x3_packed": ([8, 64, 96, 4096], 32, "bfloat16"),
    "conv3x3_packed_mma": ([8, 64, 96, 4096], 32, "bfloat16"),
    "pack_hw": ([8, 64, 64, 64, 64], None, "bfloat16"),
    "unpack_hw": ([8, 64, 6, 4096], None, "bfloat16"),
    "fused_instance_norm_leaky_relu": ([8, 32, 32, 32, 64], None, "bfloat16"),
    "conv3x3_packed_dgrad": ([8, 64, 32, 4096], 96, "bfloat16"),
    "conv3x3_wgrad": ([8, 64, 96, 4096], 32, "bfloat16"),
    "conv3x3_wgrad_mma": ([8, 64, 96, 4096], 32, "bfloat16"),
    "scalar_maps": (list(VOLUME) + [6], None, "float32"),
    "packed_norm_act": ([16, 64, 32, 4096], None, "bfloat16"),
    "packed_norm_act_backward": ([16, 64, 32, 4096], None, "bfloat16"),
    # the 96 → 32 probe case, folded; the halo forms at its D_local-32 shard
    "conv3x3_pfold": ([8, 64, 384, 1024], 32, "bfloat16"),
    "conv3x3_pfold_dgrad": ([8, 64, 128, 1024], 96, "bfloat16"),
    "conv3x3_pfold_wgrad": ([8, 64, 384, 1024], 32, "bfloat16"),
    "conv3x3_pfold_halo": ([8, 34, 384, 1024], 32, "bfloat16"),
    "conv3x3_pfold_halo_dgrad": ([8, 32, 128, 1024], 96, "bfloat16"),
    "conv3x3_pfold_wgrad_halo": ([8, 34, 384, 1024], 32, "bfloat16"),
    "lane_roll": ([8, 128], None, "float32"),
    **{name: ([8, 64, 24, 4096], 32, "bfloat16") for name in PROBE_KERNELS[1:]},
}


# Phase 18: the wguard layout, switched on by UNET_BSSFP_WGUARD=1 for the
# phase alone. guard_cols gives 2 guard columns a row at 64² (row width 66)
# and at 128² (130). The guarded paths launch what their unguarded twins
# launch: a served volume K1 4, K3a 2, K3b 1 (EVAL_STEP_LAUNCHES); a GAN step
# TRAIN_STEP_LAUNCHES; a FINE_TUNE step the stage's; a step on (1, 2) its
# sharded_launches.
WGUARD_VAR = "UNET_BSSFP_WGUARD"
WGUARD_CONVS = ((24, 32), (32, 32), (96, 32))  # conv_0.conv_0, *.conv_1, upcat_1.conv_0
WGUARD_MESH = (1, 2)
WGUARD_TIMED = dict(warmup=2, timed=5)


@contextlib.contextmanager
def wguard_env(on: bool):
    """``UNET_BSSFP_WGUARD`` set to "1" (``on``) or unset inside, and put back
    as it was after, also when the body raises."""
    before = os.environ.get(WGUARD_VAR)
    if on:
        os.environ[WGUARD_VAR] = "1"
    else:
        os.environ.pop(WGUARD_VAR, None)
    try:
        yield
    finally:
        if before is None:
            os.environ.pop(WGUARD_VAR, None)
        else:
            os.environ[WGUARD_VAR] = before


def check_k2w(torch, K, checks, b, d, h, w, g, cin, cout, loop=False):
    """K2W, the guarded conv's weight gradient as its backward runs it: x
    and dy (B, D, ·, H·(W+g)), guard columns zero, stripped to W and K2 at W
    (``K.strip_guards`` then ``K.conv3x3_wgrad``), against the plain weight
    gradient of the guarded conv on the whole rows, under K2's bound at the
    launch's chain; a rerun bit for bit; one ``conv3x3_wgrad`` launch and no
    routed one. Timed (the strips included) beside its bound, the plain
    version, ``convolution_backward``'s dW and K2 on the unguarded tensors.
    ``loop``: also the ``mma.sync`` loop K2 took at the guarded width before
    (``conv3x3_wgrad_mma`` at W+g), held to its own chain's bound, timed."""
    dt = torch.bfloat16
    wd = w + g
    gen = torch.Generator(device="cuda").manual_seed(cin * 13 + d)
    xk = K.guard_mask(torch.randn(b, d, cin, h * wd, device="cuda", generator=gen).to(dt),
                      wd, g).contiguous()
    dy = K.guard_mask(torch.randn(b, d, cout, h * wd, device="cuda", generator=gen).to(dt),
                      wd, g).contiguous()
    xs, dys = K.strip_guards(xk, wd, g), K.strip_guards(dy, wd, g)

    def route():
        return K.conv3x3_wgrad(K.strip_guards(xk, wd, g), K.strip_guards(dy, wd, g), w)

    before = K.launches()
    got = route()
    after = K.launches()
    one = (after["conv3x3_wgrad"] - before["conv3x3_wgrad"] == 1
           and after["conv3x3_wgrad_mma_routed"] == before["conv3x3_wgrad_mma_routed"])
    ref = K.conv3x3_wgrad_plain(xk, dy, wd)
    scale = float(ref.abs().max())
    chain = K.conv3x3_wgrad_chain(xs, dys, w)
    atol = 16 * math.sqrt(chain) * 2 ** -24 * scale
    err = float((got - ref).abs().max())
    repeats = bool(torch.equal(got, route()))
    info = {}
    iters = 5
    if loop:
        lp = K.conv3x3_wgrad_mma(xk, dy, wd)
        loop_chain = K.conv3x3_wgrad_mma_chain(xk, dy, wd)
        info = {"loop_max_abs_err": float((lp - ref).abs().max()),
                "loop_atol": 16 * math.sqrt(loop_chain) * 2 ** -24 * scale,
                "loop_ms": time_ms(torch, lambda: K.conv3x3_wgrad_mma(xk, dy, wd), iters)}
        del lp
    xn = xs.reshape(b, d, cin, h, w).permute(0, 2, 1, 3, 4).contiguous()
    dyn = dys.reshape(b, d, cout, h, w).permute(0, 2, 1, 3, 4).contiguous()
    wn = torch.zeros(cout, cin, 3, 3, 3, device="cuda", dtype=dt)
    lib = lambda: torch.ops.aten.convolution_backward(  # noqa: E731
        dyn, xn, wn, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False, [0, 0, 0], 1,
        [False, True, False])
    nbytes = (xk.numel() + dy.numel()) * xk.element_size() + 27 * cin * cout * 4
    bms, by = bound(nbytes, 2 * 27 * cin * cout * b * d * h * w, "bfloat16")
    ok = (err <= atol and repeats and one
          and info.get("loop_max_abs_err", 0.0) <= info.get("loop_atol", 0.0))
    checks.record(ok, dict(
        kernel="conv3x3_wgrad", route="k2w_strip", shape=list(xk.shape), cout=cout,
        wguard=g, dtype="bfloat16", max_abs_err=err, ref_max_abs=scale, rtol=0.0, atol=atol,
        chain=chain, bit_identical_rerun=repeats, one_launch_not_routed=one,
        ms=time_ms(torch, route, iters),
        plain_ms=time_ms(torch, lambda: K.conv3x3_wgrad_plain(xk, dy, wd), iters),
        bound_ms=bms, bound_by=by, library_ms=time_ms(torch, lib, iters),
        unguarded_ms=time_ms(torch, lambda: K.conv3x3_wgrad(xs, dys, w), iters), **info))


def phase_wguard(torch, F, K, checks, pkg):
    """Phase 18: the wguard layout on every path the packed layout runs (see
    the docstring), ``UNET_BSSFP_WGUARD=1`` set for its duration only.
    Returns the guarded paths' launch counts and the records."""
    (Config, build_models, make_predict_fn, weights, predict_volume, create_gan_state,
     make_train_step, ms, TrainingState, mesh_pkg, losses, guard_cols) = pkg
    make_mesh, shard_batch, gather_batch = mesh_pkg
    b, p = TRAIN_BATCH, TRAIN_PATCH
    with wguard_env(True):
        g64, g128 = guard_cols(p, p), guard_cols(VOLUME[1], VOLUME[2])
    paths, out = {}, {"guard_cols": {"64": g64, "128": g128}}

    # 1. K1W and its dgrad at every guarded shape of the paths below (their
    # first launches at N 64, 96, 24 and on N-72 tiles), K2W at the GAN
    # step's, the loop it replaces beside the heaviest
    for cin, cout in WGUARD_CONVS + MULTISTAGE_CONVS:
        check_conv(torch, F, K, checks, b, p, p, p + g64, cin, cout, "bfloat16",
                   wguard=g64, rerun=True)
        check_dgrad(torch, K, checks, b, p, p, p + g64, cin, cout, "bfloat16",
                    wguard=g64, rerun=True)
    for cin, cout in WGUARD_CONVS:
        check_conv(torch, F, K, checks, 1, VOLUME[0], VOLUME[1], VOLUME[2] + g128, cin, cout,
                   "bfloat16", wguard=g128, rerun=True)
        check_k2w(torch, K, checks, b, p, p, p, g64, cin, cout, loop=cin == 96)
    # N 96 on two data tiles a row: a span a row in the guarded epilogue
    check_dgrad(torch, K, checks, 1, VOLUME[0], VOLUME[1], VOLUME[2] + g128, 96, 32,
                "bfloat16", wguard=g128, rerun=True)
    torch.cuda.empty_cache()

    # 2. serving one volume, patch-stitched and whole, guarded and not, with
    # the counts reset before each guarded run
    cfg = Config()
    mcfg, tcfg = cfg.model, cfg.train
    probe, _ = build_models(MODALITY, mcfg, "cuda")
    sd = weights.random_state_dict(probe, SEED)
    del probe

    def model(**over):
        gen, _ = build_models(MODALITY, dataclasses.replace(mcfg, **over), "cuda",
                              state_dict=sd)
        return make_predict_fn(gen)

    vol = torch.randn(VOLUME + (24,), generator=torch.Generator().manual_seed(SEED)).to("cuda")
    fn = model()
    outs, ts = {}, {}
    for mode in ("patch", "whole"):
        for on in (True, False):
            with wguard_env(on):
                run_volume(torch, predict_volume, fn, vol, mode == "whole")  # warm-up
                K.reset_launches()
                outs[(mode, on)] = run_volume(torch, predict_volume, fn, vol, mode == "whole")
                counts = K.launches()
            ts[(mode, on)] = []
            if on:
                paths[f"wguard_serving_{mode}"] = counts
                checks.record(counts == EVAL_STEP_LAUNCHES,
                              dict(phase="wguard_serving_launches", mode=mode, launches=counts,
                                   expected=EVAL_STEP_LAUNCHES))
    for _ in range(5):  # in turns, guarded beside unguarded
        for mode, on in ts:
            with wguard_env(on):
                t0 = time.perf_counter()
                run_volume(torch, predict_volume, fn, vol, mode == "whole")
                ts[(mode, on)].append((time.perf_counter() - t0) * 1e3)
    del fn
    f32_kern, f32_plain = model(compute_dtype="float32"), model(compute_dtype="float32",
                                                                packed=False)
    serving = {}
    for mode in ("patch", "whole"):
        with wguard_env(True):
            got = run_volume(torch, predict_volume, f32_kern, vol, mode == "whole").float()
        ref = run_volume(torch, predict_volume, f32_plain, vol, mode == "whole").float()
        scale = float(ref.abs().max())
        rel = float((got - ref).abs().max()) / scale
        dist = {on: float((outs[(mode, on)].float() - ref).abs().max()) / scale
                for on in (True, False)}
        row = {"f32_vs_plain": rel, "bf16_vs_f32": dist[True],
               "unguarded_bf16_vs_f32": dist[False],
               "bf16_vs_unguarded_bf16": float((outs[(mode, True)].float()
                                                - outs[(mode, False)].float()).abs().max()) / scale,
               "ms_per_volume_median": statistics.median(ts[(mode, True)]),
               "ms_all": ts[(mode, True)],
               "unguarded_ms_per_volume_median": statistics.median(ts[(mode, False)]),
               "unguarded_ms_all": ts[(mode, False)]}
        serving[mode] = row
        print(f"wguard serving {mode}: {row['ms_per_volume_median']:.3f} ms a volume against "
              f"{row['unguarded_ms_per_volume_median']:.3f} unguarded (bf16, median of 5 in "
              f"turns); f32 vs cuDNN {rel:.2e}; bf16 vs f32 {dist[True]:.2e} (unguarded "
              f"{dist[False]:.2e})", flush=True)
        checks.record(rel <= 1e-3 and dist[True] <= 3 * dist[False] + 2 ** -8
                      and bool(torch.isfinite(got).all()) and tuple(got.shape) == VOLUME + (6,),
                      dict(phase="wguard_serving_outputs", mode=mode, **row))
    out["serving"] = serving
    del f32_kern, f32_plain, outs, vol, got, ref
    torch.cuda.empty_cache()

    # 3. the GAN step (the default config): its launches, ms and peak MiB
    # guarded beside unguarded on one state; then the f32 backward check
    gx = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.rand((b,) + (p,) * 3 + (24,), device="cuda", generator=gx)
    y = torch.rand((b,) + (p,) * 3 + (6,), device="cuda", generator=gx)

    def launches_and_times(path, step, state, want, what):
        with wguard_env(True):
            step(state, x, y)  # warm-up
            torch.cuda.synchronize()
            K.reset_launches()
            m = step(state, x, y)
            torch.cuda.synchronize()
            counts = K.launches()
        paths[path] = counts
        timing = {}
        for on in (True, False):
            with wguard_env(on):
                t, peak, metrics = time_steps(torch, step, state, x, y, **WGUARD_TIMED)
            timing["guarded" if on else "unguarded"] = {
                "ms_per_step_median": statistics.median(t), "ms_all": t, "peak_mib": peak}
        finite = all(math.isfinite(float(v)) for v in m.values())
        print(f"wguard {what} (bf16, 8 × 64³): {timing['guarded']['ms_per_step_median']:.3f} "
              f"ms, peak {timing['guarded']['peak_mib']:.0f} MiB, against "
              f"{timing['unguarded']['ms_per_step_median']:.3f} ms, "
              f"{timing['unguarded']['peak_mib']:.0f} MiB unguarded (median of 5 after 2); "
              f"launches exact {counts == want}", flush=True)
        checks.record(counts == want and finite,
                      dict(phase=f"wguard_{what}", launches=counts, expected=want,
                           finite=finite, timing=timing))
        return timing

    state = create_gan_state(SEED, MODALITY, mcfg, tcfg, "cuda")
    step = make_train_step(state.gen, state.disc, tcfg)
    out["train_step"] = launches_and_times("wguard_train_step", step, state,
                                           TRAIN_STEP_LAUNCHES, "train_step")
    del state, step
    torch.cuda.empty_cache()
    with wguard_env(True):
        phase_train_grad_check(torch, checks, (Config, build_models, weights, losses),
                               phase="wguard_train_f32_grad_check")
    torch.cuda.empty_cache()

    # 4. one FINE_TUNE supervised step at the thesis widths (PReLU)
    net = ms.build_multi_input_unet(MODALITY, mcfg, "cuda")
    st = ms.create_supervised_state(SEED, net, tcfg, TrainingState.FINE_TUNE)
    out["finetune_step"] = launches_and_times(
        "wguard_finetune_step", ms.make_supervised_train_step(net, tcfg), st,
        MULTISTAGE_STAGE_LAUNCHES["finetune"], "finetune_step")
    del net, st
    torch.cuda.empty_cache()

    # 5. one GAN step on (1, 2), dropout 0: in f32 against the unguarded
    # unsharded step from the same weights and batch (phase 16's bounds);
    # in bf16 its launches
    mesh = make_mesh(["cuda:0"], ("data", "space"), WGUARD_MESH)
    f32 = {}
    for sharded in (False, True):
        with wguard_env(sharded):
            st = create_gan_state(SEED, MODALITY, dataclasses.replace(
                mcfg, dropout=0.0, compute_dtype="float32"), tcfg, "cuda",
                mesh=mesh if sharded else None)
            m = make_train_step(st.gen, st.disc, tcfg, mesh=mesh if sharded else None)(st, x, y)
            f32[sharded] = ({k: float(v) for k, v in m.items()},
                            {n: q.grad.detach().clone() for n, q in st.gen.named_parameters()})
        del st
    torch.cuda.empty_cache()
    loss_rel, worst, bad = f32_step_failures(*f32[False], *f32[True])
    del f32
    with wguard_env(True):
        st = create_gan_state(SEED, MODALITY, dataclasses.replace(mcfg, dropout=0.0), tcfg,
                              "cuda", mesh=mesh)
        step = make_train_step(st.gen, st.disc, tcfg, mesh=mesh)
        torch.cuda.synchronize()
        K.reset_launches()
        m = step(st, x, y)
        torch.cuda.synchronize()
        counts = K.launches()
    del st, step
    want = sharded_launches(WGUARD_MESH)
    paths["wguard_sharded_step"] = counts
    finite = all(math.isfinite(float(v)) for v in m.values())
    out["sharded_step"] = {"f32_loss_rel_err": loss_rel, "f32_worst_leaf": worst,
                           "failures": bad}
    print(f"wguard sharded step {WGUARD_MESH}: f32 vs unguarded unsharded losses "
          f"{json.dumps(loss_rel)}; worst leaf {worst}; failures {bad}; bf16 launches exact "
          f"{counts == want}", flush=True)
    checks.record(not bad and counts == want and finite,
                  dict(phase="wguard_sharded_step", mesh=list(WGUARD_MESH), launches=counts,
                       expected=want, finite=finite, **out["sharded_step"]))
    del x, y
    torch.cuda.empty_cache()
    return paths, out


# Phase 19: the quality path, the three quality scripts' functions in
# process at full width on cohorts cut in size only. The A/B's target
# cohort: 3 subjects at (96, 128, 128), seed 1, link_tag_offset 10 (a 2/1/0
# split at the scripts' val and test splits of 0.2), written by a child
# process while phases 15-17 run; its pretrain cohort is phase 12's tree
# (3/1/0). Each arm 1 epoch a stage (the direct arm 3) at 8 patches a volume
# (cut from 32). The oracle's map within ORACLE_MAP_TOL of the fixture's
# numpy map (outputs in [0, 1], 24-term f32 sums), its clean pass's sums
# within ORACLE_CPU_RTOL of the CPU's on the same batches. The judged
# summary from phase 13's best step on phase 12's tree without its
# denormalised second table (it runs the chain once more: the full run
# takes it), so K1 4, K3a 2, K3b 1 and K8 2 per test volume, as phase 14.
QUALITY_TARGET_SUBJECTS = ("01", "02", "03")
QUALITY_EPOCHS = {"pretrain": 1, "transfer": 1, "finetune": 1}
QUALITY_SPV = 8
ORACLE_MAP_TOL = 1e-5
ORACLE_CPU_RTOL = 1e-4


def start_quality_tree(root: Path) -> subprocess.Popen:
    """Phase 19's target cohort, written by a child process (the native
    codec and numpy in a process of their own, off this one's GIL)."""
    shutil.rmtree(root, ignore_errors=True)
    code = ("import time; t0 = time.perf_counter()\n"
            "from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids\n"
            f"make_synthetic_bids({str(root)!r}, subjects={QUALITY_TARGET_SUBJECTS!r}, "
            f"sessions=('1',), volume_shape={VOLUME!r}, seed=1, linked=True, "
            "link_tag_offset=10)\n"
            "print(time.perf_counter() - t0)\n")
    return subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def stop_process(proc) -> None:
    if proc is not None and proc.poll() is None:
        proc.kill()
        proc.communicate()


def phase_quality(torch, K, checks, tree: str, target: str, tree_proc, best: str, work: Path):
    """Phase 19: the A/B's two arms, the oracle and the judged summary (see
    the docstring). Returns the launches of its three paths and the records."""
    import argparse

    import numpy as np

    from scripts import torch_port_multistage_bench as msb
    from scripts import torch_port_oracle_ceiling as oc
    from scripts import torch_port_quality_record as qr
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule
    from unet_bssfp_tpu_torch.data.synthetic import _linked_map

    out = {}
    t0 = time.perf_counter()
    stdout, stderr = tree_proc.communicate()
    if tree_proc.returncode != 0:
        raise RuntimeError(f"phase 19's target cohort was not written: {stderr[-2000:]}")
    out["target_tree"] = {"subjects": len(QUALITY_TARGET_SUBJECTS), "write_s": float(stdout),
                          "waited_s": time.perf_counter() - t0}
    device = qr.device_label("cuda")

    # 1. the A/B: the multistage arm, then the direct arm, the counts reset
    # before each
    args = argparse.Namespace(**QUALITY_EPOCHS, samples_per_vol=QUALITY_SPV, modality=MODALITY,
                              two_cohort=True, smoke=False, no_record=True, device="cuda")
    cfg, data, pre = msb.build(args, pretrain_bids=tree, target_bids=target,
                               workdir=str(work / "ab"))
    data.setup()
    pre.setup()

    def steps(dm, split):
        n = len(getattr(dm, f"{split}_samples")) * cfg.data.samples_per_vol
        return -(-n // cfg.data.batch_size)

    torch.cuda.synchronize()
    K.reset_launches()
    states, ms_row, ms_wall = msb.run_multistage_arm(args, cfg, data, pre, "cuda")
    ms_counts = K.launches()
    ms_expected, ms_steps = dict.fromkeys(ms_counts, 0), {}
    for stage, st in states.items():
        dm = pre if stage.value == "pretrain" else data
        epochs = QUALITY_EPOCHS[stage.value]
        ms_steps[stage.value] = {"train": st.step, "expected_train": epochs * steps(dm, "train"),
                                 "val": epochs * steps(dm, "val")}
        for k, v in MULTISTAGE_STAGE_LAUNCHES[stage.value].items():
            ms_expected[k] += st.step * v
        for k, v in EVAL_STEP_LAUNCHES.items():
            ms_expected[k] += epochs * steps(dm, "val") * v
    del states
    torch.cuda.empty_cache()
    K.reset_launches()
    t1 = time.perf_counter()
    direct_row = msb.run_direct(args, cfg, data, MODALITY, "cuda")
    torch.cuda.synchronize()
    direct_wall = time.perf_counter() - t1
    d_counts = K.launches()
    n_epochs = sum(QUALITY_EPOCHS.values())
    d_expected = {k: n_epochs * (steps(data, "train") * MULTISTAGE_STEP_LAUNCHES.get(k, 0)
                                 + steps(data, "val") * EVAL_STEP_LAUNCHES.get(k, 0))
                  for k in d_counts}
    ms_entry, direct_entry = msb.ab_entries(args, device, ms_row, ms_wall, direct_row,
                                            direct_wall)
    shared = msb.COMMON_KEYS + msb.TWO_COHORT_KEYS
    metric_keys = ("val_psnr_last", "val_ssim_last", "val_l1_last")
    for name, entry, own, counts, want in (
            ("quality_ab_multistage", ms_entry, msb.MULTISTAGE_KEYS, ms_counts, ms_expected),
            ("quality_ab_direct", direct_entry, msb.DIRECT_KEYS, d_counts, d_expected)):
        keys_ok = set(entry) == set(shared + own)
        finite = all(math.isfinite(entry[k]) for k in metric_keys + (
            ("multistage_minus_direct_psnr",) if own is msb.MULTISTAGE_KEYS else ()))
        steps_ok = all(s["train"] == s["expected_train"] for s in ms_steps.values())
        out[name] = {"launches": counts, "expected": want, "entry": entry, "keys_ok": keys_ok,
                     "finite": finite}
        checks.record(counts == want and keys_ok and finite and steps_ok,
                      dict(phase=name, **out[name],
                           **({"steps": ms_steps} if own is msb.MULTISTAGE_KEYS else {})))
    print(f"quality A/B (full width, cohorts {len(pre.train_samples)}/{len(pre.val_samples)} and "
          f"{len(data.train_samples)}/{len(data.val_samples)} subjects, 1/1/1 epochs, "
          f"{QUALITY_SPV} patches a volume): multistage {ms_wall:.1f} s, direct "
          f"{direct_wall:.1f} s, multistage - direct "
          f"{ms_entry.get('multistage_minus_direct_psnr')} dB; launches exact "
          f"{ms_counts == ms_expected} / {d_counts == d_expected}", flush=True)

    # 2. the oracle on phase 12's tree: measure on the card (1 augmented pass
    # and the clean one), the map against the fixture's numpy map, the clean
    # pass's sums against the CPU's on the same batches
    qcfg = qr.build_config(argparse.Namespace(smoke=False, samples_per_vol=QUALITY_SPV,
                                              workdir=str(work / "oracle"), max_epochs=1), tree)
    odm = DoveDataModule(tree, config=qcfg.data)
    odm.setup()
    t1 = time.perf_counter()
    res = oc.measure(odm, MODALITY, 1, device="cuda")
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t1
    fn = oc.make_linked_map_fn(6, tag=1)
    batch = next(iter(odm.val_batches(1000, keys=(MODALITY, "dwi-tensor"), augment=False,
                                      device="cuda")))
    x = batch[MODALITY]
    map_err = float(np.abs(fn(x).cpu().numpy() - _linked_map(x.cpu().numpy(), 6, 1)).max())
    del batch, x
    card = oc.oracle_pass(odm, MODALITY, 1000, False, fn, "cuda")["oracle"]
    host = oc.oracle_pass(odm, MODALITY, 1000, False, fn, "cpu")["oracle"]
    rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(card[:3], host[:3]))
    finite = all(math.isfinite(v) for r in res.values() for v in r.values())
    out["oracle"] = {"measure": res, "seconds": oracle_s, "map_max_abs_err": map_err,
                     "map_tol": ORACLE_MAP_TOL, "clean_sums_card": card, "clean_sums_cpu": host,
                     "clean_max_rel_diff": rel, "clean_rtol": ORACLE_CPU_RTOL}
    print(f"oracle on phase 12's tree ({res['oracle_clean']['n_patches']} clean patches): "
          f"{json.dumps(res)}; {oracle_s:.2f} s; map vs numpy {map_err:.2e}; clean pass card vs "
          f"CPU {rel:.2e}", flush=True)
    checks.record(map_err <= ORACLE_MAP_TOL and rel <= ORACLE_CPU_RTOL and card[3] == host[3]
                  and finite, dict(phase="quality_oracle", **out["oracle"]))

    # 3. the judged summary from phase 13's best step, the counts reset
    # before it
    with open(os.path.join(os.path.dirname(best), "config.json")) as f:
        jcfg = Config.from_json(f.read())
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, data_dir=tree))
    jdm = DoveDataModule(tree, config=jcfg.data)
    jdm.prepare_data()
    n_test = len(jdm.test_samples)
    jargs = argparse.Namespace(workdir=str(work / "judged"), modality=MODALITY, smoke=False,
                               skip_eval=False, device="cuda")
    torch.cuda.synchronize()
    K.reset_launches()
    t1 = time.perf_counter()
    judged = qr.judged_artifact(jargs, jcfg, jdm, best, str(work / "quality"), denorm=False)
    torch.cuda.synchronize()
    judged_s = time.perf_counter() - t1
    j_counts = K.launches()
    j_expected = dict(dict.fromkeys(j_counts, 0), conv3x3_packed=4 * n_test, pack_hw=2 * n_test,
                      unpack_hw=n_test, scalar_maps=2 * n_test, packed_norm_act=4 * n_test)
    with open(work / "quality" / "relative_errors.csv") as f:
        table_rows = len(f.read().splitlines()) - 1
    finite = (all(math.isfinite(v) for v in judged["test_metrics"].values())
              and math.isfinite(judged["diag_median_rel_err"]))
    keys_ok = tuple(judged) == qr.SUMMARY_KEYS
    out["judged"] = {"launches": j_counts, "expected": j_expected, "test_volumes": n_test,
                     "seconds": judged_s, "table_rows": table_rows, "keys_ok": keys_ok,
                     "summary": judged}
    print(f"judged summary ({n_test} test volume(s)): {judged_s:.1f} s; test metrics "
          f"{json.dumps(judged['test_metrics'])}; diag median {judged['diag_median_rel_err']}; "
          f"{table_rows} table rows; launches exact {j_counts == j_expected}", flush=True)
    checks.record(j_counts == j_expected and keys_ok and finite and table_rows > 0,
                  dict(phase="quality_judged", **out["judged"]))
    torch.cuda.empty_cache()
    return {"quality_ab_multistage": ms_counts, "quality_ab_direct": d_counts,
            "quality_judged": j_counts}, out


def summary(rows, by_path):
    """``by_path``: each main path's launch counts, read from its own run
    with the counters reset just before it (the serving run, one training
    step, the eval chain, the mesh serving run, the sharded block backward,
    the two probe paths).
    ``launches`` is their sum; ``launches_by_path`` keeps them apart."""
    out = []
    for name, (route, source, replaces) in KERNEL_META.items():
        shape, cout, dtype = SUMMARY_SHAPE[name]
        row = next(r for r in rows if r.get("kernel") == name
                   and r["dtype"] == dtype and r["shape"] == shape
                   and r.get("cout") == cout)
        extra = {}
        if source.endswith("conv3x3_wgmma.cu"):
            extra["header"] = WGMMA_HEADER
        if name in BUILT_IN:
            extra["built_in"] = BUILT_IN[name]
        out.append({"name": name, "route": route, "source": source, **extra,
                    "replaces": replaces,
                    "launches": sum(c[name] for c in by_path.values()),
                    "launches_by_path": {p: c[name] for p, c in by_path.items()},
                    "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                    **({"device_ms": row["device_ms"]} if "device_ms" in row else {}),
                    "shape": row["shape"], "dtype": row["dtype"]})
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from unet_bssfp_tpu_torch import model, native, weights
    from unet_bssfp_tpu_torch.config import Config
    from unet_bssfp_tpu_torch.data import augment, nifti
    from unet_bssfp_tpu_torch.data.datamodule import DoveDataModule, sample_generator
    from unet_bssfp_tpu_torch.data.sampler import extract_patches, uniform_patch_starts
    from unet_bssfp_tpu_torch.data.synthetic import make_synthetic_bids
    from unet_bssfp_tpu_torch.eval import evaluate, export
    from unet_bssfp_tpu_torch.eval.inference import predict_volume
    from unet_bssfp_tpu_torch.models.multi_input_unet import TrainingState
    from unet_bssfp_tpu_torch.models.packed_layers import PackedTwoConv, guard_cols
    from unet_bssfp_tpu_torch.ops import kernels as K
    from unet_bssfp_tpu_torch.ops import losses
    from unet_bssfp_tpu_torch.ops import scalar_maps_check as chk
    from unet_bssfp_tpu_torch.ops.kernels import _build
    from unet_bssfp_tpu_torch.ops.scalar_maps import (
        ScalarMaps,
        compute_scalar_maps,
        invert_dwi_tensor_norm,
        load_rescale_args,
    )
    from unet_bssfp_tpu_torch.parallel.mesh import (
        Mesh,
        gather_batch,
        make_mesh,
        replicas,
        shard_batch,
    )
    from unet_bssfp_tpu_torch.predict import main as predict_main
    from unet_bssfp_tpu_torch.train import checkpoint
    from unet_bssfp_tpu_torch.train import multistage
    from unet_bssfp_tpu_torch.train.loop import Trainer, train_model
    from unet_bssfp_tpu_torch.train.state import build_models, create_gan_state
    from unet_bssfp_tpu_torch.train.steps import make_eval_step, make_predict_fn, make_train_step
    from unet_bssfp_tpu_torch.utils import flops
    from scripts import torch_port_convergence, torch_port_pallas_probe, torch_port_pfold_probe

    t_start = time.perf_counter()
    clock = PhaseClock()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    checks = Checks()
    build = phase_build(torch, K, _build, native)
    clock.lap("1_build")
    phase_kernels(torch, F, K, checks)
    clock.lap("2_kernels")
    print(f"kernel checks done at {time.perf_counter() - t_start:.1f}s", flush=True)
    counts, timing = phase_main_path(
        torch, K, checks,
        (Config, build_models, make_predict_fn, weights, predict_volume))
    print(f"serving path done at {time.perf_counter() - t_start:.1f}s", flush=True)
    clock.lap("3_serving")
    phase_train_kernels(torch, K, checks)
    clock.lap("4_train_kernels")
    phase_halo_kernels(torch, F, K, checks)
    clock.lap("9_halo_kernels")
    print(f"training and halo kernel checks done at {time.perf_counter() - t_start:.1f}s",
          flush=True)
    train_counts, train_timing = phase_train(
        torch, K, checks, (Config, create_gan_state, make_train_step))
    phase_train_grad_check(torch, checks, (Config, build_models, weights, losses))
    print(f"training path done at {time.perf_counter() - t_start:.1f}s", flush=True)
    clock.lap("5_train")
    mesh_counts, mesh_timing = phase_mesh_serving(
        torch, K, checks,
        (Config, build_models, make_predict_fn, predict_volume, make_mesh), weights)
    block_counts = phase_mesh_block_backward(
        torch, K, checks, PackedTwoConv, (make_mesh, shard_batch, gather_batch))
    print(f"mesh path done at {time.perf_counter() - t_start:.1f}s", flush=True)
    clock.lap("10_mesh")
    phase_scalar_maps(torch, K, chk, checks, ScalarMaps._fields)
    clock.lap("6_scalar_maps")
    tree = Path("perf_out") / "smoke_tree"
    loop_work = Path("perf_out") / "loop_smoke"
    ms_work = Path("perf_out") / "multistage_smoke"
    sharded_work = Path("perf_out") / "sharded_smoke"
    surface_work = Path("perf_out") / "surface_smoke"
    quality_tree = Path("perf_out") / "quality_tree"
    quality_work = Path("perf_out") / "quality_smoke"
    quality_proc = None
    try:
        synth_s = make_tree(make_synthetic_bids, tree)
        print(f"synthetic tree ({len(DATA_SUBJECTS)} subjects at {VOLUME}, {nifti.codec()} "
              f"codec): {synth_s:.1f}s", flush=True)
        clock.lap("7_synthetic_tree")
        eval_counts, eval_timing = phase_eval(
            torch, K, checks,
            (Config, build_models, make_predict_fn, weights, predict_volume, nifti,
             evaluate, predict_main, compute_scalar_maps, invert_dwi_tensor_norm,
             load_rescale_args, chk), str(tree), synth_s)
        print(f"eval path done at {time.perf_counter() - t_start:.1f}s", flush=True)
        clock.lap("7_8_eval")
        phase_pfold_kernels(torch, F, K, checks)
        phase_probe_kernels(torch, F, K, checks)
        pf_counts, pa_counts, pf_rows, pa_rows = phase_probe_paths(
            torch, K, checks, torch_port_pfold_probe, torch_port_pallas_probe)
        print(f"pfold and probe kernels and paths done at {time.perf_counter() - t_start:.1f}s",
              flush=True)
        clock.lap("11_pfold_probe")
        data_counts, data_out = phase_data(
            torch, K, checks,
            (Config, DoveDataModule, augment, nifti, native,
             (sample_generator, uniform_patch_starts, extract_patches), create_gan_state,
             make_train_step), str(tree))
        print(f"data path done at {time.perf_counter() - t_start:.1f}s", flush=True)
        clock.lap("12_data")
        shutil.rmtree(loop_work, ignore_errors=True)
        loop_work.mkdir(parents=True)
        loop_counts, remat_counts, loop_out, loop_run = phase_loop(
            torch, K, checks,
            (Config, DoveDataModule, Trainer, train_model, checkpoint, create_gan_state,
             make_train_step, flops, torch_port_convergence), str(tree), loop_work)
        print(f"training loop done at {time.perf_counter() - t_start:.1f}s", flush=True)
        clock.lap("13_loop")
        ckpt_eval_counts, ckpt_predict_counts, perceptual_counts, ckpt_eval_out = \
            phase_eval_checkpoint(torch, K, checks, str(tree), loop_run, loop_work)
        loop_best = loop_run["best"]
        del loop_run
        print(f"evaluation from a checkpoint done at {time.perf_counter() - t_start:.1f}s",
              flush=True)
        clock.lap("14_eval_checkpoint")
        quality_proc = start_quality_tree(quality_tree)  # phase 19's, while 15-17 run
        shutil.rmtree(ms_work, ignore_errors=True)
        ms_work.mkdir(parents=True)
        ms_counts, ms_step_counts, ms_out = phase_multistage(
            torch, F, K, checks, (Config, DoveDataModule, multistage, weights, TrainingState),
            str(tree), ms_work)
        print(f"multi-stage regime done at {time.perf_counter() - t_start:.1f}s", flush=True)
        clock.lap("15_multistage")
        shutil.rmtree(sharded_work, ignore_errors=True)
        sharded_work.mkdir(parents=True)
        sharded_counts, sharded_out = phase_sharded(
            torch, K, checks,
            (Config, create_gan_state, make_train_step, make_eval_step,
             (make_mesh, shard_batch, gather_batch), Trainer, DoveDataModule, checkpoint,
             multistage, TrainingState), str(tree), sharded_work)
        print(f"sharded training done at {time.perf_counter() - t_start:.1f}s", flush=True)
        clock.lap("16_sharded")
        shutil.rmtree(surface_work, ignore_errors=True)
        surface_work.mkdir(parents=True)
        t_phase = time.perf_counter()
        surface_counts, surface_out = phase_surface(
            torch, K, checks,
            (Config, build_models, make_predict_fn, make_train_step, create_gan_state, weights,
             predict_volume, nifti, export, predict_main, model, TrainingState), str(tree),
            surface_work, loop_work / "relative_errors_checkpoint.csv",
            loop_work / "eval_checkpoint")
        surface_out["phase_s"] = time.perf_counter() - t_phase
        print(f"serving artifact and public surface done at "
              f"{time.perf_counter() - t_start:.1f}s (phase {surface_out['phase_s']:.1f}s)",
              flush=True)
        clock.lap("17_surface")
        shutil.rmtree(quality_work, ignore_errors=True)
        quality_work.mkdir(parents=True)
        quality_counts, quality_out = phase_quality(
            torch, K, checks, str(tree), str(quality_tree), quality_proc, loop_best,
            quality_work)
        print(f"quality path done at {time.perf_counter() - t_start:.1f}s", flush=True)
    finally:
        stop_process(quality_proc)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.rmtree(loop_work, ignore_errors=True)
        shutil.rmtree(ms_work, ignore_errors=True)
        shutil.rmtree(sharded_work, ignore_errors=True)
        shutil.rmtree(surface_work, ignore_errors=True)
        shutil.rmtree(quality_tree, ignore_errors=True)
        shutil.rmtree(quality_work, ignore_errors=True)
    clock.lap("19_quality")
    wguard_counts, wguard_out = phase_wguard(
        torch, F, K, checks,
        (Config, build_models, make_predict_fn, weights, predict_volume, create_gan_state,
         make_train_step, multistage, TrainingState, (make_mesh, shard_batch, gather_batch),
         losses, guard_cols))
    print(f"wguard layout done at {time.perf_counter() - t_start:.1f}s", flush=True)
    clock.lap("18_wguard")
    distinct_work = Path("perf_out") / "distinct_smoke"
    shutil.rmtree(distinct_work, ignore_errors=True)
    distinct_work.mkdir(parents=True)
    try:
        distinct_counts, distinct_out = phase_distinct(
            torch, K, checks,
            (Config, create_gan_state, make_train_step, (Mesh, make_mesh, replicas),
             checkpoint, multistage, TrainingState), distinct_work)
    finally:
        shutil.rmtree(distinct_work, ignore_errors=True)
    clock.lap("20_distinct")
    print(f"distinct devices done at {time.perf_counter() - t_start:.1f}s (phase "
          f"{clock.laps['20_distinct']:.1f}s on {card})", flush=True)
    mp_work = Path("perf_out") / "multiprocess_smoke"
    shutil.rmtree(mp_work, ignore_errors=True)
    mp_work.mkdir(parents=True)
    try:
        mp_counts, mp_out = phase_multiprocess(
            torch, K, checks, (Config, create_gan_state, make_train_step), card,
            mp_work.resolve())
    finally:
        shutil.rmtree(mp_work, ignore_errors=True)
    clock.lap("21_multiprocess")
    print(f"training across processes done at {time.perf_counter() - t_start:.1f}s (phase "
          f"{clock.laps['21_multiprocess']:.1f}s on {card})", flush=True)
    swin_counts, swin_out = phase_swin(torch, K, checks,
                                       (Config, create_gan_state, make_train_step))
    clock.lap("22_swin")
    print(f"swin step done at {time.perf_counter() - t_start:.1f}s", flush=True)
    elapsed = time.perf_counter() - t_start

    kernels = summary(checks.rows, {"serving": counts, "train_step": train_counts,
                                    "eval": eval_counts, "mesh_serving": mesh_counts,
                                    "mesh_block_backward": block_counts,
                                    "pfold_probe": pf_counts, "pallas_probe": pa_counts,
                                    "train_from_data": data_counts,
                                    "train_loop": loop_counts,
                                    "train_step_remat": remat_counts,
                                    "eval_from_checkpoint": ckpt_eval_counts,
                                    "predict_checkpoint": ckpt_predict_counts,
                                    "train_step_perceptual": perceptual_counts,
                                    "multistage_run": ms_counts,
                                    **{f"multistage_{s}_step": c
                                       for s, c in ms_step_counts.items()},
                                    **sharded_counts, **surface_counts, **wguard_counts,
                                    **quality_counts, **distinct_counts, **mp_counts,
                                    "swin_train_step": swin_counts})
    unlaunched = [k["name"] for k in kernels if k["launches"] == 0]
    checks.record(not unlaunched, dict(phase="every_kernel_launched_on_a_path",
                                       unlaunched=unlaunched))
    os.makedirs("perf_out", exist_ok=True)
    with open(os.path.join("perf_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__, "build": build,
                   "checks": checks.rows, "main_path_launches": counts,
                   "train_step_launches": train_counts, "eval_launches": eval_counts,
                   "mesh_serving_launches": mesh_counts,
                   "mesh_block_backward_launches": block_counts,
                   "mesh_timing": mesh_timing,
                   "pfold_probe": {"launches": pf_counts, "rows": pf_rows},
                   "pallas_probe": {"launches": pa_counts, "rows": pa_rows},
                   "timing": timing, "train_timing": train_timing,
                   "eval_timing": eval_timing,
                   "train_from_data_launches": data_counts, "data_path": data_out,
                   "train_loop_launches": loop_counts, "train_step_remat_launches": remat_counts,
                   "train_loop": loop_out,
                   "eval_from_checkpoint_launches": ckpt_eval_counts,
                   "predict_checkpoint_launches": ckpt_predict_counts,
                   "train_step_perceptual_launches": perceptual_counts,
                   "eval_from_checkpoint": ckpt_eval_out,
                   "multistage_run_launches": ms_counts,
                   "multistage_step_launches": ms_step_counts, "multistage": ms_out,
                   "sharded_launches": sharded_counts, "sharded": sharded_out,
                   "surface_launches": surface_counts, "surface": surface_out,
                   "wguard_launches": wguard_counts, "wguard": wguard_out,
                   "quality_launches": quality_counts, "quality": quality_out,
                   "distinct_launches": distinct_counts, "distinct": distinct_out,
                   "multiprocess_launches": mp_counts, "multiprocess": mp_out,
                   "swin_launches": swin_counts, "swin": swin_out,
                   "phase_seconds": clock.laps, "kernels": kernels, "elapsed_s": elapsed},
                  f, indent=1)
    if checks.failures:
        print(f"chip_smoke: {len(checks.failures)} check(s) failed:", file=sys.stderr)
        for row in checks.failures:
            print(json.dumps(row), file=sys.stderr)
        return 1
    print(f"elapsed {elapsed:.1f}s", flush=True)
    print(json.dumps({"phase": "seconds", "name": "sum", "s": sum(clock.laps.values())}),
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
