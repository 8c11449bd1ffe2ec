#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100: sm_90a).

    python3 chip_smoke.py

Drives the port's paths (graspbalance_tpu_torch) at full width on 20,000-point
synthetic scenes with weights from seeds: at bs=4 the GraspBalance eval
forward + pred_decode (the main path) and the serving pipeline
GraspInference without and with OBS (DSN + mean shift + object-balanced
re-seeding, grasp NMS, the voxel-downsampled collision filter); at bs=2 the
training step (label matching, multi-task loss, backward, Adam + OneCycle,
BatchNorm statistics); at bs=4 the fused eval configuration (every
set abstraction and local aggregation fused, the width head on the query's
gripper-frame coordinates) through forward + decode and both pipelines; the
table-gather probe; the training loop through its CLI, with a resume, an
eval pass and both label pipelines; the closed-loop quality gate; the DSN's
training at bs=4 and its gate; the inference CLI over a synthetic batch
and a GraspNet-1B-shaped dump; the other models; and data-parallel training
and the sharded DRP forward on ranks of the one card. Phases, each fatal on
failure:

  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from csrc/*.cu (one nvcc per source, all in
     parallel) and time the build;
  3. with TF32 off, compare the main path's kernels with their plain PyTorch
     versions at its shapes: FPS indices exact, query indices and rotated
     coordinates bit-equal in both modes, width MLP (3xTF32 on the tensor
     cores) within 1e-4; time each, FPS also without its distance work (the
     latency floor of its step chain), the query in both modes (indices
     only, and with the gripper-frame coordinates);
  4. run the forward + decode through the kernels, check that every kernel
     of that path was launched, run it again through the plain versions,
     and compare the valid masks (exact) and the decoded grasps (equal
     within 1e-4 wherever no decode argmax is a near tie); check every
     output is finite;
  5. time the main path (clouds/s, p50 ms/scene and the spread of the
     calls);
  6. compare the serving path's kernels with their plain versions at its
     shapes: kNN on the DSN's (4, 2048) and (4, 1024) seed clouds (indices
     exact, distances within 1e-6; the share of the warp-select's rounds in
     which a candidate passed the threshold, insertions per query, device
     ms per launch), the masked FPS on OBS's compacted slots of the scenes'
     own objects (exact over the first max_needed slots, two launches
     bit-equal; device ms per call, also at max_needed=1 and on rows whose
     only valid point is the first, and from them its time per step and the
     floor of its step chain), OBS at
     num_seed=32 on a 6- and a 7-object scene, where the sparsest scene's
     quota is not the largest (seeds exact), the collision counts of phase
     4's grasps against the voxel-downsampled scenes (exact; first the
     shares of (32-grasp group, 32-point tile) and of (grasp, tile) pairs
     that the cull removes, counted by its plain twin, then the kernel's own
     count; K10's bound counts the pairs the cull keeps, printed beside the
     bound of every pair; device kernels and device ms per call); K4 printed
     beside its time before its redesign;
  7. run GraspInference without and with OBS through the kernels (every
     kernel of each path launched; all six on the OBS path) and through the
     plain versions: segment labels and OBS seeds exact, decoded grasps as
     in phase 4, the same keep masks from the kernel and the plain
     postprocess on identical grasps, every output finite;
  8. time both pipelines (clouds/s, p50 ms/scene), with the program's spans
     on (``trace.py``, device events) over the timed calls: each stage's
     device ms, share and host ms, the NMS sweeps, host reads and waits a
     call from its counters; then trace 3 calls of each
     with torch.profiler: kernels, device ms and wall ms per call, the
     card's busy share and the largest kernels, one JSON line per pipeline;
  9. the training step, bs=2, full-width make_batch scenes (300 views, 4,096
     label points): the scatter-add kernel (the gathers' backward) against
     its plain version at every gather shape of the step, captured from the
     step itself (integer cotangents exactly, float ones within the
     worst-case bound of f32 recursive summation of the float64 sums, two
     launches bit-equal), timed per shape beside its plain version and
     index_add_, with its device time split by pass (torch.profiler);
     one step through the kernels and one through the plain versions (FPS,
     the cylinder query and, swapped in for the kernel's wrapper, the
     scatter-add) from the same state (fps, multicyl and scatter launched,
     widthmlp not; the
     losses within 1e-5 relative, every gradient within GRAD_TOL of its
     tensor's largest |grad|, every metric finite); then TRAIN_STEPS more
     steps through the kernels: each step's loss, ms per step (median and
     spread), clouds/s, a forward / backward / optimizer split from CUDA
     events and the peak device memory, and a torch.profiler pass over two
     more steps (its JSON line as phase 8's); the step's BatchNorm calls by
     the program's counters (every one ``bn.fused``, none ``bn.plain``);
     then the fused train-mode BatchNorm + ReLU (csrc/batchnorm.cu) at
     BN_SHAPES: the forward bit-equal to the plain version's, dx, dweight
     and dbias within 1e-4 of their largest |value| of float64 on the
     kernel's own ReLU mask, two launches bit-equal; the forward, its
     statistics (PyTorch's reductions), the backward and forward +
     backward timed beside the bounds from bytes (the kernels' 7 passes;
     the op's 8, statistics in one), the plain version and
     F.batch_norm + relu;
 10. the fused configuration's kernels against their plain versions at its
     shapes, on the same weights as the default model: the mlp-max kernel
     at each of the 19 calls of one fused forward, captured from it (within
     1e-4 abs + rel, two launches bit-equal), timed per call beside the
     call's bound (3xTF32 on the tensor cores) and, summed over the forward,
     beside its bound with every operation in FP32; the width MLP on the cylinder
     query's gripper-frame coordinates of that forward's seeds and top-view
     rotations (within 1e-4); the class-plane selection on the same seeds
     (indices exact against its plain version and against the cylinder
     query's kernel, two launches bit-equal; device ms per call; its time
     before its redesign and its bound before it beside the new ones), and
     once through multi_cylinder_query(impl="select");
 11. the fused forward + decode through the kernels (mlpmax 19 launches,
     widthmlp_rel 1, widthmlp 0), against its plain run and against the
     default configuration's output, both as in phase 4 (a seed whose top
     view or objectness is a near tie between the two may differ);
 12. GraspInference without and with OBS on the fused model, as phase 7;
 13. the default and the fused forward + decode timed in alternating
     rounds (clouds/s and p50 ms/scene of each), then a torch.profiler pass
     (as phase 8's) over 3 calls of each and of the two layers they differ
     in, the backbone after FPS and the width head;
 14. the table gather on the probe's four cases and on dim 0 (65,536, 128)
     (exact against its plain version and torch.gather), timed beside both
     (CUDA events, and device time per launch from torch.profiler);
 15. the training loop at bs=2 on full-width make_batch scenes with the
     static labels: cli/train.main for 2 epochs x LOOP_STEPS steps (fps,
     multicyl and scatter launched, widthmlp not; one train metric line an
     epoch, the checkpoints of both epochs, best.json at the lower epoch
     loss, config.json the CLI's config; its ms/step in epoch 2 beside
     phase 9's median, the share spent waiting on the prefetch queue, the
     uploads by key and bytes a step, the checkpoint's save ms and size);
     the same run stopped after epoch 1 by loop.train and resumed with an
     eval stream of LOOP_EVAL_BATCHES batches (fps and multicyl launched
     once a forward, widthmlp once an eval step, scatter as many times a
     step as in the CLI run; its final parameters and BatchNorm statistics
     bit-equal to the CLI run's last checkpoint); the eval step through
     the kernels against the plain versions on that state (every metric
     within LOSS_RTOL); the loop against the bare step in LOOP_ALT_ROUNDS
     alternating rounds (one loop epoch resumed, then the same batches,
     uploaded beforehand, through train_step back to back; ms/step of each
     and their ratio); --synthetic_analytic for LOOP_ANALYTIC_STEPS steps
     and the card's label expansion against the host's numpy tensors
     (equal except where a width lies within an ulp of GRASP_MAX_WIDTH,
     counted); the peak memory of one training step at bs=2 and 4, and at
     bs=8 when the extrapolation from bs=2 and 4 stays under PEAK_LIMIT_GB;
 16. the closed-loop quality gate (cli/quality_gate.py) at full width: the
     oracle (rule-made grasps through NMS and the collision filter) on the
     gate's GATE_EVAL_BATCHES x BATCH held-out 20,000-point scenes through
     the collision kernel (collision launched) against its plain version
     (keep masks exact, metrics equal) and within ORACLE_TOL of the JAX
     package's oracle on those seeds in quality and AP; the training step in
     bfloat16 (bs=2, the phase 9 scenes): one step through the kernels
     against one through the plain versions from the same state (fps,
     multicyl, scatter launched, widthmlp not; the losses within
     BF16_LOSS_RTOL, every gradient's cosine >= BF16_GRAD_COS, parameters,
     BatchNorm statistics and Adam's moments float32), its loss beside the
     float32 step's from the same state, the bfloat16 loss with cuBLAS's
     reduced-precision reduction on and off, then TRAIN_STEPS steps of each
     dtype alternating (ms/step by host clock, a forward / backward /
     optimizer split from CUDA events, the peak device memory of each, and
     a torch.profiler pass over two steps of each, as phase 9's); and
     run_gate for GATE_STEPS steps in bfloat16 at BATCH (fps, multicyl,
     scatter, widthmlp and collision launched; untrained against trained
     metrics, every one finite; no quality threshold at that length);
 17. DSN training at full width (train/seg_step.py: the default stage
     table, bs=BATCH, the DSN gate's 20,000-point scenes): one step through
     the kernels against one through the plain versions from the same state
     (fps, knn and scatter launched; the losses within LOSS_RTOL, every
     gradient's cosine >= DSN_GRAD_COS but those that are 0 in exact
     arithmetic, printed apart), the scatter-add at each gather shape of the
     step, captured from it, as in phase 9; DSN_TRAIN_STEPS timed steps (ms
     per step, a forward + loss / backward / optimizer split from CUDA
     events, the peak device memory, a torch.profiler pass as phase 9's);
     then run_dsn_gate (cli/dsn_quality_gate.py) for DSN_GATE_STEPS steps,
     its metrics finite and the oracle's fg_iou 1;
 18. the data path on the card: cli/infer's synthetic smoke at BATCH from a
     checkpoint of random weights, which the CLI restores (fps, multicyl,
     widthmlp and collision launched; some grasps kept), then cli/infer
     over a DUMP_FRAMES-frame GraspNet-1B-shaped tree written to a
     temporary directory (eval/pipeline.dump_dataset): one (G, 17) float32
     file a frame in graspnetAPI's layout, rotations orthonormal.
 19. the models the JAX package builds besides the default, and the kernels'
     new ranges: FPS's streaming mode (K1 and K4 past 65,536 and 32,768
     points) at STREAM_SIZES, exact against the plain versions and timed at
     STREAM_TIMED_M slots; GraspBalance(backbone='pointnet2') at full
     width: forward + decode through the kernels against the plain versions
     (fps, multicyl and widthmlp launched), clouds/s and p50; the cylinder
     query at 20 and 28 combos on its seeds, idx and rel bit-equal and
     timed; GraspInference without and with OBS (as phase 7; knn,
     fps_masked and collision launched) and timed, with a torch.profiler
     pass (device ms and busy share); the fused configuration (one mlp-max
     launch per SA stage, widthmlp_rel; with OBS as phase 12); one training
     step at TRAIN_BATCH through the kernels against the plain versions
     (loss within LOSS_RTOL, gradients within GRAD_TOL), then
     cli/train --backbone pointnet2 for P2_TRAIN_STEPS steps (ms/step, peak
     memory); and the default model's variants, eval against the plain
     versions: multi_scale=False (the query at 1 x 4 combos, the width MLP
     at one scale), num_depth=5 (4 x 5 combos) and query_order='nearest'
     (the plain nearest queries, no cylinder-query kernel, then the width
     MLP); then K9's other callers against their plain versions: the
     bfloat16 DSN forward at full width (fps and knn launched, outputs
     within BF16_DSN_RTOL) and LocalAggregation(grouper='knn') at
     KNN_GROUPER_STAGES (one knn launch each, within KNN_GROUPER_RTOL).
     Prints the launches per kernel over these paths.
 20. data parallelism (parallel/): 20a, a world of one NCCL rank runs
     train_step's data-parallel path (mesh, collectives) on phase 9's batch,
     bit-equal to the one-process step (loss, metrics, gradients,
     parameters and BatchNorm statistics; fps, multicyl, scatter launched);
     20b, DP_RANKS gloo ranks sharing the card (NCCL refuses two ranks on
     one device) take the loss-only eval step and one training step of the
     default model at full width on DP_BATCH scenes, DP_BATCH / DP_RANKS a
     rank, held against the one-process DP_BATCH steps from the same state:
     the eval losses to DP_EVAL_RTOL, the first BatchNorm's statistics to
     DP_FIRST_STAT_TOL, and the losses, the gradients' median cosine, the
     running statistics and the firm-gradient parameters within
     DP_FLOOR_FACTOR of how far the one-process step on the same scenes in
     another order (DP_ORDER) lies from it; the ranks bit-equal to each
     other; the same steps with each planted fault of DP_FAULTS must fail
     that comparison; then one DSN step on phase 17's scenes, held the same
     way; 20c, sharded_drp_forward on a (1, DP_RANKS) mesh of the same ranks
     at DRP_STAGES on SHARDED_BATCH 20,000-point scenes against the
     unsharded DRP forward (indices and coordinates exact, features within
     SHARDED_FEAT_RTOL of each output's largest |value|). Prints each
     step's and forward's ms beside the one-process ones; ranks sharing one
     card give no speed figure.

Under torchrun (WORLD_SIZE set), the script runs 20b and 20c alone, on one
NCCL rank a card, S dividing DP_BATCH; the ms are then a speed figure:

    torchrun --standalone --nproc_per_node=S chip_smoke.py

Prints the kernel table as one JSON line, a row per TPU kernel (K2 and K3 are
covered by K1's kernel): its launches on the path named in its "path" (the
resumed training loop with its eval pass for FPS, the cylinder query, the
width MLP and the scatter-add; the OBS pipeline; the fused OBS pipeline
for the mlp-max and the width MLP on rotated coordinates; the op-level
select query; the probe phase for the table gather), its error against the
plain version, its time, the plain version's, the card's least time for the
work (FPS's rows also the measured latency floor of its step chain) and,
where one PyTorch call computes the same function, that call's time; the
rows of the kernels redesigned last (the masked FPS and the class-plane
selection) are marked "redesigned", with their device ms (their earlier
times are printed in phases 6 and 10); each row's "gate_launches" counts
its launches in phase 16's short gate, each row's "dsn_train_launches"
in one DSN training step of phase 17, each row's "pointnet2_launches" over
phase 19's paths (K1 and K4 also with their streaming mode's ms at each N,
K7 with its ms at 20 and 28 combos), each row's "dp_launches" over phase
20's data-parallel steps (20a's, and each rank's 20b steps); and as the last
line {"ok": true, "device": {...}}. Without CUDA it exits non-zero before
any result. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import json
import os
import statistics
import subprocess
import sys
import time

BATCH = 4
NUM_POINTS = 20000
SEED = 0
# random DSN weights: a random head tends to put a whole scene in one class,
# and with no foreground OBS sees no object and falls back to the identity
# seeds; seeds 1-4 do that on these scenes, seed 5 marks objects in all four
DSN_SEED = 5
WIDTHMLP_TOL = 1e-4  # abs; 3xTF32 tensor-core products against the plain f32 matmuls
REL_TOL = 1e-5  # abs, metres; both sides round the same ops, any gap is a fault
GRASP_TOL = 1e-4  # abs, on decoded grasps of seeds whose argmaxes agree
KNN_DIST_TOL = 1e-6  # abs; both sides round the same ops
MAIN_ITERS = 20  # timed forward + decode calls, after a warm-up
PIPELINE_ITERS = 10  # timed GraspInference calls per pipeline, after a warm-up
TRAIN_BATCH = 2  # the training step's batch (the JAX package's DataConfig.batch_size)
TRAIN_STEPS = 6  # timed training steps through the kernels, after the compared one
STEPS_PER_EPOCH = 10  # sets OneCycle's length (max_epoch x this); the run stays in epoch 0
LOSS_RTOL = 1e-5  # kernel vs plain step: the forward is the same, so the losses are too
# kernel vs plain step gradients, of each tensor's largest |grad|: the two
# backward passes differ only in the order the scatter-add sums its rows
GRAD_TOL = 1e-4
MLPMAX_TOL = 1e-4  # abs + rel; f32 FMA order against the plain matmuls
FUSED_MLPMAX_LAUNCHES = 19  # 4 set abstractions + 15 local aggregations per forward
FUSED_ROUNDS = 4  # alternating rounds of the default and the fused forward + decode
FUSED_ITERS = 5  # timed calls of each configuration per round
PROBE_REPS = 20  # timed launches of the table gather and its yardsticks
KERNEL_REPS = 20  # timed launches of the masked FPS and the class-plane selection
# the kernels redesigned last, marked in the kernel table, and their times
# before (commit b12ed93; NVIDIA H100 80GB HBM3, 700.00 W, this script),
# printed beside the new ones: the masked FPS on OBS's rows (phase 6), the
# class-plane selection on the fused forward's seeds (phase 10)
REDESIGNED = ("fps_masked", "select")
FPS_MASKED_BEFORE_MS = 0.197
SELECT_BEFORE_MS = 2.434
OBS_SMALL_SEEDS = 32  # phase 6's extra OBS check: a 6- and a 7-object scene
# phase 15, the training loop: 2 epochs of LOOP_STEPS synthetic steps at
# TRAIN_BATCH, an eval stream of LOOP_EVAL_BATCHES batches on the resume
LOOP_STEPS = 4
LOOP_EVAL_BATCHES = 2
LOOP_ANALYTIC_STEPS = 2  # --synthetic_analytic steps (labels expanded on the card)
LOOP_ALT_ROUNDS = 4  # the loop against the bare step: rounds of one loop epoch, then the bare steps
PEAK_LIMIT_GB = 76.0  # the bs=8 step runs only when its extrapolated peak is below this
# phase 16, the closed-loop quality gate: GATE_EVAL_BATCHES eval batches of
# BATCH scenes at the gate's seeds, the bfloat16 training step at
# TRAIN_BATCH, a short gate of GATE_STEPS steps at BATCH
GATE_EVAL_BATCHES = 4
GATE_STEPS = 40
# the JAX package's oracle at the gate's seeds (TPU v5e;
# QUALITY_GATE_MIXED_r05.json "oracle"): the port's must lie within
# ORACLE_TOL in quality and AP
JAX_ORACLE = {"quality_mean": 0.9955357185431889, "ap_analytic": 0.8593523134654616, "kept_per_scene": 28.0}
ORACLE_TOL = 0.005
# phase 17, DSN training at full width: bs=BATCH on the DSN gate's scenes,
# DSN_TRAIN_STEPS timed steps, a DSN gate of DSN_GATE_STEPS steps
DSN_MAX_OBJECTS = 12
DSN_TRAIN_STEPS = 6
DSN_GATE_STEPS = 40
# DSN step through the kernels against the plain versions: the forward is
# the same (FPS and kNN exact), the gathers' backward sums in another order
DSN_GRAD_COS = 0.9999
# phase 18: frames of the fixture tree dumped through cli/infer, and the
# seeds a scene of the CLI's model (the default config's)
DUMP_FRAMES = 4
DEFAULT_NUM_SEED = 1024
# bfloat16 step through the kernels against the plain versions: the forward
# is the same (FPS and the query are exact), the gathers' backward sums in
# another order in float32 and rounds to bfloat16
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_COS = 0.99
# the fused BatchNorm + ReLU's shapes, (rows, C): the width head's last
# layer at bs=8 (8 x 4 depths x 1,024 seeds x 64 neighbours, 256), a
# stage-2 block's expansion at bs=8 (8 x 1,024 x 32, 512), the graspable
# head's conv2 at bs=8 (C % 4 != 0: the scalar route); its gradients'
# tolerance (tests/test_torch_cuda.py's) and timed launches
BN_SHAPES = ((2_097_152, 256), (262_144, 512), (32_768, 302))
BN_GRAD_TOL = 1e-4
BN_REPS = 10
BN_KERNELS = ("bn_apply", "bn_grad_reduce", "bn_grad_apply")
# biases whose gradient is 0 in exact arithmetic: a train-mode BatchNorm
# downstream removes any per-channel shift they make
ZERO_GRADIENT = ("fuse_multi_scale.bias", *(f"width_grouping.mlp_scale{i}.layer2.bn.bias" for i in range(4)))
# the kernels each path must launch
PATH_KERNELS = {
    "main": ("fps", "multicyl", "widthmlp"),
    "no_obs": ("fps", "multicyl", "widthmlp", "collision"),
    "obs": ("fps", "multicyl", "widthmlp", "knn", "fps_masked", "collision"),
    "train": ("fps", "multicyl", "scatter", *BN_KERNELS),
    "loop": ("fps", "multicyl", "scatter", "widthmlp", *BN_KERNELS),
    "fused_main": ("fps", "multicyl", "mlpmax", "widthmlp_rel"),
    "fused_no_obs": ("fps", "multicyl", "mlpmax", "widthmlp_rel", "collision"),
    "fused_obs": ("fps", "multicyl", "mlpmax", "widthmlp_rel", "knn", "fps_masked", "collision"),
    "oracle": ("collision",),
    "train_bf16": ("fps", "multicyl", "scatter"),
    "gate": ("fps", "multicyl", "scatter", "widthmlp", "collision"),
    "dsn_train": ("fps", "knn", "scatter", *BN_KERNELS),
    # phase 19: the PointNet++ SSG model and the default model's variants
    "p2_main": ("fps", "multicyl", "widthmlp"),
    "p2_no_obs": ("fps", "multicyl", "widthmlp", "collision"),
    "p2_obs": ("fps", "multicyl", "widthmlp", "knn", "fps_masked", "collision"),
    "p2_fused_main": ("fps", "multicyl", "mlpmax", "widthmlp_rel"),
    "p2_fused_obs": ("fps", "multicyl", "mlpmax", "widthmlp_rel", "knn", "fps_masked", "collision"),
    "p2_train": ("fps", "multicyl", "scatter", *BN_KERNELS),
    "single_scale": ("fps", "multicyl", "widthmlp"),
    "depth5": ("fps", "multicyl", "widthmlp"),
    "nearest": ("fps", "widthmlp"),
    "dsn_bf16": ("fps", "knn"),
    # phase 20: the data-parallel steps (each rank's; the grasp model's eval
    # and training steps)
    "dp_train": ("fps", "multicyl", "scatter", "widthmlp", *BN_KERNELS),
    "dp_dsn": ("fps", "knn", "scatter", *BN_KERNELS),
}
# phase 19: LocalAggregation(grouper='knn') at DRP stages 2 and 3's
# (points, channels, K), and the tolerances of K9's other callers against
# their plain versions, relative to the largest |output| (the kNN's indices
# are exact, so both are bit-equal in practice)
KNN_GROUPER_STAGES = ((1024, 256, 32), (512, 256, 16))
KNN_GROUPER_RTOL = 1e-5
BF16_DSN_RTOL = 1e-2
# phase 19: FPS's streaming mode (past the register routes' 65,536 points,
# 32,768 masked) at these (clouds, N, slots checked against the plain
# version), timed at STREAM_TIMED_M slots; the cylinder query past 16 combos
STREAM_SIZES = ((BATCH, 100_000, 64), (2, 1_048_576, 16))
STREAM_TIMED_M = 256
MANY_COMBOS = {20: (0.01, 0.02, 0.03, 0.04, 0.05), 28: (0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07)}
P2_TRAIN_STEPS = 4  # cli/train --backbone pointnet2 steps at TRAIN_BATCH
# phase 20, data parallelism: DP_RANKS gloo ranks sharing the card take one
# step at DP_BATCH (20b), then the sharded DRP forward at SHARDED_BATCH (20c)
DP_RANKS = 2
DP_BATCH = 4
SHARDED_BATCH = 2
DP_TIMEOUT_S = 420  # the ranks' run, joined with this limit
# two ranks against one process at full width: the ranks add their partial
# sums of BatchNorm's statistics and of the losses' denominators (float64
# across the ranks) where one process sums all rows in one cascade. At full
# width the batch-statistics step amplifies any rounding (ROADMAP Queue 3:
# the float32 forward is far from float64 at the full stage table): the
# one-process step on the same scenes in another order, the same function,
# already moves the gradients to a median cosine of ~0.92 and the running
# statistics by ~1% (NVIDIA H100 80GB HBM3, 700 W). So the ranks' step is held to
# that floor, measured in the same run: its largest relative loss
# difference, its median (1 - gradient cosine) and its largest statistic
# difference, and the parameter elements with a firm gradient (|grad| above
# DP_FIRM x its tensor's largest, or 1e-4 x the model's) that stepped apart by
# more than 1e-3 x lr + 2 ulp (Adam's first step moves each by about lr), each
# within DP_FLOOR_FACTOR of the reordered step's. Two checks that nothing
# amplifies hold the split itself: the loss-only eval step from the initial
# state (running statistics, so the forward is row-local, and the losses'
# global denominators), each loss to DP_EVAL_RTOL relative (float32 sums in
# another order: 1.1e-7 on an H100 at 700 W), and the first BatchNorm's running
# statistics after the step (its input is the data through one Linear) to
# DP_FIRST_STAT_TOL of max(1, |statistic|). Each planted fault of DP_FAULTS
# (parallel/faults.py) must fail them: at full width the 'loss' fault moves
# the eval losses by only 5.4e-5, as the ranks' scenes have similar ratios.
DP_FLOOR_FACTOR = 3.0
DP_EVAL_RTOL = 1e-5
DP_FIRST_STAT_TOL = 1e-5
DP_FAULTS = ("loss", "bn")  # of parallel/faults.py
DP_FIRM = 1e-2
DP_ORDER = (2, 3, 0, 1)  # the reordered batch: the same scenes, the ranks' halves swapped
# the sharded forward's features against the unsharded one's: each output
# row runs the same operations, on products over fewer rows, which cuBLAS
# may round apart; of each output's largest |value|
SHARDED_FEAT_RTOL = 1e-5
# one row per TPU kernel: (its number, the name of the row, the kernel
# measured for it, the source, the TPU kernel's def, the path whose launches
# the row reports); K2 and K3 compute K1's function in other layouts and
# are covered by K1's kernel
KERNEL_TABLE = (
    ("K1", "fps", "fps", "fps.cu", "graspbalance_tpu/ops/pallas/fps_kernel.py:357", "loop"),
    ("K2", "fps_pallas_2d", "fps", "fps.cu", "graspbalance_tpu/ops/pallas/fps_kernel.py:399", "loop"),
    ("K3", "fps_pallas", "fps", "fps.cu", "graspbalance_tpu/ops/pallas/fps_kernel.py:439", "loop"),
    ("K4", "fps_masked", "fps_masked", "fps.cu", "graspbalance_tpu/ops/pallas/fps_kernel.py:300", "obs"),
    ("K5", "widthmlp", "widthmlp", "widthmlp.cu", "graspbalance_tpu/ops/pallas/widthmlp_kernel.py:197", "loop"),
    ("K6", "widthmlp_rel", "widthmlp_rel", "widthmlp.cu", "graspbalance_tpu/ops/pallas/widthmlp_kernel.py:74",
     "fused_obs"),
    ("K7", "multicyl", "multicyl", "multicyl.cu", "graspbalance_tpu/ops/pallas/multicyl_kernel.py:212", "loop"),
    ("K8", "select", "select", "select.cu", "graspbalance_tpu/ops/pallas/select_kernel.py:136", "select_query"),
    ("K9", "knn", "knn", "knn.cu", "graspbalance_tpu/ops/pallas/knn_kernel.py:80", "obs"),
    ("K10", "collision", "collision", "collision.cu", "graspbalance_tpu/ops/pallas/collision_kernel.py:132", "obs"),
    ("K11", "scatter", "scatter", "scatter.cu", "graspbalance_tpu/ops/pallas/scatter_kernel.py:81", "loop"),
    ("K12", "mlpmax", "mlpmax", "mlpmax.cu", "graspbalance_tpu/ops/pallas/mlpmax_kernel.py:133", "fused_obs"),
    ("K13", "table_gather", "table_gather", "table_gather.cu", "tools/probe_mosaic_gather.py:45", "probe"),
)
# the card's peaks (NVIDIA H100 SXM data sheet, 700 W): device memory, FP32
# outside the tensor cores, and dense TF32 on the tensor cores (the width
# MLP's layers 1 and 2, three TF32 products per f32 product)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_TF32_S = 495e12


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (after one warm-up)."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int = 1) -> float:
    """Mean host time of fn() up to the card's end of it, over reps calls."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def stage_line(got: dict, calls: int) -> str:
    """The stages of ``calls`` served calls from the program's spans
    (``trace.take()``, device events on): each stage of ``gb.call`` with its
    device ms a call, its share of the call's, its host ms, and the device
    ms of the stages inside it; the NMS sweeps, host reads and the host's
    waits a call (the program's counters)."""
    spans = got["spans"]
    top = {s["id"] for s in spans if s["name"] == "gb.call"}
    call_ms = sum(s["device_ms"] for s in spans if s["id"] in top) / calls
    stages, inner = {}, {}
    for s in spans:
        if s["parent"] in top:
            inner[s["id"]] = s["name"]
            host, dev = stages.get(s["name"], (0.0, 0.0))
            stages[s["name"]] = (host + (s["t1_ns"] - s["t0_ns"]) * 1e-6 / calls, dev + s["device_ms"] / calls)
    within = collections.defaultdict(lambda: collections.defaultdict(float))
    for s in spans:
        if s["parent"] in inner:
            within[inner[s["parent"]]][s["name"][3:]] += s["device_ms"] / calls
    parts = []
    for k, (host, dev) in stages.items():
        sub = ", ".join(f"{n} {ms:.3f}" for n, ms in within[k].items())
        parts.append(f"{k[3:]} {dev:.3f} ms ({dev / call_ms:.1%}, host {host:.3f})" + (f" [{sub}]" if sub else ""))
    c = got["counters"]
    reads = sum(v for k, v in c.items() if k.startswith("sync."))
    return (f"stages from the spans (device ms a call, share of the call's {call_ms:.3f}, host ms) "
            f"{', '.join(parts)}; NMS sweeps {c.get('nms.sweeps', 0) / calls:.1f}, host reads {reads / calls:.1f}, "
            f"host waits {c.get('sync_wait_ns', 0) * 1e-6 / calls:.3f} ms a call")


def rate_line(iters: list[float]) -> str:
    """clouds/s and p50 ms/scene over timed bs=BATCH calls (seconds), with
    the spread of the calls."""
    per_scene = sorted(t / BATCH * 1e3 for t in iters)
    return (f"{BATCH * len(iters) / sum(iters):.3f} clouds/s, p50 {statistics.median(per_scene):.3f} "
            f"ms/scene (min {per_scene[0]:.3f}, max {per_scene[-1]:.3f} over {len(iters)} calls)")


def bound(nbytes: float, ops: float, *more: tuple[float, float]) -> tuple[float, str]:
    """The least time the card could take (ms) and what binds it: the bytes
    over the memory rate, or the operations on each unit over its peak
    (``ops`` FP32 on the CUDA cores, and ``more`` (ops, peak) pairs of other
    units, which run beside them), whichever is longest."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = max(w / peak * 1e3 for w, peak in ((ops, PEAK_FP32_S), *more))
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def widthmlp_bound(weights, rows: int, nbytes: float) -> tuple[float, str]:
    """The width MLP's bound over ``rows`` rows of each scale: layer 0 in
    FP32 on the CUDA cores, layers 1 and 2 on the tensor cores in 3xTF32
    (three TF32 products for each f32 product)."""
    layer0 = sum(scale[0][0].numel() for scale in weights)
    tail = sum(w.numel() for scale in weights for w, _ in scale[1:])
    return bound(nbytes, 2.0 * layer0 * rows, (3 * 2.0 * tail * rows, PEAK_TF32_S))


def argmax_margin(x, dim: int):
    """Gap between the largest and second-largest value along dim."""
    top2 = x.topk(2, dim=dim).values
    return top2.select(dim, 0) - top2.select(dim, 1)


def compare_decoded(ep, ep_p, grasps, grasps_p, valid, valid_p, what: str) -> str:
    """Two runs' decoded grasps (kernel against plain, or the fused
    configuration against the default). An argmax can only flip where its
    margin is at most twice the largest gap between the two runs' inputs to
    it: the valid masks must agree wherever objectness is no such near tie
    (everywhere when the two runs' objectness scores are equal), and every
    seed whose grasp differs must be a near tie of its top view (when the
    view scores differ), its angle or its depth."""
    import torch

    def firm_seeds(key, dim):
        gap = float((ep[key] - ep_p[key]).abs().max())
        return (argmax_margin(ep_p[key], dim) > 2 * gap) | (gap == 0.0)

    obj_firm = firm_seeds("objectness_score", -1)
    require(torch.equal(valid[obj_firm], valid_p[obj_firm]),
            f"{what}: valid masks differ between the two runs away from objectness near ties")
    view_firm = firm_seeds("view_score", -1)
    gap_ang = (ep["grasp_angle_cls_pred"] - ep_p["grasp_angle_cls_pred"]).abs().amax(dim=(2, 3))
    gap_score = (ep["grasp_score_pred"] - ep_p["grasp_score_pred"]).abs().amax(dim=(2, 3))
    # the head gaps of seeds whose top view is the same in both runs
    d_ang = float(gap_ang[view_firm].max()) if bool(view_firm.any()) else 0.0
    d_score = float(gap_score[view_firm].max()) if bool(view_firm.any()) else 0.0
    firm = view_firm & (argmax_margin(ep_p["grasp_angle_cls_pred"], 2) > 2 * d_ang).all(dim=-1)
    ang = ep_p["grasp_angle_cls_pred"].argmax(dim=2, keepdim=True)
    score_at = ep_p["grasp_score_pred"].gather(2, ang)[:, :, 0]
    firm &= argmax_margin(score_at, 2) > 2 * d_score
    row_err = (grasps - grasps_p).abs().amax(dim=-1)
    differ = row_err > GRASP_TOL
    require(not bool((differ & firm).any()),
            f"{what}: decoded grasps differ by up to {float(row_err[firm].max())} on seeds with firm argmaxes")
    require(float(differ.float().mean()) <= 0.05, f"{what}: {int(differ.sum())} decoded grasps differ")
    require(bool(torch.isfinite(grasps).all()), f"{what}: non-finite grasps")
    for key, v in ep.items():
        if v is not None and v.is_floating_point():
            require(bool(torch.isfinite(v).all()), f"{what}: non-finite values in {key}")
    ties = int((~obj_firm).sum()) + int((~view_firm).sum())
    return (f"valid equal{'' if ties == 0 else f' ({ties} objectness or top-view near ties)'}, grasps max err "
            f"{float(row_err[~differ].max()):.3g} on {int((~differ).sum())}/{differ.numel()} seeds, "
            f"{int(differ.sum())} near-tie seeds decode another view, angle or depth (head gaps angle "
            f"{d_ang:.3g}, score {d_score:.3g})")


def device_ms_by_kernel(fn, calls: int = 1) -> dict:
    """torch.profiler over `calls` calls of ``fn``, after one unprofiled
    call: kernel name -> (device ms, launches) per call. Device
    events only, without the ranges that annotate them (the optimizer
    step's, whose kernels are counted on their own)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.self_device_time_total / 1e3 / calls, e.count / calls) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation}


def profile_calls(fns: dict, calls: int = 3) -> None:
    """torch.profiler over `calls` calls of each fn in `fns` (name -> fn):
    kernels and device (kernel) ms per call, beside the unprofiled wall ms
    per call, one JSON line each."""
    for name, fn in fns.items():
        kernels = device_ms_by_kernel(fn, calls)
        wall = wall_ms(fn, calls)
        dev_ms = sum(ms for ms, _ in kernels.values())
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
        print(json.dumps({
            "profile": name,
            "kernels_per_call": sum(count for _, count in kernels.values()),
            "device_ms_per_call": dev_ms,
            "wall_ms_per_call": wall,
            "busy_share": dev_ms / wall,
            "top": [[key[:70], ms, int(count)] for key, (ms, count) in top],
        }))


def check_pipeline(name: str, infer, cloud) -> dict:
    """Phase 7 for one pipeline: run it through the kernels (every kernel
    of PATH_KERNELS[name] launched), then its stages through the kernels and
    through the plain versions: segment labels and OBS seeds exact, decoded
    grasps as compare_decoded, the same keep masks from the kernel and the
    plain postprocess on identical grasps. Returns the launch counts."""
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.eval.obs import object_balance_indices
    from graspbalance_tpu_torch.models import pred_decode

    m = infer.model.backbone.num_seed
    with torch.no_grad():
        torch.cuda.synchronize()
        _build.reset_launches()
        g_np, keep_np = infer(cloud)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        require(all(launches[n] > 0 for n in PATH_KERNELS[name]),
                f"{name}: a kernel of the path was not launched: {launches}")
        require(g_np.shape == (BATCH, m, 17) and keep_np.shape == (BATCH, m), f"{name}: output shapes")
        require(bool(torch.isfinite(torch.from_numpy(g_np)).all()), f"{name}: non-finite grasps")

        # the same stages, kernel against plain
        msg = ""
        if infer.use_obs:
            labels_k, sa_k = infer.segment(cloud)
            labels_p, sa_p = infer.segment(cloud, plain=True)
            require(torch.equal(sa_k, sa_p), f"{name}: shared FPS differs")
            require(torch.equal(labels_k, labels_p), f"{name}: segment labels differ between kernel and plain")
            obs_k = object_balance_indices(cloud, labels_k, num_seed=m)
            obs_p = object_balance_indices(cloud, labels_k, num_seed=m, plain=True)
            require(torch.equal(obs_k, obs_p), f"{name}: OBS seeds differ between kernel and plain")
            msg = (f"labels exact ({int(labels_k.amax(dim=1).min())}-{int(labels_k.amax(dim=1).max())} "
                   f"clusters per scene), OBS seeds exact; ")
        ep = infer.forward(cloud)
        ep_p = infer.forward(cloud, plain=True)
        g, v = pred_decode(ep)
        g_p, v_p = pred_decode(ep_p)
        msg += compare_decoded(ep, ep_p, g, g_p, v, v_p, name)
        keep_k = infer.postprocess(g, v, cloud)
        keep_p = infer.postprocess(g, v, cloud, plain=True)
        require(torch.equal(keep_k, keep_p), f"{name}: keep masks differ on identical grasps")
        # the same with every seed valid, so that NMS and the collision
        # filter decide every grasp whatever the random objectness says
        all_valid = torch.ones_like(v)
        keep_all_k = infer.postprocess(g, all_valid, cloud)
        keep_all_p = infer.postprocess(g, all_valid, cloud, plain=True)
        require(torch.equal(keep_all_k, keep_all_p), f"{name}: keep masks differ on identical all-valid grasps")
        keep_e2e_p = infer.postprocess(g_p, v_p, cloud, plain=True)
    print(f"GraspInference {name}: launches {launches}; {msg}; keep masks equal on "
          f"identical grasps ({int(keep_k.sum())} kept of {int(v.sum())} valid; with every seed "
          f"valid {int(keep_all_k.sum())} of {v.numel()} kept); "
          f"end to end {int((keep_k != keep_e2e_p).sum())} keep entries differ")
    return launches


@contextlib.contextmanager
def gather_backward(fn):
    """Within the block, the gathers' backward (ops/gather.py) calls ``fn``
    (ct, idx, n) in place of the scatter-add kernel's wrapper."""
    from graspbalance_tpu_torch.ops import gather

    real = gather.scatter_add
    gather.scatter_add = fn
    try:
        yield
    finally:
        gather.scatter_add = real


def capture_scatters(step) -> list:
    """(ct, idx, n) of every scatter-add kernel launch that ``step()`` makes
    (copies, for the comparisons); the launches themselves run as usual."""
    from graspbalance_tpu_torch.ops.scatter import scatter_add

    launched = []

    def recording(ct, idx, n):
        launched.append((ct.clone(), idx.clone(), n))
        return scatter_add(ct, idx, n)

    with gather_backward(recording):
        step()
    return launched


def scatter_phase(calls) -> tuple[tuple, float, tuple]:
    """The scatter-add kernel against its plain version on each captured
    call: integer-valued cotangents exactly, two launches bit-equal, float
    cotangents within the worst-case error bound of recursive f32 summation,
    (rows - 1) * 2^-24 * sum |ct| per output, of the float64 sums. Prints,
    per shape, the kernel's, index_add_'s and the plain version's ms, and
    the kernel's device ms per pass (torch.profiler) over the step's calls.
    Returns (kernel, plain, index_add_ ms summed over the calls; the largest
    float error; the bound (ms, by) of all the calls' bytes)."""
    import torch

    from graspbalance_tpu_torch.ops.scatter import scatter_add, scatter_add_plain

    max_err, nbytes = 0.0, 0.0
    shapes = {}  # (B, R, n, C) -> [calls, kernel ms, index_add_ ms, plain ms], summed over its calls
    for ct, idx, n in calls:
        b, r, c = ct.shape
        ct_int = torch.randint(-8, 9, ct.shape, generator=torch.Generator(device=ct.device).manual_seed(r),
                               device=ct.device).float()
        require(torch.equal(scatter_add(ct_int, idx, n), scatter_add_plain(ct_int, idx, n)),
                f"scatter kernel != plain on integer cotangents at {tuple(ct.shape)} -> n={n}")
        got = scatter_add(ct, idx, n)
        require(torch.equal(got, scatter_add(ct, idx, n)), f"scatter kernel not deterministic at {tuple(ct.shape)}")
        exact = scatter_add_plain(ct.double(), idx, n)
        rows = scatter_add_plain(torch.ones_like(ct[..., :1], dtype=torch.float64), idx, n)
        limit = (rows - 1).clamp(min=0) * 2.0**-24 * scatter_add_plain(ct.abs().double(), idx, n)
        err = (got.double() - exact).abs()
        require(bool((err <= limit).all()),
                f"scatter kernel error {float(err.max())} beyond the summation bound at {tuple(ct.shape)}")
        max_err = max(max_err, float(err.max()))
        flat_rows = (idx.long() + torch.arange(b, device=idx.device).unsqueeze(1) * n).reshape(-1)
        flat_ct = ct.reshape(-1, c)
        entry = shapes.setdefault((b, r, n, c), [0, 0.0, 0.0, 0.0])
        entry[0] += 1
        entry[1] += cuda_ms(lambda: scatter_add(ct, idx, n), 5)
        entry[2] += cuda_ms(lambda: torch.zeros((b * n, c), device=ct.device).index_add_(0, flat_rows, flat_ct), 5)
        entry[3] += cuda_ms(lambda: scatter_add_plain(ct, idx, n), 5)
        nbytes += ct.numel() * 4 + idx.numel() * 4 + b * n * c * 4
    times = tuple(sum(e[i] for e in shapes.values()) for i in (1, 3, 2))
    print("scatter-add at the step's gather shapes, integer cotangents exact, two launches bit-equal, float max "
          f"err {max_err:.3g} (within the f32 summation bound everywhere); per shape (B, R, n, C) x calls: kernel, "
          "index_add_, plain ms summed over its calls: "
          + "; ".join(f"{k} x{e[0]}: {e[1]:.4f}, {e[2]:.4f}, {e[3]:.4f}" for k, e in shapes.items()))
    # the kernel's passes, device time over one launch per captured call
    by_kernel = device_ms_by_kernel(lambda: [scatter_add(ct, idx, n) for ct, idx, n in calls])
    passes = {name: sum(ms for key, (ms, _) in by_kernel.items() if f"{name}_kernel" in key)
              for name in ("hist", "scan", "rank", "sum")}
    print(f"scatter-add per step ({len(calls)} calls): kernel {times[0]:.4f} ms, index_add_ {times[2]:.4f} ms, "
          f"plain {times[1]:.4f} ms (CUDA events); the kernel's "
          f"device ms by pass (torch.profiler): " + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
          + f", total {sum(passes.values()):.4f}")
    # one add per (row, channel): the bytes bind
    return times, max_err, bound(nbytes, sum(ct.numel() for ct, _, _ in calls))


def capture_mlpmax(fn) -> list:
    """(parts, weights, reduction) of every mlp-max kernel launch that
    ``fn()`` makes (the parts copied, for the comparisons); the launches
    themselves run as usual."""
    from graspbalance_tpu_torch.ops import mlpmax

    real = mlpmax.mlp_max_fused
    launched = []

    def recording(parts, weights, *, reduction="max"):
        launched.append((tuple(p.clone() for p in parts), weights, reduction))
        return real(parts, weights, reduction=reduction)

    mlpmax.mlp_max_fused = recording
    try:
        fn()
    finally:
        mlpmax.mlp_max_fused = real
    return launched


def mlpmax_bound(parts, weights, out) -> tuple[tuple[float, str], tuple[float, str]]:
    """The mlp-max kernel's bound on one call, and its bound with every
    operation on the FP32 CUDA cores (the rule before the kernel used the
    tensor cores). Per row and
    layer a multiply-add per weight, a bias add and a ReLU per output; the
    reduction one operation per row and channel. The kernel runs a leading
    part of fewer than 8 channels (the 3-channel offset) on the CUDA cores
    and every other product on the tensor cores in 3xTF32: three TF32
    products for each f32 product."""
    import torch

    b, n, k, _ = parts[0].shape
    rows = b * n * k
    layers = [torch.cat(weights[0][0], dim=0)] + [w for w, _ in weights[1:]]
    c_fma = parts[0].shape[-1] if parts[0].shape[-1] < 8 else 0
    nbytes = (sum(p.numel() for p in parts) + out.numel() + sum(w.numel() + w.shape[1] for w in layers)) * 4.0
    products = sum(2.0 * w.shape[0] * w.shape[1] for w in layers) * rows
    fma_products = 2.0 * c_fma * layers[0].shape[1] * rows
    rest = rows * (sum(2.0 * w.shape[1] for w in layers) + layers[-1].shape[1])
    tf32 = bound(nbytes, fma_products + rest, (3 * (products - fma_products), PEAK_TF32_S))
    return tf32, bound(nbytes, products + rest)


def mlpmax_phase(calls) -> tuple[tuple, float, tuple]:
    """The mlp-max kernel against its plain version on each captured call:
    within MLPMAX_TOL (abs + rel), two launches bit-equal; its time per call
    beside the call's bound. Returns (kernel, plain ms summed over the
    calls, None), the largest error, the bound (ms, by) summed over the
    calls."""
    import torch

    from graspbalance_tpu_torch.ops.mlpmax import mlp_max_fused, mlp_max_fused_plain

    max_err, t_k, t_p, b_tf32, b_fp32 = 0.0, 0.0, 0.0, 0.0, 0.0
    by = {"bytes": 0.0, "operations": 0.0}  # the summed bound by what binds each call
    per_call = []
    for parts, weights, reduction in calls:
        run = functools.partial(mlp_max_fused, parts, weights, reduction=reduction)
        run_p = functools.partial(mlp_max_fused_plain, parts, weights, reduction=reduction)
        got, want = run(), run_p()
        err = (got - want).abs()
        require(bool((err <= MLPMAX_TOL * (1.0 + want.abs())).all()),
                f"mlp-max kernel error {float(err.max())} beyond {MLPMAX_TOL} abs + rel at "
                f"{[tuple(p.shape) for p in parts]}")
        require(torch.equal(got, run()), f"mlp-max kernel not deterministic at {tuple(parts[0].shape)}")
        max_err = max(max_err, float(err.max()))
        ms = cuda_ms(run, 3)
        t_k += ms
        t_p += cuda_ms(run_p, 1)
        tf32, fp32 = mlpmax_bound(parts, weights, got)
        b_tf32 += tf32[0]
        b_fp32 += fp32[0]
        by[tf32[1]] += tf32[0]
        b, n, k, _ = parts[0].shape
        widths = [weights[0][0][0].shape[1]] + [w.shape[1] for w, _ in weights[1:]]
        per_call.append(f"({b}, {n}, K={k}, {'+'.join(str(p.shape[-1]) for p in parts)}->"
                        f"{'->'.join(map(str, widths))}) {ms:.4f} ms, bound {tf32[0]:.4f} ({tf32[1]})")
    print(f"mlp-max: {len(calls)} calls at bs={BATCH}, max err {max_err:.3g} (within {MLPMAX_TOL} abs + rel), "
          f"two launches bit-equal; per call (CUDA events, TF32 bound): " + "; ".join(per_call))
    print(f"mlp-max per forward: {t_k:.4f} ms, plain {t_p:.4f} ms; "
          f"bound {b_tf32:.4f} ms (products on the tensor cores in 3xTF32), {b_fp32:.4f} ms with every "
          f"operation on the FP32 CUDA cores (the bound before the tensor-core redesign)")
    return (t_k, t_p, None), max_err, (b_tf32, max(by, key=by.get))


def fused_phase(model, dsn, cloud, smi: str):
    """Phases 10-13 (see the module docstring): the fused eval
    configuration on the same weights as ``model``. Returns (path_launches,
    times, errs, bounds, device ms) of its paths and of the mlp-max,
    width-MLP-rel and select kernels (device ms of the select only)."""
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.eval.pipeline import GraspInference
    from graspbalance_tpu_torch.models import GraspBalance, pred_decode
    from graspbalance_tpu_torch.ops.multicyl import multi_cylinder_group
    from graspbalance_tpu_torch.ops.query import class_plane, multi_cylinder_query
    from graspbalance_tpu_torch.ops.select import multicyl_select, multicyl_select_plain
    from graspbalance_tpu_torch.ops.widthmlp import width_mlp_fused, width_mlp_fused_plain

    fused = GraspBalance(fused_backbone_min_nsample=0, width_impl="fused_pallas")
    fused.load_state_dict(model.state_dict(), strict=True)  # the same variables
    fused = fused.to(cloud.device).eval()
    wg = fused.width_grouping
    launches, times, errs, bounds, device = {}, {}, {}, {}, {}

    # 10. the fused kernels against their plain versions at this path's shapes
    with torch.no_grad():
        ep = {}
        calls = capture_mlpmax(lambda: ep.update(fused(cloud)))
        require(len(calls) == FUSED_MLPMAX_LAUNCHES,
                f"the fused forward made {len(calls)} mlp-max calls, not {FUSED_MLPMAX_LAUNCHES}")
        times["mlpmax"], errs["mlpmax"], bounds["mlpmax"] = mlpmax_phase(calls)
        del calls

        # the width MLP on the query's gripper-frame coordinates of this
        # forward's seeds and top-view rotations
        seeds, rot = ep["fp2_xyz"].contiguous(), ep["grasp_top_view_rot"].contiguous()
        qargs = (cloud, seeds, rot, wg.radii, wg.hmin, wg.hmax_list, wg.nsample)
        idx, rel = multi_cylinder_group(*qargs, emit_rel=True)
        weights = wg.folded_weights()
        got, want = width_mlp_fused(rel, weights), width_mlp_fused_plain(rel, weights)
        errs["widthmlp_rel"] = float((got - want).abs().max())
        require(errs["widthmlp_rel"] <= WIDTHMLP_TOL, f"width MLP (rel) error {errs['widthmlp_rel']} > {WIDTHMLP_TOL}")
        require(torch.equal(got, width_mlp_fused(rel, weights)), "width MLP (rel) kernel not deterministic")
        times["widthmlp_rel"] = (cuda_ms(lambda: width_mlp_fused(rel, weights), 5),
                                 cuda_ms(lambda: width_mlp_fused_plain(rel, weights), 2), None)
        b, n_r, n_h, m, k = idx.shape
        bounds["widthmlp_rel"] = widthmlp_bound(weights, b * m * n_h * k, rel.numel() * 4 + got.numel() * 4)
        print(f"width MLP (rel): {tuple(rel.shape)} -> {tuple(got.shape)} max err {errs['widthmlp_rel']:.3g} "
              f"(max |out| {float(want.abs().max()):.3g}), two launches bit-equal; {times['widthmlp_rel'][0]:.4f} ms")
        del rel, got, want

        # the class-plane selection on the same seeds: the same indices as
        # its plain version and as the cylinder query's kernel
        cls = class_plane(*qargs[:6]).reshape(b * m, -1)
        sel = multicyl_select(cls, n_r, n_h, k)
        require(torch.equal(sel, multicyl_select_plain(cls, n_r, n_h, k)),
                f"select kernel != plain: {int((sel != multicyl_select_plain(cls, n_r, n_h, k)).sum())} differ")
        require(torch.equal(sel.reshape(b, m, n_r, n_h, k).permute(0, 2, 3, 1, 4), idx),
                "select kernel != the cylinder query's indices")
        require(torch.equal(sel, multicyl_select(cls, n_r, n_h, k)), "select kernel not deterministic")
        errs["select"] = 0
        times["select"] = (cuda_ms(lambda: multicyl_select(cls, n_r, n_h, k), KERNEL_REPS),
                           cuda_ms(lambda: multicyl_select_plain(cls, n_r, n_h, k), 1), None)
        per_call = device_ms_by_kernel(lambda: multicyl_select(cls, n_r, n_h, k), KERNEL_REPS)
        device["select"] = sum(ms for key, (ms, _) in per_call.items() if "select_kernel" in key)
        # each row is read up to its last combo's k-th hit (all N where a
        # combo has fewer): its bytes and the indices written, and two
        # integer operations per scanned point to decode its class; beside it
        # the bound before the redesign, 2 + 3 per combo operations a point
        full = sel[..., -1] != sel[..., 0]
        scan = float(torch.where(full, sel[..., -1].long() + 1, cls.shape[1]).amax(dim=1).sum())
        bounds["select"] = bound(scan + sel.numel() * 4, scan * 2)
        old_bound = bound(scan + sel.numel() * 4, scan * (2 + 3 * n_r * n_h))
        # the op-level query that runs it, once
        torch.cuda.synchronize()
        _build.reset_launches()
        sel_q = multi_cylinder_query(*qargs, impl="select")
        torch.cuda.synchronize()
        launches["select_query"] = dict(_build.launches)
        require(launches["select_query"]["select"] == 1 and torch.equal(sel_q, idx),
                f"multi_cylinder_query(impl='select'): launches {launches['select_query']}, "
                f"indices equal to the kernel query's: {torch.equal(sel_q, idx)}")
        print(f"select: class plane {tuple(cls.shape)} {cls.dtype}, {n_r}x{n_h} combos, k={k}: indices "
              f"exact against the plain version and the cylinder query's kernel, two launches bit-equal; "
              f"{scan / cls.numel():.3f} of the plane scanned; {times['select'][0]:.4f} ms (before the redesign: "
              f"{SELECT_BEFORE_MS} ms), device {device['select']:.4f} ms; bound {bounds['select'][0]:.5f} ms "
              f"({bounds['select'][1]}; before the redesign {old_bound[0]:.5f} ms, {old_bound[1]})")
        del cls, sel, sel_q, idx

    # 11. the fused forward + decode through the kernels, through the plain
    # versions, and against the default configuration
    with torch.no_grad():
        torch.cuda.synchronize()
        _build.reset_launches()
        ep = fused(cloud)
        grasps, valid = pred_decode(ep)
        torch.cuda.synchronize()
        launches["fused_main"] = dict(_build.launches)
        fl = launches["fused_main"]
        require(all(fl[n] > 0 for n in PATH_KERNELS["fused_main"]) and fl["mlpmax"] == FUSED_MLPMAX_LAUNCHES
                and fl["widthmlp_rel"] == 1 and fl["widthmlp"] == 0,
                f"fused forward+decode: launches {fl}; needs mlpmax {FUSED_MLPMAX_LAUNCHES}, widthmlp_rel 1, "
                f"widthmlp 0, fps and multicyl > 0")
        ep_p = fused(cloud, plain=True)
        grasps_p, valid_p = pred_decode(ep_p)
        msg_p = compare_decoded(ep, ep_p, grasps, grasps_p, valid, valid_p, "fused forward+decode")
        del ep_p
        ep_d = model(cloud)
        grasps_d, valid_d = pred_decode(ep_d)
        msg_d = compare_decoded(ep, ep_d, grasps, grasps_d, valid, valid_d, "fused vs default forward+decode")
        print(f"fused forward+decode: launches {fl}; kernel vs plain: {msg_p}; against the default "
              f"configuration: {msg_d}")
        del ep, ep_d

    # 12. GraspInference without and with OBS on the fused model
    pipelines = {"fused_no_obs": GraspInference(fused), "fused_obs": GraspInference(fused, dsn, use_obs=True)}
    for name, infer in pipelines.items():
        launches[name] = check_pipeline(name, infer, cloud)
        require(launches[name]["mlpmax"] == FUSED_MLPMAX_LAUNCHES and launches[name]["widthmlp"] == 0,
                f"{name}: launches {launches[name]}")

    # 13. the fused and the default forward + decode, in alternating rounds
    configs = {"default": model, "fused": fused}
    iters = {name: [] for name in configs}
    with torch.no_grad():
        for net in configs.values():  # warm-up
            pred_decode(net(cloud))
        for r in range(FUSED_ROUNDS):
            for name in (("default", "fused") if r % 2 == 0 else ("fused", "default")):
                for _ in range(FUSED_ITERS):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    pred_decode(configs[name](cloud))
                    torch.cuda.synchronize()
                    iters[name].append(time.perf_counter() - t1)
    for name, its in iters.items():
        print(f"forward+decode {name} configuration, alternating rounds, bs={BATCH}, {NUM_POINTS} pts: "
              f"{rate_line(its)} ({smi})")
    # the profiler's device time of each configuration's forward + decode
    # and of the two layers they differ in: the backbone after FPS, and the
    # width head (query + MLPs) on the configuration's own seeds and
    # top-view rotations
    calls = {}
    with torch.no_grad():
        sa_inds = fused.backbone(cloud)["sa1_inds"]
        for name, net in configs.items():
            ep = net.backbone(cloud, sa_inds=sa_inds)
            ep.update(net.graspable(ep["fp2_xyz"], ep["fp2_features"]))
            calls[f"forward+decode {name}"] = functools.partial(lambda net: pred_decode(net(cloud)), net)
            calls[f"backbone {name}"] = functools.partial(net.backbone, cloud, sa_inds=sa_inds)
            calls[f"width head {name}"] = functools.partial(
                net.width_grouping, ep["fp2_xyz"], cloud, ep["grasp_top_view_rot"])
        profile_calls(calls)
    return launches, times, errs, bounds, device


def probe_phase():
    """Phase 14: the table gather on the probe's four cases and on one past
    the old design's limit (its launches counted), exactly against its plain
    version and torch.gather, then timed beside both at the probe's
    benchmark case. Returns (launches, times, max error, bound)."""
    import numpy as np
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.ops.table_gather import table_gather, table_gather_plain

    def case(dim, m, n, seed):  # tools/probe_mosaic_gather.py's inputs
        x = np.random.RandomState(seed).rand(m, n).astype(np.float32)
        idx = np.random.RandomState(seed + 1).randint(0, m if dim == 0 else n, (m, n)).astype(np.int32)
        return torch.from_numpy(x).cuda(), torch.from_numpy(idx).cuda(), dim

    cases = [case(0, 512, 128, 0), case(0, 19968, 128, 10), case(1, 512, 128, 20), case(0, 2048, 512, 30),
             case(0, 65536, 128, 40)]  # the last past the old design's shared-memory limit on M
    torch.cuda.synchronize()
    _build.reset_launches()
    outs = [table_gather(*c) for c in cases]
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    require(launches["table_gather"] == len(cases), f"probe: launches {launches}")
    for (x, idx, dim), out in zip(cases, outs):
        require(torch.equal(out, table_gather_plain(x, idx, dim)), f"table gather != plain at {tuple(x.shape)}")
        require(torch.equal(out, torch.gather(x, dim, idx.long())), f"table gather != torch.gather at {tuple(x.shape)}")
        require(torch.equal(out, table_gather(x, idx, dim)), f"table gather not deterministic at {tuple(x.shape)}")
    x, idx, dim = case(0, 19968, 128, 7)  # bench_dim0's case
    idx_l = idx.long()
    times = (cuda_ms(lambda: table_gather(x, idx, dim), PROBE_REPS),
             cuda_ms(lambda: table_gather_plain(x, idx, dim), PROBE_REPS),
             cuda_ms(lambda: torch.gather(x, dim, idx_l), PROBE_REPS))
    dev_k = sum(ms for ms, _ in device_ms_by_kernel(lambda: table_gather(x, idx, dim), PROBE_REPS).values())
    dev_g = sum(ms for ms, _ in device_ms_by_kernel(lambda: torch.gather(x, dim, idx_l), PROBE_REPS).values())
    print(f"table gather: dim 0 (512, 128), dim 0 (19968, 128), dim 1 (512, 128), dim 0 (2048, 512), dim 0 "
          f"(65536, 128) exact against the plain version and torch.gather; at dim 0 (19968, 128): {times[0]:.4f} ms "
          f"(plain {times[1]:.4f}, torch.gather {times[2]:.4f}; CUDA events), device ms per launch (torch.profiler) "
          f"{dev_k:.4f} against torch.gather's {dev_g:.4f}")
    # an index in, a table value in once, a value out: 12 bytes per element
    return launches, times, 0, bound(12.0 * x.numel(), 0.0)


def train_phase(dev, smi: str):
    """Phase 9 (see the module docstring). Returns the launch counts of one
    step and the scatter-add's table entries: ((ms, plain ms, library ms),
    max error, bound)."""
    import torch

    from graspbalance_tpu_torch import _build, trace
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.nn.layers import BatchNorm
    from graspbalance_tpu_torch.ops.scatter import scatter_add_plain
    from graspbalance_tpu_torch.train.config import Config
    from graspbalance_tpu_torch.train.train_step import (
        build_model,
        forward_loss,
        make_optimizer,
        to_device,
        train_step,
    )
    from graspbalance_tpu_torch.weights import init_random_

    cfg = Config()
    t0 = time.perf_counter()
    batch = to_device(make_batch(SEED, TRAIN_BATCH, SceneConfig(num_points=NUM_POINTS)), dev)
    label_gb = sum(v.numel() * v.element_size() for v in batch.values()) / 1e9
    print(f"train batch: {TRAIN_BATCH} x {NUM_POINTS} points, label tensors "
          f"{tuple(batch['grasp_labels'].shape)}, {label_gb:.2f} GB on the card, "
          f"made in {time.perf_counter() - t0:.1f} s")
    model = init_random_(build_model(cfg, device=dev), SEED)
    model_p = copy.deepcopy(model)
    opt, sched = make_optimizer(model, cfg, STEPS_PER_EPOCH)
    opt_p, sched_p = make_optimizer(model_p, cfg, STEPS_PER_EPOCH)

    # one step through the kernels (its scatter calls captured), one through
    # the plain versions, from the same state
    torch.cuda.synchronize()
    _build.reset_launches()
    out = {}
    trace.enable()
    try:
        calls = capture_scatters(lambda: out.update(train_step(model, opt, sched, batch, 0, cfg)))
    finally:
        trace.disable()
    counters = trace.take()["counters"]
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    print(f"training step BatchNorm calls: bn.fused {counters.get('bn.fused', 0)}, bn.plain "
          f"{counters.get('bn.plain', 0)} ({n_bn} BatchNorm modules)")
    require(counters.get("bn.fused", 0) >= n_bn and counters.get("bn.plain", 0) == 0,
            f"training step: BatchNorm counters {counters}; every call must take the kernels")
    require(all(launches[k] > 0 for k in PATH_KERNELS["train"]) and launches["widthmlp"] == 0,
            f"training step: launches {launches}; needs fps, multicyl, scatter > 0 and widthmlp == 0")
    metrics_k = {k: float(v) for k, v in out.items()}
    with gather_backward(scatter_add_plain):
        metrics_p = {k: float(v) for k, v in train_step(model_p, opt_p, sched_p, batch, 0, cfg, plain=True).items()}
    for name, metrics in (("kernel", metrics_k), ("plain", metrics_p)):
        bad = [k for k, v in metrics.items() if v != v or abs(v) == float("inf")]
        require(not bad, f"training step ({name}): non-finite metrics {bad}")
    loss_k, loss_p = metrics_k["loss/overall_loss"], metrics_p["loss/overall_loss"]
    require(abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p), f"training loss: kernel {loss_k} vs plain {loss_p}")
    grad_errs = {}
    for (name, p), (_, q) in zip(model.named_parameters(), model_p.named_parameters()):
        scale = float(q.grad.abs().max())
        grad_errs[name] = float((p.grad - q.grad).abs().max()) / max(scale, 1e-30)
    worst = max(grad_errs, key=grad_errs.get)
    print(f"train step kernel vs plain: launches {launches}; loss {loss_k!r} vs {loss_p!r}; gradients: "
          f"largest error {grad_errs[worst]:.3g} of the tensor's max |grad| ({worst}), "
          f"median {statistics.median(grad_errs.values()):.3g} over {len(grad_errs)} tensors")
    require(grad_errs[worst] <= GRAD_TOL, f"gradient of {worst}: {grad_errs[worst]:.3g} > {GRAD_TOL}")
    print("metrics (kernel step): " + json.dumps(metrics_k))

    scatter = scatter_phase(calls)
    del calls, model_p, opt_p, sched_p

    # more steps through the kernels: loss per step, ms per step, the split
    torch.cuda.reset_peak_memory_stats()
    losses, iters = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = train_step(model, opt, sched, batch, 0, cfg)
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t1)
        losses.append(m["loss/overall_loss"])
    losses = [float(v) for v in losses]
    require(all(v == v and abs(v) != float("inf") for v in losses), f"non-finite training losses {losses}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    loss, _ = forward_loss(model, batch, 0, cfg)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    sched.step()
    ev[3].record()
    torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ms = sorted(t * 1e3 for t in iters)
    print(f"train step bs={TRAIN_BATCH}, {NUM_POINTS} pts, through the kernels: losses {losses}; "
          f"{TRAIN_BATCH * len(iters) / sum(iters):.3f} clouds/s, median {statistics.median(ms):.3f} ms/step "
          f"(min {ms[0]:.3f}, max {ms[-1]:.3f} over {len(ms)} steps); split (CUDA events, one more step) "
          f"forward+loss {split[0]:.3f} ms, backward {split[1]:.3f} ms, optimizer {split[2]:.3f} ms; "
          f"peak device memory {peak_gb:.2f} GB ({smi})")
    profile_calls({"train": lambda: train_step(model, opt, sched, batch, 0, cfg)}, calls=2)
    return launches, *scatter, statistics.median(ms)


def bn_phase(smi: str) -> tuple[tuple, float, tuple, dict]:
    """Phase 9's fused BatchNorm + ReLU at BN_SHAPES (see the module
    docstring). Returns its table entries at the largest shape ((ms, plain
    ms, library ms) of forward + backward, the largest error, the bound of
    the op's 8 passes) and every shape's numbers."""
    import torch
    import torch.nn.functional as F

    from graspbalance_tpu_torch.ops.batchnorm import (
        batch_moments,
        bn_act_backward_plain,
        bn_act_train,
        bn_act_train_plain,
    )

    eps, momentum = 1e-5, 0.1
    shapes, worst = {}, 0.0
    for rows, c in BN_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(rows + c)
        x = torch.randn(rows, c, device="cuda", generator=g) * 2 + 1
        dy = torch.randn(rows, c, device="cuda", generator=g)
        w = 1 + 0.1 * torch.randn(c, device="cuda", generator=g)
        b = 0.1 * torch.randn(c, device="cuda", generator=g)
        rm, rv = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")
        fns = {
            "kernel": lambda xg, wg, bg: bn_act_train(xg, wg, bg, rm, rv, momentum, eps, True),
            "plain": lambda xg, wg, bg: bn_act_train_plain(xg, wg, bg, rm, rv, momentum, eps, True),
            "library": lambda xg, wg, bg: torch.relu(F.batch_norm(xg, rm, rv, wg, bg, True, momentum, eps)),
        }

        def step(fn):
            xg, wg, bg = (t.detach().requires_grad_(True) for t in (x, w, b))
            y = fn(xg, wg, bg)
            return (y.detach(), *torch.autograd.grad(y, (xg, wg, bg), dy))

        got, again = step(fns["kernel"]), step(fns["kernel"])
        require(all(torch.equal(u, v) for u, v in zip(got, again)), f"batchnorm kernel not deterministic at {rows, c}")
        require(torch.equal(got[0], step(fns["plain"])[0]), f"batchnorm forward != the plain version's at {rows, c}")
        del again
        want = bn_act_backward_plain(dy.double(), x.double(), w.double(), b.double(), eps, True, mask=got[0] > 0)
        errs = {name: float((u.double() - v).abs().max()) / float(v.abs().max())
                for name, u, v in zip(("dx", "dweight", "dbias"), got[1:], want)}
        del want
        require(max(errs.values()) <= BN_GRAD_TOL, f"batchnorm kernel at {rows, c}: errors {errs}")
        worst = max(worst, *errs.values())
        xg, wg, bg = (t.detach().requires_grad_(True) for t in (x, w, b))
        y = fns["kernel"](xg, wg, bg)
        sq = torch.empty_like(x)
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: fns["kernel"](x, w, b), BN_REPS)
            stats_ms = cuda_ms(lambda: batch_moments(x, None, sq=sq), BN_REPS)
        bwd_ms = cuda_ms(lambda: torch.autograd.grad(y, (xg, wg, bg), dy, retain_graph=True), BN_REPS)
        del y, sq
        ms = {name: cuda_ms(lambda fn=fn: step(fn), BN_REPS) for name, fn in fns.items()}
        pass_ms = rows * c * 4 / PEAK_BYTES_S * 1e3
        kernels_ms = fwd_ms - stats_ms + bwd_ms
        shapes[f"{rows}x{c}"] = {"forward_ms": fwd_ms, "stats_ms": stats_ms, "backward_ms": bwd_ms, "ms": ms["kernel"],
                                 "plain_ms": ms["plain"], "library_ms": ms["library"], "bound_ms": 8 * pass_ms,
                                 "of_bound": ms["kernel"] / (8 * pass_ms), "kernels_ms": kernels_ms,
                                 "kernels_bound_ms": 7 * pass_ms, "kernels_of_bound": kernels_ms / (7 * pass_ms),
                                 "errors": errs}
        print(f"batchnorm + relu ({rows}, {c}): forward {fwd_ms:.4f} ms (its statistics {stats_ms:.4f}), backward "
              f"{bwd_ms:.4f} ms; the kernels {kernels_ms:.4f} ms = {kernels_ms / (7 * pass_ms):.3f} x their bound "
              f"{7 * pass_ms:.4f} ms (bytes, 7 passes); forward + backward {ms['kernel']:.4f} ms = "
              f"{ms['kernel'] / (8 * pass_ms):.3f} x the op's bound {8 * pass_ms:.4f} ms (8 passes); plain "
              f"{ms['plain']:.4f} ms, F.batch_norm + relu {ms['library']:.4f} ms (CUDA events); forward bit-equal "
              f"to the plain version's, backward errors {errs}; two launches bit-equal ({smi})")
        del x, dy, got, xg, wg, bg
        torch.cuda.empty_cache()
    top = shapes[f"{BN_SHAPES[0][0]}x{BN_SHAPES[0][1]}"]
    return (top["ms"], top["plain_ms"], top["library_ms"]), worst, (top["bound_ms"], "bytes"), shapes


def stream_phase(dev, smi: str) -> dict:
    """Phase 19a: K1 and K4 in the streaming mode, exact against their
    plain versions, timed. Returns {name: {N: ms}} at STREAM_TIMED_M slots."""
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.ops.fps import (
        CLUSTER_MAX_POINTS,
        MASKED_BLOCK_MAX_POINTS,
        furthest_point_sample,
        furthest_point_sample_masked,
        furthest_point_sample_masked_plain,
        furthest_point_sample_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {"fps": {}, "fps_masked": {}}
    for b, n, m in STREAM_SIZES:
        require(n > CLUSTER_MAX_POINTS and n > MASKED_BLOCK_MAX_POINTS, "stream sizes must pass the register routes")
        # a scene-sized box, with near-origin points that are never picked
        xyz = (torch.rand((b, n, 3), generator=gen, device=dev) - 0.5) * torch.tensor([1.0, 1.0, 0.5], device=dev)
        xyz[:, 7::9973] = 0.001
        _build.reset_launches()
        got = furthest_point_sample(xyz, m)
        require(_build.launches["fps"] == 1, f"FPS at N={n}: launches {dict(_build.launches)}")
        want = furthest_point_sample_plain(xyz, m)
        require(torch.equal(got, want), f"FPS streaming kernel != plain at N={n}: {int((got != want).sum())} differ")
        out["fps"][n] = cuda_ms(lambda: furthest_point_sample(xyz, STREAM_TIMED_M), 3)
        rows = 4 * b  # each cloud under four masks
        mxyz = xyz.repeat_interleave(4, dim=0).contiguous()
        valid = torch.rand((rows, n), generator=gen, device=dev) < 0.5
        valid[0] = False  # a row with no valid point: 0 everywhere
        valid[1, : n // 2] = False  # the seed is the first valid index
        valid[2] = True
        _build.reset_launches()
        needed = torch.tensor(m - 8, dtype=torch.int32, device=dev)
        got = furthest_point_sample_masked(mxyz, valid, m, max_needed=needed)
        require(_build.launches["fps_masked"] == 1, f"masked FPS at N={n}: launches {dict(_build.launches)}")
        want = furthest_point_sample_masked_plain(mxyz, valid, m - 8)
        require(torch.equal(got[:, : m - 8], want) and bool((got[:, m - 8 :] == 0).all()),
                f"masked FPS streaming kernel != plain at N={n}: {int((got[:, : m - 8] != want).sum())} differ")
        out["fps_masked"][n] = cuda_ms(lambda: furthest_point_sample_masked(mxyz, valid, STREAM_TIMED_M), 3)
        # each step updates every (valid) point: 10 operations; the inputs
        # read once, the slots written once
        steps = STREAM_TIMED_M - 1
        k1 = bound(xyz.numel() * 4 + b * STREAM_TIMED_M * 4, steps * b * n * 10)
        k4 = bound(mxyz.numel() * 4 + valid.numel() + rows * STREAM_TIMED_M * 4, steps * float(valid.sum()) * 10)
        print(f"FPS streaming mode, ({b}, {n}, 3) -> {m}: exact; ({rows} masked rows) -> {m}, max_needed {m - 8}: "
              f"exact; at {STREAM_TIMED_M} slots {out['fps'][n]:.4f} ms "
              f"({out['fps'][n] / steps * 1e3:.3f} us per step; bound {k1[0]:.5f} ms, {k1[1]}), masked "
              f"{out['fps_masked'][n]:.4f} ms ({out['fps_masked'][n] / steps * 1e3:.3f} us per step; bound "
              f"{k4[0]:.5f} ms, {k4[1]}) ({smi})")
        del xyz, mxyz, valid
    return out


def pointnet2_phase(dev, smi: str, cloud, dsn) -> tuple[dict, dict]:
    """Phase 19 (see the module docstring): the PointNet++ SSG model and
    the default model's variants at full width. Returns (path launches,
    the streaming and many-combo times)."""
    import tempfile

    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.cli import train as cli
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.eval.pipeline import GraspInference
    from graspbalance_tpu_torch.models import GraspBalance, pred_decode
    from graspbalance_tpu_torch.ops.multicyl import multi_cylinder_group, multi_cylinder_group_plain
    from graspbalance_tpu_torch.ops.scatter import scatter_add_plain
    from graspbalance_tpu_torch.train.config import Config, ModelConfig
    from graspbalance_tpu_torch.train.train_step import build_model, make_optimizer, to_device, train_step
    from graspbalance_tpu_torch.weights import init_random_

    extra = {"stream": stream_phase(dev, smi)}
    launches = {}

    def eval_path(name, model):
        """Forward + decode through the kernels (PATH_KERNELS[name]
        launched), against the plain versions as phase 4."""
        torch.cuda.synchronize()
        _build.reset_launches()
        with torch.no_grad():
            ep = model(cloud)
            grasps, valid = pred_decode(ep)
            torch.cuda.synchronize()
            launches[name] = dict(_build.launches)
            require(all(launches[name][k] > 0 for k in PATH_KERNELS[name]),
                    f"{name}: a kernel of the path was not launched: {launches[name]}")
            ep_p = model(cloud, plain=True)
            grasps_p, valid_p = pred_decode(ep_p)
        a, d = model.grasp_params.num_angle, model.grasp_params.num_depth
        require(ep["grasp_score_pred"].shape == (BATCH, model.backbone.num_seed, a, d), f"{name}: head shapes")
        print(f"{name} forward+decode: launches {launches[name]}; kernel vs plain: "
              + compare_decoded(ep, ep_p, grasps, grasps_p, valid, valid_p, name))
        return ep

    # 19b. the PointNet++ SSG model: forward + decode, timed, and profiled
    p2 = init_random_(GraspBalance(backbone="pointnet2"), SEED).to(dev).eval()
    ep = eval_path("p2_main", p2)
    iters = []
    with torch.no_grad():
        for _ in range(MAIN_ITERS + 1):
            t1 = time.perf_counter()
            pred_decode(p2(cloud))
            torch.cuda.synchronize()
            iters.append(time.perf_counter() - t1)
    print(f"pointnet2 forward+decode bs={BATCH}, {NUM_POINTS} pts: {rate_line(iters[1:])} ({smi})")

    # 19c. the cylinder query past 16 combos, on this model's seeds and rotations
    wg = p2.width_grouping
    seeds, rot = ep["fp2_xyz"].contiguous(), ep["grasp_top_view_rot"].contiguous()
    extra["multicyl"] = {}
    for n_combo, hmaxs in MANY_COMBOS.items():
        qargs = (cloud, seeds, rot, wg.radii, wg.hmin, hmaxs, wg.nsample)
        _build.reset_launches()
        idx_k, rel_k = multi_cylinder_group(*qargs, emit_rel=True)
        idx_p, rel_p = multi_cylinder_group_plain(*qargs, emit_rel=True)
        require(_build.launches["multicyl"] == 1 and idx_k.shape[1] * idx_k.shape[2] == n_combo,
                f"query at {n_combo} combos: launches {dict(_build.launches)}, shape {tuple(idx_k.shape)}")
        require(torch.equal(idx_k, idx_p) and torch.equal(rel_k, rel_p),
                f"query kernel != plain at {n_combo} combos: {int((idx_k != idx_p).sum())} indices differ")
        extra["multicyl"][n_combo] = (cuda_ms(lambda: multi_cylinder_group(*qargs), 5),
                                      cuda_ms(lambda: multi_cylinder_group_plain(*qargs), 1))
        print(f"query at {n_combo} combos {tuple(idx_k.shape)}: idx and rel bit-equal to the plain version; "
              f"{extra['multicyl'][n_combo][0]:.4f} ms indices only, plain {extra['multicyl'][n_combo][1]:.4f} ms "
              f"({smi})")
        del idx_k, rel_k, idx_p, rel_p

    # 19d. GraspInference without and with OBS, timed
    pipelines = {"p2_no_obs": GraspInference(p2), "p2_obs": GraspInference(p2, dsn, use_obs=True)}
    for name, infer in pipelines.items():
        launches[name] = check_pipeline(name, infer, cloud)
        iters = []
        for _ in range(PIPELINE_ITERS + 1):
            t1 = time.perf_counter()
            infer(cloud)
            iters.append(time.perf_counter() - t1)
        print(f"pointnet2 GraspInference {name} bs={BATCH}, {NUM_POINTS} pts: {rate_line(iters[1:])} ({smi})")
    with torch.no_grad():
        profile_calls({"p2_forward_decode": lambda: pred_decode(p2(cloud)),
                       **{name: functools.partial(infer, cloud) for name, infer in pipelines.items()}})

    # 19e. the fused configuration: the mlp-max kernel on the SA stages
    fused = GraspBalance(backbone="pointnet2", fused_backbone_min_nsample=0, width_impl="fused_pallas")
    fused.load_state_dict(p2.state_dict(), strict=True)
    fused = fused.to(dev).eval()
    eval_path("p2_fused_main", fused)
    require(launches["p2_fused_main"]["mlpmax"] == len(fused.backbone.stages),
            f"fused pointnet2: one mlp-max launch per SA stage, got {launches['p2_fused_main']}")
    launches["p2_fused_obs"] = check_pipeline("p2_fused_obs", GraspInference(fused, dsn, use_obs=True), cloud)
    del fused

    # 19f. training: one step through the kernels against one through the
    # plain versions from the same state, then cli/train --backbone pointnet2
    cfg = Config(model=ModelConfig(backbone="pointnet2"))
    # on the card before the steps, as phase 9's batch: the steps time the
    # step, not the labels' upload
    batch = to_device(make_batch(SEED, TRAIN_BATCH, SceneConfig(num_points=NUM_POINTS, static_labels=True)), dev)
    model = init_random_(build_model(cfg, device=dev), SEED)
    model_p = copy.deepcopy(model)
    (opt, sched), (opt_p, sched_p) = make_optimizer(model, cfg, STEPS_PER_EPOCH), make_optimizer(
        model_p, cfg, STEPS_PER_EPOCH)
    torch.cuda.synchronize()
    _build.reset_launches()
    loss_k = float(train_step(model, opt, sched, batch, 0, cfg)["loss/overall_loss"])
    torch.cuda.synchronize()
    step_launches = dict(_build.launches)
    require(all(step_launches[k] > 0 for k in PATH_KERNELS["p2_train"]),
            f"pointnet2 training step: launches {step_launches}")
    with gather_backward(scatter_add_plain):
        loss_p = float(train_step(model_p, opt_p, sched_p, batch, 0, cfg, plain=True)["loss/overall_loss"])
    require(abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p), f"pointnet2 training loss: kernel {loss_k} vs plain {loss_p}")
    grad_errs = {name: float((p.grad - q.grad).abs().max()) / max(float(q.grad.abs().max()), 1e-30)
                 for (name, p), (_, q) in zip(model.named_parameters(), model_p.named_parameters())}
    worst = max(grad_errs, key=grad_errs.get)
    require(grad_errs[worst] <= GRAD_TOL, f"pointnet2 gradient of {worst}: {grad_errs[worst]:.3g} > {GRAD_TOL}")
    print(f"pointnet2 train step kernel vs plain: launches {step_launches}; loss {loss_k!r} vs {loss_p!r}; "
          f"gradients: largest error {grad_errs[worst]:.3g} of the tensor's max |grad| ({worst})")
    del model_p, opt_p, sched_p
    torch.cuda.reset_peak_memory_stats()
    iters = []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        train_step(model, opt, sched, batch, 0, cfg)
        torch.cuda.synchronize()
        iters.append((time.perf_counter() - t1) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    extra["p2_step"] = (statistics.median(iters), peak_gb)
    print(f"pointnet2 train step bs={TRAIN_BATCH}, {NUM_POINTS} pts, through the kernels: median "
          f"{extra['p2_step'][0]:.3f} ms/step (min {min(iters):.3f}, max {max(iters):.3f} over {len(iters)} steps); "
          f"peak device memory {peak_gb:.2f} GB ({smi})")
    profile_calls({"p2_train": lambda: train_step(model, opt, sched, batch, 0, cfg)}, calls=2)
    del model, opt, sched, batch

    root = tempfile.mkdtemp(prefix="gb_p2_")
    argv = ["--backbone", "pointnet2", "--max_epoch", "1", "--synthetic_steps", str(P2_TRAIN_STEPS), "--batch_size",
            str(TRAIN_BATCH), "--num_point", str(NUM_POINTS), "--device", str(dev), "--log_dir", root]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    cli.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches["p2_train"] = dict(_build.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(all(launches["p2_train"][k] > 0 for k in PATH_KERNELS["p2_train"])
            and launches["p2_train"]["fps"] == P2_TRAIN_STEPS,
            f"cli/train --backbone pointnet2: launches {launches['p2_train']} over {P2_TRAIN_STEPS} steps")
    rec = read_jsonl(f"{root}/loop_metrics.jsonl")[-1]
    lines = read_jsonl(f"{root}/train_metrics.jsonl")
    require(all(all_finite(v for k, v in r.items() if k != "time") for r in lines), f"train metric lines {lines}")
    print(f"pointnet2 training (cli/train --backbone pointnet2, bs={TRAIN_BATCH}, {P2_TRAIN_STEPS} steps, "
          f"{NUM_POINTS} pts): launches {launches['p2_train']}; {rec['loop/ms_per_step']:.3f} ms/step (the epoch's "
          f"steps, first included; host clock); {cli_s:.1f} s in all; loss {lines[-1]['loss/overall_loss']!r}; peak "
          f"device memory {peak_gb:.2f} GB ({smi})")
    extra["p2_train"] = (rec["loop/ms_per_step"], peak_gb)

    # 19g. the default model's variants, eval at full width
    for name, kw in (("single_scale", dict(multi_scale=False)),
                     ("depth5", dict(num_depth=5, hmax_list=MANY_COMBOS[20])),
                     ("nearest", dict(query_order="nearest"))):
        eval_path(name, init_random_(GraspBalance(**kw), SEED).to(dev).eval())
        if name == "nearest":
            require(launches[name]["multicyl"] == 0, f"nearest: the index-order query kernel ran: {launches[name]}")

    launches.update(knn_callers_phase(dev, cloud, dsn))
    return launches, extra


def knn_callers_phase(dev, cloud, dsn) -> dict:
    """Phase 19h: K9's other callers, the bfloat16 DSN (phase 6's weights)
    and LocalAggregation(grouper='knn') at DRP stages 2 and 3's widths, each
    through the kernels against its plain versions (the kNN on float32
    coordinates either way: indices exact, so the rest runs the same ops).
    Returns the launches of each."""
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.models.drp import LocalAggregation
    from graspbalance_tpu_torch.models.dsn import DSN

    out = {}
    dsn_bf16 = DSN(dtype=torch.bfloat16)
    dsn_bf16.load_state_dict(dsn.state_dict(), strict=True)
    dsn_bf16 = dsn_bf16.to(dev).eval()
    torch.cuda.synchronize()
    _build.reset_launches()
    out_k = dsn_bf16(cloud)
    torch.cuda.synchronize()
    out["dsn_bf16"] = dict(_build.launches)
    require(all(out["dsn_bf16"][k] > 0 for k in PATH_KERNELS["dsn_bf16"]),
            f"bf16 DSN: a kernel of the path was not launched: {out['dsn_bf16']}")
    out_p = dsn_bf16(cloud, plain=True)
    errs = {}
    for key in ("seed_xyz", "foreground_logits", "center_offsets"):
        errs[key], top = float((out_k[key] - out_p[key]).abs().max()), float(out_p[key].abs().max())
        require(out_k[key].shape == out_p[key].shape and bool(torch.isfinite(out_k[key]).all())
                and errs[key] <= BF16_DSN_RTOL * top, f"bf16 DSN {key}: kernel vs plain {errs[key]} of max {top}")
    print(f"bf16 DSN forward bs={BATCH}, {NUM_POINTS} pts: launches {out['dsn_bf16']}; kernel vs plain max "
          f"errors {errs}")
    del dsn_bf16, out_k, out_p
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out["knn_grouper"] = dict.fromkeys(_build.launches, 0)
    for npoint, channels, nsample in KNN_GROUPER_STAGES:
        xyz = cloud[:, :npoint].contiguous()
        feats = torch.randn((BATCH, npoint, channels), generator=gen, device=dev)
        for feature_type in ("dp_fj", "dp_fj_df"):
            torch.manual_seed(SEED)
            la = LocalAggregation(channels, 0.0, nsample, grouper="knn", feature_type=feature_type).to(dev).eval()
            with torch.no_grad():
                _build.reset_launches()
                f_k = la(xyz, feats)
                torch.cuda.synchronize()
                require(_build.launches["knn"] == 1, f"knn grouper: launches {dict(_build.launches)}")
                for k, v in _build.launches.items():
                    out["knn_grouper"][k] += v
                f_p = la(xyz, feats, plain=True)
            err, top = float((f_k - f_p).abs().max()), float(f_p.abs().max())
            require(err <= KNN_GROUPER_RTOL * top, f"knn grouper {feature_type} at K={nsample}: {err} of max {top}")
            print(f"LocalAggregation(grouper='knn', {feature_type}) on ({BATCH}, {npoint}, {channels}), K={nsample}: "
                  f"kernel vs plain max err {err!r} of max {top!r}")
    return out


def read_jsonl(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f]


def all_finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def loop_phase(dev, smi: str, step_ms: float) -> dict:
    """Phase 15 (see the module docstring). Returns the launch counts of the
    resumed run: one epoch of training steps and its eval pass."""
    import dataclasses
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.cli import train as cli
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.labels.analytic import analytic_label_tensors, expand_batch_labels
    from graspbalance_tpu_torch.labels.geometry import GRASP_MAX_WIDTH
    from graspbalance_tpu_torch.train import loop
    from graspbalance_tpu_torch.train.checkpoints import load_config, load_inference_variables
    from graspbalance_tpu_torch.train.config import Config
    from graspbalance_tpu_torch.train.train_step import create_train_state, eval_step, train_step

    root = tempfile.mkdtemp(prefix="gb_loop_")
    scene = SceneConfig(num_points=NUM_POINTS, static_labels=True)  # the CLI's default stream
    argv = ["--max_epoch", "2", "--synthetic_steps", str(LOOP_STEPS), "--batch_size", str(TRAIN_BATCH),
            "--num_point", str(NUM_POINTS), "--device", str(dev)]
    try:
        # the CLI, 2 epochs straight through
        cfg = cli.config_from_args(cli.parse_args(argv + ["--log_dir", f"{root}/cli"]))
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        cli.main(argv + ["--log_dir", f"{root}/cli"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_launches = dict(_build.launches)
        steps = 2 * LOOP_STEPS
        require(all(cli_launches[k] > 0 for k in PATH_KERNELS["train"]) and cli_launches["widthmlp"] == 0,
                f"loop training steps: launches {cli_launches}; needs fps, multicyl, scatter > 0 and widthmlp == 0")
        require(cli_launches["fps"] == cli_launches["multicyl"] == steps and cli_launches["scatter"] % steps == 0,
                f"loop training steps: launches {cli_launches} over {steps} steps")
        lines = read_jsonl(f"{root}/cli/train_metrics.jsonl")  # log_every 10 > the epoch: one window an epoch
        require([r["step"] for r in lines] == [LOOP_STEPS, steps], f"train metric lines at {[r['step'] for r in lines]}")
        require(all(len(r) == len(lines[0]) and all_finite(v for k, v in r.items() if k != "time") for r in lines),
                f"train metric lines: keys or values wrong: {lines}")
        ckpt = f"{root}/cli/checkpoints"
        saved = sorted(n for n in os.listdir(ckpt) if n.endswith(".pt"))
        require(saved == [f"step_{LOOP_STEPS}.pt", f"step_{steps}.pt"], f"checkpoints {saved}")
        with open(f"{ckpt}/best.json") as f:
            best = json.load(f)
        best_line = min(lines, key=lambda r: r["loss/overall_loss"])
        require(best["step"] == best_line["step"] and best["loss"] == best_line["loss/overall_loss"],
                f"best.json {best} against the epoch losses {[(r['step'], r['loss/overall_loss']) for r in lines]}")
        require(load_config(ckpt) == cfg, "config.json differs from the CLI's config")
        records = read_jsonl(f"{root}/cli/loop_metrics.jsonl")
        require(len(records) == 2, f"loop telemetry records {records}")
        rec = records[1]
        uploads = {k.split("/")[-1]: int(v) for k, v in rec.items() if k.startswith("loop/uploads/")}
        label_uploads = {k: int(records[0].get(f"loop/uploads/{k}", 0)) for k in ("grasp_labels", "grasp_widths",
                                                                                 "grasp_tolerance")}
        print(f"loop (cli/train.main, bs={TRAIN_BATCH}, 2 epochs x {LOOP_STEPS} steps, static labels): launches "
              f"{cli_launches}; {cli_s:.1f} s in all; logged epoch losses "
              f"{[r['loss/overall_loss'] for r in lines]}; checkpoints {saved}, best.json {best}")
        print(f"loop epoch 2: {rec['loop/ms_per_step']:.3f} ms/step (host clock, synchronised at the epoch's end) "
              f"against phase 9's median step {step_ms:.3f} ms ({rec['loop/ms_per_step'] / step_ms:.3f}x); "
              f"waiting on the prefetch queue {rec['loop/prefetch_wait_share']:.4f} of it; uploads by key "
              f"{uploads}, {rec['loop/uploaded_bytes'] / LOOP_STEPS / 1e6:.3f} MB a step (epoch 1: label tensors "
              f"uploaded {label_uploads}, {records[0]['loop/uploaded_bytes'] / 1e9:.3f} GB); checkpoint save "
              f"{rec['loop/checkpoint_ms']:.1f} ms, {rec['loop/checkpoint_bytes'] / 1e6:.1f} MB ({smi})")
        require(all(label_uploads[k] == 1 for k in label_uploads) and not set(label_uploads) & set(uploads),
                f"static label tensors uploaded {label_uploads} in epoch 1 and {uploads} in epoch 2")

        # the same run stopped after epoch 1, then resumed with an eval stream
        def batches(epoch):
            for i in range(LOOP_STEPS):
                yield make_batch(epoch * LOOP_STEPS + i, TRAIN_BATCH, scene)

        def evals():
            return (make_batch(1000 + i, TRAIN_BATCH, scene) for i in range(LOOP_EVAL_BATCHES))

        rcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log_dir=f"{root}/res"))
        loop.train(dataclasses.replace(rcfg, train=dataclasses.replace(rcfg.train, stop_after_epochs=1)), batches,
                   steps_per_epoch=LOOP_STEPS, device=dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        res = loop.train(rcfg, batches, evals, steps_per_epoch=LOOP_STEPS, device=dev)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        forwards = LOOP_STEPS + LOOP_EVAL_BATCHES
        per_step = cli_launches["scatter"] // steps
        require(launches["fps"] == launches["multicyl"] == forwards and launches["widthmlp"] == LOOP_EVAL_BATCHES
                and launches["scatter"] == per_step * LOOP_STEPS,
                f"resumed loop: launches {launches}; needs fps and multicyl {forwards} (train and eval steps), "
                f"widthmlp {LOOP_EVAL_BATCHES} (eval steps), scatter {per_step * LOOP_STEPS} (train steps)")
        res_lines = read_jsonl(f"{root}/res/train_metrics.jsonl")
        test_lines = read_jsonl(f"{root}/res/test_metrics.jsonl")
        require([r["step"] for r in test_lines] == [steps] and all_finite(
            v for k, v in test_lines[0].items() if k != "time"), f"eval metric lines {test_lines}")
        a, full_step = load_inference_variables(ckpt, map_location=dev)  # the CLI run's last checkpoint
        b = res.model.state_dict()
        diffs = {k: float((a[k] - b[k]).abs().max()) for k in a}
        worst = max(diffs, key=diffs.get)
        bit_equal = all(torch.equal(a[k], b[k]) for k in a)
        print(f"resume: launches {launches}; logged losses {[r['loss/overall_loss'] for r in res_lines]} "
              f"(straight through {[r['loss/overall_loss'] for r in lines]}); eval "
              f"{test_lines[0]['loss/overall_loss']!r}; final parameters and BatchNorm statistics against the run "
              f"straight through: bit-equal {bit_equal}, max abs difference {diffs[worst]:.3g} ({worst})")
        require(res.step == full_step == steps, f"steps {res.step}, {full_step}")
        require(bit_equal, f"resumed run differs from the run straight through: {diffs[worst]:.3g} at {worst}")

        # the eval step through the kernels and through the plain versions
        eb = make_batch(1000, TRAIN_BATCH, scene)
        m_k = {k: float(v) for k, v in eval_step(res.model, eb, rcfg).items()}
        m_p = {k: float(v) for k, v in eval_step(res.model, eb, rcfg, plain=True).items()}
        bad = {k: (m_k[k], m_p[k]) for k in m_p if abs(m_k[k] - m_p[k]) > LOSS_RTOL * abs(m_p[k])}
        print(f"eval step kernel vs plain: loss {m_k['loss/overall_loss']!r} vs {m_p['loss/overall_loss']!r}; "
              f"largest relative gap {max(abs(m_k[k] - m_p[k]) / max(abs(m_p[k]), 1e-30) for k in m_p):.3g}")
        require(all_finite(m_k.values()) and not bad, f"eval metrics beyond {LOSS_RTOL}: {bad}")
        del res, a, b

        # the loop against the bare step, alternating in this process: each
        # round resumes the loop for one epoch (its own ms/step record), then
        # runs the same epoch's batches, uploaded beforehand, through
        # train_step back to back on a second state (host clock, the card
        # synchronised at the end, as the loop's record); round 0 uploads
        # the static labels and is left out of the ratio
        acfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log_dir=f"{root}/alt",
                                                                  max_epoch=LOOP_ALT_ROUNDS))
        cache = loop.TransferCache(dev)
        bstate = create_train_state(cfg, LOOP_STEPS, cache.put(make_batch(0, TRAIN_BATCH, scene)), device=dev)
        loop_ms, bare_ms = [], []
        for r in range(LOOP_ALT_ROUNDS):
            loop.train(dataclasses.replace(acfg, train=dataclasses.replace(acfg.train, stop_after_epochs=r + 1)),
                       batches, steps_per_epoch=LOOP_STEPS, device=dev)
            loop_ms.append(read_jsonl(f"{root}/alt/loop_metrics.jsonl")[-1]["loop/ms_per_step"])
            bare = [cache.put(b) for b in batches(r)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for step_batch in bare:
                train_step(bstate.model, bstate.optimizer, bstate.scheduler, step_batch, r, cfg)
            torch.cuda.synchronize()
            bare_ms.append((time.perf_counter() - t0) * 1e3 / LOOP_STEPS)
            del bare, step_batch  # the last batch holds the static labels on the card
        ratios = [lm / bm for lm, bm in zip(loop_ms[1:], bare_ms[1:])]
        print(f"loop against the bare step, alternating, {LOOP_ALT_ROUNDS} rounds of {LOOP_STEPS} steps: loop "
              f"ms/step {loop_ms}, bare ms/step {bare_ms}; rounds 1-{LOOP_ALT_ROUNDS - 1} loop / bare {ratios}, "
              f"median {statistics.median(ratios):.4f} ({smi})")
        del bstate, cache

        # --synthetic_analytic: the labels expanded on the card
        cli.main(["--max_epoch", "1", "--synthetic_steps", str(LOOP_ANALYTIC_STEPS), "--synthetic_analytic",
                  "--batch_size", str(TRAIN_BATCH), "--num_point", str(NUM_POINTS), "--device", str(dev),
                  "--log_dir", f"{root}/analytic"])
        a_lines = read_jsonl(f"{root}/analytic/train_metrics.jsonl")
        a_rec = read_jsonl(f"{root}/analytic/loop_metrics.jsonl")[0]
        require(all_finite(a_lines[0][k] for k in a_lines[0] if k != "time") and "loop/uploads/grasp_labels" not in a_rec,
                f"analytic run: {a_lines}, {a_rec}")
        ab = make_batch(0, TRAIN_BATCH, SceneConfig(num_points=NUM_POINTS, analytic_labels=True,
                                                    emit_label_tensors=False))
        geo = ("obj_sizes", "grasp_pt_obj", "grasp_pt_mask")
        got = expand_batch_labels({k: torch.from_numpy(ab[k]).to(dev) for k in geo}, 300, 12, 4)
        edge = np.float32(GRASP_MAX_WIDTH)
        n_boundary = n_differ = 0
        for i in range(TRAIN_BATCH):
            host = analytic_label_tensors(*(ab[k][i] for k in geo), 300, 12, 4)
            boundary = np.abs(host[1] - edge) <= np.spacing(edge)
            n_boundary += int(boundary.sum())
            for key, want in zip(("grasp_labels", "grasp_widths", "grasp_tolerance"), host):
                differ = got[key][i].cpu().numpy() != want
                n_differ += int(differ.sum())
                require(not (differ & ~boundary).any(), f"analytic {key}: the card differs from the host off the "
                                                        f"width boundary at {int((differ & ~boundary).sum())} elements")
        del got
        print(f"analytic labels ({TRAIN_BATCH} x {tuple(ab['grasp_pt_obj'].shape[1:])} points x 300 x 12 x 4): loss "
              f"{a_lines[0]['loss/overall_loss']!r}; card against host: {n_differ} elements differ, {n_boundary} "
              f"elements have a width within an ulp of GRASP_MAX_WIDTH")

        # the peak memory of one training step at bs=2, 4 and (when it fits) 8
        def one_step(bs: int):
            cfg_i = Config()
            batch = loop.TransferCache(dev).put(make_batch(7, bs, scene))
            state = create_train_state(cfg_i, LOOP_STEPS, batch, device=dev)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            metrics = train_step(state.model, state.optimizer, state.scheduler, batch, 0, cfg_i)
            require(all_finite(float(v) for v in metrics.values()), f"bs={bs}: non-finite metrics {metrics}")
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            del state, batch, metrics
            torch.cuda.empty_cache()
            print(f"peak max_memory_allocated of one training step at bs={bs}: {peak / 1e9:.3f} GB, "
                  f"{(peak - resident) / 1e9:.3f} GB above what was resident before the step ({smi})")
            return peak / 1e9

        p2, p4 = one_step(TRAIN_BATCH), one_step(2 * TRAIN_BATCH)
        est8 = p4 + (p4 - p2) * (4 * TRAIN_BATCH - 2 * TRAIN_BATCH) / (2 * TRAIN_BATCH - TRAIN_BATCH)
        print(f"bs={4 * TRAIN_BATCH} peak extrapolated from bs={TRAIN_BATCH} and {2 * TRAIN_BATCH}: {est8:.3f} GB")
        if est8 < PEAK_LIMIT_GB:
            one_step(4 * TRAIN_BATCH)
        else:
            print(f"bs={4 * TRAIN_BATCH} not run: extrapolated peak {est8:.3f} GB >= {PEAK_LIMIT_GB}")
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def gate_phase(dev, smi: str) -> dict:
    """Phase 16 (see the module docstring). Returns the launch counts of
    the oracle, of one bfloat16 training step and of the short gate, by
    path."""
    import dataclasses

    import numpy as np
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.cli.quality_gate import GATE_SEED0, gate_scene, run_gate
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.eval.quality import evaluate_oracle_quality, oracle_keep
    from graspbalance_tpu_torch.ops.scatter import scatter_add_plain
    from graspbalance_tpu_torch.train.config import Config, ModelConfig
    from graspbalance_tpu_torch.train.train_step import build_model, forward_loss, make_optimizer, to_device, train_step
    from graspbalance_tpu_torch.weights import init_random_

    out = {}
    # the oracle on the gate's held-out scenes: the collision kernel against
    # its plain version, then against the JAX package's numbers
    scene = gate_scene(NUM_POINTS)
    kw = dict(num_batches=GATE_EVAL_BATCHES, batch_size=BATCH, seed0=GATE_SEED0, device=dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    oracle = evaluate_oracle_quality(scene, **kw)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    out["oracle"] = dict(_build.launches)
    require(out["oracle"]["collision"] == GATE_EVAL_BATCHES, f"oracle: launches {out['oracle']}")
    oracle_p = evaluate_oracle_quality(scene, plain=True, **kw)
    require(oracle == oracle_p, f"oracle: kernel {oracle} against plain {oracle_p}")
    kept = 0
    for i in range(GATE_EVAL_BATCHES):
        batch = make_batch(GATE_SEED0 + i, BATCH, scene)
        _, keep = oracle_keep(batch, device=dev)
        _, keep_p = oracle_keep(batch, device=dev, plain=True)
        require(np.array_equal(keep, keep_p), f"oracle batch {i}: keep masks differ at {np.argwhere(keep != keep_p)}")
        kept += int(keep.sum())
    gaps = {k: oracle[k] - JAX_ORACLE[k] for k in JAX_ORACLE}
    print(f"oracle, {GATE_EVAL_BATCHES} x {BATCH} scenes from seed {GATE_SEED0}: {json.dumps(oracle)} "
          f"({oracle_s:.1f} s; launches {out['oracle']}); keep masks of the kernel equal to the plain version's "
          f"({kept} kept); against the JAX package's oracle (TPU v5e, QUALITY_GATE_MIXED_r05.json) "
          f"{json.dumps(JAX_ORACLE)}: differences {json.dumps(gaps)}")
    for key in ("quality_mean", "ap_analytic"):
        require(abs(gaps[key]) <= ORACLE_TOL, f"oracle {key}: {oracle[key]} against the JAX package's "
                f"{JAX_ORACLE[key]} (tolerance {ORACLE_TOL})")

    # the training step in bfloat16, through the kernels and the plain
    # versions, from the same state; the float32 step beside it
    cfg16 = Config(model=ModelConfig(dtype="bfloat16"))
    cfg32 = Config()
    batch = to_device(make_batch(SEED, TRAIN_BATCH, SceneConfig(num_points=NUM_POINTS)), dev)
    models = {"bf16": init_random_(build_model(cfg16, device=dev), SEED)}
    models["bf16_plain"] = copy.deepcopy(models["bf16"])
    models["f32"] = init_random_(build_model(cfg32, device=dev), SEED)
    cfgs = {"bf16": cfg16, "bf16_plain": cfg16, "f32": cfg32}
    opts = {k: make_optimizer(m, cfgs[k], STEPS_PER_EPOCH) for k, m in models.items()}
    torch.cuda.synchronize()
    _build.reset_launches()
    m16 = {k: float(v) for k, v in train_step(models["bf16"], *opts["bf16"], batch, 0, cfg16).items()}
    torch.cuda.synchronize()
    out["train_bf16"] = dict(_build.launches)
    require(all(out["train_bf16"][k] > 0 for k in PATH_KERNELS["train_bf16"]) and out["train_bf16"]["widthmlp"] == 0,
            f"bf16 training step: launches {out['train_bf16']}; needs fps, multicyl, scatter > 0 and widthmlp == 0")
    with gather_backward(scatter_add_plain):
        m16p = {k: float(v) for k, v in
                train_step(models["bf16_plain"], *opts["bf16_plain"], batch, 0, cfg16, plain=True).items()}
    m32 = {k: float(v) for k, v in train_step(models["f32"], *opts["f32"], batch, 0, cfg32).items()}
    for name, metrics in (("kernel", m16), ("plain", m16p), ("float32", m32)):
        require(all_finite(metrics.values()), f"bf16 phase, {name} step: non-finite metrics {metrics}")
    loss_k, loss_p, loss_32 = m16["loss/overall_loss"], m16p["loss/overall_loss"], m32["loss/overall_loss"]
    require(abs(loss_k - loss_p) <= BF16_LOSS_RTOL * abs(loss_p), f"bf16 loss: kernel {loss_k} vs plain {loss_p}")
    cosines = {}
    for (name, p), (_, q) in zip(models["bf16"].named_parameters(), models["bf16_plain"].named_parameters()):
        a, b = p.grad.double().flatten(), q.grad.double().flatten()
        cosines[name] = float(a @ b / (a.norm() * b.norm()).clamp_min(1e-30))
    # biases whose gradient is 0 in exact arithmetic (a train-mode BatchNorm
    # follows them): rounding noise on both sides, printed apart
    noise = {k: cosines.pop(k) for k in ZERO_GRADIENT}
    worst = min(cosines, key=cosines.get)
    require(cosines[worst] >= BF16_GRAD_COS, f"bf16 gradient of {worst}: cosine {cosines[worst]:.5f}")
    m = models["bf16"]
    kinds = {t.dtype for t in m.state_dict().values()}
    kinds |= {v.dtype for st in opts["bf16"][0].state.values() for k, v in st.items() if k != "step"}
    require(kinds == {torch.float32}, f"bf16 step: parameters, statistics or Adam moments in {kinds}")
    print(f"train step bf16 bs={TRAIN_BATCH} kernel vs plain: launches {out['train_bf16']}; loss {loss_k!r} vs "
          f"{loss_p!r}; gradient cosines: smallest {cosines[worst]:.6f} ({worst}), median "
          f"{statistics.median(cosines.values()):.6f} (the zero-gradient biases, noise: "
          f"{min(noise.values()):.3f}-{max(noise.values()):.3f}); state float32; the float32 step's loss from the same state "
          f"{loss_32!r} (bf16 - f32 {loss_k - loss_32:+.5f})")
    del models["bf16_plain"], opts["bf16_plain"]

    # cuBLAS's reduced-precision (bfloat16) split-K reduction, on and off,
    # from the same state (the step keeps it off)
    probe = copy.deepcopy(models["bf16"])
    flag = {}
    for on in (False, True, False, True):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = on
        with torch.no_grad():
            loss = forward_loss(probe, batch, 0, cfg16)[0]
        flag.setdefault(on, []).append(float(loss))
        probe.load_state_dict(models["bf16"].state_dict())
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"bf16 loss with cuBLAS's reduced-precision reduction off {flag[False]}, on {flag[True]}")
    del probe

    # the two dtypes' steps, alternating
    iters = {"bf16": [], "f32": []}
    for _ in range(TRAIN_STEPS):
        for k in iters:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            loss = train_step(models[k], *opts[k], batch, 0, cfgs[k])["loss/overall_loss"]
            torch.cuda.synchronize()
            iters[k].append(time.perf_counter() - t1)
            require(all_finite([float(loss)]), f"{k} step: loss {float(loss)}")
    for k in iters:
        model, (opt, sched) = models[k], opts[k]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss, _ = forward_loss(model, batch, 0, cfgs[k])
        ev[1].record()
        loss.backward()
        ev[2].record()
        opt.step()
        sched.step()
        ev[3].record()
        torch.cuda.synchronize()
        split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
        ms = sorted(t * 1e3 for t in iters[k])
        print(f"train step {k} bs={TRAIN_BATCH}: median {statistics.median(ms):.3f} ms/step (min {ms[0]:.3f}, "
              f"max {ms[-1]:.3f} over {len(ms)} steps, alternating with the other dtype); split (CUDA events) "
              f"forward+loss {split[0]:.3f} ms, backward {split[1]:.3f} ms, optimizer {split[2]:.3f} ms; peak "
              f"device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB ({smi})")
    profile_calls({f"train_{k}": functools.partial(train_step, models[k], *opts[k], batch, 0, cfgs[k])
                   for k in iters}, calls=2)
    del models, opts, batch

    # a short gate in bfloat16
    lines = []
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    record = run_gate(GATE_STEPS, BATCH, "bfloat16", eval_batches=GATE_EVAL_BATCHES, num_points=NUM_POINTS,
                      log=lines.append, device=dev)
    torch.cuda.synchronize()
    gate_s = time.perf_counter() - t0
    out["gate"] = dict(_build.launches)
    require(all(out["gate"][k] > 0 for k in PATH_KERNELS["gate"]), f"gate: launches {out['gate']}")
    for key in ("untrained", "trained", "oracle", "trained_xdist_mild", "oracle_xdist_mild", "trained_xdist",
                "oracle_xdist"):
        require(all_finite(record[key].values()), f"gate {key}: {record[key]}")
    require(all_finite([record["first_loss"], record["last_loss"], record["gate_ratio"]]), f"gate: {record}")
    print(f"gate, {GATE_STEPS} steps bf16 at bs={BATCH} ({gate_s:.1f} s; launches {out['gate']}): " + json.dumps(record))
    return out


def dsn_zero_gradient(stages) -> set:
    """The DSN's parameters whose gradient is 0 in exact arithmetic: every
    attention's last bias (the softmax over the neighbours ignores a
    constant), and the biases that shift a stage's output features by a
    per-channel constant, which the train-mode BatchNorm after the next
    dense layer removes (each stage's last block, the projection)."""
    names = {f"backbone.block{i}_{j}.attn.attn2.bias" for i, st in enumerate(stages) for j in range(st[4])}
    names |= {f"backbone.block{i}_{st[4] - 1}.mlp2.bias" for i, st in enumerate(stages) if st[4] > 0}
    return names | {"backbone.proj.bias"}


def dsn_train_phase(dev, smi: str) -> dict:
    """Phase 17 (see the module docstring). Returns the launch counts of one
    DSN training step."""
    import numpy as np
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.cli.dsn_quality_gate import run_dsn_gate
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.models.dsn import DSN
    from graspbalance_tpu_torch.models.point_transformer import PT_STAGES
    from graspbalance_tpu_torch.ops.scatter import scatter_add_plain
    from graspbalance_tpu_torch.train.seg_step import init_dsn, make_seg_optimizer, seg_forward_loss, seg_train_step

    # the DSN gate's scenes (cli/dsn_quality_gate.py) at full width
    scene = SceneConfig(num_points=NUM_POINTS, table_extent=0.15, object_scatter=0.12, num_objects=8,
                        max_objects=DSN_MAX_OBJECTS, analytic_labels=True, emit_label_tensors=False)
    b = make_batch(1, BATCH, scene)
    cloud = torch.from_numpy(b["point_clouds"][..., :3]).to(dev)
    inst = torch.from_numpy(b["instance_label"].astype(np.int32)).to(dev)
    model = init_dsn(DSN().to(dev), 0)
    model_p = copy.deepcopy(model)
    opt, sched = make_seg_optimizer(model, DSN_TRAIN_STEPS + 2)
    opt_p, sched_p = make_seg_optimizer(model_p, DSN_TRAIN_STEPS + 2)

    # one step through the kernels (its scatter calls captured), one through
    # the plain versions, from the same state
    torch.cuda.synchronize()
    _build.reset_launches()
    out = {}
    calls = capture_scatters(lambda: out.update(seg_train_step(model, opt, sched, cloud, inst, DSN_MAX_OBJECTS)))
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    require(all(launches[k] > 0 for k in PATH_KERNELS["dsn_train"]),
            f"DSN training step: launches {launches}; needs fps, knn, scatter > 0")
    metrics_k = {k: float(v) for k, v in out.items()}
    with gather_backward(scatter_add_plain):
        metrics_p = {k: float(v) for k, v in
                     seg_train_step(model_p, opt_p, sched_p, cloud, inst, DSN_MAX_OBJECTS, plain=True).items()}
    require(all_finite(metrics_k.values()) and all_finite(metrics_p.values()),
            f"DSN step: non-finite metrics {metrics_k} {metrics_p}")
    loss_k, loss_p = metrics_k["loss/seg_loss"], metrics_p["loss/seg_loss"]
    require(abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p), f"DSN loss: kernel {loss_k} vs plain {loss_p}")
    cosines = {}
    for (name, p), (_, q) in zip(model.named_parameters(), model_p.named_parameters()):
        a, c = p.grad.double().flatten(), q.grad.double().flatten()
        cosines[name] = float(a @ c / (a.norm() * c.norm()).clamp_min(1e-30))
    # gradients that are 0 in exact arithmetic: rounding noise on both
    # sides, printed apart
    noise = {k: cosines.pop(k) for k in dsn_zero_gradient(PT_STAGES)}
    worst = min(cosines, key=cosines.get)
    require(cosines[worst] >= DSN_GRAD_COS, f"DSN gradient of {worst}: cosine {cosines[worst]:.6f} < {DSN_GRAD_COS}")
    print(f"DSN train step bs={BATCH}, {NUM_POINTS} pts, kernel vs plain: launches {launches}; loss {loss_k!r} vs "
          f"{loss_p!r}; gradient cosines: smallest {cosines[worst]:.7f} ({worst}), median "
          f"{statistics.median(cosines.values()):.7f} over {len(cosines)} tensors (the {len(noise)} zero-gradient "
          f"biases, noise: {min(noise.values()):.3f}-{max(noise.values()):.3f}); metrics {json.dumps(metrics_k)}")
    del model_p, opt_p, sched_p
    n_calls = len(calls)
    print("DSN step's gathers:")
    (k11_ms, k11_plain_ms, k11_lib_ms), _, _ = scatter_phase(calls)
    del calls

    # timed steps through the kernels: ms per step, the split, peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters, losses = [], []
    for _ in range(DSN_TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        m = seg_train_step(model, opt, sched, cloud, inst, DSN_MAX_OBJECTS)
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t1)
        losses.append(float(m["loss/seg_loss"]))
    require(all_finite(losses), f"DSN losses {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    loss, _ = seg_forward_loss(model, cloud, inst, DSN_MAX_OBJECTS)
    ev[1].record()
    loss.backward()
    ev[2].record()
    opt.step()
    sched.step()
    ev[3].record()
    torch.cuda.synchronize()
    split = [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
    ms = sorted(t * 1e3 for t in iters)
    print(f"DSN train step bs={BATCH}, {NUM_POINTS} pts, through the kernels: losses {losses}; median "
          f"{statistics.median(ms):.3f} ms/step (min {ms[0]:.3f}, max {ms[-1]:.3f} over {len(ms)} steps), "
          f"{BATCH * len(ms) / (sum(ms) / 1e3):.3f} clouds/s; split (CUDA events, one more step) forward+loss "
          f"{split[0]:.3f} ms, backward {split[1]:.3f} ms, optimizer {split[2]:.3f} ms; peak device memory "
          f"{peak_gb:.3f} GB ({smi}); K11 over the step's {n_calls} calls: kernel {k11_ms:.4f} ms, plain "
          f"{k11_plain_ms:.4f}, index_add_ {k11_lib_ms:.4f}")
    profile_calls({"dsn_train": lambda: seg_train_step(model, opt, sched, cloud, inst, DSN_MAX_OBJECTS)}, calls=2)
    del model, opt, sched

    # a short DSN gate at full width
    lines = []
    t0 = time.perf_counter()
    record = run_dsn_gate(steps=DSN_GATE_STEPS, bs=BATCH, num_points=NUM_POINTS, eval_batches=GATE_EVAL_BATCHES,
                          log=lines.append, device=dev)
    torch.cuda.synchronize()
    for key in ("untrained", "trained", "oracle", "trained_xdist", "oracle_xdist"):
        require(all_finite(record[key].values()), f"DSN gate {key}: {record[key]}")
    require(record["oracle"]["fg_iou"] == 1.0, f"DSN gate oracle: {record['oracle']}")
    print(f"DSN gate, {DSN_GATE_STEPS} steps at bs={BATCH} ({time.perf_counter() - t0:.1f} s, {smi}): "
          + json.dumps(record))
    return launches


def write_fixture_tree(root: str, frames: int) -> None:
    """A GraspNet-1B-shaped tree of one test_seen scene (scene_0100) holding
    ``frames`` frames: clean-scene clouds and segmentations (the loader's
    first choice, 20,000-point synthetic scenes), and a placeholder file a
    frame in depth/, which the loader counts and the clean path never
    opens."""
    import os

    import numpy as np

    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_scenes

    clouds, labels = make_scenes(SEED + 7, frames, SceneConfig(num_points=NUM_POINTS))
    base = os.path.join(root, "scenes", "scene_0100", "realsense", "depth")
    clean = os.path.join(root, "clean_scenes", "scene_0100", "realsense")
    for d in (base, f"{clean}/points", f"{clean}/seg"):
        os.makedirs(d, exist_ok=True)
    for f in range(frames):
        open(os.path.join(base, f"{f:04d}.png"), "wb").close()
        np.save(f"{clean}/points/{f:04d}.npy", clouds[f])
        np.save(f"{clean}/seg/{f:04d}.npy", labels[f])


def data_phase(dev, smi: str) -> dict:
    """Phase 18 (see the module docstring). Returns the launch counts of the
    synthetic smoke."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.cli import infer
    from graspbalance_tpu_torch.train.checkpoints import CheckpointManager
    from graspbalance_tpu_torch.train.config import Config
    from graspbalance_tpu_torch.train.train_step import TrainState, build_model, make_optimizer
    from graspbalance_tpu_torch.weights import init_random_

    root = tempfile.mkdtemp(prefix="gb_data_")
    try:
        # a checkpoint of the smoke's random weights (flax's initialisation
        # keeps no seed valid), restored by the CLI as a training run's
        cfg = Config()
        model = init_random_(build_model(cfg, device=dev), SEED)
        ckpt = CheckpointManager(f"{root}/checkpoints")
        ckpt.save_config(cfg)
        ckpt.save(0, TrainState(model, *make_optimizer(model, cfg, 1)))
        del model
        argv = ["--batch_size", str(BATCH), "--num_point", str(NUM_POINTS), "--device", str(dev),
                "--checkpoint_dir", f"{root}/checkpoints"]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        grasps, keep = infer.main(argv)
        torch.cuda.synchronize()
        launches = dict(_build.launches)
        require(all(launches[k] > 0 for k in PATH_KERNELS["no_obs"]), f"infer smoke: launches {launches}")
        m = DEFAULT_NUM_SEED
        require(grasps.shape == (BATCH, m, 17) and keep.shape == (BATCH, m) and bool(np.isfinite(grasps).all()),
                f"infer smoke: shapes {grasps.shape} {keep.shape} or non-finite grasps")
        require(keep.any(), "infer smoke: no grasp kept")
        print(f"cli/infer synthetic smoke bs={BATCH}: {time.perf_counter() - t0:.1f} s with the model's build and "
              f"restore; {int(keep.sum())} of {keep.size} grasps kept; launches {launches}")

        write_fixture_tree(f"{root}/graspnet", DUMP_FRAMES)
        t0 = time.perf_counter()
        n = infer.main(argv + ["--dataset_root", f"{root}/graspnet", "--dump_dir", f"{root}/dump"])
        torch.cuda.synchronize()
        dump_s = time.perf_counter() - t0
        out_dir = f"{root}/dump/scene_0100/realsense"
        files = sorted(os.listdir(out_dir))
        require(n == DUMP_FRAMES and files == [f"{f:04d}.npy" for f in range(DUMP_FRAMES)],
                f"dump: {n} frames, files {files}")
        rows = [np.load(f"{out_dir}/{f}") for f in files]
        require(all(r.dtype == np.float32 and r.ndim == 2 and r.shape[1] == 17 and r.shape[0] <= m
                    and np.isfinite(r).all() for r in rows), f"dump rows: {[(r.dtype, r.shape) for r in rows]}")
        rot = np.concatenate([r[:, 4:13] for r in rows]).reshape(-1, 3, 3)
        require(len(rot) > 0 and np.abs(rot @ rot.transpose(0, 2, 1) - np.eye(3)).max() < 1e-4,
                f"dump: {len(rot)} rows, or their rotations not orthonormal")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"dump_dataset through cli/infer over a {DUMP_FRAMES}-frame fixture tree ({dump_s:.1f} s): "
          f"dump/scene_0100/realsense/{files[0]}..{files[-1]}, rows a frame {[len(r) for r in rows]} x 17 float32 "
          f"({smi})")
    return launches


def _cpu(tensors: dict) -> dict:
    return {k: v.detach().cpu().clone() for k, v in tensors.items()}


def _step_record(model, metrics, lr: float) -> dict:
    """A training step's metrics, gradients, state after it (on the host)
    and the learning rate it stepped at."""
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()},
            "state": _cpu(model.state_dict()), "lr": lr}


def _steps_ms(step, calls: int = 2) -> float:
    """Median ms of ``calls`` more calls of ``step`` (host clock, the card
    synchronised around each)."""
    import torch

    times = []
    for _ in range(calls):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def dp_grasp(dev):
    """Phase 20b's default model at full width from SEED, its optimizer and
    schedule, and the DP_BATCH scenes (host arrays): the same in the parent
    and on every rank."""
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.train.config import Config, DataConfig
    from graspbalance_tpu_torch.train.train_step import build_model, make_optimizer
    from graspbalance_tpu_torch.weights import init_random_

    cfg = Config(data=DataConfig(batch_size=DP_BATCH))
    model = init_random_(build_model(cfg, device=dev), SEED)
    return cfg, model, *make_optimizer(model, cfg, STEPS_PER_EPOCH), make_batch(
        SEED, DP_BATCH, SceneConfig(num_points=NUM_POINTS))


def dp_dsn(dev):
    """Phase 20b's DSN (init_dsn(0)), its optimizer and schedule, and phase
    17's DP_BATCH scenes: clouds (B, N, 3) and instance labels (host)."""
    import numpy as np

    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.models.dsn import DSN
    from graspbalance_tpu_torch.train.seg_step import init_dsn, make_seg_optimizer

    scene = SceneConfig(num_points=NUM_POINTS, table_extent=0.15, object_scatter=0.12, num_objects=8,
                        max_objects=DSN_MAX_OBJECTS, analytic_labels=True, emit_label_tensors=False)
    b = make_batch(1, DP_BATCH, scene)
    model = init_dsn(DSN().to(dev), 0)
    return (model, *make_seg_optimizer(model, DSN_TRAIN_STEPS + 2), np.ascontiguousarray(b["point_clouds"][..., :3]),
            b["instance_label"].astype(np.int32))


def dp_drp(dev):
    """Phase 20c's DRP (DRP_STAGES, random weights from SEED, eval mode) and
    SHARDED_BATCH 20,000-point scenes on the card."""
    import torch

    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_scenes
    from graspbalance_tpu_torch.models.drp import DRP
    from graspbalance_tpu_torch.weights import init_random_

    clouds, _ = make_scenes(SEED, SHARDED_BATCH, SceneConfig(num_points=NUM_POINTS))
    return init_random_(DRP().to(dev), SEED).eval(), torch.from_numpy(clouds).to(dev)


def _grasp_step(model, opt, sched, cfg, batch, mesh=None) -> dict:
    """Phase 20b's grasp-model record from a fresh state: the loss-only
    eval step (its "eval" metrics; the running statistics as initialised)
    and then one training step, on ``batch`` (this rank's rows with
    ``mesh``)."""
    from graspbalance_tpu_torch.train.train_step import eval_step, train_step

    lr = opt.param_groups[0]["lr"]
    ev = {k: float(v) for k, v in eval_step(model, batch, cfg, mesh=mesh).items()}
    return {**_step_record(model, train_step(model, opt, sched, batch, 0, cfg, mesh=mesh), lr), "eval": ev}


def _on_ranks(dev) -> dict:
    """This rank's launches per kernel, their sum over the ranks, and the
    kernels some rank did not launch."""
    import torch
    import torch.distributed as dist

    from graspbalance_tpu_torch import _build

    names = list(_build.launches)
    n = torch.tensor([_build.launches[k] for k in names], dtype=torch.int64, device=dev)
    t = torch.stack([n, (n == 0).long()])
    dist.all_reduce(t)
    return {"launches": dict(_build.launches), "launches_sum": dict(zip(names, t[0].tolist())),
            "unlaunched": [k for k, z in zip(names, t[1].tolist()) if z]}


def _same_on_ranks(tensors, dev) -> bool:
    """Whether every rank holds the same values as rank 0 (float32 and the
    integers used here are exact in float64)."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([t.detach().reshape(-1).to(dev, torch.float64) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, 0)
    bad = (flat != ref).sum().reshape(1)
    dist.all_reduce(bad)
    return int(bad.item()) == 0


def dp_rank_work(dev, world: int) -> dict:
    """Phases 20b and 20c on one rank of a process group of ``world`` ranks
    (gloo ranks sharing the card, or NCCL ranks a card each): the grasp
    model's eval and training steps on DP_BATCH / world scenes as they are
    and with each of DP_FAULTS planted, the DSN's step, and the sharded DRP
    forward; what phase 20 compares (rank 0's records), with the launches,
    whether the ranks agree bit for bit, and the ms."""
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.parallel.backbone import sharded_drp_forward
    from graspbalance_tpu_torch.parallel.faults import planted_fault
    from graspbalance_tpu_torch.parallel.mesh import make_mesh, replicate_, shard_batch, shard_rows
    from graspbalance_tpu_torch.train.seg_step import seg_train_step
    from graspbalance_tpu_torch.train.train_step import make_optimizer, train_step

    res = {"grasp": {}}
    mesh = make_mesh(world, 1, device_type="cuda")
    cfg, model, _, _, batch = dp_grasp(dev)
    state0 = copy.deepcopy(model.state_dict())
    batch = shard_batch(batch, mesh)
    for fault in ("none", *DP_FAULTS):
        model.load_state_dict(state0)
        opt, sched = make_optimizer(model, cfg, STEPS_PER_EPOCH)
        replicate_(model, mesh)
        _build.reset_launches()
        with planted_fault(fault, world):
            rec = _grasp_step(model, opt, sched, cfg, batch, mesh)
        torch.cuda.synchronize()
        if fault == "none":
            rec.update(_on_ranks(dev), equal=_same_on_ranks(model.state_dict().values(), dev),
                       ms=_steps_ms(lambda: train_step(model, opt, sched, batch, 0, cfg, mesh=mesh)))
        res["grasp"][fault] = rec
    del model, opt, sched, batch, state0

    dsn, opt, sched, cloud, inst = dp_dsn(dev)
    replicate_(dsn, mesh)
    cloud, inst = shard_rows(cloud, mesh), shard_rows(inst, mesh)
    lr = opt.param_groups[0]["lr"]
    _build.reset_launches()
    res["dsn"] = _step_record(dsn, seg_train_step(dsn, opt, sched, cloud, inst, DSN_MAX_OBJECTS, mesh=mesh), lr)
    torch.cuda.synchronize()
    res["dsn"].update(_on_ranks(dev), equal=_same_on_ranks(dsn.state_dict().values(), dev),
                      ms=_steps_ms(lambda: seg_train_step(dsn, opt, sched, cloud, inst, DSN_MAX_OBJECTS, mesh=mesh)))
    del dsn, opt, sched
    torch.cuda.empty_cache()

    mesh = make_mesh(1, world, device_type="cuda")
    drp, clouds = dp_drp(dev)
    got = {k: v for k, v in sharded_drp_forward(mesh, drp, clouds).items() if v is not None}
    torch.cuda.synchronize()
    res["sharded"] = {"out": _cpu(got), "equal": _same_on_ranks(got.values(), dev),
                      "ms": _steps_ms(lambda: sharded_drp_forward(mesh, drp, clouds), calls=1)}
    return res


def dp_rank(rank: int, world: int, out: str) -> None:
    """``dp_rank_work`` on one of the gloo ranks sharing the card (spawned
    by parallel/ranks.run_ranks); rank 0 writes <out>/rank0.pt."""
    import torch

    torch.cuda.set_device(0)
    res = dp_rank_work(torch.device("cuda", 0), world)
    if rank == 0:
        torch.save(res, f"{out}/rank0.pt")


def dp_references(dev) -> dict:
    """The one-process runs phase 20 holds the ranks' against: the grasp
    model's eval and training steps and the DSN's step on all DP_BATCH
    scenes ("one", with its ms) and on the same scenes reordered
    ("reordered"), and the unsharded DRP forward with its ms."""
    import torch

    from graspbalance_tpu_torch.train.seg_step import seg_train_step
    from graspbalance_tpu_torch.train.train_step import train_step

    refs = {"grasp": {}, "dsn": {}}
    for name, rows in (("one", slice(None)), ("reordered", list(DP_ORDER))):
        cfg, model, opt, sched, batch = dp_grasp(dev)
        batch = {k: v[rows] for k, v in batch.items()}
        refs["grasp"][name] = _grasp_step(model, opt, sched, cfg, batch)
        if name == "one":
            refs["grasp"][name]["ms"] = _steps_ms(lambda: train_step(model, opt, sched, batch, 0, cfg))
        del model, opt, sched, batch
        dsn, opt, sched, cloud, inst = dp_dsn(dev)
        lr = opt.param_groups[0]["lr"]
        cloud, inst = cloud[rows], inst[rows]
        refs["dsn"][name] = _step_record(dsn, seg_train_step(dsn, opt, sched, cloud, inst, DSN_MAX_OBJECTS), lr)
        if name == "one":
            refs["dsn"][name]["ms"] = _steps_ms(lambda: seg_train_step(dsn, opt, sched, cloud, inst,
                                                                        DSN_MAX_OBJECTS))
        del dsn, opt, sched
    drp, clouds = dp_drp(dev)
    with torch.no_grad():
        refs["sharded"] = {"out": _cpu({k: v for k, v in drp(clouds).items() if v is not None}),
                           "ms": _steps_ms(lambda: drp(clouds), calls=3)}
    del drp, clouds
    torch.cuda.empty_cache()
    return refs


def step_spread(got: dict, want: dict, zero: set) -> dict:
    """How far the training step ``got`` lies from ``want`` (the same
    state, the same scenes): the largest relative difference of a loss, the
    median and the largest (1 - cosine) of a parameter's gradient (the
    zero-gradient biases apart), the largest statistic difference of
    max(1, |statistic|), that of the first BatchNorm alone, the elements
    whose gradient is firm that stepped apart (see DP_FIRM), and, where
    both carry an eval step, the largest relative difference of its loss."""
    losses = [k for k in want["metrics"] if k.startswith("loss/")]
    loss = max(abs(got["metrics"][k] - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-30) for k in losses)
    gaps = []
    model_max = max(float(g.abs().max()) for g in want["grads"].values())
    firm_apart = 0
    for k, w in want["grads"].items():
        firm = w.abs() > DP_FIRM * max(float(w.abs().max()), 1e-4 * model_max)
        p, q = got["state"][k][firm], want["state"][k][firm]
        firm_apart += int(((p - q).abs() > 1e-3 * want["lr"] + 2 * _ulp(q)).sum())
        if k not in zero:
            a, c = got["grads"][k].double().flatten(), w.double().flatten()
            gaps.append(1.0 - float(a @ c / (a.norm() * c.norm()).clamp_min(1e-30)))
    stats = {k: float((got["state"][k].double() - w.double()).abs().max()) / max(1.0, float(w.abs().max()))
             for k, w in want["state"].items() if "running" in k}
    first_bn = next(iter(stats)).rsplit(".", 1)[0]
    out = {"loss": loss, "grad_median": statistics.median(gaps), "grad_max": max(gaps), "stat": max(stats.values()),
           "first_stat": max(v for k, v in stats.items() if k.startswith(first_bn + ".")), "firm_apart": firm_apart}
    if "eval" in want:
        out["eval"] = max(abs(got["eval"][k] - w) / max(abs(w), 1e-30) for k, w in want["eval"].items()
                          if k.startswith("loss/"))
    return out


def _ulp(x):
    """The spacing of float32 at each |x|."""
    import torch

    return torch.nextafter(x.abs(), torch.full_like(x, float("inf"))) - x.abs()


def dp_step_failures(got: dict, want: dict, floor: dict, zero: set) -> tuple[dict, dict, list]:
    """Phase 20b's comparison of a rank's step with the one-process step,
    beside the one-process step on the reordered scenes (``floor``; see
    DP_FLOOR_FACTOR): (the rank's spreads, the reordered step's, the checks
    it fails)."""
    require(got["lr"] == want["lr"] == floor["lr"], f"learning rates {got['lr']}, {want['lr']}, {floor['lr']}")
    ranks, order = step_spread(got, want, zero), step_spread(floor, want, zero)
    fails = [f"{k} {ranks[k]:.3g} > {DP_FLOOR_FACTOR} x the reordered step's {order[k]:.3g}"
             for k in ("loss", "grad_median", "stat", "firm_apart") if ranks[k] > DP_FLOOR_FACTOR * order[k] + 1e-6]
    fails += [f"{k} {ranks[k]:.3g} > {tol}" for k, tol in (("first_stat", DP_FIRST_STAT_TOL),
                                                           ("eval", DP_EVAL_RTOL)) if ranks.get(k, 0.0) > tol]
    return ranks, order, fails


def dp_check(res: dict, refs: dict, world: int, how: str, smi: str) -> dict:
    """Phases 20b and 20c's checks of rank 0's records ``res``
    (``dp_rank_work``) against ``refs`` (``dp_references``); ``how`` names
    the ranks. Returns the launches per kernel of the ranks' steps."""
    import torch

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.models.point_transformer import PT_STAGES
    from graspbalance_tpu_torch.parallel.faults import FAULTS

    launches = dict.fromkeys(_build.launches, 0)
    zero = {"grasp": set(ZERO_GRADIENT), "dsn": dsn_zero_gradient(PT_STAGES)}
    speed = "" if "a card each" in how else "; ranks sharing one card give no speed figure"
    for part, path in (("grasp", "dp_train"), ("dsn", "dp_dsn")):
        got = res["grasp"]["none"] if part == "grasp" else res["dsn"]
        want, floor = refs[part]["one"], refs[part]["reordered"]
        require(got["equal"], f"20b {part}: the ranks' parameters and statistics differ after the step")
        require(not set(PATH_KERNELS[path]) & set(got["unlaunched"]),
                f"20b {part}: some rank launched none of {got['unlaunched']}")
        for k, n in got["launches_sum"].items():
            launches[k] += n
        ranks, order, fails = dp_step_failures(got, want, floor, zero[part])
        require(not fails, f"20b {part} over {how}: " + "; ".join(fails))
        loss = "loss/overall_loss" if part == "grasp" else "loss/seg_loss"
        print(f"20b {part}, bs={DP_BATCH} over {how} (bs={DP_BATCH // world} a rank) against one process "
              f"({NUM_POINTS} pts): " + "; ".join(f"{k} {ranks[k]:.3g} (reordered {order[k]:.3g})" for k in ranks)
              + f"; {loss} {got['metrics'][loss]!r} vs {want['metrics'][loss]!r} (reordered "
              f"{floor['metrics'][loss]!r}); the ranks bit-equal after the step; launches on rank 0 "
              f"{got['launches']}; {got['ms']:.3f} ms a step on rank 0 against {want['ms']:.3f} ms in one process "
              f"({smi}{speed})")
    for fault in DP_FAULTS:
        ranks, _, fails = dp_step_failures(res["grasp"][fault], refs["grasp"]["one"], refs["grasp"]["reordered"],
                                           zero["grasp"])
        require(fails, f"20b: the grasp step with the planted fault {fault!r} passed the comparison: {ranks}")
        print(f"20b planted fault {fault!r} ({FAULTS[fault]}) rejected: " + "; ".join(fails)
              + " (" + ", ".join(f"{k} {v:.3g}" for k, v in ranks.items()) + ")")

    got, want = res["sharded"]["out"], refs["sharded"]["out"]
    require(res["sharded"]["equal"], "20c: the ranks' forwards differ")
    require(got.keys() == want.keys(), f"20c keys: {sorted(got)} vs {sorted(want)}")
    feat_errs = {}
    for k, w in want.items():
        require(got[k].shape == w.shape and got[k].dtype == w.dtype, f"20c {k}: {got[k].shape} vs {w.shape}")
        if "features" in k:
            feat_errs[k] = float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            require(feat_errs[k] <= SHARDED_FEAT_RTOL, f"20c {k}: {feat_errs[k]:.3g} > {SHARDED_FEAT_RTOL}")
        else:
            require(torch.equal(got[k], w), f"20c {k}: not exact")
    print(f"20c sharded_drp_forward, a (1, {world}) mesh of {how}, DRP_STAGES, bs={SHARDED_BATCH} x {NUM_POINTS} "
          f"pts: indices and coordinates exact, features within "
          + ", ".join(f"{k} {e:.3g}" for k, e in feat_errs.items())
          + f" of each output's largest |value|; {res['sharded']['ms']:.3f} ms a forward on rank 0 against "
          f"{refs['sharded']['ms']:.3f} ms unsharded ({smi}{speed})")
    return launches


def dp_phase(dev, smi: str) -> dict:
    """Phase 20 (see the module docstring). Returns the launches per kernel
    of its data-parallel steps (20a's, and the ranks' 20b steps)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.parallel.mesh import make_mesh, replicate_
    from graspbalance_tpu_torch.parallel.ranks import run_ranks
    from graspbalance_tpu_torch.train.config import Config
    from graspbalance_tpu_torch.train.train_step import build_model, make_optimizer, to_device, train_step
    from graspbalance_tpu_torch.weights import init_random_

    t_phase = time.perf_counter()
    launches = dict.fromkeys(_build.launches, 0)
    with tempfile.TemporaryDirectory() as tmp:
        # 20a: a world of one NCCL rank, phase 9's batch, against the one-process step
        cfg = Config()
        batch = to_device(make_batch(SEED, TRAIN_BATCH, SceneConfig(num_points=NUM_POINTS)), dev)
        recs = []
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl", rank=0, world_size=1)
        try:
            for mesh in (None, make_mesh(1, 1, device_type="cuda")):
                model = init_random_(build_model(cfg, device=dev), SEED)
                opt, sched = make_optimizer(model, cfg, STEPS_PER_EPOCH)
                replicate_(model, mesh)
                lr = opt.param_groups[0]["lr"]
                _build.reset_launches()
                metrics = train_step(model, opt, sched, batch, 0, cfg, mesh=mesh)
                torch.cuda.synchronize()
                recs.append((_step_record(model, metrics, lr), dict(_build.launches)))
                del model, opt, sched
        finally:
            dist.destroy_process_group()
        (one, _), (world1, world1_launches) = recs
        require(all(world1_launches[k] > 0 for k in PATH_KERNELS["train"]),
                f"20a: launches {world1_launches}; needs fps, multicyl, scatter > 0")
        require(world1["metrics"] == one["metrics"], f"20a metrics: {world1['metrics']} vs {one['metrics']}")
        for part in ("grads", "state"):
            bad = [k for k, v in one[part].items() if not torch.equal(v, world1[part][k])]
            require(not bad, f"20a: {part} not bit-equal: {bad[:5]}")
        print(f"20a data-parallel step in a world of one NCCL rank, bs={TRAIN_BATCH}: loss "
              f"{world1['metrics']['loss/overall_loss']!r}, metrics, {len(one['grads'])} gradients and "
              f"{len(one['state'])} state tensors (parameters, BatchNorm statistics) bit-equal to the one-process "
              f"step; launches {world1_launches}")
        for k, n in world1_launches.items():
            launches[k] += n
        del batch, recs

        # 20b, 20c: the one-process references, then the ranks
        refs = dp_references(dev)
        t0 = time.perf_counter()
        run_ranks(dp_rank, DP_RANKS, (tmp,), init_file=f"{tmp}/gloo", backend="gloo", timeout=DP_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        res = torch.load(f"{tmp}/rank0.pt")

    for k, n in dp_check(res, refs, DP_RANKS, "gloo ranks sharing the card", smi).items():
        launches[k] += n
    print(f"phase 20: {time.perf_counter() - t_phase:.1f} s, the ranks' run {ranks_s:.1f} s; launches of the "
          f"data-parallel steps {launches}")
    return launches


def multicard_main() -> int:
    """Phases 20b and 20c on one NCCL rank a card, under
    ``torchrun --standalone --nproc_per_node=S chip_smoke.py`` (S divides
    DP_BATCH): each step's ms is then a speed figure."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs CUDA cards", file=sys.stderr)
        return 1
    from graspbalance_tpu_torch import _build
    from graspbalance_tpu_torch.parallel.mesh import init_from_env

    dev, _ = init_from_env("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    require(DP_BATCH % world == 0, f"{world} ranks do not split DP_BATCH = {DP_BATCH}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    if rank == 0:
        print(smi[0])
        print(f"{world} NCCL ranks, a card each: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
        _build.library()  # once, before the other ranks load it
    dist.barrier()
    _build.library()
    res = dp_rank_work(dev, world)
    if rank == 0:
        dp_check(res, dp_references(dev), world, f"{world} NCCL ranks, a card each", smi[0])
    dist.barrier()
    dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke needs a CUDA card",
              file=sys.stderr)
        return 1

    from graspbalance_tpu_torch import _build, trace
    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_scenes
    from graspbalance_tpu_torch.eval.collision import voxel_downsample_fixed
    from graspbalance_tpu_torch.eval.obs import (
        COMPACT_CAP,
        FPS_CAP,
        MAX_OBJECTS,
        _compact_mask,
        max_needed_steps,
        object_balance_indices,
        object_masks,
    )
    from graspbalance_tpu_torch.eval.pipeline import GraspInference
    from graspbalance_tpu_torch.models import DSN, GraspBalance, pred_decode
    from graspbalance_tpu_torch.ops.collision import (
        N_PARAMS,
        TILE,
        collision_counts,
        collision_counts_plain,
        collision_cull_stats,
        cull_share,
        pack_grasp_params,
        tile_bounds,
        tile_may_hit,
    )
    from graspbalance_tpu_torch.ops.fps import (
        furthest_point_sample,
        furthest_point_sample_masked,
        furthest_point_sample_masked_plain,
        furthest_point_sample_plain,
        initial_distances,
    )
    from graspbalance_tpu_torch.ops.gather import gather_points, group_points
    from graspbalance_tpu_torch.ops.knn import knn, knn_plain, knn_round_stats
    from graspbalance_tpu_torch.ops.multicyl import multi_cylinder_group, multi_cylinder_group_plain
    from graspbalance_tpu_torch.ops.query import cylinder_thresholds, rot_planes
    from graspbalance_tpu_torch.ops.widthmlp import width_mlp_fused_rot, width_mlp_fused_rot_plain
    from graspbalance_tpu_torch.weights import init_random_

    dev = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s ({_build.library_path()})")

    # 3. each main-path kernel against its plain version, at the path's shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    clouds_np, instance_np = make_scenes(SEED, BATCH, SceneConfig(num_points=NUM_POINTS))
    cloud = torch.from_numpy(clouds_np).to(dev)
    instance_label = torch.from_numpy(instance_np).to(dev)
    model = init_random_(GraspBalance(), SEED).to(dev).eval()
    wg = model.width_grouping
    m = model.backbone.num_seed
    n_fps = model.backbone.stages[0][0]

    fps_k = furthest_point_sample(cloud, n_fps)
    fps_p = furthest_point_sample_plain(cloud, n_fps)
    fps_err = int((fps_k - fps_p).abs().max())
    require(torch.equal(fps_k, fps_p), f"FPS kernel != plain: {int((fps_k != fps_p).sum())} indices differ")

    with torch.no_grad():  # the path's own query inputs: seeds and their top-view rotations
        ep = model.backbone(cloud, sa_inds=fps_k)
        ep.update(model.graspable(ep["fp2_xyz"], ep["fp2_features"]))
    seeds, rot = ep["fp2_xyz"].contiguous(), ep["grasp_top_view_rot"].contiguous()
    qargs = (cloud, seeds, rot, wg.radii, wg.hmin, wg.hmax_list, wg.nsample)
    idx_k, rel_k = multi_cylinder_group(*qargs, emit_rel=True)
    idx_p, rel_p = multi_cylinder_group_plain(*qargs, emit_rel=True)
    require(torch.equal(idx_k, idx_p), f"query kernel != plain: {int((idx_k != idx_p).sum())} indices differ")
    rel_err = float((rel_k - rel_p).abs().max())
    require(rel_err <= REL_TOL, f"query rel error {rel_err} > {REL_TOL}")
    require(torch.equal(rel_k, rel_p), f"query rel not bit-equal to the plain version (max err {rel_err})")
    require(torch.equal(multi_cylinder_group(*qargs)[0], idx_k), "query indices differ between the two modes")
    hits = idx_k[..., 1:] != idx_k[..., :1]
    # what the query's cull can skip on these scenes: the points in the union
    # of the cylinders per seed, the 32-point chunks holding one, and the
    # seeds whose smallest cylinder fills (its k-th slot is not the first)
    r2, hmin32, hm = cylinder_thresholds(wg.radii, wg.hmin, wg.hmax_list)
    xr, yr, zr = rot_planes(cloud, seeds, rot)
    union = (xr > hmin32) & (yr * yr + zr * zr < max(r2)) & (xr < max(hm))
    chunk_share = float(union.reshape(BATCH, m, -1, 32).any(dim=-1).float().mean())
    smallest = min(range(len(r2)), key=lambda c: (r2[c], hm[c]))
    fills = idx_k.flatten(1, 2)[:, smallest, :, -1] != idx_k.flatten(1, 2)[:, smallest, :, 0]
    del xr, yr, zr
    print(f"query: {idx_k.shape} idx and rel bit-equal to the plain version in both modes; "
          f"share of slots past the first that differ from it {float(hits.float().mean()):.3f}; the cylinders' "
          f"union holds {float(union.sum(dim=-1).float().mean()):.1f} points a seed, {chunk_share:.3f} of the "
          f"32-point chunks; the smallest cylinder fills for {float(fills.float().mean()):.3f} of the seeds")
    del union

    b, n_r, n_h, _, k = idx_k.shape
    grouped = group_points(
        cloud, idx_k.permute(0, 3, 1, 2, 4).reshape(b, m * n_r * n_h, k)
    ).reshape(b, m, n_r, n_h, k, 3)
    weights = wg.folded_weights()
    with torch.no_grad():
        mlp_k = width_mlp_fused_rot(grouped, seeds, rot, weights)
        mlp_p = width_mlp_fused_rot_plain(grouped, seeds, rot, weights)
    mlp_err = float((mlp_k - mlp_p).abs().max())
    require(mlp_err <= WIDTHMLP_TOL, f"width MLP error {mlp_err} > {WIDTHMLP_TOL}")
    print(f"width MLP: {tuple(mlp_k.shape)} max err {mlp_err:.3g} (max |out| {float(mlp_p.abs().max()):.3g})")

    with torch.no_grad():
        times = {
            "fps": (cuda_ms(lambda: furthest_point_sample(cloud, n_fps), 5),
                    cuda_ms(lambda: furthest_point_sample_plain(cloud, n_fps), 1), None),
            "multicyl": (cuda_ms(lambda: multi_cylinder_group(*qargs), 5),
                         cuda_ms(lambda: multi_cylinder_group_plain(*qargs), 2), None),
            "widthmlp": (cuda_ms(lambda: width_mlp_fused_rot(grouped, seeds, rot, weights), 5),
                         cuda_ms(lambda: width_mlp_fused_rot_plain(grouped, seeds, rot, weights), 2), None),
        }
    errs = {"fps": fps_err, "multicyl": rel_err, "widthmlp": mlp_err}
    # FPS's latency floor: the same cluster launch with the distance work
    # taken out (csrc/fps.cu gb_fps_chain), every step only its exchange
    planes = cloud.transpose(1, 2).contiguous()
    dist0 = initial_distances(cloud).contiguous()
    chain_out = torch.empty_like(fps_k)
    lib, stream = _build.library(), _build.stream_of(cloud)

    def fps_chain():
        err = lib.gb_fps_chain(planes.data_ptr(), dist0.data_ptr(), chain_out.data_ptr(), BATCH, NUM_POINTS,
                               n_fps, stream)
        require(err == 0, f"fps chain launch failed: CUDA error {err}")

    fps_floor_ms = cuda_ms(fps_chain, 5)
    del planes, dist0, chain_out
    print(f"FPS ({BATCH}, {NUM_POINTS}) -> {n_fps}: {times['fps'][0]:.4f} ms, {times['fps'][0] / (n_fps - 1) * 1e3:.3f} us per step; latency floor (the step chain without the "
          f"distance work) {fps_floor_ms:.4f} ms, {fps_floor_ms / (n_fps - 1) * 1e3:.3f} us per step")
    print(f"width MLP {tuple(grouped.shape)}: {times['widthmlp'][0]:.4f} ms")
    multicyl_rel_ms = cuda_ms(lambda: multi_cylinder_group(*qargs, emit_rel=True), 5)
    print(f"query {tuple(idx_k.shape)}: {times['multicyl'][0]:.4f} ms indices only, {multicyl_rel_ms:.4f} ms with "
          f"the gripper-frame coordinates")

    # least work of each main-path kernel on these inputs
    n_in = cloud.numel() * 4
    bounds = {
        # every step updates every point's distance (3 sub, 3 mul, 2 add,
        # min) and compares it: 10 operations
        "fps": bound(n_in + fps_k.numel() * 4, (n_fps - 1) * BATCH * NUM_POINTS * 10),
    }
    # the query must scan each seed's points up to its last combo's k-th hit
    # (all N where a combo has fewer): 18 operations for the rotated point,
    # 3 for y^2 + z^2, 3 comparisons per combo
    full = idx_k[..., -1] != idx_k[..., 0]
    scan = torch.where(full, idx_k[..., -1].long() + 1, NUM_POINTS).amax(dim=(1, 2))
    n_combo = n_r * n_h
    bounds["multicyl"] = bound(n_in + (seeds.numel() + rot.numel() + idx_k.numel()) * 4,
                               float(scan.sum()) * (21 + 3 * n_combo))
    bounds["widthmlp"] = widthmlp_bound(weights, BATCH * m * n_h * k, grouped.numel() * 4 + mlp_k.numel() * 4)

    # 4. the main path through the kernels, then through the plain versions
    torch.cuda.synchronize()
    _build.reset_launches()
    ep = model(cloud)
    grasps, valid = pred_decode(ep)
    torch.cuda.synchronize()
    main_launches = dict(_build.launches)
    require(all(main_launches[n] > 0 for n in PATH_KERNELS["main"]),
            f"a kernel of the main path was not launched: {main_launches}")
    require(grasps.shape == (BATCH, m, 17) and valid.shape == (BATCH, m), "decode shapes")
    ep_p = model(cloud, plain=True)
    grasps_p, valid_p = pred_decode(ep_p)
    print(f"forward+decode: launches {main_launches}; {int(valid.sum())} valid seeds; kernel vs plain: "
          + compare_decoded(ep, ep_p, grasps, grasps_p, valid, valid_p, "forward+decode"))

    # 5. timing of the main path
    iters = []
    for _ in range(MAIN_ITERS + 1):
        t1 = time.perf_counter()
        pred_decode(model(cloud))
        torch.cuda.synchronize()
        iters.append(time.perf_counter() - t1)
    print(f"main path bs={BATCH}, {NUM_POINTS} pts: {rate_line(iters[1:])} ({smi})")

    # 6. the serving path's kernels against their plain versions, at its shapes
    dsn = init_random_(DSN(), DSN_SEED).to(dev).eval()
    seg_labels, _ = GraspInference(model, dsn, use_obs=True).segment(cloud)
    require(bool((seg_labels.amax(dim=1) > 0).all()),
            f"the DSN from seed {DSN_SEED} marks no foreground in some scene: OBS would see no object")
    print(f"DSN weights from seed {DSN_SEED}: {seg_labels.amax(dim=1).tolist()} clusters per scene")
    device_ms = {}  # device ms per call of the kernels timed so (torch.profiler)
    with torch.no_grad():
        knn_errs, knn_shapes = [], []
        xyz_dsn = gather_points(cloud, fps_k[:, : dsn.pt_stages[0][0]]).contiguous()
        for npoint in (dsn.pt_stages[0][0], dsn.pt_stages[1][0]):  # nested prefixes
            x = xyz_dsn[:, :npoint].contiguous()
            d_k, i_k = knn(x, x, dsn.backbone.knn)
            d_p, i_p = knn_plain(x, x, dsn.backbone.knn)
            require(torch.equal(i_k, i_p), f"kNN kernel != plain at {tuple(x.shape)}: "
                                           f"{int((i_k != i_p).sum())} indices differ")
            knn_errs.append(float((d_k - d_p).abs().max()))
            require(knn_errs[-1] <= KNN_DIST_TOL, f"kNN distance error {knn_errs[-1]} > {KNN_DIST_TOL}")
            knn_shapes.append(x)
        kk = dsn.backbone.knn
        times["knn"] = (
            sum(cuda_ms(lambda x=x: knn(x, x, kk), 5) for x in knn_shapes),
            sum(cuda_ms(lambda x=x: knn_plain(x, x, kk), 2) for x in knn_shapes),
            sum(cuda_ms(lambda x=x: torch.cdist(x, x).topk(kk, dim=-1, largest=False), 5)
                for x in knn_shapes),
        )
        errs["knn"] = max(knn_errs)
        # the warp-select's work on each stage, and its device time per launch
        knn_work = []
        for x in knn_shapes:
            (_, i_s), (rounds, passed, inserted) = knn_round_stats(x, x, kk)
            require(torch.equal(i_s, knn_plain(x, x, kk)[1]), f"kNN (counting) != plain at {tuple(x.shape)}")
            per_call = device_ms_by_kernel(lambda x=x: knn(x, x, kk), 5)
            knn_work.append(f"{tuple(x.shape)}: {passed / rounds:.3f} of the rounds after the first had a "
                            f"candidate below the threshold, {inserted / (x.shape[0] * x.shape[1]):.1f} insertions "
                            f"a query, device {sum(ms for ms, _ in per_call.values()):.4f} ms in "
                            f"{sum(c for _, c in per_call.values()):.0f} kernel(s)")
            device_ms["knn"] = device_ms.get("knn", 0.0) + sum(ms for ms, _ in per_call.values())
        # 3 sub, 3 mul, 2 add and one comparison per (query, reference) pair
        bounds["knn"] = bound(
            sum(x.numel() * 4 + x.shape[0] * x.shape[1] * kk * 8 for x in knn_shapes),
            sum(x.shape[0] * x.shape[1] ** 2 * 9 for x in knn_shapes),
        )
        print(f"kNN: {[tuple(x.shape) for x in knn_shapes]} k={kk} idx exact, "
              f"dist max err {errs['knn']:.3g}; {times['knn'][0]:.4f} ms both stages, "
              f"cdist + topk {times['knn'][2]:.4f} ms; " + "; ".join(knn_work))

        # OBS's masked FPS on the compacted slots of the scenes' own objects
        o, fps_cap = MAX_OBJECTS, FPS_CAP
        masks = object_masks(instance_label)
        cxyz, _, cvalid = _compact_mask(cloud, masks, COMPACT_CAP)
        cxyz = cxyz.reshape(BATCH * o, COMPACT_CAP, 3).contiguous()
        cvalid = cvalid.reshape(BATCH * o, COMPACT_CAP).contiguous()
        present = masks.any(dim=2)
        kmin = int(present.sum(dim=1).min())
        needed_t = max_needed_steps(present, m)
        needed = int(needed_t)
        mf_k = furthest_point_sample_masked(cxyz, cvalid, fps_cap, max_needed=needed_t)
        mf_p = furthest_point_sample_masked_plain(cxyz, cvalid, fps_cap)
        require(torch.equal(mf_k[:, :needed], mf_p[:, :needed]),
                f"masked FPS kernel != plain over the first {needed} slots: "
                f"{int((mf_k[:, :needed] != mf_p[:, :needed]).sum())} differ")
        errs["fps_masked"] = int((mf_k[:, :needed] - mf_p[:, :needed]).abs().max())
        times["fps_masked"] = (
            cuda_ms(lambda: furthest_point_sample_masked(cxyz, cvalid, fps_cap, max_needed=needed_t), KERNEL_REPS),
            cuda_ms(lambda: furthest_point_sample_masked_plain(cxyz, cvalid, fps_cap), 1),
            None,
        )
        require(torch.equal(mf_k, furthest_point_sample_masked(cxyz, cvalid, fps_cap, max_needed=needed_t)),
                "masked FPS kernel not deterministic")
        n_valid = float(cvalid.sum())  # each step updates each valid point: 10 operations
        bounds["fps_masked"] = bound(cxyz.numel() * 4 + cvalid.numel() + mf_k.numel() * 4,
                                     (needed - 1) * n_valid * 10)
        # the kernel's device time per call on the path's rows, at
        # max_needed=1 (no step), and on rows whose only valid point is the
        # first (every step only reduces: the floor of the step chain)
        one = torch.ones((), dtype=torch.int32, device=dev)
        first_only = torch.zeros_like(cvalid)
        first_only[:, 0] = True

        def masked_device_ms(valid, needed_arg):
            per_call = device_ms_by_kernel(
                lambda: furthest_point_sample_masked(cxyz, valid, fps_cap, max_needed=needed_arg), KERNEL_REPS)
            return sum(ms for key, (ms, _) in per_call.items() if "fps_masked" in key)

        device_ms["fps_masked"] = masked_device_ms(cvalid, needed_t)
        fixed_ms = masked_device_ms(cvalid, one)
        chain_ms = masked_device_ms(first_only, needed_t)
        step_us = (device_ms["fps_masked"] - fixed_ms) / (needed - 1) * 1e3
        chain_us = (chain_ms - fixed_ms) / (needed - 1) * 1e3
        print(f"masked FPS: {tuple(cxyz.shape)} -> {fps_cap}, {kmin} objects in the sparsest scene, "
              f"exact over max_needed={needed} slots ({int(n_valid)} valid points in {BATCH * o} rows), two "
              f"launches bit-equal; {times['fps_masked'][0]:.4f} ms (before the redesign: {FPS_MASKED_BEFORE_MS} "
              f"ms); device ms per call {device_ms['fps_masked']:.4f}, at max_needed=1 {fixed_ms:.4f}, on rows "
              f"whose only valid point is the first {chain_ms:.4f}; per step {step_us:.3f} us, its chain's "
              f"floor {chain_us:.3f} us")
        # OBS at a seed count where the sparsest scene's quota is not the
        # largest: a 6- and a 7-object scene (points dealt to objects 1..k
        # and the background in turn, shuffled) at num_seed=32, whose last
        # objects read 7 and 8 slots
        gen = torch.Generator(device=dev).manual_seed(SEED)
        small_labels = torch.stack([(torch.arange(NUM_POINTS, device=dev) % (k + 1))[
            torch.randperm(NUM_POINTS, generator=gen, device=dev)] for k in (6, 7)]).to(torch.int32)
        small_needed = int(max_needed_steps(object_masks(small_labels).any(dim=2), OBS_SMALL_SEEDS))
        obs_small = object_balance_indices(cloud[:2], small_labels, num_seed=OBS_SMALL_SEEDS)
        obs_small_p = object_balance_indices(cloud[:2], small_labels, num_seed=OBS_SMALL_SEEDS, plain=True)
        require(small_needed == 8 and torch.equal(obs_small, obs_small_p),
                f"OBS at num_seed={OBS_SMALL_SEEDS} on a 6- and a 7-object scene: max_needed {small_needed} "
                f"(needs 8), {int((obs_small != obs_small_p).sum())} seeds differ from the plain version")
        print(f"OBS at num_seed={OBS_SMALL_SEEDS}, a 6- and a 7-object scene: max_needed={small_needed}, seeds exact "
              "against the plain version")

        # the collision counts of phase 4's grasps on the downsampled scenes;
        # first what the cull removes there, counted by its plain twin
        s_ds, s_valid = voxel_downsample_fixed(cloud)
        params = pack_grasp_params(grasps, 0.03, 0.01, 0.06)
        twin_kept, twin_pairs = cull_share(s_ds, s_valid, params)
        t_lo, t_hi, t_any = tile_bounds(s_ds, s_valid)
        grasp_tiles = int((tile_may_hit(params, t_lo, t_hi) & t_any.unsqueeze(1)).sum())  # (grasp, tile) pairs kept
        all_grasp_tiles = int(t_any.sum()) * params.shape[1]
        print(f"collision cull (plain twin, before the kernel runs): {1 - twin_kept / twin_pairs:.4f} of the "
              f"{twin_pairs} (32-grasp group, 32-point tile) pairs with a valid point removed, {twin_kept} kept; "
              f"{1 - grasp_tiles / all_grasp_tiles:.4f} of the {all_grasp_tiles} (grasp, tile) pairs, "
              f"{grasp_tiles} kept")
        cc_s, cull_kernel = collision_cull_stats(s_ds, s_valid, params)
        cc_k = collision_counts(s_ds, s_valid, params)
        require(torch.equal(cc_s, cc_k), "collision counts differ between the launches with and without counters")
        cc_p = collision_counts_plain(s_ds, s_valid, params)
        require(torch.equal(cc_k, cc_p), f"collision counts kernel != plain: {int((cc_k != cc_p).sum())} differ")
        errs["collision"] = float((cc_k - cc_p).abs().max())
        times["collision"] = (
            cuda_ms(lambda: collision_counts(s_ds, s_valid, params), 5),
            cuda_ms(lambda: collision_counts_plain(s_ds, s_valid, params), 2),
            None,
        )
        n_vox = float(s_valid.sum())
        # per (grasp, point) of a kept (grasp, tile) pair: 18 operations for
        # the gripper-frame point, 12 comparisons, 6 count updates; per
        # (grasp, tile with a valid point) the 6 comparisons of the world-box
        # test that skips the rest; beside it the bound of every (grasp,
        # valid point) pair, the work before the cull
        c_bytes = s_ds.numel() * 4 + s_valid.numel() + params.numel() * 4 + cc_k.numel() * 4
        bounds["collision"] = bound(c_bytes, grasp_tiles * TILE * 36 + all_grasp_tiles * 6)
        all_pairs = bound(c_bytes, n_vox * grasps.shape[1] * 36)
        per_call = device_ms_by_kernel(lambda: collision_counts(s_ds, s_valid, params), 5)
        device_ms["collision"] = sum(ms for ms, _ in per_call.values())
        print(f"collision counts: {BATCH} x {grasps.shape[1]} grasps x {int(n_vox)} valid voxels "
              f"(of {BATCH * NUM_POINTS} points; {N_PARAMS} params) exact; "
              f"max overall count {int(cc_k[..., 4].max())}; the kernel kept {cull_kernel[0]} of "
              f"{cull_kernel[1]} (group, tile) pairs; bound {bounds['collision'][0]:.5f} ms on the pairs the "
              f"cull keeps ({all_pairs[0]:.5f} ms on every pair); "
              f"{times['collision'][0]:.4f} ms, device "
              f"{device_ms['collision']:.4f} ms in {sum(c for _, c in per_call.values()):.0f} kernels per call ("
              + ", ".join(f"{key[:40]} {ms:.4f}" for key, (ms, _) in per_call.items()) + ")")

    # 7. GraspInference without and with OBS, through the kernels and plain
    pipelines = {
        "no_obs": GraspInference(model),
        "obs": GraspInference(model, dsn, use_obs=True),
    }
    path_launches = {name: check_pipeline(name, infer, cloud) for name, infer in pipelines.items()}

    # 8. timing of both pipelines; the stage shares from the program's own
    # spans over the timed calls (device events on), the NMS sweeps from
    # its counter
    for name, infer in pipelines.items():
        iters = []
        for i in range(PIPELINE_ITERS + 1):
            if i == 1:  # after the untimed first call
                trace.enable(device_events=True)
            t1 = time.perf_counter()
            infer(cloud)
            iters.append(time.perf_counter() - t1)
        trace.disable()
        print(f"GraspInference {name} bs={BATCH}, {NUM_POINTS} pts: {rate_line(iters[1:])} ({smi}); "
              + stage_line(trace.take(), PIPELINE_ITERS))

    with torch.no_grad():
        profile_calls({name: functools.partial(infer, cloud) for name, infer in pipelines.items()})

    # 9. the training step
    path_launches["train"], times["scatter"], errs["scatter"], bounds["scatter"], step_ms = train_phase(dev, smi)
    times["bn"], errs["bn"], bounds["bn"], bn_shapes = bn_phase(smi)

    # 10-13. the fused eval configuration; 14. the table-gather probe
    fused = fused_phase(model, dsn, cloud, smi)
    path_launches.update(fused[0])
    for d, new in zip((times, errs, bounds, device_ms), fused[1:]):
        d.update(new)
    path_launches["probe"], times["table_gather"], errs["table_gather"], bounds["table_gather"] = probe_phase()

    # 15. the training loop, its resume, eval step, analytic labels and label pipelines
    path_launches["loop"] = loop_phase(dev, smi, step_ms)

    # 16. the closed-loop quality gate: the oracle, the bfloat16 step, a short gate
    path_launches.update(gate_phase(dev, smi))

    # 17. DSN training at full width; 18. the data path and cli/infer on the card
    path_launches["dsn_train"] = dsn_train_phase(dev, smi)
    path_launches["infer"] = data_phase(dev, smi)

    # 19. the PointNet++ SSG model, FPS's streaming mode, the query past 16
    # combos and the default model's variants
    p2_launches, p2_extra = pointnet2_phase(dev, smi, cloud, dsn)
    path_launches.update(p2_launches)
    print("pointnet2 and variant paths, launches per kernel: " + json.dumps(
        {k: sum(p2_launches[p][k] for p in p2_launches) for k in _build.launches}))

    # 20. data parallelism: a world of one NCCL rank, two gloo ranks sharing
    # the card, and the point-axis-sharded DRP forward
    dp_launches = dp_phase(dev, smi)

    table = [
        {
            "name": name,
            "tpu_kernel": k_num,
            **({"covered_by": measured} if measured != name else {}),
            "route": "cuda",
            "source": f"graspbalance_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "path": path,
            "launches": path_launches[path][measured],
            "max_abs_err": errs[measured],
            "ms": times[measured][0],
            "plain_ms": times[measured][1],
            "bound_ms": bounds[measured][0],
            "bound_by": bounds[measured][1],
            "library_ms": times[measured][2],
            **({"latency_floor_ms": fps_floor_ms} if measured == "fps" else {}),
            **({"redesigned": True, "device_ms": device_ms[measured]} if measured in REDESIGNED else {}),
            "gate_launches": path_launches["gate"][measured],
            "dsn_train_launches": path_launches["dsn_train"][measured],
            "pointnet2_launches": sum(p2_launches[p][measured] for p in p2_launches),
            "dp_launches": dp_launches[measured],
            **({"streaming_ms": {str(n): ms for n, ms in p2_extra["stream"][measured].items()},
                "streaming_slots": STREAM_TIMED_M} if measured in p2_extra["stream"] else {}),
            **({"many_combos_ms": {str(c): t[0] for c, t in p2_extra["multicyl"].items()}}
               if measured == "multicyl" else {}),
        }
        for k_num, name, measured, source, replaces, path in KERNEL_TABLE
    ]
    table.append({
        "name": "bn_act_train",
        "tpu_kernel": None,
        "route": "cuda",
        "source": "graspbalance_tpu_torch/csrc/batchnorm.cu",
        "replaces": "none (the JAX package's BatchNorm is plain XLA)",
        "path": "train",
        "launches": {k: path_launches["train"][k] for k in BN_KERNELS},
        "max_abs_err": errs["bn"],
        "ms": times["bn"][0],
        "plain_ms": times["bn"][1],
        "bound_ms": bounds["bn"][0],
        "bound_by": bounds["bn"][1],
        "library_ms": times["bn"][2],
        "shapes": bn_shapes,
        "dsn_train_launches": {k: path_launches["dsn_train"][k] for k in BN_KERNELS},
        "pointnet2_launches": {k: sum(p2_launches[p][k] for p in p2_launches) for k in BN_KERNELS},
        "dp_launches": {k: dp_launches[k] for k in BN_KERNELS},
    })
    print(json.dumps({"kernels": table}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(multicard_main() if "WORLD_SIZE" in os.environ else main())
