"""graspbalance_tpu_torch: the GraspBalance eval forward, decode, serving
pipeline and training (on one card or data-parallel over several), and the
DSN's training, in PyTorch, with hand-written CUDA kernels for an
NVIDIA H100 (sm_90a).

A port of ``graspbalance_tpu`` (JAX), which stays the reference: each module
here mirrors the one at the same path there, keeps its channels-last
``(B, N, C)`` layout at every public function, and names its parameters
after the flax tree (``weights.py`` bridges JAX variables into a
``state_dict``). This package imports torch and numpy, never jax.

Layout:
  ops/      FPS, queries, gathers, kNN, three-NN interpolation, and the
            wrappers of the six CUDA kernels (``csrc/*.cu``, built by
            ``_build.py``): FPS and its masked mode, the multi-cylinder
            query, the width MLP, kNN, the collision counts
  nn/       BatchNorm / MLPBlock / SharedMLP (train-mode BatchNorm + ReLU
            through ``ops/batchnorm.py``'s kernels on the card), set
            abstraction and feature propagation
  models/   the DRP, PointNet++ and Point Transformer backbones, grasp
            heads, GraspBalance eval forward (with OBS re-seeding),
            pred_decode, the point-transformer DSN
  eval/     grasp NMS, voxel downsample + collision filter, mean shift, OBS,
            the end-to-end GraspInference pipeline and its dataset dump,
            closed-loop quality of both models
  labels/   grasp view geometry, label matching,
            the loss, the analytic synthetic labels, the DSN's seg losses
  data/     synthetic scenes with their label tensors; the GraspNet-1B
            dataset, host utilities, the native library's bindings, the
            offline label generators
  train/    the config tree, the training and eval steps, the epoch loop,
            checkpoints and metric streams; the DSN's training step
  cli/      command lines (python -m graspbalance_tpu_torch.cli.<name>):
            train, train_seg, quality_gate, dsn_quality_gate, infer, eval_ap
  parallel/ data-parallel training over torch.distributed ranks, and the
            DRP backbone with each cloud's points split over ranks
  utils/    parameter counts, bytes and norms
  trace.py  spans over the stages of a served call and of a training step,
            counters, and the host's waits on the card (off by default)
"""

__version__ = "0.1.0"
