"""graspbalance_tpu_torch: the GraspBalance eval forward and decode in
PyTorch, with hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

A port of ``graspbalance_tpu`` (JAX), which stays the reference: each module
here mirrors the one at the same path there, keeps its channels-last
``(B, N, C)`` layout at every public function, and names its parameters
after the flax tree (``weights.py`` bridges JAX variables into a
``state_dict``). This package imports torch and numpy, never jax.

Layout:
  ops/      FPS, queries, gathers, three-NN interpolation, and the wrappers of
            the three CUDA kernels (``csrc/*.cu``, built by ``_build.py``)
  nn/       BatchNorm / MLPBlock / SharedMLP, set abstraction and feature
            propagation
  models/   DRP backbone, grasp heads, GraspBalance eval forward, pred_decode
  labels/   grasp view geometry
  data/     synthetic scene clouds
"""

__version__ = "0.1.0"
