"""Core layers: Linear (= 1x1 conv) + BatchNorm + ReLU blocks
(port of graspbalance_tpu/nn/layers.py).

Parameter names follow the flax tree: ``<block>.dense.weight`` (O, I),
``<block>.bn.weight`` / ``.bn.bias`` (flax ``scale`` / ``bias``) and the
buffers ``<block>.bn.running_mean`` / ``.bn.running_var`` (flax
``batch_stats``). ``init_flax_defaults_`` gives a fresh model the
initialisation flax gives the JAX package's modules.

Compute dtype: each module takes a ``dtype`` (float32 or bfloat16), as its
flax twin does. Parameters, BatchNorm statistics and their updates stay
float32; a ``Dense`` casts its input and parameters to ``dtype`` at each
call (flax ``Dense(dtype, param_dtype=float32)``), and a ``BatchNorm``
computes batch statistics in float32 and normalises in ``dtype``. No
autocast: the casts are where the JAX package makes them.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.ops.batchnorm import bn_act_train, bn_act_train_plain, kernel_rows, normalize
from graspbalance_tpu_torch.parallel.mesh import data_group

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def compute_dtype(name: str | None) -> torch.dtype | None:
    """The torch dtype of a config's dtype name (None stays None)."""
    return None if name is None else DTYPES[name]


def bn_momentum_schedule(
    epoch: int, *, init: float = 0.5, decay_rate: float = 0.5, decay_step: int = 2, floor: float = 0.001
) -> float:
    """The reference's BN momentum schedule:
    max(init * decay_rate ** (epoch // decay_step), floor), in float32."""
    m = np.float32(init) * np.float32(decay_rate) ** np.float32(epoch // decay_step)
    return float(np.maximum(m, np.float32(floor)))


class BatchNorm(nn.Module):
    """BatchNorm over all axes but the last, ``(x - mean) * (scale /
    sqrt(var + eps)) + bias``.

    Eval mode normalises with the running statistics. Train mode
    (``self.training``) normalises with the batch statistics, the variance
    biased and computed as mean(x^2) - mean^2 (as the JAX package does), and
    updates the running statistics in the torch-momentum convention,
    ``running = (1 - m) * running + m * batch``, with the unbiased variance
    n / (n - 1) * var; ``momentum`` is ``m``, set by the training step.
    Within ``parallel.mesh.data_parallel`` the batch statistics and n span
    every rank of its group (``ops/batchnorm.group_moments``), as the JAX
    package's mesh step computes them over the global batch; outside it, or
    in a group of one rank, nothing changes.
    The statistics are in the buffers' dtype (float32) whatever ``dtype``:
    a bfloat16 input is read as float32 for them, and the normalisation and
    the affine run in bfloat16 on the statistics and parameters cast to
    it."""

    def __init__(self, features: int, eps: float = 1e-5, momentum: float = 0.1, *, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor, act: bool = False) -> torch.Tensor:
        """The norm, then a ReLU with ``act``. A train-mode float32 call on a
        CUDA tensor runs the fused kernels (``ops/batchnorm.bn_act_train`` on
        the rows); any other train-mode call runs the plain version."""
        if not self.training:
            y = normalize(x, self.running_mean, self.running_var, self.weight, self.bias, self.eps, self.dtype)
            return torch.relu(y) if act else y
        args = (self.weight, self.bias, self.running_mean, self.running_var, self.momentum, self.eps, act)
        if x.is_cuda and self.dtype == torch.float32 and x.dtype == torch.float32:
            rows = kernel_rows(x.reshape(-1, x.shape[-1]))
            return bn_act_train(rows, *args, group=data_group()).view(x.shape)
        if x.is_cuda:
            trace.count("bn.plain")
        return bn_act_train_plain(x, *args, group=data_group(), dtype=self.dtype)

    def fold(self, dense_weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Fold this BN into the preceding bias-free dense layer:
        relu(x @ W^T) after BN == relu(x @ (W^T * a) + (beta - mean * a)),
        a = gamma / sqrt(var + eps). Returns (W_eff (I, O), b_eff (O,))."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return dense_weight.t() * a, self.bias - self.running_mean * a


def fused_eval_ok(module: nn.Module, x: torch.Tensor) -> bool:
    """Gate of a grouping module's fused eval branch (the explicit form of
    graspbalance_tpu/ops/pallas/mlpmax_kernel.py:fused_eval_ok): the module
    has ``fused_min_nsample`` set and ``nsample >= fused_min_nsample``, it is
    in eval mode, its compute dtype and ``x`` are float32."""
    return (
        module.fused_min_nsample is not None
        and module.nsample >= module.fused_min_nsample
        and not module.training
        and module.dtype == torch.float32
        and x.dtype == torch.float32
    )


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype``: its float32 parameters and its
    input are cast to ``dtype`` at each call (flax ``nn.Dense(dtype,
    param_dtype=float32)``); the output is in ``dtype``. In bfloat16 the
    product is rounded before the bias is added, as flax adds it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *, dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.dtype
        if d == torch.float32:
            return F.linear(x.to(self.weight.dtype), self.weight, self.bias)
        y = F.linear(x.to(d), self.weight.to(d))
        return y if self.bias is None else y + self.bias.to(d)


ORDERS = ("conv-norm-act", "norm-act-conv", "conv-act-norm")


class MLPBlock(nn.Module):
    """Linear + norm + activation in ``dtype``, in ``order``
    ('conv-norm-act', the default; 'norm-act-conv', whose norm takes the
    input's channels; 'conv-act-norm'). The linear layer has a bias only
    without a norm (``use_bn=False``), as in the reference. ``norm_type`` is
    any ``nn.registry.create_norm`` key (default 'bn', this module's
    BatchNorm in ``dtype``), ``act_type`` any ``create_act`` key (default
    'relu'); ``act=False`` drops the activation. The norm is named ``bn``
    whatever its kind, and a PReLU ``PReLU_0``, as in the flax tree."""

    def __init__(self, in_features: int, features: int, *, act: bool = True, use_bn: bool = True,
                 norm_type: str = "bn", act_type: str = "relu", order: str = "conv-norm-act", dtype=torch.float32):
        super().__init__()
        if order not in ORDERS:
            raise NotImplementedError(f"{order} is not supported")
        self.order = order
        self.act = act
        self.use_bn = use_bn
        self.dense = Dense(in_features, features, bias=not use_bn, dtype=dtype)
        if use_bn:
            norm_features = in_features if order == "norm-act-conv" else features
            if norm_type == "bn":
                self.bn = BatchNorm(norm_features, dtype=dtype)
            else:
                from graspbalance_tpu_torch.nn.registry import create_norm

                self.bn = create_norm(norm_type, norm_features)
        self.act_fn = torch.relu
        if act and act_type != "relu":
            from graspbalance_tpu_torch.nn.registry import create_act

            fn = create_act(act_type)
            if isinstance(fn, nn.Module):  # a PReLU: a submodule with its slopes
                self.add_module("PReLU_0", fn)
                fn = None
            self.act_fn = fn

    def _act(self, x: torch.Tensor) -> torch.Tensor:
        if not self.act:
            return x
        return self.PReLU_0(x) if self.act_fn is None else self.act_fn(x)

    def _post(self, x: torch.Tensor) -> torch.Tensor:
        """Norm and activation in the block's order (the linear layer done)."""
        if self.order == "conv-act-norm":
            x = self._act(x)
            return self.bn(x) if self.use_bn else x
        if self.use_bn and self.act and self.act_fn is torch.relu and isinstance(self.bn, BatchNorm):
            return self.bn(x, act=True)  # the ReLU fused into the norm
        x = self.bn(x) if self.use_bn else x
        return self._act(x)

    def forward(self, x: torch.Tensor, *, stage: str | None = None) -> torch.Tensor:
        """stage=None: the full block; 'dense': only the linear layer;
        'post': only the norm + activation on a precomputed pre-activation.
        The split lets a caller commute the linear layer with a gather; it
        needs the 'conv-norm-act' order."""
        if stage not in (None, "dense", "post"):
            raise ValueError(f"unknown stage {stage}")
        if stage is not None and self.order != "conv-norm-act":
            raise ValueError("staged call requires order='conv-norm-act'")
        if self.order == "norm-act-conv":
            return self.dense(self._post(x))
        if stage != "post":
            x = self.dense(x)
            if stage == "dense":
                return x
        return self._post(x)

    @torch.no_grad()
    def fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The block with its BN folded in (eval only): (W_eff (I, O), b_eff)."""
        if not isinstance(getattr(self, "bn", None), BatchNorm) or self.order != "conv-norm-act":
            raise ValueError("only a 'conv-norm-act' block with BatchNorm folds")
        return self.bn.fold(self.dense.weight)


class SharedMLP(nn.Sequential):
    """Stack of MLPBlocks over the trailing feature axis, named layer0, ...,
    in ``dtype``."""

    def __init__(self, in_features: int, layers: Sequence[int], *, dtype=torch.float32):
        super().__init__()
        for i, width in enumerate(layers):
            self.add_module(f"layer{i}", MLPBlock(in_features, width, dtype=dtype))
            in_features = width

    def fold(self) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
        """Every block's (W_eff, b_eff) with its BN folded in (eval only)."""
        return tuple(block.fold() for block in self)


# std of a unit normal truncated to (-2, 2); flax's variance_scaling divides
# by it so that the truncated draw keeps the target std
TRUNC_NORMAL_STD = 0.87962566103423978


def _truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """A unit normal truncated to (-2, 2), drawn by inverting the CDF of a
    uniform draw from ``generator`` (in float64, rounded to float32 once)."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)
    return x.clamp_(-2.0, 2.0).to(torch.float32)


@torch.no_grad()
def init_flax_defaults_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise ``module`` in place as flax initialises the JAX package's
    modules: every ``nn.Linear`` weight ``lecun_normal`` (a normal truncated
    to +-2 std and rescaled to std 1/sqrt(fan_in), fan_in = in_features)
    and its bias 0; every BatchNorm scale 1, offset 0, running mean 0 and
    variance 1; every ``nn.LayerNorm`` scale 1 and offset 0. ``generator``
    is a CPU ``torch.Generator``: the same seed gives the same weights on
    any device."""
    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            std = 1.0 / math.sqrt(mod.in_features) / TRUNC_NORMAL_STD
            mod.weight.copy_(_truncated_normal(mod.weight.shape, generator) * std)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    return module
