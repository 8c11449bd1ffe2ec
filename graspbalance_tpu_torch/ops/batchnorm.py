"""Train-mode BatchNorm with the ReLU after it fused, over channels-last
rows (replaces no TPU kernel: the JAX package's BatchNorm is plain XLA,
which fuses it into its neighbours).

``bn_act_train(x, weight, bias, running_mean, running_var, momentum, eps,
act, group=None)`` takes x (rows, C) float32 and returns

  y = relu((x - mean) * inv + bias)     (act=False: without the ReLU),
  inv = weight / sqrt(var + eps),

with the batch statistics mean(x) and var = mean(x^2) - mean^2 over the
rows, and updates the running statistics in place in the torch-momentum
convention: running = (1 - m) * running + m * batch, the variance made
unbiased by n / (n - 1). With ``group`` (a process group of several ranks,
``parallel.mesh.data_group()``) the statistics and n span every rank: the
sums of x and x^2 and the row count are added over the ranks in float64
(``group_moments``), and the backward adds its per-channel sums over them
the same way. Its gradient is a ``torch.autograd.Function``:

  g = dy where y > 0 (every dy without the ReLU), d = x - mean,
  dbias = sum(g), dweight = sum(g * d) * rstd,
  dx = inv * (g - sum(g) / n - d * rstd^2 * sum(g * d) / n).

On a CUDA tensor the batch statistics come from the plain code's own
PyTorch reductions (``batch_moments``), so that the forward is the plain
code's bit for bit: the training step's label matching and view choices
take argmaxes of the forward's outputs, and statistics summed in another
order flip some of them. The kernels of ``csrc/batchnorm.cu`` then run the
forward's apply pass and the backward (a reduction pass and an apply pass;
deterministic, with no float atomics); only x is saved for the backward,
beside the per-channel mean, rstd and inv. On a CPU tensor the plain
version ``bn_act_train_plain`` runs: BatchNorm's train-mode PyTorch code,
whose backward is autograd's. ``bn_act_backward_plain`` is the closed form
of the kernels' backward in plain PyTorch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from graspbalance_tpu_torch import _build, trace
from graspbalance_tpu_torch.parallel.mesh import all_reduce_sum


def group_moments(s: torch.Tensor, q: torch.Tensor, rows: int, group):
    """The batch statistics over every rank of ``group`` from this rank's
    per-channel sums of x (``s``) and x^2 (``q``) over its ``rows`` rows:
    the sums and the row count, added over the ranks in float64 (the
    backward adds the cotangents over them too), give mean(x) and mean(x^2)
    in float32 and the variance mean(x^2) - mean^2 as one process forms
    it. Returns (mean, var, the unbiased factor n / (n - 1), n), the last
    two as float32 and float64 tensors of the global row count n."""
    c = s.shape[0]
    count = torch.full((1,), rows, dtype=torch.float64, device=s.device)
    total = all_reduce_sum(torch.cat([s.double(), q.double(), count]), group)
    n = total[-1]
    mean = (total[:c] / n).float()
    var = (total[c:2 * c] / n).float() - mean * mean
    return mean, var, (n / torch.clamp(n - 1, min=1)).float(), n


def batch_moments(xf: torch.Tensor, group, sq: torch.Tensor | None = None):
    """The batch statistics of ``xf`` (float32) over all its axes but the
    last, and over every rank of ``group``: (mean, var, the unbiased factor
    n / (n - 1), n). ``sq``, where given, is a tensor of xf's shape that
    takes xf * xf (the same values as a fresh product, in memory the caller
    reuses)."""
    if group is None:  # the mean first: autograd then adds x's cotangents in the plain code's order
        axes = tuple(range(xf.ndim - 1))
        mean = xf.mean(dim=axes)
        var = torch.mul(xf, xf, out=sq).mean(dim=axes) - mean * mean
        n = xf.numel() // xf.shape[-1]
        return mean, var, n / max(n - 1, 1), n
    rows = xf.reshape(-1, xf.shape[-1])
    s = rows.sum(dim=0)
    return group_moments(s, torch.mul(xf, xf, out=sq).reshape(rows.shape).sum(dim=0), rows.shape[0], group)


@torch.no_grad()
def update_running_(running_mean, running_var, mean, var, unbias, momentum: float) -> None:
    """running = (1 - m) * running + m * batch in place, the variance times
    ``unbias``; both factors rounded to float32, as the JAX package rounds
    them."""
    m = np.float32(momentum)
    keep, m = float(np.float32(1.0) - m), float(m)
    running_mean.copy_(keep * running_mean + m * mean)
    running_var.copy_(keep * running_var + m * (var * unbias))


def normalize(x, mean, var, weight, bias, eps: float, dtype=torch.float32):
    """(x - mean) * (weight / sqrt(var + eps)) + bias in ``dtype``: in
    float32 on the statistics and parameters as they are, otherwise with
    x, the statistics' factor and the parameters cast to ``dtype``."""
    if dtype == torch.float32:
        inv = weight * (1.0 / torch.sqrt(var + eps))
        return (x.to(mean.dtype) - mean) * inv + bias
    inv = weight.to(dtype) * (1.0 / torch.sqrt(var + eps)).to(dtype)
    return (x.to(dtype) - mean.to(dtype)) * inv + bias.to(dtype)


def bn_act_train_plain(x, weight, bias, running_mean, running_var, momentum: float, eps: float, act: bool,
                       group=None, dtype=torch.float32):
    """Plain PyTorch version over all axes of ``x`` but the last, in
    ``dtype`` (the statistics in the running buffers' dtype, float32, for
    any ``dtype``); its backward is autograd's."""
    mean, var, unbias, _ = batch_moments(x.to(running_mean.dtype), group)
    update_running_(running_mean, running_var, mean, var, unbias, momentum)
    y = normalize(x, mean, var, weight, bias, eps, dtype)
    return torch.relu(y) if act else y


def bn_act_backward_plain(dy, x, weight, bias, eps: float, act: bool, mask=None):
    """The closed form of the kernels' backward, in plain PyTorch, for x
    (rows, C) and the batch statistics of its rows: (dx, dweight, dbias).
    ``mask`` (where given) is the ReLU's y > 0, so that a check can take
    the kernel's own side of the ReLU's edge for an element within rounding
    of it."""
    n = x.shape[0]
    mean = x.mean(dim=0)
    var = (x * x).mean(dim=0) - mean * mean
    rstd = 1.0 / torch.sqrt(var + eps)
    inv = weight * rstd
    d = x - mean
    if act and mask is None:
        mask = d * inv + bias > 0
    g = torch.where(mask, dy, torch.zeros_like(dy)) if act else dy
    sg, sgd = g.sum(dim=0), (g * d).sum(dim=0)
    dx = inv * g - inv * (sg / n) - inv * rstd * rstd * (sgd / n) * d
    return dx, sgd * rstd, sg


@functools.lru_cache(maxsize=512)
def _partials(rows: int, c: int) -> int:
    """The slabs of the kernels' reduction pass over (rows, C)."""
    slabs = _build.library().gb_bn_partials(rows, c)
    if slabs <= 0:
        raise ValueError(f"batchnorm kernel refuses (rows, C) = {(rows, c)}")
    return slabs


class _BnActTrain(torch.autograd.Function):
    """``bn_act_train`` on a CUDA tensor (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps, act, group):
        rows, c = x.shape
        y = torch.empty_like(x)  # takes x * x first
        mean, var, unbias, n = batch_moments(x, group, sq=y)
        update_running_(running_mean, running_var, mean, var, unbias, momentum)
        rstd = 1.0 / torch.sqrt(var + eps)
        stat = torch.cat([mean, rstd, weight * rstd])  # [mean | rstd | inv]
        with torch.cuda.device(x.device):
            err = _build.library().gb_bn_apply(x.data_ptr(), stat.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, c,
                                               int(act), _build.stream_of(x))
        _build.check(err, "bn_apply")
        ctx.save_for_backward(x, stat, bias)
        ctx.act, ctx.group, ctx.n = act, group, n
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, stat, bias = ctx.saved_tensors
        rows, c = x.shape
        dy = kernel_rows(dy)
        lib, stream = _build.library(), _build.stream_of(x)
        part = torch.empty(_partials(rows, c) * 2 * c, dtype=torch.float32, device=x.device)
        out = torch.empty(4 * c, dtype=torch.float32, device=x.device)  # [dweight | dbias | c0 | cd]
        full = ctx.group is None
        with torch.cuda.device(x.device):
            err = lib.gb_bn_grad_reduce(dy.data_ptr(), x.data_ptr(), stat.data_ptr(), bias.data_ptr(),
                                        part.data_ptr(), out.data_ptr(), rows, c, float(np.float32(rows)),
                                        int(ctx.act), int(full), stream)
        _build.check(err, "bn_grad_reduce")
        if not full:  # out[2C:] holds this rank's [sum g | sum g * d]
            sums = all_reduce_sum(out[2 * c:].double(), ctx.group)
            rstd, inv = stat[c:2 * c], stat[2 * c:]
            out[2 * c:3 * c] = inv * (sums[:c] / ctx.n).float()
            out[3 * c:] = inv * rstd * rstd * (sums[c:] / ctx.n).float()
        dx = None
        if ctx.needs_input_grad[0]:
            dx = torch.empty_like(x)
            with torch.cuda.device(x.device):
                err = lib.gb_bn_grad_apply(dy.data_ptr(), x.data_ptr(), stat.data_ptr(), bias.data_ptr(),
                                           out[2 * c:].data_ptr(), dx.data_ptr(), rows, c, int(ctx.act), stream)
            _build.check(err, "bn_grad_apply")
        dweight = out[:c] if ctx.needs_input_grad[1] else None
        dbias = out[c:2 * c] if ctx.needs_input_grad[2] else None
        return dx, dweight, dbias, None, None, None, None, None, None


def kernel_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels take it: contiguous, and 16-byte aligned (a copy
    where it is not)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def bn_act_train(x, weight, bias, running_mean, running_var, momentum: float, eps: float, act: bool, group=None):
    """x (rows, C) f32 -> (rows, C) f32 (see the module docstring); the
    kernels on a CUDA tensor, the plain version on a CPU tensor."""
    if x.ndim != 2:
        raise ValueError(f"x must be (rows, C), got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return bn_act_train_plain(x, weight, bias, running_mean, running_var, momentum, eps, act, group)
    _build.require_cuda("x", x, torch.float32, 2)
    rows, c = x.shape
    for name, t in (("weight", weight), ("bias", bias), ("running_mean", running_mean),
                    ("running_var", running_var)):
        _build.require_cuda(name, t, torch.float32, 1)
        if t.shape[0] != c:
            raise ValueError(f"{name} must have {c} channels, got {t.shape[0]}")
    if c % 4 == 0 and x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned where C % 4 == 0 (the kernels' 16-byte loads)")
    if rows == 0:
        raise ValueError("x has no rows")
    trace.count("bn.fused")
    return _BnActTrain.apply(x, weight, bias, running_mean, running_var, momentum, eps, act, group)
