"""Dense / BatchNorm / MLP blocks of the plain reference, float32.

Parameter names follow the program's (its flax tree's): ``<block>.dense.weight``
(O, I), ``<block>.bn.weight`` / ``.bn.bias`` and the buffers
``.bn.running_mean`` / ``.bn.running_var``, so that one state dict loads into
both.

Every product of the reference goes through ``matmul`` or ``linear``: in
float32 (TF32 off), or, inside ``tf32_products()``, with both operands
rounded to TF32 first (10 mantissa bits, to nearest even, then a float32
product), the precision of a TF32 tensor-core product. That is the control
of the correctness check: the reference computed one step of precision
below the configuration's.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.nn.functional as F
from torch import nn

_TF32 = contextvars.ContextVar("tf32_products", default=False)


@contextlib.contextmanager
def tf32_products():
    """Within: every product of the reference rounds its operands to TF32."""
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the nearest TF32 value (ties to even)."""
    i = x.float().contiguous().view(torch.int32)
    r = (i + (0xFFF + ((i >> 13) & 1))) & -0x2000
    return r.view(torch.float32)


def _operands(*ts):
    """The operands as a product sees them (TF32-rounded inside
    ``tf32_products``), passing gradients through unchanged."""
    if not _TF32.get():
        return ts
    return tuple(t + (round_tf32(t) - t).detach() for t in ts)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _operands(a, b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = _operands(a, b)
    return torch.einsum(eq, a, b)


class _TF32Linear(torch.autograd.Function):
    """A linear layer whose forward and backward products all take TF32
    operands, as TF32 tensor cores compute both."""

    @staticmethod
    def forward(ctx, x, w, b):
        xr, wr = round_tf32(x), round_tf32(w)
        ctx.save_for_backward(xr, wr)
        ctx.has_bias = b is not None
        return F.linear(xr, wr, b)

    @staticmethod
    def backward(ctx, gy):
        xr, wr = ctx.saved_tensors
        g = round_tf32(gy)
        gx = g @ wr
        gw = g.reshape(-1, g.shape[-1]).t() @ xr.reshape(-1, xr.shape[-1])
        gb = gy.reshape(-1, gy.shape[-1]).sum(dim=0) if ctx.has_bias else None
        return gx, gw, gb


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    if _TF32.get():
        return _TF32Linear.apply(x.float(), w, b)
    return F.linear(x.float(), w, b)


class Dense(nn.Linear):
    def forward(self, x):
        return linear(x, self.weight, self.bias)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis: in eval mode with the running
    statistics, in train mode with the batch's (the variance as
    mean(x^2) - mean^2); the running statistics are not updated here."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        mean, var = self.running_mean, self.running_var
        if self.training:
            axes = tuple(range(x.ndim - 1))
            mean = x.mean(dim=axes)
            var = (x * x).mean(dim=axes) - mean * mean
        inv = self.weight * (1.0 / torch.sqrt(var + self.eps))
        return (x - mean) * inv + self.bias

    def fold(self, dense_weight):
        """(W_eff (I, O), b_eff (O,)) of relu(bn(x @ W^T)) == relu(x @ W_eff + b_eff)."""
        a = self.weight * torch.rsqrt(self.running_var + self.eps)
        return dense_weight.t() * a, self.bias - self.running_mean * a


class MLPBlock(nn.Module):
    """Linear (no bias) + BatchNorm + ReLU (``act=False``: no ReLU)."""

    def __init__(self, in_features: int, features: int, *, act: bool = True):
        super().__init__()
        self.act = act
        self.dense = Dense(in_features, features, bias=False)
        self.bn = BatchNorm(features)

    def post(self, x):
        x = self.bn(x)
        return torch.relu(x) if self.act else x

    def forward(self, x):
        return self.post(self.dense(x))

    def fold(self):
        return self.bn.fold(self.dense.weight)


class SharedMLP(nn.Sequential):
    def __init__(self, in_features: int, layers):
        super().__init__()
        for i, width in enumerate(layers):
            self.add_module(f"layer{i}", MLPBlock(in_features, width))
            in_features = width

    def fold(self):
        return tuple(block.fold() for block in self)
