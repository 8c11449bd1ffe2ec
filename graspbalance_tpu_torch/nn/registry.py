"""Norm and activation registries and the grouper feature-width map (port
of graspbalance_tpu/nn/registry.py).

Every norm acts on the trailing (channels-last) feature axis, so the
reference's dimension suffixes ('bn1d', 'ln2d', ...) and the 'fast' prefix
are aliases, and 'syncbn' is BatchNorm. LayerNorm, GroupNorm and
InstanceNorm follow flax's arithmetic, which the JAX package's registry
runs: statistics in float32 over the input read as float32, the variance as
max(E[x^2] - E[x]^2, 0), ``(x - mean) * (rsqrt(var + eps) * scale) + bias``,
with the registry's epsilon 1e-5 (passed explicitly: flax's and torch's
defaults differ from it and from each other). GroupNorm keeps the batch
axis (dim 0) apart and reduces over every other axis and the channels of a
group; InstanceNorm is GroupNorm with a group per channel. Activations are
the JAX package's, with its defaults: 'gelu' is the tanh approximation
(``jax.nn.gelu``), unless ``approximate=False`` is passed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from graspbalance_tpu_torch.nn.layers import BatchNorm

NORM_EPS = 1e-5  # the registry's epsilon for every norm

# the grouped rows' feature width per grouper feature mode; x = feature
# channels, 3 = xyz
CHANNEL_MAP = {
    "fj": lambda x: x,
    "df": lambda x: x,
    "assa": lambda x: x * 3,
    "assa_dp": lambda x: x * 3 + 3,
    "dp_fj": lambda x: 3 + x,
    "pj": lambda x: x,
    "dp": lambda x: 3,
    "pi_dp": lambda x: x + 3,
    "pj_dp": lambda x: x + 3,
    "dp_fj_df": lambda x: x * 2 + 3,
    "dp_fi_df": lambda x: x * 2 + 3,
    "pi_dp_fj_df": lambda x: x * 2 + 6,
    "pj_dp_fj_df": lambda x: x * 2 + 6,
    "pj_dp_df": lambda x: x + 6,
    "dp_df": lambda x: x + 3,
}


def _gelu(x, approximate: bool = True):
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _leaky_relu(x, negative_slope: float = 0.01):
    return F.leaky_relu(x, negative_slope)


def _elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


def _celu(x, alpha: float = 1.0):
    return F.celu(x, alpha)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


_ACT_LAYER = {
    "silu": F.silu,
    "swish": F.silu,
    "mish": _mish,
    "relu": torch.relu,
    "relu6": F.relu6,
    "leaky_relu": _leaky_relu,
    "leakyrelu": _leaky_relu,
    "elu": _elu,
    "celu": _celu,
    "selu": F.selu,
    "gelu": _gelu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "hard_sigmoid": F.hardsigmoid,
    "hard_swish": F.hardswish,
}


class PReLU(nn.Module):
    """Parametric ReLU with ``num_parameters`` slopes (flax leaf ``alpha``),
    x where x >= 0, else alpha * x."""

    def __init__(self, num_parameters: int = 1, init_value: float = 0.25):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((num_parameters,), float(init_value)))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


def create_act(act_args):
    """act_args: None | str | {'act': str, **kwargs} -> callable or None
    ('prelu' gives a ``PReLU`` module, with ``init`` read as its
    ``init_value``; torch's ``inplace`` is dropped)."""
    if act_args is None:
        return None
    if isinstance(act_args, str):
        act_args = {"act": act_args}
    act_args = dict(act_args)
    act = act_args.pop("act", None)
    act_args.pop("inplace", None)
    if act is None:
        return None
    act = act.lower()
    if act == "prelu":
        if "init" in act_args:
            act_args["init_value"] = act_args.pop("init")
        return PReLU(**act_args)
    if act not in _ACT_LAYER:
        raise ValueError(f"activation {act!r} is not supported")
    fn = _ACT_LAYER[act]
    if act_args:
        return lambda x: fn(x, **act_args)
    return fn


def flax_norm(x, weight, bias, eps: float, group_dims, num_groups: int | None = None, out_dtype=None):
    """Flax's normalisation (see the module docstring) over ``group_dims``
    of ``x`` (and, with ``num_groups``, the channels of each of that many
    groups of the last axis); the result in ``out_dtype``, else float32."""
    xf = x.float()
    if num_groups is not None:
        c = x.shape[-1]
        xg = xf.reshape(*x.shape[:-1], num_groups, c // num_groups)
        dims = tuple(d if d >= 0 else d - 1 for d in group_dims) + (-1,)
        mean = xg.mean(dim=dims, keepdim=True)
        var = torch.clamp((xg * xg).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
        mean = mean.expand_as(xg).reshape(x.shape)
        var = var.expand_as(xg).reshape(x.shape)
    else:
        mean = xf.mean(dim=group_dims, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=group_dims, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + eps) * weight) + bias
    return y if out_dtype is None else y.to(out_dtype)


class FlaxNorm(nn.Module):
    """A flax LayerNorm (``groups=None``) or GroupNorm (``groups`` groups)
    over the trailing axis, with a scale (``weight``) and an offset."""

    def __init__(self, features: int, eps: float, groups: int | None = None):
        super().__init__()
        if groups is not None and (groups < 1 or features % groups):
            raise ValueError(f"{groups} groups do not divide {features} channels")
        self.eps = eps
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if self.groups is None:
            return flax_norm(x, self.weight, self.bias, self.eps, (-1,))
        return flax_norm(x, self.weight, self.bias, self.eps, tuple(range(1, x.ndim - 1)), self.groups)


class StatlessNorm(nn.Module):
    """LayerNorm ('ln'), GroupNorm ('gn') or InstanceNorm ('in') under the
    name the JAX package's adapter gives it (its submodule ``ln``, ``gn`` or
    ``in``); no running statistics, the same in train and eval mode."""

    def __init__(self, features: int, kind: str = "ln", num_groups: int | None = None, eps: float = NORM_EPS):
        super().__init__()
        if kind == "ln":
            norm = FlaxNorm(features, eps)
        elif kind == "gn":
            norm = FlaxNorm(features, eps, num_groups or default_groups(features))
        elif kind == "in":
            norm = FlaxNorm(features, eps, features)
        else:
            raise ValueError(kind)
        self.kind = kind
        self.add_module(kind, norm)

    def forward(self, x):
        return getattr(self, self.kind)(x)


def default_groups(channels: int) -> int:
    """The largest divisor of ``channels`` that is <= 32."""
    for g in range(min(32, channels), 0, -1):
        if channels % g == 0:
            return g
    return 1


def create_norm(norm_args, channels: int, dimension=None, *, dtype=torch.float32):
    """norm_args: None | str | {'norm': str, **kwargs} -> module or None.
    'bn' + dimension '2d' completes to 'bn2d'; every suffixed variant
    normalises the trailing axis. ``eps`` and ``num_groups`` are read from
    the kwargs (eps default 1e-5). ``dtype``: a BatchNorm's compute dtype."""
    if norm_args is None:
        return None
    if isinstance(norm_args, dict):
        norm_args = dict(norm_args)
        norm = norm_args.pop("norm", None)
    else:
        norm, norm_args = norm_args, {}
    if norm is None:
        return None
    norm = norm.lower()
    if dimension is not None:
        dimension = str(dimension).lower()
        if dimension not in norm:
            norm += dimension
    base = norm.removeprefix("fast").removesuffix("1d").removesuffix("2d")
    eps = norm_args.get("eps", NORM_EPS)
    if base in ("bn", "syncbn"):
        return BatchNorm(channels, eps=eps, dtype=dtype)
    if base == "ln":
        return StatlessNorm(channels, "ln", eps=eps)
    if base == "gn":
        return StatlessNorm(channels, "gn", num_groups=norm_args.get("num_groups", default_groups(channels)), eps=eps)
    if base == "in":
        return StatlessNorm(channels, "in", eps=eps)
    raise ValueError(f"norm {norm!r} is not supported")
