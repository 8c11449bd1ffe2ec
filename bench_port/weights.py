"""Random weights from a seed, made on the device in one draw.

Every tensor of a state dict is filled from one ``torch.randn`` of all their
elements on a ``torch.Generator`` seeded with the run's seed: a linear
layer's (out, in) weight at std 1/sqrt(in), biases at std 0.1, a norm's
scale 1 + 0.1 n and offset 0.1 n, BatchNorm running means 0.1 n and
variances 1 + 0.2 |n|. So the same seed gives the same weights on the same
device, and the folds of BatchNorm into the layers before them (which the
program's fused kernels make) meet statistics that are not the identity.
"""

from __future__ import annotations

import math

import torch

# std of a unit normal truncated to (-2, 2)
TRUNC_NORMAL_STD = 0.87962566103423978


def generator(seed: int, device, salt: int = 0) -> torch.Generator:
    """A generator on ``device`` for ``seed`` (any whole number) and ``salt``."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1000003 + salt) % (2**63))


def random_state(shapes: dict[str, torch.Size], seed: int, device, salt: int = 0) -> dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device`` for every entry of ``shapes``."""
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, salt), device=device, dtype=torch.float32)
    out = {}
    for (name, shape), part in zip(shapes.items(), torch.split(flat, sizes)):
        n = part.reshape(shape)
        if name.endswith("running_var"):
            t = 1.0 + 0.2 * n.abs()
        elif name.endswith("running_mean"):
            t = 0.1 * n
        elif n.ndim == 2:
            t = n / math.sqrt(shape[1])
        elif name.endswith("weight"):
            t = 1.0 + 0.1 * n
        else:
            t = 0.1 * n
        out[name] = t.contiguous()
    return out


def shapes_of(module: torch.nn.Module) -> dict[str, torch.Size]:
    return {k: v.shape for k, v in module.state_dict().items()}


def flax_init_state(shapes: dict[str, torch.Size], seed: int, device, salt: int = 0) -> dict[str, torch.Tensor]:
    """A fresh model's tensors as flax initialises the JAX package's modules,
    from one draw on ``device``: every linear (out, in) weight lecun-normal
    (a unit normal truncated to (-2, 2) by inverting its CDF on a uniform
    draw in float64, rescaled to std 1/sqrt(in) over the truncated normal's
    std), every bias 0, every norm's scale and running variance 1, its
    offset and running mean 0."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    mats = {k: s for k, s in shapes.items() if len(s) == 2}
    sizes = [math.prod(s) for s in mats.values()]
    u = torch.rand(sum(sizes), generator=generator(seed, device, salt), device=device, dtype=torch.float64)
    x = (math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0)).clamp_(-2.0, 2.0).to(torch.float32)
    out = {}
    for (name, shape), part in zip(mats.items(), torch.split(x, sizes)):
        out[name] = (part.reshape(shape) * (1.0 / math.sqrt(shape[1]) / TRUNC_NORMAL_STD)).contiguous()
    for name, shape in shapes.items():
        if name not in out:
            one = name.endswith("running_var") or (name.endswith("weight") and ".bn." in f".{name}")
            out[name] = (torch.ones if one else torch.zeros)(shape, device=device, dtype=torch.float32)
    return {k: out[k] for k in shapes}
