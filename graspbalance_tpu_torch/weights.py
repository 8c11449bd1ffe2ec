"""The weight bridge: JAX package variables -> this package's state_dict.

``variables`` is the flax variable tree as nested dicts of arrays, with the
collections ``params`` and ``batch_stats`` (numpy arrays, or anything
``np.asarray`` takes). The port's modules carry the flax module names, so a
key is the flax path joined with dots and a renamed leaf:

  params      .../kernel (I, O)  ->  .../weight (O, I)   (torch Linear layout)
  params      .../bias           ->  .../bias
  params      .../bn/scale       ->  .../bn/weight
  params      .../ln|gn|in/scale ->  .../ln|gn|in/weight   (the registry's norms)
  params      .../PReLU_0/alpha  ->  .../PReLU_0/alpha
  batch_stats .../bn/mean        ->  .../bn/running_mean
  batch_stats .../bn/var         ->  .../bn/running_var

Both directions are checked: every flax leaf fills exactly one key, and
every key of the model's state_dict is filled, with its shape.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

_LEAVES = {
    "params": {"kernel": "weight", "bias": "bias", "scale": "weight", "alpha": "alpha"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _flatten(tree, prefix=()):
    for name, value in tree.items():
        if hasattr(value, "items"):  # dict or flax FrozenDict
            yield from _flatten(value, prefix + (str(name),))
        else:
            yield prefix + (str(name),), value


def state_dict_from_flax(variables, model: nn.Module) -> dict[str, torch.Tensor]:
    """Map flax ``variables`` onto ``model``'s state_dict keys; raise on any
    key that is missing, left over, duplicated or of the wrong shape."""
    unknown = set(variables) - set(_LEAVES)
    if unknown:
        raise ValueError(f"unexpected variable collections: {sorted(unknown)}")
    out: dict[str, torch.Tensor] = {}
    for collection, leaves in _LEAVES.items():
        for path, value in _flatten(variables.get(collection, {})):
            *mods, leaf = path
            if leaf not in leaves:
                raise ValueError(f"no port key for {collection}/{'/'.join(path)}")
            key = ".".join(mods + [leaves[leaf]])
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            arr = np.array(value, dtype=np.float32)  # a writable copy
            if leaf == "kernel":
                arr = np.ascontiguousarray(arr.T)
            out[key] = torch.from_numpy(arr)
    expected = model.state_dict()
    missing = sorted(expected.keys() - out.keys())
    extra = sorted(out.keys() - expected.keys())
    if missing or extra:
        raise ValueError(f"weight bridge mismatch: missing {missing}, left over {extra}")
    for key, t in out.items():
        if t.shape != expected[key].shape:
            raise ValueError(f"{key}: flax shape {tuple(t.shape)}, port {tuple(expected[key].shape)}")
    return out


def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Random weights from a seeded ``torch.Generator`` (on the CPU, so the
    same seed gives the same weights on any device): Linear weights and
    biases uniform in +-1/sqrt(fan_in), as torch initialises them, and
    non-trivial BatchNorm parameters and running statistics, so that the BN
    fold is exercised, and LayerNorm scales and offsets around 1 and 0."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                bound = 1.0 / mod.in_features**0.5
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * bound)
            elif hasattr(mod, "running_var"):
                n = mod.running_var.shape
                mod.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_mean.copy_(0.1 * torch.randn(n, generator=gen))
                mod.running_var.copy_(0.5 + torch.rand(n, generator=gen))
            elif isinstance(mod, nn.LayerNorm):
                n = mod.weight.shape
                mod.weight.copy_(1.0 + 0.1 * torch.randn(n, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(n, generator=gen))
    return model


def load_flax_variables(model: nn.Module, variables) -> nn.Module:
    """Load JAX variables into ``model`` (see ``state_dict_from_flax``)."""
    model.load_state_dict(state_dict_from_flax(variables, model), strict=True)
    return model
