"""Parameter introspection (port of graspbalance_tpu/utils/misc.py).

Each function takes a module (its parameters), a state dict, or any
iterable of tensors (a list of gradients); ``None`` entries, as
``p.grad`` of an unused parameter, are skipped."""

from __future__ import annotations

import torch


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        tree = tree.parameters()
    elif isinstance(tree, dict):
        tree = tree.values()
    return [t for t in tree if t is not None]


def count_params(tree) -> int:
    return sum(t.numel() for t in _tensors(tree))


def param_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm (grad-norm logging), float32, 0-dim."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in _tensors(tree)))
