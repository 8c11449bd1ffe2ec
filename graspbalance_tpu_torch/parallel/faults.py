"""Planted faults of the data-parallel step, for the checks that must tell
a wrong split of the global batch from the right one (the smoke's phase 20,
tests/test_torch_data_parallel.py). Each is the step as a per-rank
implementation would compute it.
"""

from __future__ import annotations

import contextlib

import graspbalance_tpu_torch.labels.losses as losses
import graspbalance_tpu_torch.nn.layers as layers

FAULTS = {
    "bn": "BatchNorm statistics of each rank's own rows",
    "loss": "each rank's own loss denominators, the loss the mean of the ranks' ratios (DDP's convention)",
}


@contextlib.contextmanager
def planted_fault(fault: str, world: int):
    """Within this context the data-parallel step over ``world`` ranks
    carries ``fault`` (a key of FAULTS; 'none': the step as it is)."""
    patches = {
        "none": [],
        "bn": [(layers, "data_group", lambda: None)],
        "loss": [(losses, "global_sum", lambda x: x * world), (losses, "global_mean", lambda x: x.mean() / world)],
    }[fault]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
