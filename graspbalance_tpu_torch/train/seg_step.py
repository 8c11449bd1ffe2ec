"""The DSN's training step, as graspbalance_tpu/cli/train_seg.py and
tools/dsn_quality_gate.py write it inline: the DSN's training forward
(BatchNorm on batch statistics at the constant momentum 0.1), the labels
``foreground_label = instance > 0`` and ``compute_center_offset_labels``,
``get_seg_loss`` with ``max_objects + 1`` classes, the backward (on the card
the gathers' backward is the scatter-add kernel) and Adam at the rate of
optax's ``cosine_onecycle_schedule(total_steps, lr, pct_start=0.3)``.

That schedule is not torch's OneCycleLR (train/train_step.py): it is two
cosine pieces between 0, int(0.3 * T) and T, computed in float32. At T = 10
optax gives 4e-5, 2.8e-4, 7.6e-4, 1e-3 at step 3; torch's OneCycleLR 4e-5,
5.2e-4, 1e-3 at step 2. ``CosineOneCycle`` computes optax's rates in
optax's order and precision.

Data parallelism as train/train_step.py has it: with a ``mesh``,
``seg_train_step`` takes this rank's rows, runs the forward and the loss
within ``data_parallel`` over 'data' (BatchNorm's statistics and the
weighted losses' denominators over the global batch), and sums the
gradients and the metrics over the ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from graspbalance_tpu_torch.labels.seg_losses import get_seg_loss
from graspbalance_tpu_torch.models.dsn import DSN, compute_center_offset_labels
from graspbalance_tpu_torch.nn.layers import init_flax_defaults_
from graspbalance_tpu_torch.parallel.mesh import all_reduce_grads_, all_reduce_metrics, axis_group, data_parallel
from graspbalance_tpu_torch.train.train_step import set_bn_momentum, set_matmul_precision

DSN_BN_MOMENTUM = 0.1  # the DSN's BatchNorm momentum, constant (the torch convention)
PCT_START = 0.3
DIV_FACTOR = 25.0
FINAL_DIV_FACTOR = 1e4


def cosine_onecycle_rate(count: int, total_steps: int, peak: float) -> float:
    """optax.cosine_onecycle_schedule(total_steps, peak, pct_start=0.3)
    at step ``count``, in float32 as optax computes it: from peak / 25 up to
    peak over [0, int(0.3 T)), down to peak / 2.5e5 over [int(0.3 T), T),
    then held."""
    bounds = (0, int(PCT_START * total_steps), int(total_steps))
    if bounds[1] == 0:
        # optax divides by the empty warm-up interval's length: its rates are NaN
        raise ValueError(f"cosine one-cycle over {total_steps} steps: the warm-up int(0.3 * T) is empty "
                         "(optax's schedule is NaN there); train at least 4 steps")
    # the values and (start - end) / 2 in float64 as numpy makes them, each
    # rounded to float32 where it meets the float32 step count
    values = np.cumprod([peak / DIV_FACTOR, DIV_FACTOR, 1.0 / (DIV_FACTOR * FINAL_DIV_FACTOR)])
    for i in range(2):
        if bounds[i] <= count < bounds[i + 1]:
            pct = np.float32(count - bounds[i]) / np.float32(bounds[i + 1] - bounds[i])
            start, end = values[i], values[i + 1]
            half = np.float32((start - end) / 2.0)
            return float(np.float32(end) + half * (np.cos(np.float32(np.pi) * pct) + np.float32(1.0)))
    return float(np.float32(values[-1]))


class CosineOneCycle(torch.optim.lr_scheduler.LRScheduler):
    """Sets every parameter group's rate to ``cosine_onecycle_rate`` of the
    step count (0 before the first ``step()``); its state_dict holds only
    plain values, so that a checkpoint loads with ``weights_only=True``."""

    def __init__(self, optimizer: torch.optim.Optimizer, total_steps: int, peak: float):
        cosine_onecycle_rate(0, total_steps, peak)  # refuses a schedule optax makes NaN
        self.total_steps = int(total_steps)
        self.peak = float(peak)
        super().__init__(optimizer)

    def get_lr(self):
        rate = cosine_onecycle_rate(self.last_epoch, self.total_steps, self.peak)
        return [rate for _ in self.optimizer.param_groups]

    def state_dict(self) -> dict:
        plain = (bool, int, float, str, list, dict, type(None))
        return {k: v for k, v in super().state_dict().items() if isinstance(v, plain)}


def make_seg_optimizer(model: torch.nn.Module, total_steps: int, lr: float = 1e-3):
    """optax.adam (betas 0.9/0.999, eps 1e-8, no weight decay) at the
    cosine one-cycle rate over ``total_steps``: (optimizer, scheduler)."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, foreach=True)
    return optimizer, CosineOneCycle(optimizer, total_steps, lr)


def init_dsn(model: DSN, seed: int = 0) -> DSN:
    """``model`` initialised in place as flax initialises the JAX DSN from
    PRNGKey(seed) in distribution (the draws differ); returns it."""
    return init_flax_defaults_(model, torch.Generator().manual_seed(seed))


def seg_forward_loss(model: DSN, cloud: torch.Tensor, instance: torch.Tensor, max_objects: int, *,
                     plain: bool = False):
    """The DSN's training forward and ``get_seg_loss`` on a batch on the
    model's device: cloud (B, N, 3), instance (B, N) int (0 = background).
    Puts the model in train mode at the DSN's BatchNorm momentum. ``plain``
    runs the plain PyTorch versions of FPS and kNN (the gathers' backward
    follows the device, ``ops/gather.py``). Returns (loss, metrics)."""
    set_bn_momentum(model, DSN_BN_MOMENTUM)
    model.train()
    instance = instance.long()
    ep = model.forward_train(cloud, plain=plain)
    ep["foreground_label"] = (instance > 0).long()
    ep["instance_label"] = instance
    ep["center_offset_label"] = compute_center_offset_labels(cloud, instance, max_objects)
    return get_seg_loss(ep, max_objects + 1)


def seg_train_step(model: DSN, optimizer, scheduler, cloud, instance, max_objects: int, *,
                   plain: bool = False, mesh=None) -> dict:
    """One step on cloud (B, N, 3) and instance (B, N) (numpy arrays or
    tensors, moved to the model's device; with ``mesh`` this rank's rows,
    and the step is the global batch's). Returns the metrics as 0-dim
    tensors on the device (no host sync); the parameters' .grad keep this
    step's gradients (summed over the ranks)."""
    set_matmul_precision()
    device = next(model.parameters()).device
    cloud = torch.as_tensor(cloud, device=device)[..., :3]
    instance = torch.as_tensor(instance, device=device)
    optimizer.zero_grad(set_to_none=True)
    group = axis_group(mesh, "data")
    with data_parallel(group):
        loss, metrics = seg_forward_loss(model, cloud, instance, max_objects, plain=plain)
        loss.backward()
    if group is not None:
        all_reduce_grads_(model, group)
        metrics = all_reduce_metrics(metrics, group)
    optimizer.step()
    scheduler.step()
    return {k: v.detach() for k, v in metrics.items()}
