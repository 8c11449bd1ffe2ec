"""One training step of GraspBalance (port of
graspbalance_tpu/train/train_step.py: ``build_model``, ``make_optimizer`` and
the body of ``make_train_step``, with ``backbone='drp'``,
``label_impl='full'``).

A step runs on the model's device: the training forward (BatchNorm on batch
statistics at the scheduled momentum, label matching on the device),
``get_loss``, the backward (on the card the feature gathers' backward is the
scatter-add kernel, ``csrc/scatter.cu``), the Adam update at the OneCycle
learning rate, and, inside the forward, the BatchNorm running-statistics
update. Everything stays float32: TF32 is off for the matrix products.
"""

from __future__ import annotations

import torch

from graspbalance_tpu_torch.eval.pipeline import resolve_device
from graspbalance_tpu_torch.labels.losses import get_loss
from graspbalance_tpu_torch.models.drp import DRP_STAGES
from graspbalance_tpu_torch.models.graspbalance import GraspBalance
from graspbalance_tpu_torch.nn.layers import BatchNorm, bn_momentum_schedule
from graspbalance_tpu_torch.train.config import Config


def build_model(cfg: Config = Config(), *, device="cuda") -> GraspBalance:
    """The model of ``cfg`` on ``device`` (a CUDA device by default, which
    must exist; ``device="cpu"`` runs every kernel's plain version)."""
    m = cfg.model
    model = GraspBalance(
        num_view=m.num_view, backbone_stages=m.backbone_stages or DRP_STAGES, num_seed=m.num_seed
    )
    return model.to(resolve_device(device))


def make_optimizer(model: torch.nn.Module, cfg: Config, steps_per_epoch: int):
    """Adam (betas 0.9/0.999, eps 1e-8, L2 weight decay as optax's
    add_decayed_weights before adam) and OneCycleLR over max_epoch *
    steps_per_epoch steps (pct_start 0.3, cosine, div_factor 25,
    final_div_factor 1e4). Adam's beta1 is not cycled: optax keeps it at
    0.9. Returns (optimizer, scheduler)."""
    t = cfg.train
    optimizer = torch.optim.Adam(
        model.parameters(), lr=t.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=t.weight_decay,
    )
    scheduler = torch.optim.lr_scheduler.OneCycleLR(
        optimizer, max_lr=t.learning_rate, total_steps=max(t.max_epoch * steps_per_epoch, 1),
        pct_start=0.3, div_factor=25.0, final_div_factor=1e4, anneal_strategy="cos",
        cycle_momentum=False,
    )
    return optimizer, scheduler


def set_bn_momentum(model: torch.nn.Module, momentum: float) -> None:
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.momentum = momentum


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def forward_loss(model: GraspBalance, batch: dict, epoch: int, cfg: Config = Config(), *, plain: bool = False):
    """The training forward and ``get_loss`` on a batch already on the
    model's device; puts the model in train mode and sets every BatchNorm's
    momentum for ``epoch``. Returns (loss, metrics)."""
    t = cfg.train
    set_bn_momentum(model, bn_momentum_schedule(
        epoch, init=t.bn_momentum_init, decay_rate=t.bn_decay_rate,
        decay_step=t.bn_decay_step, floor=t.bn_momentum_floor,
    ))
    model.train()
    ep = model.forward_train(batch, plain=plain)
    ep["objectness_label"] = batch["objectness_label"]
    return get_loss(ep)


def train_step(
    model: GraspBalance, optimizer, scheduler, batch: dict, epoch: int, cfg: Config = Config(),
    *, plain: bool = False,
) -> dict:
    """One step; ``batch`` (numpy arrays or tensors) is moved to the model's
    device. Returns the metrics as 0-dim tensors on the device (no host
    sync); the parameters' .grad keep this step's gradients. ``plain`` runs
    the plain PyTorch versions of FPS and the cylinder query (to compare
    against them on the card; see ``GraspBalance.forward_train``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = to_device(batch, next(model.parameters()).device)
    optimizer.zero_grad(set_to_none=True)
    loss, metrics = forward_loss(model, batch, epoch, cfg, plain=plain)
    loss.backward()
    optimizer.step()
    scheduler.step()
    return {k: v.detach() for k, v in metrics.items()}
