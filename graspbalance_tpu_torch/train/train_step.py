"""The training and eval steps of GraspBalance (port of
graspbalance_tpu/train/train_step.py: ``build_model``, ``make_optimizer``,
``create_train_state``, ``_maybe_expand_analytic``, and the bodies of
``make_train_step`` and ``make_eval_step``).

A training step runs on the model's device: the training forward
(BatchNorm on batch statistics at the scheduled momentum, label matching on
the device), ``get_loss``, the backward (on the card the feature gathers'
backward is the scatter-add kernel, ``csrc/scatter.cu``), the Adam update at
the OneCycle learning rate, and, inside the forward, the BatchNorm
running-statistics update. An eval step is the reference's loss-only eval:
running BatchNorm statistics, the training label matching, ``get_loss``'s
metrics, without gradients.

Compute dtype (``cfg.model.dtype``, ``width_mlp_dtype``): float32, or
bfloat16 as the JAX package's production training runs (every module's
products and normalisations in bfloat16; parameters, BatchNorm statistics,
the heads' outputs, label matching, the loss and Adam in float32). TF32 is
off for float32 matrix products, and cuBLAS keeps float32 accumulation for
bfloat16 ones (``allow_bf16_reduced_precision_reduction=False``), as the
TPU accumulates; neither setting touches the other dtype's products.

Data parallelism (``cfg.train.n_data_shards`` ranks, the JAX package's
'data' mesh axis): ``train_step`` and ``eval_step`` take the
``parallel.mesh.make_mesh`` mesh and this rank's rows of the batch
(``parallel.mesh.shard_batch``). The forward and the loss run within
``data_parallel`` over the mesh's 'data' group: BatchNorm's batch
statistics and every loss denominator span the global batch, so that each
rank's loss is its share of the global-batch loss. The step then sums the
gradients over 'data' (a sum: the shares add up to the loss) and the
metrics, and every rank takes the same Adam step. The parameters start
equal on every rank (``parallel.mesh.replicate_``), and the step draws
nothing at random, so they stay equal. A mesh of one rank computes what
the one-process step computes, bit for bit.

A training step is the span ``gb.train_step`` of ``trace.py`` over
``gb.label_expand`` (the upload and the analytic labels), ``gb.forward_train``
(``GraspBalance.forward_train``'s own spans inside), ``gb.loss``,
``gb.backward``, ``gb.allreduce`` (with a mesh) and ``gb.optimizer``.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.eval.pipeline import resolve_device
from graspbalance_tpu_torch.labels.analytic import expand_batch_labels
from graspbalance_tpu_torch.labels.losses import get_loss
from graspbalance_tpu_torch.models.graspbalance import BACKBONES, GraspBalance
from graspbalance_tpu_torch.ops.query import ORDERS
from graspbalance_tpu_torch.parallel.mesh import (
    all_reduce_grads_,
    all_reduce_metrics,
    axis_group,
    data_parallel,
)
from graspbalance_tpu_torch.nn.layers import DTYPES, BatchNorm, bn_momentum_schedule, compute_dtype, init_flax_defaults_
from graspbalance_tpu_torch.train.config import Config


def check_supported(cfg: Config, world: int | None = None) -> None:
    """Raise ValueError on every value of ``cfg`` the port cannot honour:
    ``n_data_shards`` other than the ``world`` size (by default the process
    group's, 1 without one: ``n_data_shards=2`` needs a 2-rank group) or a
    ``batch_size`` it does not divide, ``query_order='nearest_approx'``
    (the TPU's approximate top-k, left behind), ``label_impl='reduced'``
    (the measurement that left it out), and the values the JAX package
    itself rejects: an unknown backbone, query order or compute dtype, and
    an ``hmax_list`` without ``num_depth`` entries."""
    m = cfg.model
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    shards = world if cfg.train.n_data_shards is None else cfg.train.n_data_shards
    if shards != world:
        raise ValueError(f"n_data_shards={cfg.train.n_data_shards!r} needs a process group of {shards} ranks; "
                         f"this one has {world} (torchrun --nproc_per_node={shards})")
    if cfg.data.batch_size % shards:
        raise ValueError(f"batch_size={cfg.data.batch_size} does not split over n_data_shards={shards} ranks")
    if m.backbone not in BACKBONES:
        raise ValueError(f"backbone={m.backbone!r}: one of {sorted(BACKBONES)}")
    if m.query_order not in ORDERS:
        raise ValueError(f"query_order={m.query_order!r}: one of {ORDERS} ('nearest_approx' targets the TPU's "
                         "approximate top-k unit and is not ported, ROADMAP 'Leave behind')")
    if len(m.hmax_list) != m.num_depth:
        raise ValueError(f"hmax_list={tuple(m.hmax_list)!r} needs num_depth={m.num_depth} entries")
    for name in ("dtype", "width_mlp_dtype"):
        value = getattr(m, name)
        if value not in DTYPES and not (name == "width_mlp_dtype" and value is None):
            raise ValueError(f"{name}={value!r}: a compute dtype is one of {sorted(DTYPES)}")
    if m.label_impl != "full":
        raise ValueError(
            f"label_impl={m.label_impl!r}: the port has the 'full' label pipeline only; 'reduced' is not "
            "ported because on the card its training step peaked at the same memory as 'full' at bs=2 "
            "and 4 (the peak falls in the backward, after the label tensors are freed; PERF.md)"
        )


def build_model(cfg: Config = Config(), *, device="cuda") -> GraspBalance:
    """The model of ``cfg`` on ``device`` (a CUDA device by default, which
    must exist; ``device="cpu"`` runs every kernel's plain version), with
    torch's default initialisation: ``create_train_state`` initialises it
    as the JAX package does. Every field of ``cfg.model`` is passed
    through; raises on settings the port cannot honour
    (``check_supported``)."""
    check_supported(cfg)
    m = cfg.model
    model = GraspBalance(
        num_view=m.num_view, num_angle=m.num_angle, num_depth=m.num_depth, cylinder_radius=m.cylinder_radius,
        hmin=m.hmin, hmax_list=tuple(m.hmax_list), backbone=m.backbone, backbone_stages=m.backbone_stages,
        num_seed=m.num_seed, query_order=m.query_order,
        dtype=compute_dtype(m.dtype), width_mlp_dtype=compute_dtype(m.width_mlp_dtype),
    )
    return model.to(resolve_device(device))


class OneCycleLR(torch.optim.lr_scheduler.OneCycleLR):
    """torch's OneCycleLR, except that past its last step it holds the final
    rate, as the JAX package's optax schedule clamps (torch's raises once
    stepped past ``total_steps``), and that its state_dict holds only plain
    values (so that a checkpoint loads with ``weights_only=True``)."""

    def get_lr(self):
        step = self.last_epoch
        self.last_epoch = min(step, self.total_steps - 1)
        try:
            return super().get_lr()
        finally:
            self.last_epoch = step

    def state_dict(self) -> dict:
        plain = (bool, int, float, str, list, dict, type(None))
        return {k: v for k, v in super().state_dict().items() if isinstance(v, plain)}


def make_optimizer(model: torch.nn.Module, cfg: Config, steps_per_epoch: int):
    """Adam (betas 0.9/0.999, eps 1e-8, L2 weight decay as optax's
    add_decayed_weights before adam) and OneCycle over max_epoch *
    steps_per_epoch steps (pct_start 0.3, cosine, div_factor 25,
    final_div_factor 1e4). Adam's beta1 is not cycled: optax keeps it at
    0.9. ``cfg.train.opt_flatten`` keeps the JAX package's meaning, the
    same math as one multi-tensor update: Adam's ``foreach``
    implementation. Returns (optimizer, scheduler)."""
    t = cfg.train
    optimizer = torch.optim.Adam(
        model.parameters(), lr=t.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=t.weight_decay, foreach=t.opt_flatten,
    )
    scheduler = OneCycleLR(
        optimizer, max_lr=t.learning_rate, total_steps=max(t.max_epoch * steps_per_epoch, 1),
        pct_start=0.3, div_factor=25.0, final_div_factor=1e4, anneal_strategy="cos",
        cycle_momentum=False,
    )
    return optimizer, scheduler


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer and schedule, and the count of steps taken
    (the JAX TrainState's step, params, batch_stats and opt_state)."""

    model: GraspBalance
    optimizer: torch.optim.Optimizer
    scheduler: OneCycleLR
    step: int = 0


def create_train_state(cfg: Config, steps_per_epoch: int, sample_batch: dict, *, device="cuda") -> TrainState:
    """A fresh model for training on ``device``, initialised from
    ``cfg.train.seed`` as flax initialises the JAX package's
    (``init_flax_defaults_``), with its optimizer and schedule.
    ``sample_batch`` is a batch of the stream, checked to carry what the
    step reads: the clouds, and the label tensors unless
    ``cfg.data.analytic_labels`` has the step expand them."""
    need = {"point_clouds", "objectness_label", "object_poses", "obj_mask", "grasp_points", "grasp_pt_obj",
            "grasp_pt_mask"}
    need |= {"obj_sizes"} if cfg.data.analytic_labels else {"grasp_labels", "grasp_widths", "grasp_tolerance"}
    missing = sorted(need - sample_batch.keys())
    if missing:
        raise ValueError(f"the training batches lack {missing}")
    model = build_model(cfg, device=device)
    init_flax_defaults_(model, torch.Generator().manual_seed(cfg.train.seed))
    return TrainState(model, *make_optimizer(model, cfg, steps_per_epoch))


def set_matmul_precision() -> None:
    """cuBLAS as the step needs it: float32 products without TF32, bfloat16
    products accumulated in float32 (no bfloat16 split-K reduction)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def set_bn_momentum(model: torch.nn.Module, momentum: float) -> None:
    for mod in model.modules():
        if isinstance(mod, BatchNorm):
            mod.momentum = momentum


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays or tensors as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _maybe_expand_analytic(batch: dict, cfg: Config) -> dict:
    """With ``cfg.data.analytic_labels``, a batch that carries only the
    geometry arrays gets its (B, P, V, A, D) label tensors expanded on its
    device (labels/analytic.py); any other batch is returned as it is."""
    if not cfg.data.analytic_labels or "grasp_labels" in batch:
        return batch
    m = cfg.model
    return expand_batch_labels(batch, m.num_view, m.num_angle, m.num_depth)


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
    with trace.span("gb.forward_train"):
        ep = model.forward_train(batch, plain=plain)
    ep["objectness_label"] = batch["objectness_label"]
    with trace.span("gb.loss"):
        return get_loss(ep)


def train_step(
    model: GraspBalance, optimizer, scheduler, batch: dict, epoch: int, cfg: Config = Config(),
    *, plain: bool = False, mesh=None,
) -> dict:
    """One step; ``batch`` (numpy arrays or tensors) is moved to the model's
    device and, with ``cfg.data.analytic_labels``, its labels expanded
    there. Returns the metrics as 0-dim tensors on the device (no host
    sync); the parameters' .grad keep this step's gradients (summed over
    the ranks). ``plain`` runs the plain PyTorch versions of FPS and the
    cylinder query (to compare against them on the card; see
    ``GraspBalance.forward_train``). With ``mesh``, ``batch`` is this
    rank's rows and the step is the global batch's (see the module
    docstring)."""
    with trace.span("gb.train_step"):
        set_matmul_precision()
        with trace.span("gb.label_expand"):
            batch = _maybe_expand_analytic(to_device(batch, next(model.parameters()).device), cfg)
        optimizer.zero_grad(set_to_none=True)
        group = axis_group(mesh, "data")
        with data_parallel(group):
            loss, metrics = forward_loss(model, batch, epoch, cfg, plain=plain)
            with trace.span("gb.backward"):
                loss.backward()
        if group is not None:
            with trace.span("gb.allreduce"):
                all_reduce_grads_(model, group)
                metrics = all_reduce_metrics(metrics, group)
        with trace.span("gb.optimizer"):
            optimizer.step()
            scheduler.step()
        return {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def eval_step(model: GraspBalance, batch: dict, cfg: Config = Config(), *, plain: bool = False, mesh=None) -> dict:
    """The loss-only eval step: the model in eval mode (running BatchNorm
    statistics; on the card the width head's fused MLP, which has no
    backward, hence no gradients here), label matching as in training, and
    ``get_loss``'s metrics as 0-dim tensors on the device. ``batch`` as for
    ``train_step``; ``plain`` runs the kernels' plain versions. With
    ``mesh``, ``batch`` is this rank's rows and the metrics are the global
    batch's."""
    set_matmul_precision()
    batch = _maybe_expand_analytic(to_device(batch, next(model.parameters()).device), cfg)
    model.eval()
    group = axis_group(mesh, "data")
    with data_parallel(group):
        ep = model.forward_train(batch, plain=plain)
        ep["objectness_label"] = batch["objectness_label"]
        metrics = get_loss(ep)[1]
    return metrics if group is None else all_reduce_metrics(metrics, group)
