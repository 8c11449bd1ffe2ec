"""One dataclass config tree (port of graspbalance_tpu/train/config.py, with
the same fields, defaults and JSON layout; the port keeps its own copy: it
imports nothing of the JAX package).

Left out are the JAX package's four trace-time knobs of its TPU compiler
(``gather_vjp``, ``query_batch_chunk``, ``count_matmul``,
``query_extract_group``) and their ``GB_*`` environment overrides: nothing
on the card corresponds to them. ``config_from_dict`` ignores them, as it
ignores every unknown key, so a ``config.json`` written by the JAX package
loads here. ``train_step.check_supported`` refuses what the port cannot
honour: ``n_data_shards`` other than the process group's size or a batch it
does not divide, ``query_order`` ``'nearest_approx'`` (left behind: the
TPU's approximate top-k) and ``label_impl='reduced'``, and the values the
JAX package itself rejects.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_view: int = 300
    num_angle: int = 12
    num_depth: int = 4
    cylinder_radius: float = 0.08
    hmin: float = -0.02
    hmax_list: Sequence[float] = (0.01, 0.02, 0.03, 0.04)
    backbone: str = "drp"  # 'drp' | 'pointnet2' | 'pt' (models/graspbalance.py:BACKBONES)
    backbone_stages: tuple | None = None  # None = the backbone's full stage table
    num_seed: int = 1024
    query_order: str = "index"  # 'index' (reference parity) | 'nearest'
    dtype: str = "float32"  # compute dtype: 'float32' | 'bfloat16' (parameters stay float32)
    # the width head's compute dtype (None = follow `dtype`)
    width_mlp_dtype: str | None = None
    # label pipeline: 'full' only ('reduced' is refused: on the card its
    # training step peaked at the same memory as 'full', PERF.md; kept here
    # so that the JAX package's config.json files load)
    label_impl: str = "full"


@dataclasses.dataclass(frozen=True)
class DataConfig:
    dataset_root: str = ""  # GraspNet-1B root (data/dataset.py); empty = synthetic scenes
    camera: str = "realsense"  # 'realsense' | 'kinect'
    num_points: int = 20000
    max_objects: int = 16
    max_grasp_points: int = 4096
    batch_size: int = 2
    num_workers: int = 2
    ncm: bool = True  # noisy-clean per-object mix augmentation
    augment: bool = True
    precompute_fps: bool = True  # host-side FPS indices in the loader
    # synthetic analytic labels (labels/analytic.py): the step expands the
    # (B, P, V, A, D) label tensors on the device from the small geometry
    # arrays (obj_sizes, grasp_pt_obj, grasp_pt_mask) when the batch does
    # not carry them
    analytic_labels: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_epoch: int = 18
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    # the same Adam math as one multi-tensor update (torch.optim.Adam's
    # foreach implementation) instead of one update per parameter tensor;
    # the JAX package's name for it (there: optax.flatten)
    opt_flatten: bool = True
    bn_momentum_init: float = 0.5
    bn_decay_rate: float = 0.5
    bn_decay_step: int = 2
    bn_momentum_floor: float = 0.001
    log_dir: str = "logs/graspbalance_tpu"
    log_every: int = 10
    checkpoint_every_epochs: int = 1
    seed: int = 0  # the weights' initialisation (train_step.create_train_state)
    n_data_shards: int | None = None  # data-parallel ranks (None: every rank of the process group)
    # stop the epoch loop after this many epochs without changing max_epoch
    # (the OneCycle schedule keeps its length): a preemption at an epoch
    # boundary, for resume checks
    stop_after_epochs: int | None = None
    profile_steps: int = 0  # > 0: a torch.profiler trace over that many steps
    # (from step `profile_start` of the first epoch run, after warm-up)
    profile_start: int = 10


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    train: TrainConfig = TrainConfig()


def config_to_dict(cfg: Config) -> dict:
    """JSON-serialisable dict (tuples become lists; from_dict restores them)."""
    return dataclasses.asdict(cfg)


def config_from_dict(d: dict) -> Config:
    """Inverse of config_to_dict; ignores unknown keys, so a config written
    by the JAX package or a newer build loads."""

    def tuplify(v):
        # JSON has no tuple; every sequence-valued field is a tuple
        # (hmax_list, backbone_stages with its nested stage rows)
        if isinstance(v, list):
            return tuple(tuplify(x) for x in v)
        return v

    def build(cls, sub: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuplify(v) for k, v in sub.items() if k in names})

    return Config(
        model=build(ModelConfig, d.get("model", {})),
        data=build(DataConfig, d.get("data", {})),
        train=build(TrainConfig, d.get("train", {})),
    )
