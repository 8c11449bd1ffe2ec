"""The training step's settings: the fields of graspbalance_tpu/train/
config.py that the step reads, with the same defaults (the port keeps its
own copy: it imports nothing of the JAX package)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    num_view: int = 300
    num_seed: int = 1024
    backbone_stages: tuple | None = None  # None = the full DRP stage table


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    max_epoch: int = 18
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    bn_momentum_init: float = 0.5
    bn_decay_rate: float = 0.5
    bn_decay_step: int = 2
    bn_momentum_floor: float = 0.001


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
