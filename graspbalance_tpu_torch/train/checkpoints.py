"""Checkpoints with step granularity (port of graspbalance_tpu/train/
checkpoints.py, on ``torch.save`` in place of orbax).

In the checkpoint directory:
  step_{step}.pt     the latest ``max_to_keep`` (3) checkpoints
  best/step_{s}.pt   the one with the lowest loss passed to ``save``
  best.json          {"step", "loss"} of it
  extra_{step}.json  the caller's sidecar (the loop's epoch count)
  config.json        the Config, in the JAX package's layout

A checkpoint is a dict of plain values and tensors: the step, the model's
state_dict (BatchNorm running statistics included), the optimizer's and the
schedule's; it loads with ``torch.load(weights_only=True)``. Every file is
written under a temporary name and moved into place with ``os.replace``, so
a crash never leaves a torn checkpoint.
"""

from __future__ import annotations

import json
import os
import re
import shutil

import torch

from graspbalance_tpu_torch.train.config import Config, config_from_dict, config_to_dict

_STEP_FILE = re.compile(r"step_(\d+)\.pt")


def _replace_into(path: str, write) -> None:
    """Run ``write(tmp_path)``, then move the file into ``path``."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_json(path: str, obj) -> None:
    def write(tmp):
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=1)

    _replace_into(path, write)


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.fullmatch, os.listdir(directory)) if m)


def _load(path: str, map_location) -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._best_dir = os.path.join(self._dir, "best")
        self._best_path = os.path.join(self._dir, "best.json")
        self._max_to_keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def save_config(self, cfg: Config):
        """Write the Config beside the checkpoints, so that a later run or an
        inference entry point rebuilds the same model."""
        _write_json(os.path.join(self._dir, "config.json"), config_to_dict(cfg))

    def best_loss(self) -> float | None:
        if os.path.exists(self._best_path):
            with open(self._best_path) as f:
                return json.load(f)["loss"]
        return None

    def save(self, step: int, state, extra: dict | None = None, metrics: dict | None = None) -> str:
        """Save ``state`` (train_step.TrainState) as step ``step``; keep the
        newest ``max_to_keep``; with ``metrics={"loss": x}`` mirror it under
        best/ when x is the lowest loss so far. Returns the file's path."""
        payload = {
            "step": int(state.step),
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "scheduler": state.scheduler.state_dict(),
        }
        path = os.path.join(self._dir, f"step_{step}.pt")
        _replace_into(path, lambda tmp: torch.save(payload, tmp))
        for old in _steps(self._dir)[: -self._max_to_keep]:
            os.remove(os.path.join(self._dir, f"step_{old}.pt"))
        if extra:
            _write_json(os.path.join(self._dir, f"extra_{step}.json"), extra)
        loss = (metrics or {}).get("loss")
        if loss is not None:
            prev = self.best_loss()
            if prev is None or float(loss) < prev:
                os.makedirs(self._best_dir, exist_ok=True)
                best = os.path.join(self._best_dir, f"step_{step}.pt")
                _replace_into(best, lambda tmp: shutil.copyfile(path, tmp))
                for old in _steps(self._best_dir):
                    if old != step:
                        os.remove(os.path.join(self._best_dir, f"step_{old}.pt"))
                _write_json(self._best_path, {"step": int(step), "loss": float(loss)})
        return path

    def latest_step(self) -> int | None:
        steps = _steps(self._dir)
        return steps[-1] if steps else None

    def restore(self, state, step: int | None = None):
        """Load step ``step`` (default the latest) into ``state`` in place;
        returns (state, extra), extra {} when there is no sidecar, and
        (state, {}) unchanged when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return state, {}
        device = next(state.model.parameters()).device
        payload = _load(os.path.join(self._dir, f"step_{step}.pt"), device)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.scheduler.load_state_dict(payload["scheduler"])
        state.step = int(payload["step"])
        extra = {}
        sidecar = os.path.join(self._dir, f"extra_{step}.json")
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                extra = json.load(f)
        return state, extra


def load_config(directory: str) -> Config | None:
    """The Config saved by ``CheckpointManager.save_config`` (by this
    package or the JAX package), or None where there is none."""
    path = os.path.join(os.path.abspath(directory), "config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return config_from_dict(json.load(f))


def load_inference_variables(directory: str, step: int | None = None, best: bool = False,
                             map_location="cpu") -> tuple[dict, int]:
    """The model state_dict (parameters and BatchNorm statistics) of a
    checkpoint, for inference without an optimizer; returns (state_dict,
    step). ``best=True`` reads the best-loss mirror; ``step`` defaults to
    the latest."""
    directory = os.path.abspath(directory)
    if best:
        directory = os.path.join(directory, "best")
        if not os.path.isdir(directory):
            raise FileNotFoundError(
                f"no best-loss mirror at {directory} (train for one epoch-end save with a loss, or drop best)"
            )
    if step is None:
        steps = _steps(directory)
        if not steps:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        step = steps[-1]
    payload = _load(os.path.join(directory, f"step_{step}.pt"), map_location)
    return payload["model"], int(payload["step"])
