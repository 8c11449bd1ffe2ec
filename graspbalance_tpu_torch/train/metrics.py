"""Metric aggregation and logging (port of graspbalance_tpu/train/
metrics.py).

A windowed aggregator keeps its sums on the device and syncs only when it
is flushed; a logger writes every window to ``{name}_metrics.jsonl`` and
``log_train.txt`` (and to TensorBoard where ``torch.utils.tensorboard``
imports; it is never required). ``step_timer`` times a step on the host
clock and ``profiler_trace`` records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch


class MetricAggregator:
    """Windowed mean. Each key's sum is a 0-dim tensor on the metrics'
    device, added lazily, so an update never waits for the device: the
    training loop syncs only at ``flush()``, every log_every steps."""

    def __init__(self):
        self._sums: dict = {}
        self._n = 0

    def update(self, metrics: dict):
        for k, v in metrics.items():
            self._sums[k] = v if k not in self._sums else self._sums[k] + v
        self._n += 1

    def flush(self) -> dict:
        """The window's mean of each key as a float (the first read syncs),
        and a new window."""
        if self._n == 0:
            return {}
        out = {k: float(v) / self._n for k, v in self._sums.items()}
        self._sums, self._n = {}, 0
        return out


class NullLogger:
    """A MetricLogger that writes nothing (a data-parallel rank other than
    0)."""

    def log(self, step: int, metrics: dict, echo: bool = True):
        pass

    def close(self):
        pass


class MetricLogger:
    """JSONL and text sinks in ``log_dir`` (and TensorBoard where it
    imports); close() closes them."""

    def __init__(self, log_dir: str, name: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"{name}_metrics.jsonl"), "a")
        self._txt = open(os.path.join(log_dir, "log_train.txt"), "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the optional sink: tensorboard is not installed
            pass
        else:
            self._tb = SummaryWriter(os.path.join(log_dir, name))

    def log(self, step: int, metrics: dict, echo: bool = True):
        rec = {"step": int(step), "time": time.time(), **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), int(step))
        if echo:
            msg = f"step {step}: " + " ".join(f"{k}={float(v):.4f}" for k, v in sorted(metrics.items()))
            self._txt.write(msg + "\n")
            self._txt.flush()
            print(msg)

    def close(self):
        self._jsonl.close()
        self._txt.close()
        if self._tb is not None:
            self._tb.close()


@contextlib.contextmanager
def step_timer(metrics_out: dict, key: str = "time/step_ms"):
    """Host-clock ms of the block into ``metrics_out[key]``. On the card
    this is the step's dispatch time, not its device time: PyTorch returns
    before the card finishes, and the timer does not synchronise (as the
    JAX package's returns before the TPU finishes)."""
    t0 = time.perf_counter()
    yield
    metrics_out[key] = (time.perf_counter() - t0) * 1000.0


@contextlib.contextmanager
def profiler_trace(log_dir: str, enabled: bool = False):
    """A ``torch.profiler`` trace of the block as a Chrome trace under
    ``log_dir/profile`` when ``enabled``."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace_dir = os.path.join(log_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{time.time_ns()}.json"))
