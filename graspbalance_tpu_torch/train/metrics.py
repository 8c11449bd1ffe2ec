"""Metric aggregation and logging (port of graspbalance_tpu/train/
metrics.py).

A windowed aggregator keeps its sums on the device and syncs only when it
is flushed; a logger writes every window to ``{name}_metrics.jsonl`` and
``log_train.txt`` (and to TensorBoard where ``torch.utils.tensorboard``
imports; it is never required). ``step_timer`` times a step on the card
and on the host clock, and ``profiler_trace`` records a ``torch.profiler``
trace with the port's spans (``trace.py``) on.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from graspbalance_tpu_torch import trace

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
def step_timer(metrics_out: dict, device="cpu"):
    """The block's times into ``metrics_out``: ``time/dispatch_ms``, the
    host-clock ms of the block (on the card the time to issue the step:
    PyTorch returns before the card finishes), and ``time/step_ms``. On a
    CUDA ``device`` that is the block's device time, a ``trace.DeviceMs``
    between CUDA events around it, which adds up in a ``MetricAggregator``
    and is read when the window is flushed (a flush waits for the card
    anyway, so no step waits for it); elsewhere the step runs on the host,
    and it is the host time."""
    cuda = torch.device(device).type == "cuda"
    device_ms = trace.DeviceMs.start() if cuda else None
    t0 = time.perf_counter()
    yield
    metrics_out["time/dispatch_ms"] = (time.perf_counter() - t0) * 1000.0
    metrics_out["time/step_ms"] = device_ms.stop() if cuda else metrics_out["time/dispatch_ms"]


@contextlib.contextmanager
def profiler_trace(log_dir: str, enabled: bool = False):
    """A ``torch.profiler`` trace of the block as a Chrome trace under
    ``log_dir/profile`` when ``enabled``, with the port's spans on for the
    block (unless a caller already had them on), so that the trace shows
    their ranges; the spans' own records are dropped."""
    if not enabled:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    trace_dir = os.path.join(log_dir, "profile")
    os.makedirs(trace_dir, exist_ok=True)
    spans_on = not trace.enabled()
    if spans_on:
        trace.enable()
    try:
        with torch.profiler.profile(activities=activities) as prof:
            yield
    finally:
        if spans_on:
            trace.disable()
            trace.take()
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace_{time.time_ns()}.json"))
