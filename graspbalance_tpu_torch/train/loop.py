"""The epoch-level training loop (port of graspbalance_tpu/train/loop.py).

Works with any source of batches: ``train_batches(epoch)`` yields dicts of
numpy arrays (or tensors), made on a background thread (``Prefetch``) and
uploaded through a ``TransferCache``. Per epoch the loop runs the training
steps (the BatchNorm momentum of the epoch), logs a metric window every
``log_every`` steps, runs one eval pass when ``eval_batches`` is given,
saves a checkpoint every ``checkpoint_every_epochs`` with the epoch's mean
loss, and logs its own telemetry. A run resumes from the latest checkpoint
in ``log_dir/checkpoints``, and refuses to when its model config differs
from the stored ``config.json``.

In a process group (``torchrun``, or ``parallel.ranks.run_ranks``) the loop
trains data-parallel over ``cfg.train.n_data_shards`` ranks (None: every
rank), as the JAX loop trains over its 'data' mesh: every rank draws the
same global batches from ``train_batches`` and uploads only its rows (the
transfer cache is keyed on the source array, so the static labels still
upload once), steps with the mesh (train_step.py), and computes the same
global metrics. Only rank 0 writes: ``config.json``, the metric streams,
the checkpoints, the profile. Every rank resumes from the checkpoints.

Streams in ``log_dir`` (JSONL, and the text log ``log_train.txt``):
  train_metrics.jsonl  each window's mean metrics and the data source's
                       ``telemetry()`` counters; ``time/step_ms`` is the
                       step's device time on a CUDA device (a CUDA event
                       pair around the step, read when the window is
                       flushed, which waits for the card anyway; the host
                       time elsewhere), ``time/dispatch_ms`` the host's
                       time to issue the step (``metrics.step_timer``)
  test_metrics.jsonl   each eval pass's mean metrics
  loop_metrics.jsonl   per epoch: ``loop/ms_per_step`` (the epoch's host
                       time over its steps, the card synchronised at its
                       end), ``loop/prefetch_wait_share`` (of that time, the
                       share spent waiting for a batch),
                       ``loop/uploaded_bytes`` and ``loop/uploads/<key>``
                       (the transfer cache's uploads in the epoch, eval
                       included), and with a checkpoint
                       ``loop/checkpoint_ms`` and ``loop/checkpoint_bytes``

With ``profile_steps``, the profiled steps run with the port's spans on
(``trace.py``, through ``metrics.profiler_trace``), so the Chrome trace
shows each step's stage ranges (``gb.train_step``, ``gb.transfer``, and
``gb.make_batch`` on the prefetch thread).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import queue
import threading
import time
from typing import Callable, Iterable

import numpy as np
import torch
import torch.distributed as dist

from graspbalance_tpu_torch import trace
from graspbalance_tpu_torch.eval.pipeline import resolve_device
from graspbalance_tpu_torch.parallel.mesh import is_lead, make_mesh, replicate_, shard_rows
from graspbalance_tpu_torch.train.checkpoints import CheckpointManager, load_config
from graspbalance_tpu_torch.train.config import Config
from graspbalance_tpu_torch.train.metrics import MetricAggregator, MetricLogger, NullLogger, profiler_trace, step_timer
from graspbalance_tpu_torch.train.train_step import check_supported, create_train_state, eval_step, train_step


class TransferCache:
    """Host -> device uploads keyed by the host array's identity, per key.
    With a ``mesh`` only this rank's rows of each array are uploaded
    (``parallel.mesh.shard_rows``), still keyed by the whole array.

    A source that hands the same array object again (the synthetic static
    labels, or a loader reusing its buffers) gets one upload; an array that
    changes every step is uploaded every step. The cache holds the host
    array, so its identity stays valid. On the card an upload is copied
    through pinned memory and issued without blocking; a numpy array
    broadcast along its leading axis (stride 0, as the static labels are)
    is uploaded once and expanded on the device. ``uploads`` counts the
    uploads per key and ``uploaded_bytes`` their bytes. ``put`` is the span
    ``gb.transfer``."""

    def __init__(self, device, mesh=None):
        self.device = torch.device(device)
        self.mesh = mesh
        self._host: dict = {}
        self._dev: dict = {}
        self.uploads: collections.Counter = collections.Counter()
        self.uploaded_bytes = 0

    def put(self, batch: dict) -> dict:
        out = {}
        with trace.span("gb.transfer"):
            for k, a in batch.items():
                if self._host.get(k) is not a:
                    self._host[k] = a
                    self._dev[k] = self._upload(shard_rows(a, self.mesh))
                    self.uploads[k] += 1
                out[k] = self._dev[k]
        return out

    def take_counts(self) -> tuple[dict, int]:
        """The uploads per key and their bytes since the last call (or
        since the cache was made); starts counting anew."""
        counts, nbytes = dict(self.uploads), self.uploaded_bytes
        self.uploads, self.uploaded_bytes = collections.Counter(), 0
        return counts, nbytes

    def _upload(self, a) -> torch.Tensor:
        if isinstance(a, torch.Tensor):
            self.uploaded_bytes += a.numel() * a.element_size()
            return a.to(self.device, non_blocking=True)
        a = np.asarray(a)
        shape = a.shape
        if a.ndim and a.strides[0] == 0:
            a = a[:1]
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        pinned = self.device.type == "cuda"
        host = torch.empty(a.shape, dtype=dtype, pin_memory=pinned)
        host.numpy()[...] = a
        self.uploaded_bytes += host.numel() * host.element_size()
        return host.to(self.device, non_blocking=pinned).expand(shape)


class Prefetch:
    """Iterate ``iterable`` on a background thread, ``depth`` items ahead,
    so that making a batch on the host overlaps the device's step. An
    exception in the source is raised in the consumer. ``wait_s`` counts
    the seconds the consumer spent waiting for an item. Making each item is
    the span ``gb.make_batch``, on the background thread."""

    _END = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._work, args=(iterable,), daemon=True)
        self._thread.start()

    def _work(self, iterable):
        try:
            items = iter(iterable)
            while True:
                with trace.span("gb.make_batch"):
                    item = next(items, self._END)
                if item is self._END:
                    break
                self._q.put((True, item))
        except BaseException as e:  # handed to the consumer, which raises it
            self._q.put((False, e))
        else:
            self._q.put((True, self._END))

    def __iter__(self):
        while True:
            t = time.perf_counter()
            ok, item = self._q.get()
            self.wait_s += time.perf_counter() - t
            if not ok:
                raise item
            if item is self._END:
                return
            yield item


def _check_resume(ckpt: CheckpointManager, ckpt_dir: str, cfg: Config) -> bool:
    """True when ``ckpt_dir`` holds a run to resume; raises when its stored
    model config differs from ``cfg``'s (the run would continue under
    another model and overwrite the record of the first)."""
    stored = load_config(ckpt_dir)
    if ckpt.latest_step() is None or stored is None:
        return False
    mismatched = [f.name for f in dataclasses.fields(cfg.model)
                  if getattr(stored.model, f.name) != getattr(cfg.model, f.name)]
    if mismatched:
        raise ValueError(
            f"resume config mismatch: this run's model config differs from the checkpoint's stored config "
            f"on {mismatched} ({ckpt_dir}/config.json); use the stored values or a fresh log_dir"
        )
    return True


def train(
    cfg: Config,
    train_batches: Callable[[int], Iterable[dict]],
    eval_batches: Callable[[], Iterable[dict]] | None = None,
    steps_per_epoch: int | None = None,
    *,
    device="cuda",
):
    """Train from ``train_batches(epoch)`` (batch dicts) on ``device`` (the
    card by default; ``device="cpu"`` runs the kernels' plain versions);
    ``steps_per_epoch`` defaults to the length of epoch 0's stream and
    sets the OneCycle schedule's length (a longer stream holds its final
    rate). Returns the train_step.TrainState. Raises, before it writes
    anything, on a config the port cannot honour (``check_supported``).
    In a process group, ``device`` is this rank's."""
    check_supported(cfg)
    device = resolve_device(device)
    mesh = make_mesh(cfg.train.n_data_shards, device_type=device.type) if dist.is_initialized() else None
    lead = is_lead()
    sample = next(iter(train_batches(0)), None)
    if sample is None:
        raise ValueError("empty training stream")
    if steps_per_epoch is None:
        steps_per_epoch = sum(1 for _ in train_batches(0))

    t = cfg.train
    ckpt_dir = os.path.join(t.log_dir, "checkpoints")
    ckpt = CheckpointManager(ckpt_dir)
    if not _check_resume(ckpt, ckpt_dir, cfg) and lead:
        ckpt.save_config(cfg)

    state = create_train_state(cfg, steps_per_epoch, sample, device=device)
    state, extra = ckpt.restore(state)
    replicate_(state.model, mesh)
    start_epoch = int(extra["epoch"]) if extra else state.step // steps_per_epoch
    transfers = TransferCache(device, mesh)
    logger, eval_logger, loop_logger = (MetricLogger(t.log_dir, name) if lead else NullLogger()
                                        for name in ("train", "test", "loop"))
    profile = contextlib.ExitStack()
    try:
        for epoch in range(start_epoch, t.max_epoch):
            agg, epoch_agg = MetricAggregator(), MetricAggregator()  # windows; the epoch's loss
            t_epoch = time.perf_counter()
            batches = Prefetch(train_batches(epoch))
            steps = 0
            for i, batch in enumerate(batches):
                if t.profile_steps > 0 and epoch == start_epoch and lead:  # steps [start, start + n) of the first epoch
                    if i == t.profile_start:
                        profile.enter_context(profiler_trace(t.log_dir, enabled=True))
                    elif i == t.profile_start + t.profile_steps:
                        profile.close()
                batch = transfers.put(batch)
                with step_timer(metrics := {}, device):
                    metrics_dev = train_step(state.model, state.optimizer, state.scheduler, batch, epoch, cfg,
                                             mesh=mesh)
                state.step += 1
                steps += 1
                metrics.update(metrics_dev)
                agg.update(metrics)
                epoch_agg.update({"loss/overall_loss": metrics_dev["loss/overall_loss"]})
                if (i + 1) % t.log_every == 0:
                    window = agg.flush()
                    telemetry = getattr(train_batches, "telemetry", None)
                    if telemetry is not None:  # the data source's counters, in the same stream
                        window.update(telemetry())
                    logger.log(state.step, window)
            profile.close()
            rest = agg.flush()
            if rest:
                logger.log(state.step, rest)
            epoch_loss = epoch_agg.flush().get("loss/overall_loss")
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t_epoch
            if lead:
                print(f"epoch {epoch} done in {wall:.1f}s")
            record = {"loop/epoch": epoch, "loop/ms_per_step": wall * 1e3 / max(steps, 1),
                      "loop/prefetch_wait_share": batches.wait_s / wall}

            if eval_batches is not None:
                eagg = MetricAggregator()
                for batch in eval_batches():
                    eagg.update(eval_step(state.model, transfers.put(batch), cfg, mesh=mesh))
                eval_logger.log(state.step, eagg.flush())

            if (epoch + 1) % t.checkpoint_every_epochs == 0 and lead:
                t_save = time.perf_counter()
                path = ckpt.save(state.step, state, extra={"epoch": epoch + 1},
                                 metrics={"loss": epoch_loss} if epoch_loss is not None else None)
                record["loop/checkpoint_ms"] = (time.perf_counter() - t_save) * 1e3
                record["loop/checkpoint_bytes"] = os.path.getsize(path)
            uploads, record["loop/uploaded_bytes"] = transfers.take_counts()
            record.update({f"loop/uploads/{k}": n for k, n in uploads.items()})
            loop_logger.log(state.step, record, echo=False)

            if t.stop_after_epochs is not None and epoch + 1 >= t.stop_after_epochs:
                break  # a preemption at an epoch boundary: the schedule stays the full run's
    finally:
        profile.close()
        logger.close()
        eval_logger.close()
        loop_logger.close()
    if mesh is not None:
        # no rank returns before rank 0's last checkpoint is on disk: a run
        # resumed in the same process group must find it on every rank
        dist.barrier()
    return state
