"""K9's probe: the kNN kernel's launch (``ops/knn.py:_launch``), which
``ops.knn`` calls for every search at k <= 32 on the card. ``measure``
captures the references, queries and k of every launch in one step of the
cell's own path, times each with CUDA events over repeated launches and
counts their operations and bytes (``counts/knn.py``)."""

from __future__ import annotations

import importlib

import torch

from bench_port.counts import knn as knn_counts


def measure(drive, reps: int = 5):
    """(device ms, operations, bytes), each summed over the launches that
    one ``drive()`` makes, or None where it makes none."""
    # the module itself: the package's ``ops.knn`` is its function of that name
    knn = importlib.import_module("graspbalance_tpu_torch.ops.knn")
    entry, seen = knn._launch, []

    def keep(ref, query, k, stats):
        seen.append((ref, query, k))
        return entry(ref, query, k, stats)

    knn._launch = keep
    try:
        drive()
    finally:
        knn._launch = entry
    if not seen:
        return None
    total_ms = total_ops = total_bytes = 0.0
    for ref, query, k in seen:
        entry(ref, query, k, None)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            entry(ref, query, k, None)
        end.record()
        torch.cuda.synchronize()
        total_ms += start.elapsed_time(end) / reps
        ops, nbytes = knn_counts.knn(ref.shape[0], query.shape[1], ref.shape[1], k)
        total_ops += ops
        total_bytes += nbytes
    return total_ms, total_ops, total_bytes
