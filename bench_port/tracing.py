"""Spans and the device trace, taken from the benchmark's side.

``Spans`` times calls into the program's layers with CUDA events (wrappers
and module hooks around its callables; nothing inside it), read once the
window has closed, and marks them as profiler ranges. ``profile_stretch``
runs ``torch.profiler`` over a few calls and reduces its trace to the
seconds in which a device operation ran, the length of the traced stretch,
the device operations that took the most time and the longest idle gaps by
what the host was doing.
"""

from __future__ import annotations

import functools
from collections import defaultdict

import torch
from torch.autograd import DeviceType


class Spans:
    """name -> a list of (start, end) CUDA event pairs, one per call."""

    def __init__(self):
        self.events = defaultdict(list)
        self.ranges = {}
        self.on = False

    def begin(self, name):
        self.ranges[name] = torch.profiler.record_function(name).__enter__()
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name].append([ev, None])

    def end(self, name):
        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events[name][-1][1] = ev
        self.ranges.pop(name).__exit__(None, None, None)

    def wrap(self, name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            self.begin(name)
            out = fn(*args, **kwargs)
            self.end(name)
            return out

        return timed

    def hook_module(self, name, module):
        module.register_forward_pre_hook(lambda *_: self.begin(name))
        module.register_forward_hook(lambda *_: self.end(name))

    def ms(self) -> dict[str, list[float]]:
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v] for k, v in self.events.items()}


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:120]


def _device_intervals(prof):
    return [((e.time_range.start, e.time_range.end), e.name) for e in prof.events()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation]


def profile_stretch(call, n_calls: int, n_host_calls: int = 2, top: int = 10) -> dict:
    """The device's busy time over ``n_calls`` back-to-back calls of
    ``call``, traced with the device's activity alone (tracing the host's
    operations as well slows the host by half): busy_s, window_s (from the
    stretch's first device operation to its last) and the ``top`` device
    operations by total seconds. Then ``n_host_calls`` more calls traced on
    both sides: the ``top`` idle stretches, summed by the innermost host
    operation or benchmark range (``record_function``) under their middle."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_calls):
            call()
        torch.cuda.synchronize()
    dev = _device_intervals(prof)
    if not dev:
        return {}
    w0, w1 = min(a for (a, _), _ in dev), max(b for (_, b), _ in dev)
    busy = _union([(a, b) for (a, b), _ in dev])
    by_op = defaultdict(float)
    for (a, b), name in dev:
        by_op[_short(name)] += (b - a) * 1e-6
    out = {
        "calls": n_calls,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:top],
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_host_calls):
            call()
        torch.cuda.synchronize()
    dev = _device_intervals(prof)
    host = [((e.time_range.start, e.time_range.end), e.name) for e in prof.events()
            if e.device_type != DeviceType.CUDA]
    w0, w1 = min(a for (a, _), _ in dev), max(b for (_, b), _ in dev)
    gaps, prev = [], w0
    for a, b in _union([(a, b) for (a, b), _ in dev]) + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    by_host = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        under = [(s, name) for (s, e), name in host if s <= mid <= e]
        by_host[max(under)[1] if under else "(no host operation)"] += (b - a) * 1e-6
    out["idle_gaps"] = sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:top]
    return out
