"""The program's own spans and counters (``graspbalance_tpu_torch/trace.py``),
for the per-layer metrics that read them (``dispatch_ms.*``,
``sync_wait_ms.*``, ``label_ms.train``).

The generators never switch the program's tracer on, so a traced run's
window runs the same code as an untraced one. Once a traced run's
generator has returned, the first reader that asks calls ``read``: it
starts a fresh process (``python3 -m bench_port.program_trace``: the
generator's profiled passes leave the profiler's hooks in this one, which
slow every later launch by a few per cent) that builds the cell's program
again, from the seed of the command line (``--workload``, ``--seed``;
without them it finds nothing), warms it up and measures it in a pass of
its own:

  warm-up   serving: once over the pool's batches (every batch's shapes
            allocated once); training: two steps.
  window    serving: twice over the pool's batches, as the window cycles
            them, the tracer on with host stamps (the host path stays
            light), then once more with device events; training:
            ``WINDOW_STEPS`` steps with device events. Per call or step:
            each span's calls, host ms, the host's waits on the card inside
            it (``wait_ms``) and its device ms between CUDA events
            (``event_ms``: busy and idle, on the card's clock); every
            counter (``sync_wait_ns`` as ``sync_wait_ms``); the window's
            host time per call or step, the card synchronised at its end.
  profiled  ``PROFILED_CALLS`` calls or the mix's ``profile_steps`` steps
            under torch.profiler (host and device), the tracer on: each
            device operation goes to the innermost ``gb.`` range open on
            the dispatching thread when it was launched (the runtime call
            that the profiler correlates with it), each idle gap of the
            device to the innermost ``gb.`` range open there at the gap's
            middle. Per call or step and span (inclusive of the spans
            inside it): device busy ms, idle ms, device operations. The
            profiler slows the host, so a host-bound pass idles longer than
            the window (``program_window``: ``busy_ms + idle_ms`` against
            ``call_ms``); ``event_ms - device_ms`` is the idle inside a span
            without it.

``read`` keeps the result on the run (``run.program``) and adds
``notes.program_spans``, ``notes.counters`` and ``notes.program_window``.
A program without the tracer module gives nothing.
"""

from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import os
import subprocess
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType

WINDOW_STEPS = 4
PROFILED_CALLS = 4
OUTSIDE = "(outside)"


def command_cell(argv=None):
    """(workload, seed) of the command line, or None."""
    p = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    p.add_argument("--workload")
    p.add_argument("--seed")
    args, _ = p.parse_known_args(sys.argv[1:] if argv is None else argv)
    if not args.workload or not (args.seed or "").lstrip("-").isdigit():
        return None
    return args.workload, int(args.seed)


def program_has_tracer() -> bool:
    return importlib.util.find_spec("graspbalance_tpu_torch.trace") is not None


def read(run, root: Path) -> dict:
    """The program's spans and counters for ``run`` (see the module
    docstring), measured on the first call; {} where there are none."""
    if getattr(run, "program", None) is None:
        run.program = {}
        found = command_cell()
        if found and program_has_tracer():
            device = "cuda" if run.device.get("platform") == "gpu" else "cpu"
            if device == "cuda":
                torch.cuda.empty_cache()  # the run's memory, for the new process's program
            program = Path(importlib.util.find_spec("graspbalance_tpu_torch").origin).parents[1]
            env = dict(os.environ, PYTHONPATH=os.pathsep.join(dict.fromkeys([str(root), str(program)])))
            cmd = [sys.executable, "-m", "bench_port.program_trace", "--root", str(root), "--workload", found[0],
                   "--seed", str(found[1]), "--device", device]
            done = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=900)
            if done.returncode != 0:
                raise RuntimeError(f"{' '.join(cmd)} exited {done.returncode}: {done.stderr[-2000:]}")
            run.program = json.loads(done.stdout.strip().splitlines()[-1])
            run.notes.update(program_spans=run.program["spans"], counters=run.program["counters"],
                             program_window=run.program["window"])
    return run.program


def _serving(cell, seed, device):
    gen = cell.generator()
    inputs = gen.make_inputs(cell, seed, device)
    infer = gen.build_program(cell, inputs, device)
    nb = len(inputs.clouds)

    def call(i):
        infer(inputs.clouds[i % nb], gumbel=inputs.gumbel[i % nb])

    return call, nb, 2 * nb, nb, PROFILED_CALLS, lambda: None


def _training(cell, seed, device):
    gen = cell.generator()
    prog = gen.Program(cell, seed, gen.initial_state(cell, seed, device), device)
    return lambda i: prog.step(), 2, WINDOW_STEPS, 0, cell.traffic["profile_steps"], prog.close


def _window(trace, call, n: int, device_events: bool, sync):
    """``n`` calls with the tracer on: what it took, and the seconds to the
    card's end of the last."""
    trace.enable(device_events=device_events)
    try:
        t = time.perf_counter()
        for i in range(n):
            call(i)
        sync()
        seconds = time.perf_counter() - t
    finally:
        trace.disable()
    return trace.take(), seconds


def measure(cell, seed: int, device) -> dict:
    from graspbalance_tpu_torch import trace
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    train = cell.traffic["generator"] == "train"
    call, warmup, n_window, n_events, n_profiled, close = (_training if train else _serving)(cell, seed, device)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    try:
        for i in range(warmup):
            call(i)
        sync()
        window, window_s = _window(trace, call, n_window, train, sync)
        events = _window(trace, call, n_events, True, sync)[0] if n_events else None
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        trace.enable()
        try:
            with profile(activities=activities) as prof:
                for i in range(n_profiled):
                    call(i)
                sync()
        finally:
            trace.disable()
            trace.take()
    finally:
        close()
    top = "gb.train_step" if train else "gb.call"
    spans, counters = _window_table(window, top, n_window)
    if events is not None:  # serving: the device events from a window of their own
        for name, row in _window_table(events, top, n_events)[0].items():
            if "event_ms" in row:
                spans.setdefault(name, {})["event_ms"] = row["event_ms"]
    profiled = _profile_table(prof.events(), n_profiled, top)
    for name, row in profiled["spans"].items():
        spans.setdefault(name, {}).update(row)
    return {"spans": spans, "counters": counters,
            "window": {"calls": n_window, "call_ms": 1e3 * window_s / n_window, **profiled["window"],
                       "seconds": time.perf_counter() - t0}}


def _window_table(window: dict, top: str, n: int):
    """Per call or step (``n`` of them): each span's calls, host ms, the
    waits inside it (its own and those of the spans inside it) and its
    device ms between CUDA events; the counters."""
    spans = window["spans"]
    parent = {s["id"]: s["parent"] for s in spans}
    name_of = {s["id"]: s["name"] for s in spans}
    rows = defaultdict(lambda: defaultdict(float))
    for s in spans:
        row = rows[s["name"]]
        row["calls"] += 1 / n
        row["host_ms"] += (s["t1_ns"] - s["t0_ns"]) * 1e-6 / n
        if "device_ms" in s:
            row["event_ms"] += s["device_ms"] / n
        seen, sid = set(), s["id"]
        while sid is not None:
            if name_of[sid] not in seen:
                seen.add(name_of[sid])
                rows[name_of[sid]]["wait_ms"] += s["wait_ns"] * 1e-6 / n
            sid = parent.get(sid)
    counters = {k: v / n for k, v in window["counters"].items() if k != "sync_wait_ns"}
    counters["sync_wait_ms"] = window["counters"].get("sync_wait_ns", 0) * 1e-6 / n
    return {k: dict(v) for k, v in rows.items()}, counters


def _innermost(ranges, starts, t):
    """Index of the innermost range of ``ranges`` (sorted by start, longest
    first) that holds ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i is not None and i >= 0:
        a, b, _, up = ranges[i]
        if a <= t <= b:
            return i
        i = up  # it ended before t: only a range around it can hold t
    return None


def _profile_table(events, n: int, top: str) -> dict:
    """Per call (``n`` of them): each ``gb.`` range's device busy ms, idle
    ms and device operations, inclusive of the ranges inside it, on the
    thread that runs the ``top`` ranges (the one that dispatches)."""
    by_thread, launches, ops = defaultdict(list), {}, []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation:
                ops.append(e)
        elif e.name.startswith("gb."):
            by_thread[e.thread].append([e.time_range.start, e.time_range.end, e.name, None])
        elif e.name.startswith("cu"):  # a runtime call: cudaLaunchKernel, cudaMemcpyAsync, ...
            launches[e.id] = e.time_range.start
    main = next((th for th, rs in by_thread.items() if any(r[2] == top for r in rs)), None)
    ranges = sorted(by_thread.get(main, []), key=lambda r: (r[0], -r[1]))
    stack = []
    for i, r in enumerate(ranges):
        while stack and ranges[stack[-1]][1] < r[0]:
            stack.pop()
        r[3] = stack[-1] if stack else None
        stack.append(i)
    starts = [r[0] for r in ranges]

    def names_at(t):
        """The names of the ranges open at ``t``, innermost first."""
        i, names = _innermost(ranges, starts, t), []
        while i is not None:
            if ranges[i][2] not in names:
                names.append(ranges[i][2])
            i = ranges[i][3]
        return names or [OUTSIDE]

    busy, idle, count = Counter(), Counter(), Counter()
    matched = 0
    for e in ops:
        t = launches.get(e.id)
        matched += t is not None
        for name in names_at(e.time_range.start if t is None else t):
            busy[name] += (e.time_range.end - e.time_range.start) * 1e-3
            count[name] += 1
    merged = []
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in ops):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    for (_, a), (b, _) in zip(merged, merged[1:]):
        for name in names_at(0.5 * (a + b)):
            idle[name] += (b - a) * 1e-3
    tops = {r[2] for r in ranges if r[3] is None}
    op_ms = sum(e.time_range.end - e.time_range.start for e in ops) * 1e-3
    spans = {k: {"device_ms": busy[k] / n, "idle_ms": idle[k] / n, "ops": count[k] / n} for k in set(busy) | set(idle)}
    return {"spans": spans, "window": {
        "busy_ms": sum(b - a for a, b in merged) * 1e-3 / n, "idle_ms": sum(b - a for (_, a), (b, _) in
                                                                            zip(merged, merged[1:])) * 1e-3 / n,
        "top_level": sorted(tops), "top_level_busy_share": sum(busy[k] for k in tops) / op_ms if op_ms else None,
        "ops": len(ops) / n, "launch_matched_share": matched / len(ops) if ops else None}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="one cell's program measured with its tracer on: one JSON line")
    p.add_argument("--root", required=True)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from bench_port import harness

    torch.set_num_threads(1)
    cell = harness.load_cell(Path(args.root), args.workload)
    print(json.dumps(measure(cell, args.seed, torch.device(args.device))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
