"""The port's tracer (``graspbalance_tpu_torch/trace.py``) on the card, at
the benchmark's cells, each built by its generator under ``bench_port/``
from one seed:

  syncs  the synchronising calls that torch's sync debug mode flags outside
         ``trace.host_read`` ("file:line": count) over one served call or
         one training step after the warm-up;
  cost   the host time per call (serving) or per two steps (training, the
         card synchronised at the end of each pair) with the tracer off,
         on with host stamps, and on with device events, in turns of a few
         calls each (off, host, device, device, host, off, ...) so that the
         host's drift falls on every mode alike; each mode's mean and
         median, and each over the off mode's, in %.

    python3 trace_check.py [--cells a,b] [--seed N] [--rounds R]

Prints one JSON line per cell and writes them to
``chiprun_out/trace_check.json``, each with the card's name and power
limit. Without a CUDA card it exits 2.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import sys
import time
from pathlib import Path

os.environ["OMP_NUM_THREADS"] = "1"
ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from bench_port import harness  # noqa: E402
from bench_port.traffic.serve import power_limit  # noqa: E402
from graspbalance_tpu_torch import trace  # noqa: E402

CELLS = ("pn2.serve.b4", "drp-obs.serve.b4", "drp.train.b8")
MODES = {"off": None, "host": False, "device": True}
ORDER = ("off", "host", "device", "device", "host", "off")


def build(cell, seed: int, dev):
    """(call(i), calls a turn, warm-up calls, close) of the cell's program:
    a call is one served call (warmed up over the pool), or two training
    steps."""
    gen = cell.generator()
    if cell.traffic["generator"] == "train":
        prog = gen.Program(cell, seed, gen.initial_state(cell, seed, dev), dev)

        def steps(i):
            prog.step()
            prog.step()

        return steps, 1, 2, prog.close
    inputs = gen.make_inputs(cell, seed, dev)
    infer = gen.build_program(cell, inputs, dev)
    nb = len(inputs.clouds)
    return lambda i: infer(inputs.clouds[i % nb], gumbel=inputs.gumbel[i % nb]), 4, nb, lambda: None


def timed_ms(call, i: int, mode) -> float:
    """One call with the tracer in ``mode``, to the card's end of it."""
    if mode is not None:
        trace.enable(device_events=mode)
    t = time.perf_counter()
    call(i)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    trace.disable()
    trace.take()
    return ms


def check_cell(name: str, seed: int, rounds: int, dev) -> dict:
    cell = harness.load_cell(ROOT, name)
    call, per_turn, warmup, close = build(cell, seed, dev)
    try:
        for i in range(warmup):
            call(i)
        torch.cuda.synchronize()
        syncs = collections.Counter(trace.syncs_outside_host_read(lambda: call(warmup)))
        torch.cuda.synchronize()
        times, i = {m: [] for m in MODES}, 0
        for _ in range(rounds):
            for mode in ORDER:
                for _ in range(per_turn):
                    times[mode].append(timed_ms(call, i, MODES[mode]))
                    i += 1
    finally:
        close()
    off = statistics.fmean(times["off"])
    return {"cell": name, "seed": seed, "syncs_outside_host_read": dict(syncs), "calls_a_mode": len(times["off"]),
            "mean_ms": {m: statistics.fmean(v) for m, v in times.items()},
            "median_ms": {m: statistics.median(v) for m, v in times.items()},
            "cost_pct": {m: 100.0 * (statistics.fmean(v) / off - 1.0) for m, v in times.items() if m != "off"},
            "cost_pct_median": {m: 100.0 * (statistics.median(v) / statistics.median(times["off"]) - 1.0)
                                for m, v in times.items() if m != "off"}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", default=",".join(CELLS))
    p.add_argument("--seed", type=int, default=2**31 + 12345)
    p.add_argument("--rounds", type=int, default=8)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_check.py needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    card = power_limit()
    lines = []
    for name in args.cells.split(","):
        line = {**check_cell(name, args.seed, args.rounds, dev), "card": card}
        print(json.dumps(line), flush=True)
        lines.append(line)
        torch.cuda.empty_cache()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "trace_check.json").write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
