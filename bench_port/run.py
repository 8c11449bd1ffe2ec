"""The benchmark's command: one cell, one seed, one process on one card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the kernels built or loaded, weights and inputs made from the seed,
the cell's shapes warmed up), then ``--seconds`` of measured traffic, then
the check against the plain reference. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``, every
number compared beside its limit (also the last lines of standard error).
Without a CUDA card, or with fewer cards than the cell asks for, it exits 2
and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
os.environ.setdefault("USE_FLAX", "0")
# one process with one host compute thread: the work is the card's, and idle
# intra-op threads only contend with the thread that dispatches it
os.environ["OMP_NUM_THREADS"] = "1"

from bench_port import harness  # noqa: E402


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda", t0=None):
    """Run one cell and return (result dict, checks); the caller prints."""
    cell = harness.load_cell(root, workload)
    run = cell.generator().run(cell, seed=seed, seconds=seconds, trace=trace, device=device,
                            t0=T0 if t0 is None else t0)
    metrics = harness.read_metrics(cell.per_layer if trace else cell.end_to_end, run, cell.bench)
    result = {"correct": bool(run.correct), "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics, "device": run.device}
    if trace and run.breakdown is not None:
        result["breakdown"] = run.breakdown
    result["notes"] = run.notes
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return result, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    marks = {"torch": time.perf_counter() - T0}  # set-up's first marks, seconds from the process's start
    torch.set_num_threads(1)
    chips = harness.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    marks["cards"] = time.perf_counter() - T0
    result, run = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    run.notes["setup_marks_s"] = {**marks, **run.notes["setup_marks_s"]}
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    print(f"notes: {json.dumps(run.notes)}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
