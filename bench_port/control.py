"""The readings that a cell's correctness limits are set from, at the
cell's own sizes, without a measured window:

    python3 bench_port/control.py --workload <cell> --seeds 1 2 3 [--program]

For every seed, the control (the plain reference with TF32 products, put in
the program's place) and, with ``--program``, the program itself (with
``--fault``, a fault of the generator's planted in it) answer what a run of
that seed would check; the cell's comparison judges them. One JSON line per
seed and side: ``{"seed", "side", "checks"}``. A run of the benchmark never
runs this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import harness  # noqa: E402


def readings(root: Path, workload: str, seed: int, program: bool, device: str = "cuda", fault=None) -> dict:
    """side -> the cell's checks for ``seed`` (the cell's generator's ``readings``)."""
    cell = harness.load_cell(root, workload)
    return cell.generator().readings(cell, seed, program, device, fault)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--fault", default=None, help="a fault the generator plants in the program (its FAULTS)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in args.seeds:
        for side, checks in readings(ROOT, args.workload, seed, args.program, args.device, args.fault).items():
            print(json.dumps({"seed": seed, "side": side, "checks": {k: v for k, (v, _) in checks.items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
