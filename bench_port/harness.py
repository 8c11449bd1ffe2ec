"""The benchmark's machinery, driven by data.

A cell of ``BENCHMARK.json`` names a configuration (its ``file``, a JSON of
the model's arguments under ``bench_port/configs/``) and a traffic mix
(``bench_port/traffic/<traffic>.json``, whose ``generator`` names the
general generator ``bench_port/traffic/<generator>.py`` that runs it).
A configuration's ``model.backbone`` names its backbone's files: the
reference backbone ``bench_port/reference/backbones/<backbone>.py`` (the
module, its sampling contract and its tiny CPU stages) and its operation
count ``bench_port/counts/backbones/<backbone>.py``.
Every metric is a reader ``bench_port/metrics/<name>.py`` with a
``read(run)`` that takes it from what the generator recorded, or returns
None when it finds nothing; a per-layer metric's ``workloads`` lists
the cells that report it. A reader that names a kernel probe (``PROBE``)
has the generator run ``bench_port/kernels/<probe>.py`` in a traced run on
the card: it captures the kernel entry's inputs on the cell's own path,
times them and counts their operations and bytes (``run.kernels``). The
limits of a cell's correctness check are ``bench_port/limits/<cell>.json``.
A new cell, configuration, traffic mix, metric, backbone or kernel probe is
a new file and a new entry; no file here names one.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "graspbalance_tpu")


def load_module(path: Path, name: str | None = None):
    """Import the Python file ``path`` under a private module name."""
    name = name or "bench_port._loaded." + path.stem.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One entry of ``workloads`` with everything its files hold."""

    name: str
    bench: Path
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)

    def generator(self):
        return load_module(self.bench / "traffic" / f"{self.traffic['generator']}.py")


def load_cell(root: Path, name: str) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cfg = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    bench = root / "bench_port"
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    return Cell(
        name=name,
        bench=bench,
        chips=entry["chips"],
        config=json.loads((root / cfg["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((bench / "limits" / f"{name}.json").read_text()),
        end_to_end=e2e,
        per_layer=[m for m in manifest["per_layer"] if name in m["workloads"]],
    )


_NAMED: dict = {}


def load_named(directory: Path, name: str, what: str):
    """The module ``<directory>/<name>.py``, chosen by a name in a
    configuration or in ``BENCHMARK.json`` (``what`` says of what), loaded
    once a process; raises naming the file it looked for where there is
    none."""
    path = Path(directory).resolve() / f"{name}.py"
    if path not in _NAMED:
        if not path.is_file():
            raise ValueError(f"no {what} {name!r}: {path} does not exist")
        _NAMED[path] = load_module(path, f"bench_port._named.{path.parent.name}.{name}")
    return _NAMED[path]


def probes(metrics: list, bench: Path) -> list[str]:
    """The kernel probes that the readers of ``metrics`` name (a reader's
    ``PROBE``), each once, in the metrics' order."""
    names = []
    for m in metrics:
        probe = getattr(load_module(bench / "metrics" / f"{m['name']}.py"), "PROBE", None)
        if probe and probe not in names:
            names.append(probe)
    return names


def run_probes(cell: Cell, drive) -> dict:
    """probe -> what its ``measure(drive)`` returned, for every probe that the
    cell's per-layer metrics name and that found its kernel; ``drive()``
    runs one call or step of the cell's own path."""
    out = {}
    for name in probes(cell.per_layer, cell.bench):
        timed = load_named(cell.bench / "kernels", name, "kernel probe").measure(drive)
        if timed is not None:
            out[name] = timed
    return out


def read_metrics(metrics: list, run, bench: Path) -> dict:
    """name -> {"value", "unit"} of every metric whose reader finds a value."""
    out = {}
    for m in metrics:
        value = load_module(bench / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's, optax's or the JAX package's."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))
