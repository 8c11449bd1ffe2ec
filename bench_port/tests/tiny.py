"""A checkout in a temporary directory with the benchmark and tiny cells
that run on the CPU: one ``tiny-<cell>`` for every cell of BENCHMARK.json,
on its configuration cut to its backbone file's ``TINY_STAGES`` (and the
DSN's tiny stages), 256-point scenes, 2 a call or a step."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())

TINY_PT_STAGES = [[64, 0.1, 8, 16, 1], [32, 0.2, 8, 32, 1]]
TINY_SIZES = {
    "train": {"batch": 2, "num_points": 256, "objects": [2, 3], "max_objects": 4, "max_grasp_points": 128,
              "grasp_points_per_object": 24, "prefetch_depth": 2, "checked_steps": 3, "profile_steps": 2},
    "serve": {"batch": 2, "pool": 8, "num_points": 256, "objects": [2, 3], "warmup": 1, "checked_calls": 4},
}


def tiny_cells(generator: str) -> list[str]:
    """The tiny cells whose traffic mix runs ``generator``."""
    traffic = REPO / "bench_port" / "traffic"
    return [f"tiny-{w['name']}" for w in MANIFEST["workloads"]
            if json.loads((traffic / f"{w['traffic']}.json").read_text())["generator"] == generator]


def tiny_config(name: str) -> dict:
    """Configuration ``name`` of BENCHMARK.json at the CPU tests' sizes."""
    from bench_port.reference.models import backbone_file

    entry = next(c for c in MANIFEST["configs"] if c["name"] == name)
    cfg = json.loads((REPO / entry["file"]).read_text())
    cfg["model"].update(num_view=24, num_seed=32)
    cfg["model"]["backbone_stages"] = copy.deepcopy(backbone_file(cfg["model"]["backbone"]).TINY_STAGES)
    if "dsn" in cfg:
        cfg["dsn"]["pt_stages"] = copy.deepcopy(TINY_PT_STAGES)
    return cfg


def add_cell(root: Path, name: str, config: str, traffic: str, like: str) -> None:
    """Add cell ``name`` (configuration and traffic mix by name) to the
    checkout at ``root``, with the limits of cell ``like`` and in every
    metric that ``like`` reports."""
    bench = root / "bench_port"
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    shutil.copy(bench / "limits" / f"{like}.json", bench / "limits" / f"{name}.json")
    manifest["workloads"].append({"name": name, "config": config, "traffic": traffic, "chips": 1, "why": "tiny"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))


def add_config(root: Path, name: str, cfg: dict) -> None:
    """Add configuration ``name`` with the contents ``cfg`` to the checkout at ``root``."""
    (root / "bench_port" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": name, "source": "tests", "reduced": [], "why": "tiny",
                                "file": f"bench_port/configs/{name}.json"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))


def make_checkout(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and bench_port/ of this repository,
    plus for every cell of BENCHMARK.json the cell ``tiny-<cell>`` on the
    configuration ``tiny-<config>`` and the mix ``tiny-<traffic>`` (the
    real mix at ``TINY_SIZES``), with the real cell's limits and metrics."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "bench_port", tmp / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    traffic = tmp / "bench_port" / "traffic"
    for c in MANIFEST["configs"]:
        add_config(tmp, f"tiny-{c['name']}", tiny_config(c["name"]))
    for w in MANIFEST["workloads"]:
        mix = json.loads((traffic / f"{w['traffic']}.json").read_text())
        (traffic / f"tiny-{w['traffic']}.json").write_text(json.dumps({**mix, **TINY_SIZES[mix["generator"]]}))
        add_cell(tmp, f"tiny-{w['name']}", f"tiny-{w['config']}", f"tiny-{w['traffic']}", w["name"])
    return tmp
