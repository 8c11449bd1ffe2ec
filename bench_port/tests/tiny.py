"""A checkout in a temporary directory with the benchmark and tiny cells
that run on the CPU: the DRP and PointNet++ configurations at the CPU
tests' stage table (``tests/tiny.py``'s sizes), 256-point scenes, 2 a call."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY_DRP_STAGES = [
    [64, 0.08, 8, [16, 16, 32], 1, 0.16, 8],
    [32, 0.20, 8, [16, 16, 32], 1, 0.40, 8],
    [16, 0.40, 4, [16, 16, 32], 1, 0.80, 4],
    [8, 0.60, 4, [16, 16, 32], 1, 1.20, 4],
]
TINY_PT_STAGES = [[64, 0.1, 8, 16, 1], [32, 0.2, 8, 32, 1]]
TINY_TRAIN = {"generator": "train", "batch": 2, "num_points": 256, "objects": [2, 3], "max_objects": 4,
              "max_grasp_points": 128, "grasp_points_per_object": 24, "prefetch_depth": 2, "checked_steps": 3,
              "profile_steps": 2}
TINY_TRAFFIC = {"generator": "serve", "batch": 2, "pool": 8, "num_points": 256, "objects": [2, 3], "warmup": 1,
                "checked_calls": 4}


def tiny_config(name: str) -> dict:
    cfg = json.loads((REPO / "bench_port" / "configs" / f"{name}.json").read_text())
    cfg["model"].update(num_view=24, num_seed=32)
    if cfg["model"]["backbone"] == "drp":
        cfg["model"]["backbone_stages"] = copy.deepcopy(TINY_DRP_STAGES)
        cfg["dsn"]["pt_stages"] = copy.deepcopy(TINY_PT_STAGES)
    else:
        cfg["model"]["backbone_stages"] = [s[:4] for s in TINY_DRP_STAGES]
    return cfg


def make_checkout(tmp: Path) -> Path:
    """``tmp`` holding BENCHMARK.json and bench_port/ of this repository,
    plus the cells tiny-drp-obs, tiny-pn2 and tiny-drp-train (with their
    configurations, mixes and limits, the real cells' limits)."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "bench_port", tmp / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp / "bench_port"
    manifest = json.loads((tmp / "BENCHMARK.json").read_text())
    for cell, cfg, mix, obs, real in (("tiny-drp-obs", "graspbalance-drp", "tiny-serve-obs", True, "drp-obs.serve.b4"),
                                      ("tiny-pn2", "graspbalance-pointnet2", "tiny-serve", False, "pn2.serve.b4")):
        (bench / "configs" / f"tiny-{cfg}.json").write_text(json.dumps(tiny_config(cfg)))
        (bench / "traffic" / f"{mix}.json").write_text(json.dumps(dict(TINY_TRAFFIC, use_obs=obs)))
        shutil.copy(bench / "limits" / f"{real}.json", bench / "limits" / f"{cell}.json")
        manifest["configs"].append({"name": f"tiny-{cfg}", "source": "tests", "reduced": [], "why": "tiny",
                                    "file": f"bench_port/configs/tiny-{cfg}.json"})
        manifest["workloads"].append({"name": cell, "config": f"tiny-{cfg}", "traffic": mix, "chips": 1, "why": "tiny"})
        for m in manifest["end_to_end"] + manifest["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (bench / "traffic" / "tiny-train.json").write_text(json.dumps(TINY_TRAIN))
    shutil.copy(bench / "limits" / "drp.train.b8.json", bench / "limits" / "tiny-drp-train.json")
    manifest["workloads"].append({"name": "tiny-drp-train", "config": "tiny-graspbalance-drp", "traffic": "tiny-train",
                                  "chips": 1, "why": "tiny"})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "drp.train.b8" in m.get("workloads", ()):
            m["workloads"].append("tiny-drp-train")
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest, indent=1))
    return tmp
