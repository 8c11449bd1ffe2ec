"""BENCHMARK.json against the benchmark's contract, and the harness's
files: every cell finds its configuration, traffic mix, generator, limits and
metric readers by name, every configuration its backbone's reference and
count files, every roofline reader its kernel probe."""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
MANIFEST = json.loads((REPO / "BENCHMARK.json").read_text())
BENCH = REPO / "bench_port"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "bench_port/run.py"]
    assert MANIFEST["paths"] == ["bench_port"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    seen = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("bench_port/")
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        # the harness finds a per-layer metric's cells by its workloads alone
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    from bench_port import harness

    c = harness.load_cell(REPO, cell)
    assert (BENCH / "traffic" / f"{c.traffic['generator']}.py").is_file()
    assert set(c.limits) and all(isinstance(v, (int, float)) for v in c.limits.values())
    for m in c.end_to_end + c.per_layer:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names, (cell, m["name"])


def test_configs_reference_files_and_widths():
    for c in MANIFEST["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"]
        assert cfg["dtype"] == "float32" and cfg["peak_flops"] == 165e12 and cfg["peak_bytes"] == 3.35e12
        assert cfg["model"]["num_view"] == 300 and cfg["model"]["num_seed"] == 1024
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_config_names_its_backbone_files(config):
    from bench_port.counts.model import backbone_count
    from bench_port.reference.models import backbone_file

    entry = next(c for c in MANIFEST["configs"] if c["name"] == config)
    name = json.loads((REPO / entry["file"]).read_text())["model"]["backbone"]
    assert (BENCH / "reference" / "backbones" / f"{name}.py").is_file()
    assert (BENCH / "counts" / "backbones" / f"{name}.py").is_file()
    backbone = backbone_file(name).Backbone
    assert backbone.SAMPLED and callable(backbone.sample) and backbone_file(name).TINY_STAGES
    assert callable(backbone_count(name).forward)


def test_unknown_backbone_names_the_file_it_looked_for():
    from bench_port.counts.model import backbone_count
    from bench_port.reference.models import GraspBalance

    with pytest.raises(ValueError, match="reference/backbones/no_such_backbone.py"):
        GraspBalance(backbone="no_such_backbone", backbone_stages=[])
    with pytest.raises(ValueError, match="counts/backbones/no_such_backbone.py"):
        backbone_count("no_such_backbone")


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"] if m["name"].endswith("_roofline")])
def test_roofline_reader_names_its_probe(metric):
    from bench_port import harness

    probe = getattr(harness.load_module(BENCH / "metrics" / f"{metric}.py"), "PROBE", None)
    assert probe and (BENCH / "kernels" / f"{probe}.py").is_file(), (metric, probe)
    assert callable(harness.load_module(BENCH / "kernels" / f"{probe}.py").measure)


def test_every_metric_moves_an_e2e_metric_of_its_cells():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in target or cell in target["workloads"], (m["name"], cell)


def test_run_seconds_fit_a_full_check():
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert math.floor(0.25 * len(CELLS)) >= sum(w["chips"] == 4 for w in MANIFEST["workloads"]) - 1


def test_run_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", CELLS[0], "--seed", "3000000000",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout


def test_run_outside_a_checkout_with_the_program_exits_nonzero(tmp_path):
    """A directory with only BENCHMARK.json and bench_port/ cannot run."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "bench_port", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", CELLS[0], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and '"correct"' not in out.stdout


IMPORTS = """
import sys
sys.path.insert(0, {root!r})
from pathlib import Path
from bench_port import harness, run, control
from bench_port.reference import dsn, layers, models, ops, postprocess
bench = Path({root!r}) / "bench_port"
for d in ("traffic", "metrics", "kernels", "reference/backbones", "counts/backbones"):
    for f in sorted((bench / d).glob("*.py")):
        harness.load_module(f)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_is_imported():
    out = subprocess.run([sys.executable, "-c", IMPORTS.format(root=str(REPO))], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    loaded = set(out.stdout.split())
    assert not loaded & {"jax", "jaxlib", "flax", "optax", "graspbalance_tpu"}


def test_reference_loads_nothing_of_the_program():
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r}); "
            "from pathlib import Path; "
            "from bench_port.reference import dsn, layers, models, ops, postprocess; "
            "[models.backbone_file(f.stem) for f in Path(models.BACKBONES).glob('*.py') if f.stem != '__init__']; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert not set(out.stdout.split()) & {"graspbalance_tpu_torch", "graspbalance_tpu", "jax"}
