"""The port stands without JAX: importing graspbalance_tpu_torch, all its
modules (the eval/ and train/ subpackages included) and every module chip_smoke.py,
time_main_path.py and trace_check.py import pulls in no jax, flax or graspbalance_tpu (the
card's machine has none of them). Also: the port's synthetic scene clouds
and instance labels equal the JAX package's, draw for draw."""

import ast
import dataclasses
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

import graspbalance_tpu_torch
from graspbalance_tpu.data.synthetic import SceneConfig as JSceneConfig
from graspbalance_tpu.data.synthetic import make_batch
from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_point_clouds, make_scenes
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("chip_smoke", "time_main_path", "trace_check")  # the port's scripts at the root


def _modules_to_import():
    names = ["graspbalance_tpu_torch", *SCRIPTS]
    names += [
        m.name
        for m in pkgutil.walk_packages(graspbalance_tpu_torch.__path__, "graspbalance_tpu_torch.")
    ]
    for script in SCRIPTS:
        tree = ast.parse(open(os.path.join(REPO, f"{script}.py")).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.append(node.module)
    return sorted(set(names))


def test_port_imports_no_jax():
    names = _modules_to_import()
    assert "graspbalance_tpu_torch.ops.multicyl" in names and "torch" in names
    assert "graspbalance_tpu_torch.eval.pipeline" in names and "graspbalance_tpu_torch.models.dsn" in names
    assert "graspbalance_tpu_torch.train.train_step" in names and "graspbalance_tpu_torch.ops.scatter" in names
    assert "graspbalance_tpu_torch.labels.losses" in names and "graspbalance_tpu_torch.labels.label_gen" in names
    assert {"graspbalance_tpu_torch.ops.mlpmax", "graspbalance_tpu_torch.ops.select",
            "graspbalance_tpu_torch.ops.table_gather"} <= set(names)
    assert {"graspbalance_tpu_torch.eval.quality", "graspbalance_tpu_torch.cli.quality_gate"} <= set(names)
    assert {"graspbalance_tpu_torch.trace", "bench_port.traffic.serve"} <= set(names)
    assert {
        "graspbalance_tpu_torch.labels.seg_losses", "graspbalance_tpu_torch.eval.seg_quality",
        "graspbalance_tpu_torch.train.seg_step", "graspbalance_tpu_torch.cli.train_seg",
        "graspbalance_tpu_torch.cli.dsn_quality_gate", "graspbalance_tpu_torch.data.utils",
        "graspbalance_tpu_torch.data.native", "graspbalance_tpu_torch.data.dataset",
        "graspbalance_tpu_torch.data.generators", "graspbalance_tpu_torch.cli.infer",
        "graspbalance_tpu_torch.cli.eval_ap",
    } <= set(names)
    code = (
        "import importlib, json, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'graspbalance_tpu'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120, check=True,
    )
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "geometry",
    [
        dict(num_points=256, num_objects=3, max_grasp_points=128, grasp_points_per_object=24),
        dict(num_points=1000),  # the default scene layout, fewer points
    ],
)
def test_scene_clouds_match_jax(geometry):
    # few views keep the JAX side's label tensors small; they draw from
    # another stream and do not change the clouds
    jcfg = JSceneConfig(num_views=4, **geometry)
    want = make_batch(5, 3, jcfg)["point_clouds"]
    got = make_point_clouds(5, 3, SceneConfig(**geometry))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "geometry",
    [
        dict(num_points=256, num_objects=3, max_grasp_points=128, grasp_points_per_object=24),
        dict(num_points=1003, num_objects=7),  # a remainder of table points among the objects
    ],
)
def test_scene_instance_labels_match_jax(geometry):
    want = make_batch(6, 2, JSceneConfig(num_views=4, **geometry))
    clouds, labels = make_scenes(6, 2, SceneConfig(**geometry))
    assert labels.dtype == np.int32
    np.testing.assert_array_equal(clouds, want["point_clouds"])
    np.testing.assert_array_equal(labels, want["instance_label"])
    assert set(np.unique(labels)) == set(range(geometry["num_objects"] + 1))


def test_scene_defaults_match_jax():
    """The port's default scene is the JAX package's default (bench.py's)."""
    jdefault = JSceneConfig()
    for f in dataclasses.fields(SceneConfig):
        assert f.default == getattr(jdefault, f.name), f.name
