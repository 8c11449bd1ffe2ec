"""The port's inference and evaluation CLIs and its training CLI on
GraspNet-1B-shaped data, on tests/test_data.py's hand-made trees (the
dataset and graspnetAPI are not in the repository): cli/infer.py's dump
against the JAX package's eval/pipeline.dump_dataset from the same weights
(tests/test_infer_cli.py is the template), cli/eval_ap.py with and without
graspnetAPI and from a flax variable pickle, and cli/train.py with
--dataset_root.

Tolerances: the same files with the same number of rows (the keep masks
exactly), rows within 1e-4 absolute + 1e-4 relative (tests/test_torch_pipeline.py's:
f32 sums in other orders); the training CLI's steps as the loop counts them.
"""

import dataclasses
import json
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graspbalance_tpu.data.dataset import GraspNetDataset as JGraspNetDataset
from graspbalance_tpu.eval.pipeline import GraspInference as JGraspInference
from graspbalance_tpu.eval.pipeline import dump_dataset as j_dump_dataset
from graspbalance_tpu.models.graspbalance import GraspBalance as JGraspBalance
import graspbalance_tpu_torch.cli.train as cli_train
import graspbalance_tpu_torch.train.train_step as train_step_module
from graspbalance_tpu_torch.cli import eval_ap, infer
from graspbalance_tpu_torch.models import GraspBalance
from graspbalance_tpu_torch.train.checkpoints import CheckpointManager
from graspbalance_tpu_torch.train.config import Config, ModelConfig
from graspbalance_tpu_torch.train.train_step import TrainState, make_optimizer
from graspbalance_tpu_torch.weights import load_flax_variables
from test_data import fabricate_dataset
from test_torch_model import _random_variables
from test_torch_train import STAGES
from tiny import TINY_NUM_SEED, TINY_NUM_VIEW, TINY_STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TOL = 1e-4
MODEL_KW = dict(backbone_stages=TINY_STAGES, num_seed=TINY_NUM_SEED, num_view=TINY_NUM_VIEW)
CFG = Config(model=ModelConfig(**MODEL_KW))
NUM_POINT = 256
# a collision threshold at which the filter drops a few of these weights'
# grasps on these scenes (at the default 0.05 it keeps every valid one)
COLLISION_THRESH = 0.005


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return fabricate_dataset(str(tmp_path_factory.mktemp("graspnet")), n_scenes=2)


@pytest.fixture(scope="module")
def jax_model():
    """The tiny JAX GraspBalance with random variables (non-trivial
    BatchNorm statistics; tests/test_torch_pipeline.py's seed)."""
    jmodel = JGraspBalance(**MODEL_KW)
    pc = jnp.zeros((1, NUM_POINT, 3), jnp.float32)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), {"point_clouds": pc}, train=False))
    return jmodel, _random_variables(shapes, np.random.default_rng(13))


@pytest.fixture(scope="module")
def checkpoint(jax_model, tmp_path_factory):
    """A checkpoint directory of this package holding the JAX variables:
    config.json and step_0.pt, as a training run leaves them."""
    directory = str(tmp_path_factory.mktemp("ckpt"))
    model = load_flax_variables(GraspBalance(**MODEL_KW), jax_model[1])
    mgr = CheckpointManager(directory)
    mgr.save_config(CFG)
    mgr.save(0, TrainState(model, *make_optimizer(model, CFG, 1)))
    return directory


def _dumps(root):
    """The per-frame arrays of a dump: scene_xxxx/<camera>/xxxx.npy."""
    out = {}
    for dirpath, _, files in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        for f in files:
            if rel.startswith("scene_") and f.endswith(".npy"):
                out[os.path.join(rel, f)] = np.load(os.path.join(dirpath, f))
    return out


def _assert_same_dump(got_dir, want_dir, *, some_dropped=False):
    got, want = _dumps(got_dir), _dumps(want_dir)
    assert sorted(got) == sorted(want) and len(want) == 4
    assert "scene_0001/realsense/0001.npy" in got
    kept = 0
    for key in want:
        g, w = got[key], want[key]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape and g.shape[1] == 17, key
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=key)
        kept += len(g)
    assert 0 < kept <= 4 * TINY_NUM_SEED
    assert kept < 4 * TINY_NUM_SEED or not some_dropped  # the filters drop some grasps


def test_infer_cli_dump_matches_jax_dump_dataset(tree, jax_model, checkpoint, tmp_path, capsys):
    jmodel, variables = jax_model
    jds = JGraspNetDataset(tree, [], {}, camera="realsense", split="all", num_points=NUM_POINT, load_label=False)
    want_dir = str(tmp_path / "jax_dump")
    jinfer = JGraspInference(jmodel, variables, collision_thresh=COLLISION_THRESH)
    assert j_dump_dataset(jinfer, jds, want_dir, "realsense", batch_size=2, log=lambda *_: None) == 4
    got_dir = str(tmp_path / "dump")
    n = infer.main(["--checkpoint_dir", checkpoint, "--dataset_root", tree, "--split", "all", "--num_point",
                    str(NUM_POINT), "--batch_size", "2", "--dump_dir", got_dir, "--collision_thresh",
                    str(COLLISION_THRESH), "--device", "cpu"])
    out = capsys.readouterr().out
    assert n == 4 and "restored checkpoint step 0" in out and "GraspNetEval" in out
    _assert_same_dump(got_dir, want_dir, some_dropped=True)


def test_infer_cli_synthetic_smoke(checkpoint, capsys):
    grasps, keep = infer.main(["--checkpoint_dir", checkpoint, "--num_point", str(NUM_POINT), "--batch_size", "2",
                               "--obs", "--device", "cpu"])
    assert grasps.shape == (2, TINY_NUM_SEED, 17) and keep.shape == (2, TINY_NUM_SEED)
    assert np.isfinite(grasps).all()
    assert f"synthetic smoke: {keep.sum()} grasps kept of {keep.size}" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="best"):  # no best-loss mirror in this checkpoint dir
        infer.main(["--checkpoint_dir", checkpoint, "--best", "--num_point", str(NUM_POINT), "--device", "cpu"])


def _no_graspnetapi(monkeypatch):
    monkeypatch.delitem(sys.modules, "graspnetAPI", raising=False)
    real_import = __builtins__["__import__"] if isinstance(__builtins__, dict) else __builtins__.__import__

    def no_gnapi(name, *a, **k):
        if name == "graspnetAPI":
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr("builtins.__import__", no_gnapi)


def test_eval_ap_without_graspnetapi_dumps_and_returns(tree, jax_model, checkpoint, tmp_path, monkeypatch, capsys):
    """The dump is written and the offline instructions printed; main
    returns (exit 0), as the JAX CLI does."""
    want_dir = str(tmp_path / "jax_dump")
    jds = JGraspNetDataset(tree, [], {}, camera="realsense", split="all", num_points=NUM_POINT, load_label=False)
    j_dump_dataset(JGraspInference(*jax_model), jds, want_dir, "realsense", batch_size=2, log=lambda *_: None)
    _no_graspnetapi(monkeypatch)
    dump = str(tmp_path / "dump")
    assert eval_ap.main(["--dataset_root", tree, "--checkpoint_dir", checkpoint, "--split", "all", "--num_point",
                         str(NUM_POINT), "--batch_size", "2", "--dump_dir", dump, "--device", "cpu"]) is None
    out = capsys.readouterr().out
    assert "dumped 4 frames" in out and "graspnetAPI not installed" in out and "eval_all" in out
    _assert_same_dump(dump, want_dir)


def test_eval_ap_ported_pickle_with_graspnetapi(tree, jax_model, tmp_path, monkeypatch, capsys):
    """--ported_pkl (a flax variable pickle, as tools/port_torch_ckpt.py
    writes) through weights.load_flax_variables, then graspnetAPI's
    evaluation (stubbed) on the dump; --skip_dump evaluates it again."""
    pkl = str(tmp_path / "ported.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(jax_model[1], f)
    real_build = train_step_module.build_model
    # the pickle holds the tiny model's variables: build that model
    monkeypatch.setattr(train_step_module, "build_model",
                        lambda cfg, **kw: real_build(dataclasses.replace(cfg, model=CFG.model), **kw))
    calls = {}

    class FakeEval:
        def __init__(self, root, camera, split):
            calls["init"] = (root, camera, split)

        def eval_all(self, dump_dir, proc):
            calls["eval"] = (dump_dir, proc)
            return np.zeros((1, 2, 6)), 0.25

    want_dir = str(tmp_path / "jax_dump")
    jds = JGraspNetDataset(tree, [], {}, camera="realsense", split="all", num_points=NUM_POINT, load_label=False)
    j_dump_dataset(JGraspInference(*jax_model), jds, want_dir, "realsense", batch_size=2, log=lambda *_: None)
    monkeypatch.setitem(sys.modules, "graspnetAPI", types.SimpleNamespace(GraspNetEval=FakeEval))
    dump = str(tmp_path / "dump")
    out = eval_ap.main(["--dataset_root", tree, "--ported_pkl", pkl, "--split", "all", "--num_point",
                        str(NUM_POINT), "--batch_size", "2", "--dump_dir", dump, "--proc", "2", "--device", "cpu"])
    assert out == {"split": "all", "camera": "realsense", "AP": 0.25}
    assert calls == {"init": (tree, "realsense", "all"), "eval": (dump, 2)}
    with open(os.path.join(dump, "ap_result.json")) as f:
        assert json.load(f)["AP"] == 0.25
    assert "dumped 4 frames" in capsys.readouterr().out
    _assert_same_dump(dump, want_dir)
    assert eval_ap.main(["--dataset_root", tree, "--split", "all", "--dump_dir", dump, "--skip_dump",
                         "--proc", "2"])["AP"] == 0.25
    with pytest.raises(SystemExit, match="need --checkpoint_dir"):
        eval_ap.main(["--dataset_root", tree, "--dump_dir", dump, "--device", "cpu"])


def test_train_cli_on_a_dataset_root(tree, tmp_path, monkeypatch):
    """cli/train --dataset_root: make_dataloaders' stream through the loop
    (a tiny model; the host FPS precompute off, since it samples the full
    model's 2,048 stage-1 points), every step uploading its own batch."""
    real = cli_train.config_from_args

    def tiny(args):
        cfg = real(args)
        return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, backbone_stages=STAGES, num_seed=32),
                                   data=dataclasses.replace(cfg.data, precompute_fps=False))

    monkeypatch.setattr(cli_train, "config_from_args", tiny)
    log_dir = str(tmp_path / "run")
    cli_train.main(["--dataset_root", tree, "--num_view", "30", "--num_point", "512", "--batch_size", "1",
                    "--max_epoch", "1", "--no-ncm", "--num_workers", "1", "--log_dir", log_dir, "--device", "cpu"])
    with open(os.path.join(log_dir, "loop_metrics.jsonl")) as f:
        record = [json.loads(line) for line in f][-1]
    assert record["loop/uploads/point_clouds"] == 4  # 2 scenes x 2 frames, bs=1: 4 steps, 4 uploads
    assert record["loop/uploads/grasp_labels"] == 4
    with open(os.path.join(log_dir, "train_metrics.jsonl")) as f:
        window = [json.loads(line) for line in f][-1]
    assert np.isfinite(window["loss/overall_loss"])
    assert os.path.exists(os.path.join(log_dir, "checkpoints", "step_4.pt"))
    with open(os.path.join(log_dir, "checkpoints", "config.json")) as f:
        assert json.load(f)["data"]["dataset_root"] == tree
