"""The port's config tree (train/config.py), the settings build_model
refuses, the optimizer's schedule and the training CLI (cli/train.py),
against the JAX package's.

Tolerances:
  - configs: the shared fields equal, exactly; the port leaves out the JAX
    package's four TPU knobs and nothing else; a config.json written by
    either package loads in the other;
  - the schedule: the JAX package's optax OneCycle within 1e-5 relative
    (it computes in float32, where its warm-up sum loses ~2e-6; the port
    in float64), at and past its last step;
  - the CLI: the same argv gives the same config on the shared fields and
    the same first batch, exactly, as the JAX CLI (with --dataset_root, the
    same config and the loaders' streams); the model fields the port once
    refused (ROADMAP Queue 1 item 7) build and run; n_data_shards > 1 is
    refused, naming the item; the bfloat16 compute dtypes are accepted,
    built, and recorded in config.json.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import graspbalance_tpu.cli.train as j_cli
import graspbalance_tpu.train.loop as j_loop
from graspbalance_tpu.train import train_step as jts
from graspbalance_tpu.train.checkpoints import CheckpointManager as JCheckpointManager
from graspbalance_tpu.train.checkpoints import load_config as j_load_config
from graspbalance_tpu.train.config import Config as JConfig
from graspbalance_tpu.train.config import TrainConfig as JTrainConfig
from graspbalance_tpu.train.config import config_to_dict as j_config_to_dict
import graspbalance_tpu_torch.cli.train as cli
import graspbalance_tpu_torch.train.loop as loop
from graspbalance_tpu_torch.data.synthetic import make_batch
from graspbalance_tpu_torch.train.checkpoints import CheckpointManager, load_config
from graspbalance_tpu_torch.train.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
    config_from_dict,
    config_to_dict,
)
from graspbalance_tpu_torch.train.train_step import build_model, check_supported, make_optimizer
from test_torch_train import CFG, JCFG, SCENE, STAGES
from torch_threads import one_thread  # noqa: F401  (torch on one thread in this module)

TPU_KNOBS = {"gather_vjp", "query_batch_chunk", "count_matmul", "query_extract_group"}


def _shared(port: dict, jax_: dict) -> None:
    """Every field of the port's config dict equals the JAX one's."""
    for section, fields in port.items():
        for name, value in fields.items():
            assert jax_[section][name] == value, (section, name)


def _nondefault_config(log_dir="runs/x") -> Config:
    return Config(
        model=ModelConfig(num_view=24, backbone_stages=STAGES, num_seed=32, label_impl="reduced",
                          hmax_list=(0.01, 0.02, 0.03, 0.05)),
        data=DataConfig(num_points=512, batch_size=4, ncm=False, analytic_labels=True),
        train=TrainConfig(max_epoch=3, opt_flatten=False, log_dir=log_dir, stop_after_epochs=2, seed=7),
    )


def test_config_round_trip():
    cfg = _nondefault_config()
    assert config_from_dict(json.loads(json.dumps(config_to_dict(cfg)))) == cfg
    assert config_from_dict({"model": {"num_view": 24, "no_such_key": 1}, "extra": {}}).model.num_view == 24


def test_config_fields_and_defaults_match_jax():
    port, jd = config_to_dict(Config()), j_config_to_dict(JConfig())
    _shared(port, jd)
    assert port.keys() == jd.keys()
    left_out = {name for section in jd for name in jd[section].keys() - port[section].keys()}
    assert left_out == TPU_KNOBS


def test_jax_config_json_loads_in_port(tmp_path):
    jcfg = JConfig(
        model=dataclasses.replace(JCFG.model, count_matmul=True, label_impl="reduced"),
        train=JTrainConfig(max_epoch=5, log_every=3, stop_after_epochs=2),
    )
    mgr = JCheckpointManager(str(tmp_path))
    mgr.save_config(jcfg)
    mgr.close()
    got = load_config(str(tmp_path))
    _shared(config_to_dict(got), j_config_to_dict(jcfg))
    assert got.model.backbone_stages == STAGES


def test_port_config_json_loads_in_jax(tmp_path):
    cfg = _nondefault_config()
    CheckpointManager(str(tmp_path)).save_config(cfg)
    got = j_load_config(str(tmp_path))
    _shared(config_to_dict(cfg), j_config_to_dict(got))
    assert got.model.count_matmul is False  # the knobs the port leaves out keep their defaults


# the JAX package's model fields that the port refused until ROADMAP Queue 1
# item 7 landed; each case now builds its model, and a field that needs a
# partner takes the JAX package's (num_depth and hmax_list go together; the
# pointnet2 backbone takes an SSG stage table)
@pytest.mark.parametrize("field, value, item", [
    ("backbone", "pointnet2", 7), ("query_order", "nearest", 7), ("num_angle", 6, 7), ("num_depth", 3, 7),
    ("cylinder_radius", 0.05, 7), ("hmin", -0.01, 7), ("hmax_list", (0.01, 0.02), 7),
])
def test_build_model_refuses_what_it_cannot_honour(field, value, item):
    """Once refused (item ``item``), now accepted: the model builds with the
    value and runs a tiny eval forward whose outputs have its shapes."""
    partner = {"num_depth": {"hmax_list": (0.01, 0.02, 0.03)}, "hmax_list": {"num_depth": 2},
               "backbone": {"backbone_stages": tuple(s[:4] for s in STAGES)}}.get(field, {})
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, **{field: value}, **partner))
    model = build_model(cfg, device="cpu").eval()
    assert getattr(cfg.model, field) == value
    ep = model(torch.from_numpy(make_batch(0, 1, SCENE)["point_clouds"]))
    m = cfg.model
    assert ep["grasp_score_pred"].shape == (1, STAGES[1][0], m.num_angle, m.num_depth)
    assert torch.isfinite(ep["grasp_tolerance_pred"]).all()


@pytest.mark.parametrize("field", ["dtype", "width_mlp_dtype"])
def test_build_model_accepts_bfloat16(field):
    """A bfloat16 compute dtype builds a model that computes in it (the
    whole model, or the width head's MLPs alone) and keeps its parameters
    and statistics in float32; any other dtype name is refused."""
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, **{field: "bfloat16"}))
    model = build_model(cfg, device="cpu")
    assert {t.dtype for t in model.state_dict().values()} == {torch.float32}
    whole = field == "dtype"
    assert model.width_grouping.mlp_scale0.layer0.dense.dtype == torch.bfloat16
    assert model.backbone.sa1.mlp.layer0.bn.dtype == model.fuse_multi_scale.dtype == (
        torch.bfloat16 if whole else torch.float32)
    with pytest.raises(ValueError, match=rf"{field}='float16'"):
        build_model(dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, **{field: "float16"})),
                    device="cpu")


def test_build_model_refuses_reduced_labels():
    cfg = dataclasses.replace(CFG, model=dataclasses.replace(CFG.model, label_impl="reduced"))
    with pytest.raises(ValueError, match="label_impl='reduced'.*'full' label pipeline only"):
        build_model(cfg, device="cpu")


def test_train_refuses_before_writing(tmp_path):
    """A config the port cannot honour is refused before the loop writes
    its config.json or anything else into the log_dir: here
    n_data_shards=2 in a process without a 2-rank process group."""
    cfg = dataclasses.replace(CFG, train=TrainConfig(log_dir=str(tmp_path / "run"), n_data_shards=2))
    with pytest.raises(ValueError, match="n_data_shards=2 needs a process group of 2 ranks; this one has 1"):
        loop.train(cfg, lambda epoch: iter([{}]), steps_per_epoch=1, device="cpu")
    assert not (tmp_path / "run").exists()


def test_build_model_refuses_data_shards():
    """n_data_shards must be the process group's size (1 without one), and
    divide the batch; the message names both sizes."""
    with pytest.raises(ValueError, match="n_data_shards=2 needs a process group of 2 ranks; this one has 1"):
        build_model(dataclasses.replace(CFG, train=TrainConfig(n_data_shards=2)), device="cpu")
    build_model(dataclasses.replace(CFG, train=TrainConfig(n_data_shards=1)), device="cpu")
    odd = dataclasses.replace(CFG, data=DataConfig(batch_size=3), train=TrainConfig(n_data_shards=2))
    with pytest.raises(ValueError, match="batch_size=3 does not split over n_data_shards=2 ranks"):
        check_supported(odd, world=2)
    check_supported(dataclasses.replace(odd, data=DataConfig(batch_size=4)), world=2)


@pytest.mark.parametrize("opt_flatten", [True, False])
def test_schedule_matches_optax_and_clamps(opt_flatten):
    cfg = Config(train=TrainConfig(max_epoch=2, opt_flatten=opt_flatten))
    model = torch.nn.Linear(3, 2)
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=5)
    assert optimizer.defaults["foreach"] is opt_flatten
    want = np.asarray(jts.onecycle_schedule(10, cfg.train.learning_rate)(np.arange(15)))
    for step in range(15):  # 5 steps past the schedule's end
        np.testing.assert_allclose(optimizer.param_groups[0]["lr"], want[step], rtol=1e-5, err_msg=str(step))
        model(torch.ones(1, 3)).sum().backward()
        optimizer.step()
        scheduler.step()


# --- the loop against the JAX package's train() --------------------------



ARGVS = {
    "defaults": [],
    "static": ["--num_point", "1000", "--num_view", "24"],
    "flags": ["--num_view", "24", "--max_epoch", "3", "--batch_size", "4", "--learning_rate", "2e-3",
              "--weight_decay", "0.1", "--bn_decay_step", "3", "--bn_decay_rate", "0.7", "--no-ncm",
              "--camera", "kinect", "--log_dir", "runs/a", "--num_point", "1000", "--num_workers", "1",
              "--synthetic_steps", "7"],
    "analytic": ["--synthetic_analytic", "--num_view", "24"],
}


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_maps_argv_as_jax(argv, monkeypatch):
    captured = {}
    monkeypatch.setattr(sys, "argv", ["train"] + ARGVS[argv])
    monkeypatch.setattr(j_loop, "train", lambda cfg, *a, **k: captured.update(jax=(cfg, a, k)))
    j_cli.main()
    monkeypatch.setattr(loop, "train", lambda cfg, *a, **k: captured.update(port=(cfg, a, k)))
    cli.main(ARGVS[argv] + ["--device", "cpu"])
    (jcfg, ja, jk), (cfg, a, k) = captured["jax"], captured["port"]
    _shared(config_to_dict(cfg), j_config_to_dict(jcfg))
    assert k == {"steps_per_epoch": jk["steps_per_epoch"], "device": "cpu"}
    if argv == "defaults":  # full-size scenes: the streams are compared at the smaller sizes
        return
    first_j, first = next(iter(ja[0](1))), next(iter(a[0](1)))
    assert first.keys() == first_j.keys()
    for key in first_j:
        np.testing.assert_array_equal(first[key], first_j[key], err_msg=key)
    if argv == "static":  # the default label mode: one array object across batches
        assert next(iter(a[0](0)))["grasp_labels"] is first["grasp_labels"]


# the CLI's flags take the JAX CLI's values (``--backbone pointnet2`` is
# accepted: tests/test_torch_pointnet2.py); a value outside its choices is
# refused by the parser, as the JAX CLI's refuses it
@pytest.mark.parametrize("argv, match", [
    (["--backbone", "pointnet3"], "invalid choice"),
])
def test_cli_refuses(argv, match, capsys):
    with pytest.raises(SystemExit):
        cli.main(argv + ["--device", "cpu"])
    assert match in capsys.readouterr().err


def test_cli_maps_dataset_root_as_jax(tmp_path, monkeypatch):
    """--dataset_root (no longer refused): the same config as the JAX CLI's,
    the analytic labels off whatever the flag, and the loop handed
    make_dataloaders' streams and step count."""
    argv = ["--dataset_root", str(tmp_path), "--synthetic_analytic", "--num_view", "24", "--batch_size", "3"]
    captured = {}
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    monkeypatch.setattr(j_loop, "train", lambda cfg, *a, **k: captured.update(jax=(cfg, a, k)))
    import graspbalance_tpu.data.dataset as j_dataset
    import graspbalance_tpu_torch.data.dataset as dataset

    streams = ("train_batches", "eval_batches", 7)
    monkeypatch.setattr(j_dataset, "make_dataloaders", lambda cfg: streams)
    monkeypatch.setattr(dataset, "make_dataloaders", lambda cfg: streams)
    j_cli.main()
    monkeypatch.setattr(loop, "train", lambda cfg, *a, **k: captured.update(port=(cfg, a, k)))
    cli.main(argv + ["--device", "cpu"])
    (jcfg, ja, jk), (cfg, a, k) = captured["jax"], captured["port"]
    _shared(config_to_dict(cfg), j_config_to_dict(jcfg))
    assert cfg.data.dataset_root == str(tmp_path) and not cfg.data.analytic_labels
    assert a == ja == streams[:2] and k == {"steps_per_epoch": 7, "device": "cpu"} and jk == {"steps_per_epoch": 7}


@pytest.mark.parametrize("flag", ["--dtype", "--width_mlp_dtype"])
def test_cli_accepts_bfloat16(flag, tmp_path, monkeypatch):
    """The CLI maps a bfloat16 flag as the JAX CLI does, the loop's config
    check passes it, and the config.json the loop writes records it (and
    loads in the JAX package)."""
    argv = [flag, "bfloat16", "--num_view", "24", "--log_dir", str(tmp_path)]
    captured = {}
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    monkeypatch.setattr(j_loop, "train", lambda cfg, *a, **k: captured.update(jax=cfg))
    j_cli.main()

    def config_only(cfg, *a, **k):  # the loop's steps before its first batch
        loop.check_supported(cfg)
        CheckpointManager(f"{cfg.train.log_dir}/checkpoints").save_config(cfg)
        captured["port"] = cfg

    monkeypatch.setattr(loop, "train", config_only)
    cli.main(argv + ["--device", "cpu"])
    _shared(config_to_dict(captured["port"]), j_config_to_dict(captured["jax"]))
    field = flag[2:]
    stored = load_config(str(tmp_path / "checkpoints"))
    assert getattr(stored.model, field) == getattr(captured["port"].model, field) == "bfloat16"
    assert getattr(j_load_config(str(tmp_path / "checkpoints")).model, field) == "bfloat16"
