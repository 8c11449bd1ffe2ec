"""Rank functions of the port's multi-rank tests (tests/test_torch_parallel_*.py,
tests/test_torch_data_parallel.py), run by
graspbalance_tpu_torch.parallel.ranks.run_ranks on gloo ranks on the CPU.

They live in a module of their own, which imports torch and the port only,
because each spawned rank imports the module of the function it runs.
Each function reads its inputs with ``torch.load`` and writes what it
computed to ``<out>/rank<r>.pt``; the test compares.
"""

from __future__ import annotations

import os

import torch

from graspbalance_tpu_torch.parallel.faults import FAULTS as PLANTED
from graspbalance_tpu_torch.parallel.faults import planted_fault
from graspbalance_tpu_torch.parallel.mesh import axis_rank, make_mesh, shard_batch, shard_rows


def _save(out: str, rank: int, res: dict) -> None:
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


def ops_ranks(rank, world, path, out):
    """sharded_fps, sharded_ball_query and sharded_sa_forward on a (2, 2)
    and a (1, 4) mesh."""
    from graspbalance_tpu_torch.nn.sa_fp import SetAbstraction
    from graspbalance_tpu_torch.ops.query import ORDERS
    from graspbalance_tpu_torch.parallel.sharded_ops import local_points, sharded_ball_query, sharded_fps
    from graspbalance_tpu_torch.parallel.stage1 import sharded_sa_forward

    d = torch.load(path)
    res = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(*shape, device_type="cpu")
        tag = f"{shape[0]}x{shape[1]}"
        res[f"data_rank/{tag}"] = axis_rank(mesh, "data")
        pts = shard_rows(d["fps_pts"], mesh)
        for skip in (True, False):
            res[f"fps/{tag}/{skip}"] = sharded_fps(mesh, local_points(pts, mesh), d["m"], skip_origin=skip)
        pts, ctr = shard_rows(d["bq_pts"], mesh), shard_rows(d["bq_ctr"], mesh)
        for order in ORDERS:
            res[f"ball_query/{tag}/{order}"] = sharded_ball_query(
                mesh, local_points(pts, mesh), ctr, d["radius"], d["nsample"], order=order)
        sa = SetAbstraction(0, d["radius"], d["nsample"], d["mlp"])
        sa.load_state_dict(d["sa"])
        res[f"sa/{tag}"] = sharded_sa_forward(mesh, sa.eval(), pts, d["npoint"])
    _save(out, rank, res)


def backbone_ranks(rank, world, path, out):
    """sharded_drp_forward on a (2, 2) mesh."""
    from graspbalance_tpu_torch.models.drp import DRP
    from graspbalance_tpu_torch.parallel.backbone import sharded_drp_forward

    d = torch.load(path)
    mesh = make_mesh(2, 2, device_type="cpu")
    drp = DRP(d["stages"], num_seed=d["num_seed"])
    drp.load_state_dict(d["drp"])
    got = sharded_drp_forward(mesh, drp.eval(), shard_rows(d["pts"], mesh))
    _save(out, rank, {"data_rank": axis_rank(mesh, "data"), "out": {k: v for k, v in got.items() if v is not None}})


FAULTS = ("none", *PLANTED)


def after_step(model, metrics) -> dict:
    """A step's metrics, gradients and state after it (copies)."""
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {k: p.grad.clone() for k, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def dp_step_ranks(rank, world, path, out):
    """One data-parallel step of the grasp model from the given state, as it
    is and with each planted fault, and one of the DSN."""
    from graspbalance_tpu_torch.models.dsn import DSN
    from graspbalance_tpu_torch.train.config import config_from_dict
    from graspbalance_tpu_torch.train.seg_step import make_seg_optimizer, seg_train_step
    from graspbalance_tpu_torch.train.train_step import build_model, make_optimizer, train_step

    d = torch.load(path)
    cfg = config_from_dict(d["cfg"])
    mesh = make_mesh(device_type="cpu")
    res = {}
    for fault in FAULTS:
        model = build_model(cfg, device="cpu")
        model.load_state_dict(d["state"])
        optimizer, scheduler = make_optimizer(model, cfg, d["steps_per_epoch"])
        with planted_fault(fault, world):
            metrics = train_step(model, optimizer, scheduler, shard_batch(d["batch"], mesh), d["epoch"], cfg,
                                 mesh=mesh)
        res[fault] = after_step(model, metrics)
    dsn = DSN(d["dsn_stages"])
    dsn.load_state_dict(d["dsn_state"])
    optimizer, scheduler = make_seg_optimizer(dsn, d["dsn_steps"])
    metrics = seg_train_step(dsn, optimizer, scheduler, shard_rows(d["dsn_cloud"], mesh),
                             shard_rows(d["dsn_instance"], mesh), d["dsn_max_objects"], mesh=mesh)
    res["dsn"] = after_step(dsn, metrics)
    _save(out, rank, res)


def loop_ranks(rank, world, path, out, runs):
    """loop.train for each (log_dir, stop_after_epochs) of ``runs`` in turn;
    the final state of each run."""
    import dataclasses
    import sys

    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch
    from graspbalance_tpu_torch.train import loop
    from graspbalance_tpu_torch.train.config import config_from_dict

    # the metric streams' optional TensorBoard sink stays off: importing it
    # loads TensorFlow where that is installed, 10-20 s a rank
    sys.modules.setdefault("torch.utils.tensorboard", None)
    d = torch.load(path)
    cfg = config_from_dict(d["cfg"])
    scene = SceneConfig(**d["scene"])
    steps, bs = d["steps"], cfg.data.batch_size

    def batches(epoch):
        for i in range(steps):
            yield make_batch(epoch * steps + i, bs, scene)

    def evals():
        return iter([make_batch(50, bs, scene)])

    res = {}
    for i, (log_dir, stop) in enumerate(runs):
        run_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, log_dir=log_dir,
                                                                     stop_after_epochs=stop))
        state = loop.train(run_cfg, batches, evals, steps_per_epoch=steps, device="cpu")
        res[i] = {"step": state.step, "state": state.model.state_dict(),
                                "optimizer": state.optimizer.state_dict()["state"]}
    _save(out, rank, res)
