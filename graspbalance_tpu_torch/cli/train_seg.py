"""DSN instance-segmentation training CLI (port of
graspbalance_tpu/cli/train_seg.py, with its flags and ``--device``):

    python -m graspbalance_tpu_torch.cli.train_seg --synthetic_steps 50 --max_epoch 10

Trains the DSN (models/dsn.py) with the weighted seg losses
(train/seg_step.py: Adam at optax's cosine one-cycle rate over max_epoch x
steps), on GraspNet-1B with ``--dataset_root`` (data/dataset.py) or on
synthetic scenes, and writes the checkpoint the OBS inference path consumes.
In ``--log_dir``: train_metrics.jsonl (the seg losses every 10 steps) and
checkpoints/ (one a epoch, with its epoch count). Runs on the card unless
``--device cpu``.

GraspNet-1B's instance labels are object ids (1..88), while the losses and
the offset labels count ``max_objects + 1`` classes, so this CLI numbers
each scene's objects 1..K first (``dense_instance_labels``). The JAX CLI
passes the ids as they are: there ids past max_objects share one weight bin
and one centroid. Synthetic scenes number their objects 1..K already.

On S cards the DSN trains data-parallel over every rank, as the JAX CLI
trains over every device's mesh (each rank its rows of ``--batch_size``,
which S must divide; rank 0 writes the log_dir):

    torchrun --nproc_per_node=S -m graspbalance_tpu_torch.cli.train_seg --synthetic_steps 50
"""

from __future__ import annotations

import argparse
import os


def dense_instance_labels(instance):
    """(B, N) int instance labels -> per scene the background kept 0 and the
    objects numbered 1..K in the order of their ids."""
    import numpy as np

    out = np.empty(instance.shape, np.int32)
    for i, row in enumerate(instance):
        ids = np.union1d([0], row)
        out[i] = np.searchsorted(ids, row)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset_root", default="")
    p.add_argument("--camera", default="realsense")
    p.add_argument("--log_dir", default="logs/dsn")
    p.add_argument("--num_point", type=int, default=20000)
    p.add_argument("--max_epoch", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--max_objects", type=int, default=16)
    p.add_argument("--synthetic_steps", type=int, default=50)
    p.add_argument("--device", default="cuda", help="torch device (default the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def main(argv=None):
    """Parse ``argv`` (default the command line) and train; returns the
    final train_step.TrainState (the DSN, its optimizer and schedule).
    Under torchrun, joins its process group first and leaves it at the
    end."""
    args = parse_args(argv)
    import torch.distributed as dist

    from graspbalance_tpu_torch.parallel.mesh import init_from_env

    args.device, joined = init_from_env(args.device)
    try:
        return _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args):
    import numpy as np
    import torch.distributed as dist

    from graspbalance_tpu_torch.eval.pipeline import resolve_device
    from graspbalance_tpu_torch.models.dsn import DSN
    from graspbalance_tpu_torch.parallel.mesh import axis_size, is_lead, make_mesh, replicate_, shard_rows
    from graspbalance_tpu_torch.train.checkpoints import CheckpointManager
    from graspbalance_tpu_torch.train.metrics import MetricAggregator, MetricLogger, NullLogger
    from graspbalance_tpu_torch.train.seg_step import init_dsn, make_seg_optimizer, seg_train_step
    from graspbalance_tpu_torch.train.train_step import TrainState

    device = resolve_device(args.device)
    mesh = make_mesh(device_type=device.type) if dist.is_initialized() else None
    shards = axis_size(mesh, "data")
    if args.batch_size % shards:
        raise ValueError(f"batch_size={args.batch_size} does not split over {shards} data ranks")
    if args.dataset_root:
        from graspbalance_tpu_torch.data.dataset import make_dataloaders
        from graspbalance_tpu_torch.train.config import Config, DataConfig

        cfg = Config(data=DataConfig(dataset_root=args.dataset_root, camera=args.camera, num_points=args.num_point,
                                     batch_size=args.batch_size, max_objects=args.max_objects))
        train_batches, _, steps = make_dataloaders(cfg)
    else:
        from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch

        scene = SceneConfig(num_points=args.num_point)
        steps = args.synthetic_steps

        def train_batches(epoch):
            for i in range(steps):
                yield make_batch(epoch * steps + i, args.batch_size, scene)

    model = replicate_(init_dsn(DSN().to(device), 0), mesh)
    optimizer, scheduler = make_seg_optimizer(model, args.max_epoch * steps, args.learning_rate)
    state = TrainState(model, optimizer, scheduler)
    lead = is_lead()
    logger = MetricLogger(args.log_dir, "train") if lead else NullLogger()
    ckpt = CheckpointManager(os.path.join(args.log_dir, "checkpoints")) if lead else None
    try:
        for epoch in range(args.max_epoch):
            agg = MetricAggregator()
            for batch in train_batches(epoch):
                cloud = np.asarray(batch["point_clouds"])[..., :3]
                instance = np.asarray(batch["instance_label"]).astype(np.int32)
                if args.dataset_root:
                    instance = dense_instance_labels(instance)
                metrics = seg_train_step(model, optimizer, scheduler, shard_rows(cloud, mesh),
                                         shard_rows(instance, mesh), args.max_objects, mesh=mesh)
                agg.update(metrics)
                state.step += 1
                if state.step % 10 == 0:
                    logger.log(state.step, agg.flush())
            if lead:
                ckpt.save(state.step, state, extra={"epoch": epoch + 1})
    finally:
        logger.close()
    return state


if __name__ == "__main__":
    main()
