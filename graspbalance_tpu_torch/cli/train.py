"""Training CLI (port of graspbalance_tpu/cli/train.py, with its flags and
``--device``):

    python -m graspbalance_tpu_torch.cli.train --synthetic_steps 20 --max_epoch 1

Trains on GraspNet-1B with ``--dataset_root`` (data/dataset.py: the
training split, with the test_seen split as the eval stream), or on
synthetic scenes (data/synthetic.py): by default with the static labels (one
base label tensor shared by every scene), with ``--synthetic_varied_labels``
a roll of it per scene, with ``--synthetic_analytic`` the analytic labels,
expanded on the device. Runs on the card unless ``--device cpu``.
``--dtype bfloat16`` trains in bfloat16 compute (``--width_mlp_dtype
bfloat16`` only the width head's MLPs); both are recorded in config.json.
``--backbone pointnet2`` trains the PointNet++ SSG backbone
(models/backbone.py) in place of DRP, ``--backbone pt`` Point Transformer
(models/pt_backbone.py). As in the JAX CLI, the scenes and the
heads keep the default 12 angles and 4 depths.

On S cards, data-parallel over S ranks (each its rows of the global batch
``--batch_size``, which S must divide; the step is the global batch's, as
the JAX CLI's mesh step is):

    torchrun --nproc_per_node=S -m graspbalance_tpu_torch.cli.train --synthetic_steps 20 --max_epoch 1

Each rank trains on ``cuda:LOCAL_RANK`` over NCCL (with ``--device cpu``
on the CPU over gloo), n_data_shards is every rank, and only rank 0 writes
the log_dir.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    from graspbalance_tpu_torch.models.graspbalance import BACKBONES

    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset_root", default="", help="GraspNet-1B root (empty = synthetic data)")
    p.add_argument("--camera", default="realsense", choices=["realsense", "kinect"])
    p.add_argument("--log_dir", default="logs/graspbalance_tpu")
    p.add_argument("--num_point", type=int, default=20000)
    p.add_argument("--num_view", type=int, default=300)
    p.add_argument("--max_epoch", type=int, default=18)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--learning_rate", type=float, default=1e-3)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--bn_decay_step", type=int, default=2)
    p.add_argument("--bn_decay_rate", type=float, default=0.5)
    p.add_argument("--num_workers", type=int, default=2)
    p.add_argument("--ncm", action="store_true", default=True, help="noisy-clean mix")
    p.add_argument("--no-ncm", dest="ncm", action="store_false")
    p.add_argument("--backbone", default="drp", choices=sorted(BACKBONES), help="the backbone")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"], help="compute dtype")
    p.add_argument("--width_mlp_dtype", default=None, choices=[None, "bfloat16"],
                   help="the width head's MLPs' compute dtype (default: --dtype)")
    p.add_argument("--synthetic_steps", type=int, default=50, help="steps/epoch on synthetic data")
    p.add_argument("--synthetic_analytic", action="store_true",
                   help="labels an analytic function of the scene geometry, expanded on the device")
    p.add_argument("--synthetic_varied_labels", action="store_true",
                   help="a label tensor per scene (slower on the host); default: one shared (static_labels)")
    p.add_argument("--device", default="cuda", help="torch device (default the card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def config_from_args(args):
    """The Config of the parsed flags; raises ValueError on a refused one."""
    from graspbalance_tpu_torch.train.config import Config, DataConfig, ModelConfig, TrainConfig
    from graspbalance_tpu_torch.train.train_step import check_supported

    cfg = Config(
        model=ModelConfig(num_view=args.num_view, backbone=args.backbone, dtype=args.dtype,
                          width_mlp_dtype=args.width_mlp_dtype),
        data=DataConfig(
            dataset_root=args.dataset_root, camera=args.camera, num_points=args.num_point,
            batch_size=args.batch_size, num_workers=args.num_workers, ncm=args.ncm,
            analytic_labels=args.synthetic_analytic and not args.dataset_root,
        ),
        train=TrainConfig(
            max_epoch=args.max_epoch, learning_rate=args.learning_rate, weight_decay=args.weight_decay,
            bn_decay_step=args.bn_decay_step, bn_decay_rate=args.bn_decay_rate, log_dir=args.log_dir,
        ),
    )
    check_supported(cfg)
    return cfg


def main(argv=None) -> None:
    """Parse ``argv`` (default the command line) and train; the run's
    checkpoints and metric streams are in its ``--log_dir``. Under
    torchrun, joins its process group first and leaves it at the end."""
    args = parse_args(argv)
    import torch.distributed as dist

    from graspbalance_tpu_torch.parallel.mesh import init_from_env

    args.device, joined = init_from_env(args.device)
    try:
        _train(args)
    finally:
        if joined:
            dist.destroy_process_group()


def _train(args) -> None:
    cfg = config_from_args(args)

    from graspbalance_tpu_torch.train.loop import train

    if args.dataset_root:
        from graspbalance_tpu_torch.data.dataset import make_dataloaders

        train_batches, eval_batches, steps = make_dataloaders(cfg)
        train(cfg, train_batches, eval_batches, steps_per_epoch=steps, device=args.device)
        return

    from graspbalance_tpu_torch.data.synthetic import SceneConfig, make_batch

    scene = SceneConfig(
        num_points=args.num_point,
        num_views=args.num_view,
        static_labels=not args.synthetic_varied_labels,
        analytic_labels=args.synthetic_analytic,
        emit_label_tensors=not args.synthetic_analytic,
    )
    steps = args.synthetic_steps

    def train_batches(epoch):
        for i in range(steps):
            yield make_batch(epoch * steps + i, args.batch_size, scene)

    train(cfg, train_batches, steps_per_epoch=steps, device=args.device)


if __name__ == "__main__":
    main()
