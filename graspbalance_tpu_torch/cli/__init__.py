"""Command-line entry points of the port (``python -m
graspbalance_tpu_torch.cli.<name>``: train, train_seg, quality_gate,
dsn_quality_gate, infer, eval_ap)."""
