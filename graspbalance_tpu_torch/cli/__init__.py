"""Command-line entry points of the port (``python -m
graspbalance_tpu_torch.cli.train``)."""
