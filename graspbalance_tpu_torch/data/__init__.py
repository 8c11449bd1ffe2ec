"""Synthetic scenes, and the GraspNet-1B data path: the dataset and its
loaders, host point-cloud utilities, the native host library's bindings and
the offline label generators (numpy)."""
