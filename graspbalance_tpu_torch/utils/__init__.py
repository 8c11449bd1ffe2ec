"""Small helpers (port of graspbalance_tpu/utils/)."""
