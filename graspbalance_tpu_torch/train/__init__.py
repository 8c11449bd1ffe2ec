"""Training: the config tree, the training and eval steps (forward with
label matching, loss, backward, Adam + OneCycle, BatchNorm running
statistics), the epoch loop with checkpoints, resume and metric streams;
the DSN's training step (``seg_step.py``)."""
