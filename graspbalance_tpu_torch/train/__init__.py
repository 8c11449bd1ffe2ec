"""One training step: forward with label matching, loss, backward, Adam +
OneCycle, BatchNorm running statistics."""
