"""The training step's products per step, three times the forward's
(``counts/model.py``, the forward, the backward's two), times the steps of
the window, over the window and the configuration's peak, in %."""


def read(run):
    if not run.train or not run.attempted:
        return None
    return 100.0 * run.flops_per_call * run.attempted / run.window_s / run.peak_flops
