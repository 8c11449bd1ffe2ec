"""The served forward's (model, and DSN where the cell runs OBS) products
per call (``counts/model.py``) times the calls of the window, over the
window and the configuration's peak, in %."""


def read(run):
    if not run.scenes_per_call or not run.attempted:
        return None
    return 100.0 * run.flops_per_call * run.attempted / run.window_s / run.peak_flops
