"""The share of the window the training loop spent waiting for its next
batch (the program's ``Prefetch.wait_s`` counter over the window), in %."""


def read(run):
    return 100.0 * run.train["wait_s"] / run.window_s if run.train else None
