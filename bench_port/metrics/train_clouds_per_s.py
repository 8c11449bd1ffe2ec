"""Training throughput: the clouds of every step of the window over the
window, the card synchronised at its end (host clock)."""


def read(run):
    return run.train["clouds"] / run.window_s if run.train and run.train["clouds"] else None
