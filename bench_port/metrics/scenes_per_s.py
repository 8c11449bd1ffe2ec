"""Scenes served per second by one card: every scene of every call of the
window over the window's length (host clock)."""


def read(run):
    if not run.scenes_per_call or not run.attempted:
        return None
    return run.attempted * run.scenes_per_call / run.window_s
