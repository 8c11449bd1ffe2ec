"""The share of the window in which no device operation ran, in %: the device
time of one call, from torch.profiler's trace of one pass over the pool's
batches in turn after the window, as the window cycles them (the union of
its operations' intervals, over the stretch's calls), times the window's
calls, over the window. The trace's own stretch runs slower than the window
(tracing adds host time to every launch), so its idle share, which the
result's ``device`` gives, reads higher. Not clamped: a busy count over the
window reads below 0."""


def read(run):
    p = run.profile
    if not p or not p.get("calls") or not run.attempted:
        return None
    busy = p["busy_s"] / p["calls"] * run.attempted
    return 100.0 * (1.0 - busy / run.window_s)
