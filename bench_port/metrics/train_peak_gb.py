"""The largest device memory allocated over the window, ``max_memory_allocated()``
after a reset at its start, in GB (1e9 bytes): whether the batch still fits."""


def read(run):
    return run.train["peak_bytes"] / 1e9 if run.train and run.train["peak_bytes"] else None
