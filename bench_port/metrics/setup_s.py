"""Set-up: from the process's start to the window's (imports, the kernels
built or loaded, weights and inputs made, the cell's shapes warmed up)."""


def read(run):
    return run.setup_s
