"""Run a function on S ranks of one host without ``torchrun``: the tests'
and the smoke's multi-rank runs.

``run_ranks(fn, world, args)`` spawns ``world`` processes; rank r joins a
process group of ``backend`` through a ``file://`` store at ``init_file``
(no port is needed) and calls ``fn(rank, world, *args)``. The call waits
for every rank, at most ``timeout`` seconds: a rank that raises, or exits
non-zero, ends the others and fails the call with its traceback; a run past
the timeout is ended and raises ``TimeoutError``. ``fn`` must be importable
by name (a module-level function), since the ranks are spawned.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import multiprocessing.connection
import os
import time
import traceback


def _rank_main(fn, rank, world, backend, init_file, threads, errors, args):
    import torch
    import torch.distributed as dist

    try:
        if threads is not None:
            torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=300))
        try:
            fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        errors.put(f"rank {rank}:\n{traceback.format_exc()}")
        raise SystemExit(1)


def run_ranks(fn, world: int, args: tuple = (), *, init_file: str, backend: str = "gloo",
              timeout: float = 300.0, threads: int | None = None) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks (see the
    module docstring). ``init_file`` must not exist yet; ``threads`` sets
    each rank's torch thread count."""
    if os.path.exists(init_file):
        raise ValueError(f"the store {init_file} exists already: give each run a fresh path")
    ctx = mp.get_context("spawn")
    errors = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, backend, init_file, threads, errors, args),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        live = list(procs)
        while live and time.monotonic() < deadline:
            multiprocessing.connection.wait([p.sentinel for p in live], deadline - time.monotonic())
            live = [p for p in procs if p.exitcode is None]
            if any(p.exitcode not in (None, 0) for p in procs):
                break  # a rank failed: the others may wait on it forever
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
        for p in procs:
            p.join()
    msgs = []
    while not errors.empty():
        msgs.append(errors.get())
    codes = [p.exitcode for p in procs]
    if msgs or any(c != 0 for c in codes):
        detail = "\n".join(msgs) if msgs else ""
        if not msgs and hung and time.monotonic() >= deadline:
            raise TimeoutError(f"{len(hung)} of {world} ranks still ran after {timeout:.0f} s; ended them")
        raise RuntimeError(f"ranks exited with codes {codes}\n{detail}")
