"""The host held steady over a measured window: the garbage collector's
objects frozen and the collector off, so that no collection pauses the
thread that dispatches to the card. (Pinning that thread to one core was
tried and widened the serving cells' spreads: PERF.md.)"""

from __future__ import annotations

import contextlib
import gc


@contextlib.contextmanager
def steady():
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()
