"""The port's spans and counters: its only store of them.

Off by default. Then ``span`` is one test of a module-level flag that
returns a shared no-op context (nothing allocated, no profiler range),
``host_read`` calls its function, ``count`` returns.

``enable()`` turns it on. Then each ``span(name)`` records its name, its
parent span (a stack per thread, so a background thread has its own), a
call id that every span under one top-level span shares (one served call,
one training step), and its start and end on the host's clock in ns; while
torch.profiler records, it also enters a ``record_function`` range of the
same name, so the spans sit on the device trace's clock in any profiled
stretch (outside one a range costs ~10 us and shows nowhere).
``enable(device_events=True)`` adds a CUDA event pair around each span
(on a CUDA device), read only in ``take()``. ``host_read(site, fn)`` wraps
each place where the host waits for the card: it adds 1 to the counter
``sync.<site>`` and the blocked ns to ``sync_wait_ns`` and to the
innermost open span's ``wait_ns``. ``count(name, n)`` adds to a counter.

``take()`` returns the records and the counters, each event pair resolved
to device ms, and clears them; records stay in memory until then. The
module writes no file and reads no environment variable or setting: its
callers switch it on and read it. ``syncs_outside_host_read(fn)`` checks
the rule that every host wait goes through ``host_read``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
import traceback
import warnings

import torch

_on = False
_device_events = False
_NULL = contextlib.nullcontext()
_records: list = []
_counters: collections.Counter = collections.Counter()
_lock = threading.Lock()
_ids = itertools.count()
_calls = itertools.count()
_local = threading.local()

# a record: [id, parent id, call id, name, thread id, host start ns, host end ns, wait ns, events]
_ID, _PARENT, _CALL, _NAME, _THREAD, _T0, _T1, _WAIT, _EVENTS = range(9)


def enable(device_events: bool = False) -> None:
    """Record spans and counters from now on; ``device_events`` adds a
    CUDA event pair to each span."""
    global _on, _device_events
    _device_events = bool(device_events) and torch.cuda.is_available()
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event() -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name: str):
        self.rec = [next(_ids), None, None, name, threading.get_ident(), 0, 0, 0, None]
        self.rf = None

    def __enter__(self):
        rec, stack = self.rec, _stack()
        if stack:
            rec[_PARENT], rec[_CALL] = stack[-1][_ID], stack[-1][_CALL]
        else:
            rec[_CALL] = next(_calls)
        stack.append(rec)
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(rec[_NAME])
            self.rf.__enter__()
        if _device_events:
            rec[_EVENTS] = [_event(), None]
        rec[_T0] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec[_T1] = time.perf_counter_ns()
        if rec[_EVENTS] is not None:
            rec[_EVENTS][1] = _event()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        with _lock:
            _records.append(rec)
        return False


def span(name: str):
    """A context that records one span of ``name`` while the module is on."""
    if not _on:
        return _NULL
    return _Span(name)


def host_read(site: str, fn):
    """``fn()``, a read that makes the host wait for the card (a copy to
    the host, a value on the host, a blocking upload); counted and timed
    under ``site`` while the module is on."""
    if not _on:
        return fn()
    t = time.perf_counter_ns()
    out = fn()
    dt = time.perf_counter_ns() - t
    stack = _stack()
    if stack:
        stack[-1][_WAIT] += dt
    with _lock:
        _counters["sync." + site] += 1
        _counters["sync_wait_ns"] += dt
    return out


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while the module is on."""
    if _on:
        with _lock:
            _counters[name] += n


def take() -> dict:
    """{"spans": [...], "counters": {...}} recorded since the last take,
    and clear them. A span is a dict: id, parent (None at the top), call,
    name, thread, t0_ns, t1_ns, wait_ns and, with device events, device_ms.
    Resolving the event pairs waits for the card."""
    global _records, _counters
    with _lock:
        records, counters = _records, _counters
        _records, _counters = [], collections.Counter()
    if any(r[_EVENTS] is not None for r in records):
        torch.cuda.synchronize()
    spans = []
    for r in sorted(records, key=lambda r: r[_T0]):
        s = {"id": r[_ID], "parent": r[_PARENT], "call": r[_CALL], "name": r[_NAME], "thread": r[_THREAD],
             "t0_ns": r[_T0], "t1_ns": r[_T1], "wait_ns": r[_WAIT]}
        if r[_EVENTS] is not None:
            s["device_ms"] = r[_EVENTS][0].elapsed_time(r[_EVENTS][1])
        spans.append(s)
    return {"spans": spans, "counters": dict(counters)}


def syncs_outside_host_read(fn) -> list[str]:
    """Run ``fn()`` with torch's CUDA sync debug mode at "warn" and return
    where each synchronising call that it flags outside ``host_read`` was
    made ("file:line", and the caller's where torch's own Python made it).
    Without a CUDA device nothing synchronises."""
    global host_read
    real, inside, found = host_read, [0], []

    def read(site, f):
        inside[0] += 1
        try:
            return real(site, f)
        finally:
            inside[0] -= 1

    def show(message, category, filename, lineno, file=None, line=None):
        if inside[0] or "synchroniz" not in str(message):
            return
        where = f"{filename}:{lineno}"
        if f"{os.sep}torch{os.sep}" in filename:  # inside torch's own Python: name its caller too
            caller = next((f for f in reversed(traceback.extract_stack()[:-1])
                           if f"{os.sep}torch{os.sep}" not in f.filename and f.filename not in (__file__, warnings.__file__)),
                          None)
            where = f"{caller.filename}:{caller.lineno} ({where})" if caller else where
        found.append(where)

    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() else None
    if mode is not None:
        torch.cuda.set_sync_debug_mode("warn")
    host_read = read
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            fn()
    finally:
        host_read = real
        if mode is not None:
            torch.cuda.set_sync_debug_mode(mode)
    return found


class DeviceMs:
    """Device ms between CUDA event pairs on the current stream, summed:
    ``DeviceMs.start()`` records the first event, ``stop()`` the second;
    ``a + b`` keeps both pairs; ``float()`` waits for the last event and
    reads them. Nothing waits for the card before that."""

    __slots__ = ("pairs",)

    def __init__(self, pairs=()):
        self.pairs = list(pairs)

    @classmethod
    def start(cls) -> "DeviceMs":
        return cls([[_event(), None]])

    def stop(self) -> "DeviceMs":
        self.pairs[-1][1] = _event()
        return self

    def __add__(self, other: "DeviceMs") -> "DeviceMs":
        return DeviceMs(self.pairs + other.pairs)

    def __float__(self) -> float:
        if self.pairs:
            self.pairs[-1][1].synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.pairs))
