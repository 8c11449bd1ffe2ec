"""The host's time issuing a served call's work: the program's ``gb.call``
span's host ms less the host's waits on the card inside it (the program's
``sync_wait_ns`` counter), mean per call, from the tracer's pass after the
window (``program_trace.py``)."""

from pathlib import Path

from bench_port import program_trace

ROOT = Path(__file__).resolve().parents[2]


def read(run):
    p = program_trace.read(run, ROOT)
    if not p or "gb.call" not in p["spans"]:
        return None
    return p["spans"]["gb.call"]["host_ms"] - p["counters"]["sync_wait_ms"]
