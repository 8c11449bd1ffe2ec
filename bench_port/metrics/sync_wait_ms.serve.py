"""The host blocked on the card or on a transfer in a served call: the
program's ``sync_wait_ns`` counter (every ``trace.host_read``: the upload,
NMS's fixpoint tests, the voxel downsample's longest segment, the copies
out) in ms, mean per call, from the tracer's pass after the window
(``program_trace.py``)."""

from pathlib import Path

from bench_port import program_trace

ROOT = Path(__file__).resolve().parents[2]


def read(run):
    p = program_trace.read(run, ROOT)
    if not p or "gb.call" not in p["spans"]:
        return None
    return p["counters"]["sync_wait_ms"]
