"""Device time of the training labels per step: the program's
``gb.label_expand`` (the upload's remainder and the analytic label
expansion) and ``gb.label_match`` (``process_grasp_labels`` and
``match_grasp_view_and_label``) spans, each between CUDA events, mean per
step, from the tracer's pass after the window (``program_trace.py``)."""

from pathlib import Path

from bench_port import program_trace

ROOT = Path(__file__).resolve().parents[2]


def read(run):
    spans = program_trace.read(run, ROOT).get("spans", {})
    ms = [spans[k].get("event_ms") for k in ("gb.label_expand", "gb.label_match") if k in spans]
    return sum(ms) if len(ms) == 2 and None not in ms else None
