"""Device time of the Point Transformer backbone's attention per training
step: the program's ``gb.pt.attention`` spans (every PTLayer of the
forward), each between CUDA events, summed over a step, mean over the
steps of the tracer's pass after the window (``program_trace.py``). A
program without those spans gives nothing."""

from pathlib import Path

from bench_port import program_trace

ROOT = Path(__file__).resolve().parents[2]


def read(run):
    spans = program_trace.read(run, ROOT).get("spans", {})
    return spans.get("gb.pt.attention", {}).get("event_ms")
