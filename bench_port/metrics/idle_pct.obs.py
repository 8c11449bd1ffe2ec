"""``idle_pct.serve`` of the serving cell that runs OBS, read by
``idle_pct.serve.py``: a metric of its own, so that each serving cell's idle
share is held to what its own runs support (PERF.md §2)."""

from pathlib import Path

from bench_port.harness import load_module

read = load_module(Path(__file__).with_name("idle_pct.serve.py")).read
