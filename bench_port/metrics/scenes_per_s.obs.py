"""``scenes_per_s`` of the serving cell that runs OBS, read by
``scenes_per_s.py``: a metric of its own, so that each serving cell's rate
is held to what its own runs support (PERF.md §2)."""

from pathlib import Path

from bench_port.harness import load_module

read = load_module(Path(__file__).with_name("scenes_per_s.py")).read
