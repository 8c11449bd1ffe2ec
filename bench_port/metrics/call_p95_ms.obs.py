"""``call_p95_ms`` of the serving cell that runs OBS, read by
``call_p95_ms.py``: a metric of its own, so that each serving cell's tail is
held to what its own runs support (PERF.md §2)."""

from pathlib import Path

from bench_port.harness import load_module

read = load_module(Path(__file__).with_name("call_p95_ms.py")).read
