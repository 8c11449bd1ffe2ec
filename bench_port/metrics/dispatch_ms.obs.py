"""``dispatch_ms.serve`` of the serving cell that runs OBS, read by
``dispatch_ms.serve.py``: a metric of its own, so that each serving cell's
dispatch time moves its own end-to-end metric (PERF.md §2)."""

from pathlib import Path

from bench_port.harness import load_module

read = load_module(Path(__file__).with_name("dispatch_ms.serve.py")).read
