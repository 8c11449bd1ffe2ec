"""The benchmark of graspbalance_tpu_torch on one H100: ``run.py`` is its
command; BENCHMARK.json at the checkout's root names its cells."""
