"""The benchmark of vfidkr_torch: see benchmark/run.py and BENCHMARK.json."""
