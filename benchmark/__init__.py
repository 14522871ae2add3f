"""The benchmark of minialign_tpu_torch: `python3 -m benchmark.run`
runs one cell once (run.py). Everything that belongs to one
configuration, traffic mix, cell or metric is a file of its own, found
by the name that BENCHMARK.json gives it (spec.py)."""
