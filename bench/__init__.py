"""The goodput benchmark of the PyTorch and CUDA port (`repro_torch`).

`bench/run.py` serves one cell of `BENCHMARK.json` through the port's
`DisaggCluster` and prints one JSON line. Everything that belongs to one
configuration, traffic mix or metric is a file of its own that the
harness finds by name (`cell.py`); see `README.md`.
"""
