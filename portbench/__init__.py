"""The benchmark of filodb_tpu_torch, the PyTorch and CUDA port: dashboard
range queries over HTTP, one cell per (configuration, traffic mix) of
BENCHMARK.json. `python3 portbench/run.py --help`; see README.md."""
