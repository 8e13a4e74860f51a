"""qqbench: the benchmark of the PyTorch and CUDA port (quisquis_tpu_torch).

One command runs one cell of ``BENCHMARK.json`` once::

    python3 qqbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See README.md for the layout and how to add a configuration, a traffic mix,
an entry or a per-layer metric as files.
"""
