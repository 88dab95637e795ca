"""motbench: the benchmark of the PyTorch and CUDA port (``fastmot_tpu_torch``).

Run a cell with ``python3 motbench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout; the cells,
metrics and bounds are in ``BENCHMARK.json``."""
