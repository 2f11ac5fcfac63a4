"""The benchmark of ``scenenet_tpu_torch`` on one NVIDIA H100.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. See
``perfbench/README.md``.
"""
