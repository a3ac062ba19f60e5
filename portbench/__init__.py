"""Benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix or
per-layer metric is a file of its own, found by its name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``metrics/<metric>.py``.
"""
