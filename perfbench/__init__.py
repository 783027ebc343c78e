"""Benchmark of ``transport_analysis_tpu_torch`` on NVIDIA H100 cards.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``; see ``run.py``.
Cells, configurations and per-layer metrics are files found by name:
``workloads/<cell>.json``, ``configs/<config>.json`` with the generator
it names in ``generators/``, and ``metrics/<metric>.py``.
"""
