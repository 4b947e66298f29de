"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python3 hopaas_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line.  Configurations (``configs/``), traffic mixes
(``traffic/``), per-layer metric readers (``metrics/``) and each cell's
limits (``limits/``) are files of their own, found by the names in
``BENCHMARK.json``.  ``work/`` holds the frozen operation and byte counts
and the table of peaks; ``reference/`` the plain PyTorch model, optimizer
and data the outputs are judged against.
"""
