"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  Everything a cell needs is found by name: its
configuration in ``configs/``, its traffic mix in ``traffic/``, its
metrics in ``metrics/``, the app it assembles in ``apps/``, the route it
drives in ``requests/`` and the plain reference in ``reference/``.
"""
