"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the GPU and prints
one JSON line. Everything a cell is made of is found by name: its
configuration in ``configs/``, its traffic mix in ``traffic/``, the system
adapter the configuration names in ``systems/``, the generator the mix names
in ``generators/`` and each per-layer metric's reader in ``metrics/``. The
plain reference that decides ``correct`` is ``reference/``; it imports
nothing of the port.
"""
