"""The benchmark of ``molvax_torch``, the port on an NVIDIA H100.

``python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything that belongs to one configuration, traffic mix, cell
or per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json`` (read by the generator
``traffic/<kind>.py`` that the mix names), ``workloads/<cell>.json`` (the
cell's limits) and ``metrics/<metric>.py``. The yardstick (``yardstick.py``,
``corpus.py``, ``weights.py``, ``reference/``) is frozen here: it imports
nothing of the program.
"""
