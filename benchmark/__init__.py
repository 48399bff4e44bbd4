"""The benchmark of raft_tpu_torch, the PyTorch and CUDA port.

Run one cell of ``BENCHMARK.json`` from the root of a checkout::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, engine or
per-layer metric is a file of its own, found by name:
``configs/<config>.json`` (named by ``BENCHMARK.json``),
``traffic/<mix>.json``, ``engines/<engine>.py`` (the only code that calls
the port) and ``metrics/<metric>.py``. ``reference/`` holds the plain
exact search that decides ``correct``; it imports nothing of the port.
"""
