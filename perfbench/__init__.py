"""The serving benchmark of the PyTorch and CUDA port (``repro_torch``).

``python -m perfbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on one card and
prints one JSON line.  Everything that belongs to one configuration, one
traffic mix, one cell's output check or one per-layer metric is a file of
its own (``configs/``, ``traffic/``, ``checks/``, ``metrics/``), found by
the name ``BENCHMARK.json`` gives it.
"""
