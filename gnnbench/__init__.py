"""The benchmark of ``occ_gnn_tpu_torch``, the PyTorch and CUDA port.

``python3 -m gnnbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the CUDA card and
prints one JSON line. Everything a cell is made of is found by name: its
configuration in ``configs/``, its traffic in ``traffic/``, its
correctness limits in ``limits/``, the driver of its traffic's mode in
``drivers/`` and each per-layer metric's reader in ``metrics/``. The plain
reference that decides ``correct`` is ``reference/``; it imports nothing
of the port. See ``README.md``.
"""
