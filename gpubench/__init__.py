"""The benchmark of the port (``qublas_tpu_torch``) on the H100.

Run one cell from the checkout's root:

    python3 gpubench/run.py --workload NAME --seed N --seconds S --trace 0|1

It prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``).
"""
