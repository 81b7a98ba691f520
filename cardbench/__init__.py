"""The benchmark of ``akaze_tpu_torch`` on NVIDIA cards.

``python -m cardbench --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` (``run.py``).  The cells, their
configurations, traffic mixes, limits and per-layer metrics are data
files under this folder, found by name (``spec.py``); ``reference/`` holds
the plain reference that decides ``correct``, ``roofline/`` the kernels'
yardstick.  Nothing here imports the JAX package.
"""
