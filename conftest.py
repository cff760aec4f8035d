"""Test run settings that must hold before torch is imported.

pytest loads this file before ``tests/conftest.py``. Each test worker
runs torch's intra-op pool, MKL and OpenBLAS on one thread, so a run of
several workers on one host has about one runnable thread per worker
for them, and its wall time follows the work the tests do rather than
how the host shares an oversubscribed set of cores. Children the tests
start (``bench.py --smoke``, the CLI tests, fleet workers) inherit
``os.environ`` and with it the same settings. A test that needs more
threads sets them for its block (``tests/torch_parity.py::pool_threads``).

XLA:CPU's Eigen pool keeps its default size: with
``--xla_cpu_multi_thread_eigen=false`` the reference's cold journal
replay (tests/test_fleet_durability.py) misses its control by one ulp
in RAJ, past its bar, in every run.
"""

import os

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
