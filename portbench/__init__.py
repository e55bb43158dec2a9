"""The benchmark of the PyTorch and CUDA port (``audiossl_tpu_torch``).

One run measures one cell of ``BENCHMARK.json`` on the card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json`` (whose
``loop`` names the module under ``loops/`` that runs it), the limits of
its output check in ``limits/<cell>.json`` and each per-layer metric's reader
in ``metrics/<name before the first dot>.py``. ``reference/`` is the plain
PyTorch reference the check compares with, ``counts/`` the operation and
byte counts of the rooflines and of ``mfu``. Nothing here imports JAX or the
JAX package.
"""
