"""The benchmark of vidmat_torch, the PyTorch and CUDA port, on NVIDIA cards.

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything else here
is found by the names that file gives: a configuration's sizes in
``configs/<config>.json``, a traffic mix's parameters in
``traffic/<traffic>.json`` (read by the module it names in ``drivers/``),
a metric's reader in ``metrics/<first part of its name>.py`` and a layer's
kernels and work in ``layers/<layer>.py``. The yardstick (the peaks, the
byte and operation counts, the plain float32 reference and the comparison
that decides ``correct``) lives here too, so that a change to the program
leaves it as it was. Nothing here imports ``jax`` or the JAX package.
"""
