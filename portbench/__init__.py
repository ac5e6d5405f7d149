"""The benchmark of the PyTorch/CUDA port (``repro_torch``), driven by data.

``run.py`` runs one cell of ``BENCHMARK.json``.  Everything that belongs to
one configuration, traffic mix, cell or metric is a file of its own, found
by its name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (read
by the generator its ``kind`` names, ``traffic/<kind>.py``),
``cells/<cell>.json`` (the driver, ``drivers/<driver>.py``, and the
limits of its correctness check) and ``metrics/<metric>.py`` (a reader).
The plain reference that decides ``correct`` is under ``reference/``.
"""
