"""The benchmark of the PyTorch/CUDA port (``repro_torch``), driven by data.

``run.py`` runs one cell of ``BENCHMARK.json``.  Everything that belongs to
one configuration, traffic mix, cell or metric is a file of its own, found
by its name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (read
by the generator its ``kind`` names, ``traffic/<kind>.py``),
``cells/<cell>.json`` (the driver, ``drivers/<driver>.py``, and the
limits of its correctness check), ``metrics/<metric>.py`` (a reader) and
``reference/<module>.py``, the architecture that a configuration names
under ``"reference"``: its weights, the plain reference that decides
``correct``, and its counts of operations and bytes (``spec.INTERFACE``).
No other file knows an architecture, so a configuration of a new one is
new files: ``configs/<name>.json``, ``reference/<module>.py``, and its
traffic and cell files.
"""
