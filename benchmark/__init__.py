"""The benchmark of drnmf_torch on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once.  Everything that
belongs to one configuration, traffic mix, cell or per-layer metric sits in
a file of its own, found by the name that ``BENCHMARK.json`` gives:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``drivers/<kind>_<family>.py``, ``limits/<cell>.json`` and
``metrics/<metric>.py``.  ``yardstick/`` and ``reference/`` hold the
arithmetic and the plain reference that every cell shares; they import
nothing of the program."""
