"""One driver a kind of traffic and a model family, found by the harness
as ``drivers/<kind>_<family>.py``.  A driver's ``Driver(config, traffic,
seed, device, trace)`` makes its inputs and weights from the seed and
warms every shape it will use (set-up); ``call(i)`` runs the ``i``-th unit
of the window's work and returns how much of the rate's work it did;
``sync()`` waits for the device; ``counters`` holds what the per-layer
readers read; ``check(precision)`` frees the program's state and returns
the numbers that the cell's limits hold."""
