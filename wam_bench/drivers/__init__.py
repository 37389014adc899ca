"""Drivers, one per kind of traffic mix (``traffic/<mix>.json``'s
``driver``).  A driver module holds ``Driver(cell, config, mix, seed,
device, tracer, fault, control)`` with ``setup()``, ``window(seconds)``,
``finish()``, ``release()`` and ``check()``, and its ``rec``: the
records the metric readers read.  ``FAULTS`` and ``CONTROLS`` name what
it can plant in the timed path for the tests and the control runs."""
