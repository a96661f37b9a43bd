"""Drivers, one module a kind of traffic, found by the ``driver`` a mix
names.  Each has ``run(cell, *, seed, seconds, trace, device, control)``
returning a :class:`fxbench.cells.Outcome`."""
