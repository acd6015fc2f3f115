"""The entries a traffic file can drive, one module each, named by the
file's ``"driver"``: ``search`` (`plan(edges)`, then ``run`` or
``run_batched``).  A new entry is a new module here.

A driver is built from the traffic, the run's inputs, the device and a
generator drawn from the seed, and offers: ``build(edges)`` (the port's
construction), ``warm(sync)``, ``run(seconds, sync, traced)`` (one
stretch of the window, returning once the device has finished it),
``counts()`` (what a stretch did, to subtract), ``outcome()``
(attempted and failed answers), ``checked_roots()`` (the roots of the
trees the check compares), ``release()`` (drop the program's state,
return the sampled ``(root, parent row)`` deliveries),
``end_to_end(seconds, window_s, counts, graph)`` and ``traced(counts,
graph)`` (what the metrics read, with the reference's `run.Graph`).
"""
from __future__ import annotations

import importlib


def get(name: str):
    """The driver class of the module ``drivers/<name>.py``."""
    return importlib.import_module(f"graphbench.drivers.{name}").Driver
