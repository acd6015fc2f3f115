"""Typed failures of the port (a copy of ``repro.errors``' admission
subset; the serve-tier classes arrive with the serve port).

`GraphValidationError` IS-A ``ValueError``: code that guarded ``plan()``
with ``except ValueError`` still catches it, while new code can catch
the precise class.  This module is import-leaf.
"""
from __future__ import annotations


class ReproError(Exception):
    """Base class of every typed failure this package raises."""


class GraphValidationError(ReproError, ValueError):
    """A graph (or root) failed admission-time structural validation.

    Raised by `repro_torch.bfs.plan` when the input could produce a
    *wrong answer* rather than an error: non-monotone ``colstarts``,
    out-of-range neighbor ids, wrong dtypes, NaN-shaped geometry, roots
    outside ``[0, V)``.  The message names the violated invariant and
    the fix.
    """
