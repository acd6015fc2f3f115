"""Typed failures of the port (a copy of ``repro.errors``' admission
subset; the serve-tier classes arrive with the serve port), and the
record of degrades.

`GraphValidationError` IS-A ``ValueError``: code that guarded ``plan()``
with ``except ValueError`` still catches it, while new code can catch
the precise class.  This module is import-leaf.

A degrade is a fallback to a slower path where a kernel's budget does
not fit (only where the reference degrades).  `record_degrade` keeps it
in `DEGRADES` with the reference's ``site / reason / fallback`` fields
and warns; the metrics tier (``repro.obs``) is not ported yet.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple


class DegradeEvent(NamedTuple):
    site: str        # what degraded, e.g. "smem_fallback"
    reason: str      # the budget that did not fit
    fallback: str    # the path that ran instead


#: every degrade of this process, oldest first
DEGRADES: list[DegradeEvent] = []


def record_degrade(site: str, reason: str, fallback: str) -> DegradeEvent:
    event = DegradeEvent(site, reason, fallback)
    DEGRADES.append(event)
    warnings.warn(f"degrade[{site}]: {reason}; running {fallback}",
                  RuntimeWarning, stacklevel=3)
    return event


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
