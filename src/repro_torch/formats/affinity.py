"""Geometry-keyed affinity table: the one auto-knob lookup (a port of
``repro.formats.affinity``, with its names, keys and precedence).

Every ``"auto"`` field of a `TraversalSpec` resolves through `resolve`
below, as do the CSR format's auto tile and SELL's auto σ.  The table
is the port's own: ``affinity_table.json`` beside this module, written
on the card by ``tools/sweep_affinity.py`` (never the reference's
benchmark file).  Its rows are keyed by *format* and *geometry class*,
so a skewed R-MAT graph and a uniform torus resolve to different tuned
values from the same table:

    affinity.{format}.{geometry}.{knob}{value}

    affinity.csr.skew64.tile4096      {"us_per_call": ...}
    affinity.csr.skew64.prefetch1     {"us_per_call": ...}
    affinity.csr.skew1.pipeline_persistent
    affinity.sell.skew64.sigma1024

Numeric knobs append the value directly (``tile4096``); string knobs
separate it with ``_`` (``pipeline_megakernel``).  Within one (format,
geometry, knob) group the row with the lowest ``us_per_call`` wins.
The geometry class buckets `autotune.measure` statistics: ``dense``
when density crosses the bitmap regime threshold, else a power-of-4
degree-skew bucket (``skew1`` | ``skew4`` | ``skew16`` | ``skew64``,
labelled by the bucket's lower bound).  Keys that do not start with
``affinity.`` (the table's ``card`` record) are never read.

Precedence, highest first:

1. ``REPRO_BFS_TILE`` (the tile only; floored at 128);
2. the geometry-keyed row;
3. the flat ``affinity.tile<N>`` rows (the tile only);
4. the caller's default.

Classifying a graph reads its degrees.  A graph on ``meta`` tensors
has none: its class is None (the lookup falls through to tiers 3-4)
unless a graph of the same type, shapes and dtypes was classified
before, because classes are memoized by that geometry.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import pathlib

import torch

from repro_torch.formats import autotune

_TILE_ENV = "REPRO_BFS_TILE"

# knobs whose table value is a string (key form ``{knob}_{value}``);
# everything else parses as int (key form ``{knob}{value}``)
_STR_KNOBS = frozenset({"pipeline", "policy", "algorithm", "merge"})

# spec field -> key token (compact, underscore-free numeric tokens)
_KEY_TOKEN = {"prefetch_depth": "prefetch", "max_layers": "maxlayers"}

# degree-skew bucket lower bounds (powers of 4), label = lower bound
_SKEW_BUCKETS = (64, 16, 4)

_GEOM_CACHE: dict[tuple, str] = {}

# the tables `table_at` put in place, innermost last (None: no table)
_TABLE_STACK: list = []


def _table_path() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent / "affinity_table.json"


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    """The table in use (cached; `clear_cache` to re-read): the
    innermost `table_at`'s, else the committed one; a missing or
    unreadable file is an empty table."""
    path = _TABLE_STACK[-1] if _TABLE_STACK else _table_path()
    if path is None:
        return {}
    try:
        table = json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError):
        return {}
    return table if isinstance(table, dict) else {}


@contextlib.contextmanager
def table_at(path):
    """Resolve through the table at ``path`` while the block runs
    (``None``: no table, so every auto knob takes its built-in default);
    the sweep times its rows so, and the smoke test holds its earlier
    phases to the built-in defaults."""
    _TABLE_STACK.append(path)
    _table.cache_clear()
    try:
        yield
    finally:
        _TABLE_STACK.pop()
        _table.cache_clear()


def clear_cache() -> None:
    """Drop the cached table and geometry classes (tests, and the sweep
    before it times a row under another table)."""
    _table.cache_clear()
    _GEOM_CACHE.clear()


def _bucket(stats: autotune.GraphStats) -> str:
    if stats.density >= autotune.DENSITY_THRESHOLD:
        return "dense"
    for lo in _SKEW_BUCKETS:
        if stats.degree_skew >= lo:
            return f"skew{lo}"
    return "skew1"


def _leaves(graph) -> tuple:
    """The graph's arrays and counts: a format's `tensors()`, or the
    fields of a Csr / EdgeList."""
    tensors = getattr(graph, "tensors", None)
    return tuple(tensors()) if callable(tensors) else tuple(graph)


def _memo_key(graph) -> tuple:
    return (type(graph).__name__,
            tuple((tuple(getattr(x, "shape", ())),
                   str(getattr(x, "dtype", type(x).__name__)))
                  for x in _leaves(graph)))


def geometry_class(graph) -> str | None:
    """Density/skew bucket of a graph (a GraphFormat, Csr or EdgeList):
    the middle segment of the affinity keys.  None for a graph on
    ``meta`` tensors whose geometry was never classified on real
    ones."""
    key = _memo_key(graph)
    hit = _GEOM_CACHE.get(key)
    if hit is not None:
        return hit
    if any(isinstance(x, torch.Tensor) and x.is_meta
           for x in _leaves(graph)):
        return None
    geom = _bucket(autotune.measure(graph))
    _GEOM_CACHE[key] = geom
    return geom


def _best_row(prefix: str, knob: str):
    """argmin over ``us_per_call`` of every table row under ``prefix``
    -> parsed knob value (int or str), or None; rows that do not parse
    are skipped."""
    token = _KEY_TOKEN.get(knob, knob)
    sep = f"{token}_" if knob in _STR_KNOBS else token
    best, best_us = None, None
    for key, rec in _table().items():
        tail = key[len(prefix):] if key.startswith(prefix) else None
        if tail is None or not tail.startswith(sep):
            continue
        raw = tail[len(sep):]
        try:
            value = raw if knob in _STR_KNOBS else int(raw)
            us = float(rec["us_per_call"])
        except (KeyError, TypeError, ValueError):
            continue
        if best_us is None or us < best_us:
            best, best_us = value, us
    return best


def key_for(fmt_name: str, geometry: str, knob: str, value) -> str:
    """The canonical sweep-row key: the writer-side counterpart of
    `resolve` (``tools/sweep_affinity.py`` writes through it, so the
    schema cannot drift between the sweep and the lookup)."""
    token = _KEY_TOKEN.get(knob, knob)
    sep = "_" if knob in _STR_KNOBS else ""
    return f"affinity.{fmt_name}.{geometry}.{token}{sep}{value}"


def resolve(graph, knob: str, default, *, fmt_name: str | None = None):
    """Resolve one auto knob: env > geometry-keyed row > flat row >
    ``default``.  ``graph`` may be None (no geometry tier: the legacy
    array-level callers); ``fmt_name`` overrides the format segment
    when ``graph`` is not a built format (a Csr headed for
    `SellFormat.from_csr`)."""
    if knob == "tile":
        env = os.environ.get(_TILE_ENV)
        if env:
            try:
                return max(128, int(env))
            except ValueError:
                raise ValueError(
                    f"{_TILE_ENV}={env!r} is not an integer tile size"
                ) from None
    if graph is not None:
        name = fmt_name if fmt_name is not None \
            else getattr(graph, "name", None)
        geom = geometry_class(graph) if name else None
        if geom is not None:
            row = _best_row(f"affinity.{name}.{geom}.", knob)
            if row is not None:
                return row
    if knob == "tile":
        flat = _best_row("affinity.", "tile")
        if flat is not None:
            return flat
    return default
