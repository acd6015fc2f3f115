"""TraversalSpec — one frozen configuration object for every BFS.

The same eight fields as ``repro.api.spec.TraversalSpec``, the same
validation messages for the values this port supports, and the same
``to_dict`` layout, so a dict from either package loads in the other.

Every field accepts ``"auto"``, resolved once at plan time from
built-in defaults only (no benchmark table is read):

* ``policy``: `BeamerHybrid` when the degree skew max/mean is >= 4,
  else `ThresholdSimd` (the reference's autotune rule);
* ``algorithm``: ``"simd"``; ``pipeline``: ``"fused_gather"``;
  ``packed``: True; ``prefetch_depth``: 0; ``max_layers``: 64;
  ``merge``: ``"packed"`` (read only by the distributed path);
* ``tile``: the format's rule (``fmt.resolve_tile``: rows slots per
  block on CSR, slabs per group on SELL).

``pipeline`` runs ``"fused_gather"``, ``"materialized"``,
``"megakernel"`` and ``"persistent"``, at any ``prefetch_depth``, where
the format supports them (its ``supports_*`` flags; the reference's
messages); the auto choice stays ``fused_gather`` at depth 0 (changing
it needs measurements).  ``persistent`` with a policy its kernel cannot
encode runs the ``megakernel`` steps, with a recorded
``pipeline_unsupported`` degrade (`engine.persistent_fallback`).
``packed=False`` is the dense-mask arm of the CSR planning and queues;
SELL and bitmap ignore it, as in the reference.  ``algorithm`` also
takes the semiring portfolio (``"sssp"``, ``"cc"``, ``"ksource_bfs"``:
`is_semiring`), which runs the ``fused_gather`` relax arm only, on
formats that list it in ``supported_semirings``.  Every value the
reference accepts resolves and runs.
"""
from __future__ import annotations

import dataclasses
from typing import Any
import warnings

import torch

from repro_torch.algorithms.semiring import SEMIRING_ALGORITHMS
from repro_torch.core import engine as _engine

AUTO = "auto"

_ALGORITHMS = ("simd", "nonsimd")
#: the reference's pipelines, all ported
PIPELINES = ("fused_gather", "materialized", "megakernel", "persistent")
_MERGES = ("allreduce", "owner", "packed")
SKEW_THRESHOLD = 4.0       # max_deg / mean_deg floor for BeamerHybrid

#: registered policy names <-> engine policy classes
POLICIES = {
    "topdown": _engine.TopDown,
    "threshold_simd": _engine.ThresholdSimd,
    "paper_layers": _engine.PaperLiteralLayers,
    "beamer": _engine.BeamerHybrid,
}
_POLICY_NAMES = {cls: name for name, cls in POLICIES.items()}


def _is_policy(obj: Any) -> bool:
    """Duck-typed DirectionPolicy: decides a mode from a Workload."""
    return callable(getattr(obj, "decide", None)) \
        and hasattr(obj, "modes")


#: spec fields the distributed per-chip program (a fixed top-down
#: rowsweep) cannot honor — it consumes only merge/max_layers
MESH_IGNORED_FIELDS = ("policy", "algorithm", "pipeline", "packed",
                       "tile", "prefetch_depth")


def warn_mesh_ignored_fields(spec: "TraversalSpec", entry: str) -> None:
    """The one mesh-path contract warning (shared by
    `core.bfs_distributed.run_bfs_distributed` and a mesh-bound `plan`):
    a `UserWarning` naming the explicitly set fields the fixed per-chip
    program ignores.  A resolved spec passes silently: its concrete
    fields are resolution artifacts, not user intent."""
    if spec.is_resolved:
        return
    ignored = [f for f in MESH_IGNORED_FIELDS if getattr(spec, f) != AUTO]
    if ignored:
        warnings.warn(
            f"{entry}: the distributed per-chip program is a fixed "
            f"top-down rowsweep; spec fields {ignored} are ignored "
            f"(only merge/max_layers apply)",
            UserWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class TraversalSpec:
    """Frozen, hashable traversal configuration (see module docstring).
    `resolve` turns autos into concrete values exactly once;
    `validate` rejects invalid values in ONE place."""

    policy: Any = AUTO
    algorithm: str = AUTO
    pipeline: str = AUTO
    packed: Any = AUTO            # bool | "auto"
    tile: Any = AUTO              # positive int | "auto"
    prefetch_depth: Any = AUTO    # int >= 0 | "auto"
    max_layers: Any = AUTO        # int >= 1 | "auto"
    merge: str = AUTO

    @classmethod
    def field_names(cls) -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))

    @property
    def is_resolved(self) -> bool:
        """True iff no field is ``"auto"`` and policy is an object."""
        return (not any(getattr(self, f) == AUTO
                        for f in self.field_names())
                and _is_policy(self.policy))

    @property
    def is_semiring(self) -> bool:
        """True iff this spec selects the semiring portfolio (sssp, cc,
        ksource_bfs) rather than the BFS engine."""
        return self.algorithm in SEMIRING_ALGORITHMS

    def replace(self, **changes) -> "TraversalSpec":
        return dataclasses.replace(self, **changes)

    # -- validation --------------------------------------------------------
    def validate(self) -> "TraversalSpec":
        """Reject invalid values (ValueError, the reference's messages).
        Returns self."""
        p = self.policy
        if not (_is_policy(p) or p == AUTO or
                (isinstance(p, str) and p in POLICIES)):
            raise ValueError(
                f"unknown policy {p!r}; expected a DirectionPolicy "
                f"object, one of {sorted(POLICIES)}, or 'auto'")
        if self.algorithm != AUTO \
                and self.algorithm not in _ALGORITHMS \
                and self.algorithm not in SEMIRING_ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; expected a "
                f"scalar algorithm in {_ALGORITHMS}, a semiring "
                f"algorithm in {SEMIRING_ALGORITHMS}, or 'auto'")
        if self.is_semiring:
            # the relax kernels (K11, K12) are the fused_gather arm
            # only: an explicit BFS-specialized pipeline or a prefetch
            # stream is a typed error, with the reference's messages
            if self.pipeline in ("megakernel", "persistent",
                                 "materialized"):
                raise ValueError(
                    f"pipeline={self.pipeline!r} is invalid for the "
                    f"semiring algorithm {self.algorithm!r}: the "
                    f"portfolio kernels only implement the "
                    f"'fused_gather' relax arm — use "
                    f"pipeline='fused_gather' (or 'auto')")
            if isinstance(self.prefetch_depth, int) \
                    and self.prefetch_depth > 0:
                raise ValueError(
                    f"prefetch_depth={self.prefetch_depth} is invalid "
                    f"for the semiring algorithm {self.algorithm!r}: "
                    f"the relax kernels have no manual prefetch "
                    f"stream — use prefetch_depth=0 (or 'auto')")
        if self.pipeline != AUTO and self.pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {self.pipeline!r}; "
                             f"expected one of {PIPELINES}")
        if self.merge != AUTO and self.merge not in _MERGES:
            raise ValueError(
                f"unknown merge {self.merge!r}; expected one of "
                f"{_MERGES} or 'auto' (merge only matters with a mesh)")
        if self.packed != AUTO and not isinstance(self.packed, bool):
            raise ValueError(
                f"packed must be True, False or 'auto', got "
                f"{self.packed!r}")
        if self.tile != AUTO and (not isinstance(self.tile, int)
                                  or isinstance(self.tile, bool)
                                  or self.tile < 1):
            raise ValueError(
                f"tile must be a positive int or 'auto', got "
                f"{self.tile!r}")
        if self.prefetch_depth != AUTO and (
                not isinstance(self.prefetch_depth, int)
                or isinstance(self.prefetch_depth, bool)
                or self.prefetch_depth < 0):
            raise ValueError(
                f"prefetch_depth must be an int >= 0 or 'auto', got "
                f"{self.prefetch_depth!r}")
        if self.max_layers != AUTO and (
                not isinstance(self.max_layers, int)
                or isinstance(self.max_layers, bool)
                or self.max_layers < 1):
            raise ValueError(
                f"max_layers must be an int >= 1 or 'auto', got "
                f"{self.max_layers!r}")
        return self

    def _validate_for(self, fmt) -> None:
        """The format-dependent checks of the reference's ``validate``
        (the same messages, read from the format's capability flags)."""
        fmt_label = getattr(fmt, "name", type(fmt).__name__)
        if self.is_semiring:
            allowed = getattr(fmt, "supported_semirings", ())
            if self.algorithm not in allowed:
                raise ValueError(
                    f"algorithm={self.algorithm!r} is invalid for "
                    f"the {fmt_label!r} format: it declares "
                    f"supported_semirings={allowed!r} — pick a "
                    f"layout with a per-edge candidate stream "
                    f"like 'csr'/'sell'")
        depth = self.prefetch_depth
        if isinstance(depth, int) and depth > 0 \
                and not getattr(fmt, "supports_prefetch", True):
            raise ValueError(
                f"prefetch_depth={depth} is invalid for the "
                f"{fmt_label!r} "
                f"format: it streams no edge tiles to prefetch "
                f"(supports_prefetch=False) — use prefetch_depth=0 "
                f"(or 'auto'), or pick a streamed layout like "
                f"'csr'/'sell'")
        if self.pipeline == "megakernel" \
                and not getattr(fmt, "supports_megakernel", True):
            raise ValueError(
                f"pipeline='megakernel' is invalid for the "
                f"{fmt_label!r} format: it has no whole-layer "
                f"fused kernel (supports_megakernel=False) — use "
                f"pipeline='fused_gather' (or 'auto'), or pick a "
                f"layout with a megakernel like 'csr'")
        if self.pipeline == "persistent":
            if not getattr(fmt, "supports_persistent", False):
                raise ValueError(
                    f"pipeline='persistent' is invalid for the "
                    f"{fmt_label!r} format: it has no "
                    f"whole-traversal fused kernel "
                    f"(supports_persistent=False) — use "
                    f"pipeline='megakernel'/'fused_gather' (or "
                    f"'auto'), or pick a layout with a persistent "
                    f"kernel like 'csr'/'sell'")
            allowed = getattr(fmt, "persistent_algorithms", ())
            if self.algorithm != AUTO and allowed \
                    and self.algorithm not in allowed:
                raise ValueError(
                    f"pipeline='persistent' on the {fmt_label!r} "
                    f"format honors algorithm in {allowed}, got "
                    f"{self.algorithm!r}: the in-kernel layer "
                    f"loop has no plain-jnp scalar arm — use one "
                    f"of {allowed}, or pipeline='megakernel'")

    # -- auto resolution (exactly once, at plan time) --------------------
    def resolve(self, fmt) -> "TraversalSpec":
        """Resolve every ``"auto"`` against a `formats.GraphFormat` from
        built-in defaults; the result `is_resolved` and has been
        validated against the format."""
        self.validate()
        policy = self.policy
        if policy == AUTO:
            deg = fmt.degrees().to("cpu", dtype=torch.float64)
            mean = float(deg.mean()) if deg.numel() else 0.0
            skew = float(deg.max()) / mean if mean > 0 else 0.0
            policy = (_engine.BeamerHybrid() if skew >= SKEW_THRESHOLD
                      else _engine.ThresholdSimd())
        elif isinstance(policy, str):
            policy = POLICIES[policy]()
        self._validate_for(fmt)
        # the auto pipeline is fused_gather at depth 0 (no affinity
        # table), which the semiring portfolio runs, so the reference's
        # `pipeline_unsupported` / `prefetch_unsupported` degrades of an
        # auto choice cannot arise here
        resolved = self.replace(
            policy=policy,
            algorithm="simd" if self.algorithm == AUTO else self.algorithm,
            pipeline=("fused_gather" if self.pipeline == AUTO
                      else self.pipeline),
            packed=True if self.packed == AUTO else self.packed,
            tile=fmt.resolve_tile(None if self.tile == AUTO
                                  else self.tile),
            prefetch_depth=(0 if self.prefetch_depth == AUTO
                            else self.prefetch_depth),
            max_layers=64 if self.max_layers == AUTO else self.max_layers,
            merge="packed" if self.merge == AUTO else self.merge)
        return resolved.validate()

    # -- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-ready dict; policy objects serialize as
        ``{"name": ..., "params": {...}}`` (tuples become lists)."""
        d = {f: getattr(self, f) for f in self.field_names()}
        p = self.policy
        if _is_policy(p):
            cls = type(p)
            if cls not in _POLICY_NAMES:
                raise ValueError(
                    f"cannot serialize unregistered policy class "
                    f"{cls.__name__}; register it in spec.POLICIES")
            params = {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in dataclasses.asdict(p).items()}
            d["policy"] = {"name": _POLICY_NAMES[cls], "params": params}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TraversalSpec":
        """Inverse of `to_dict` (round-trips to an equal spec)."""
        unknown = set(d) - set(cls.field_names())
        if unknown:
            raise ValueError(
                f"unknown TraversalSpec fields {sorted(unknown)}; "
                f"expected a subset of {cls.field_names()}")
        kw = dict(d)
        p = kw.get("policy")
        if isinstance(p, dict):
            pol_cls = POLICIES[p["name"]]
            params = {k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in p.get("params", {}).items()}
            kw["policy"] = pol_cls(**params)
        return cls(**kw).validate()
