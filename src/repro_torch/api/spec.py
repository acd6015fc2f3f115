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
* ``tile``: the format's rule (`CsrFormat.resolve_tile`).

Values the reference accepts but this port does not run yet raise a
typed `NotImplementedError` naming the ROADMAP item that brings them;
nothing degrades silently.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import engine as _engine

AUTO = "auto"

_ALGORITHMS = ("simd", "nonsimd")
#: the reference's pipelines; only "fused_gather" is ported so far
PIPELINES = ("fused_gather", "materialized", "megakernel", "persistent")
_MERGES = ("allreduce", "owner", "packed")
#: the reference's semiring portfolio values (ROADMAP item 9)
SEMIRING_ALGORITHMS = ("sssp", "cc", "ksource_bfs")
SKEW_THRESHOLD = 4.0       # max_deg / mean_deg floor for BeamerHybrid

#: registered policy names <-> engine policy classes
POLICIES = {
    "topdown": _engine.TopDown,
    "threshold_simd": _engine.ThresholdSimd,
    "paper_layers": _engine.PaperLiteralLayers,
    "beamer": _engine.BeamerHybrid,
}
_POLICY_NAMES = {cls: name for name, cls in POLICIES.items()}

#: unsupported-but-valid values -> the ROADMAP item that brings them
_NOT_PORTED = {
    ("pipeline", "materialized"): "6 (materialized pipeline on K7)",
    ("pipeline", "megakernel"): "7 (megakernel, K5)",
    ("pipeline", "persistent"): "7 (persistent kernel, K6)",
    ("packed", False): "6 (the dense-mask packed=False arm)",
}


def _is_policy(obj: Any) -> bool:
    """Duck-typed DirectionPolicy: decides a mode from a Workload."""
    return callable(getattr(obj, "decide", None)) \
        and hasattr(obj, "modes")


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP item {item}); "
        f"this slice runs pipeline='fused_gather', packed=True, "
        f"prefetch_depth=0 on CSR")


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

    def replace(self, **changes) -> "TraversalSpec":
        return dataclasses.replace(self, **changes)

    # -- validation --------------------------------------------------------
    def validate(self) -> "TraversalSpec":
        """Reject invalid values (ValueError, the reference's messages)
        and valid values this port does not run yet
        (NotImplementedError).  Returns self."""
        p = self.policy
        if not (_is_policy(p) or p == AUTO or
                (isinstance(p, str) and p in POLICIES)):
            raise ValueError(
                f"unknown policy {p!r}; expected a DirectionPolicy "
                f"object, one of {sorted(POLICIES)}, or 'auto'")
        if self.algorithm in SEMIRING_ALGORITHMS:
            raise not_ported(f"algorithm={self.algorithm!r}",
                             "9 (semiring portfolio, K11-K12)")
        if self.algorithm != AUTO and self.algorithm not in _ALGORITHMS:
            raise ValueError(
                f"unknown algorithm {self.algorithm!r}; expected a "
                f"scalar algorithm in {_ALGORITHMS}, a semiring "
                f"algorithm in {SEMIRING_ALGORITHMS}, or 'auto'")
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
        for field in ("pipeline", "packed"):
            item = _NOT_PORTED.get((field, getattr(self, field)))
            if item is not None:
                raise not_ported(f"{field}={getattr(self, field)!r}", item)
        if self.prefetch_depth != AUTO and self.prefetch_depth > 0:
            raise not_ported(f"prefetch_depth={self.prefetch_depth}",
                             "7 (the K4 DMA pipeline)")
        return self

    # -- auto resolution (exactly once, at plan time) --------------------
    def resolve(self, fmt) -> "TraversalSpec":
        """Resolve every ``"auto"`` against a `CsrFormat` from built-in
        defaults; the result `is_resolved` and has been validated."""
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
