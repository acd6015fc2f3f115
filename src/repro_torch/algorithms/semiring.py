"""Semiring — the (⊕, ⊗) pair behind the algorithm portfolio, in torch.

A port of ``repro.algorithms.semiring``.  One layer of the frontier
sweep is a semiring SpMV, ``vals' = vals ⊕ (A ⊗ vals)``; every
registered instance is tropical (⊕ = min), so the relax kernels (K11 on
CSR, K12 on SELL) share one deterministic primitive, a masked
scatter-min of edge candidates

    cand = vals[u] + unit + (w(u, v) if weighted else 0)

==============  =======  ====  ========  ==========================
name            dtype    unit  weighted  algorithm
==============  =======  ====  ========  ==========================
bfs             int32    1     no        BFS depths / min-parent tree
ksource_bfs     int32    1     no        batched k-root BFS depths
sssp            float32  0     yes       min-plus shortest paths
cc              int32    0     no        min-label propagation
==============  =======  ====  ========  ==========================

The strict "improved" predicate (``new < old``) is both the update gate
and the next frontier's generator.

**Synthetic edge weights** (`edge_weight`): the layouts store no weight
array, so SSSP draws weights in [1, 2) from a symmetric splitmix hash
of the endpoints, bit-identical to the reference's ``_weight_impl``.
Torch has no usable uint32 multiply or shift, so the hash runs in
int64 on the unsigned 32-bit pattern, masked after every step, and each
32-bit multiply is taken in 16-bit halves so no product leaves 48 bits.
`edge_weight_np` is the same hash in numpy uint32 (the oracles' copy).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: ⊕-identity == "unreached": int32 uses a half-range infinity so that
#: ``identity + unit`` cannot wrap; float32 uses inf
INT_INF = np.int32(np.iinfo(np.int32).max // 2)
FLOAT_INF = np.float32(np.inf)

#: the `TraversalSpec.algorithm` values run by the semiring driver
SEMIRING_ALGORITHMS = ("sssp", "cc", "ksource_bfs")

#: SSSP delta-stepping bucket width (= the minimum edge weight)
SSSP_DELTA = 1.0

_MIX1 = 0x7FEB352D
_MIX2 = 0x846CA68B
_GOLD = 0x9E3779B1
_U32 = 0xFFFFFFFF


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32): the constant in
    16-bit halves keeps every product below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix_u32(x: torch.Tensor) -> torch.Tensor:
    x = _mul_u32(x ^ (x >> 16), _MIX1)
    x = _mul_u32(x ^ (x >> 15), _MIX2)
    return x ^ (x >> 16)


def edge_weight(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Deterministic symmetric float32 weight in [1, 2) of edge (u, v),
    bit-identical to the reference's ``edge_weight``."""
    u = torch.as_tensor(u)
    v = torch.as_tensor(v, device=u.device)
    a = torch.minimum(u, v).to(torch.int64) & _U32
    b = torch.maximum(u, v).to(torch.int64) & _U32
    h = _mix_u32((_mul_u32(a, _GOLD) + b) & _U32)
    # the top 24 hash bits, exact in float32, scaled to [0, 1)
    frac = (h >> 8).to(torch.float32) * np.float32(1.0 / (1 << 24))
    return frac + np.float32(1.0)


def edge_weight_np(u, v) -> np.ndarray:
    """The numpy mirror of `edge_weight` (uint32 arithmetic)."""
    u32, f32 = np.uint32, np.float32
    u, v = np.asarray(u), np.asarray(v)
    with np.errstate(over="ignore"):
        a = np.minimum(u, v).astype(u32)
        b = np.maximum(u, v).astype(u32)
        x = a * u32(_GOLD) + b
        x = (x ^ (x >> u32(16))) * u32(_MIX1)
        x = (x ^ (x >> u32(15))) * u32(_MIX2)
        x = x ^ (x >> u32(16))
    return f32(1.0) + (x >> u32(8)).astype(f32) * f32(1.0 / (1 << 24))


def candidate(u_val: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
              unit: int, weighted: bool) -> torch.Tensor:
    """⊗ along edge (u, v): the value offered to v, in ``u_val``'s
    dtype — the formula of the relax kernels' plain versions."""
    if weighted:
        return u_val + edge_weight(u, v)
    if unit:
        return u_val + unit
    return u_val


@dataclasses.dataclass(frozen=True)
class Semiring:
    """One (⊕, ⊗) pair.  ⊕ is min for every registered instance; ⊗ is
    data: ``unit`` (the hop cost) and ``weighted`` (add `edge_weight`).

    Fields as in the reference: ``name`` (the registry key and
    ``TraversalSpec.algorithm`` value), ``dtype`` ("int32" |
    "float32"), ``identity`` (⊕-identity == unreached), ``annihilator``
    (documented algebra, never materialized), ``unit``, ``weighted``
    and ``all_vertices_frontier`` (CC: seed every real vertex with its
    own id instead of the roots)."""

    name: str
    dtype: str
    identity: float
    annihilator: float = 0.0
    unit: int = 0
    weighted: bool = False
    all_vertices_frontier: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.float32 if self.dtype == "float32" else torch.int32

    def identity_value(self, device=None) -> torch.Tensor:
        return torch.tensor(self.identity, dtype=self.torch_dtype,
                            device=device)

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """⊕: min."""
        return torch.minimum(a, b)

    def mul(self, u_val, u, v) -> torch.Tensor:
        """⊗ along edge (u, v)."""
        return candidate(u_val, u, v, unit=self.unit,
                         weighted=self.weighted)

    def improved(self, old, new) -> torch.Tensor:
        """Strict improvement: the update gate and the frontier rule."""
        return new < old

    def init_vals(self, roots: torch.Tensor, n_vertices: int,
                  v_pad: int) -> torch.Tensor:
        """(B, V_pad) initial value rows for a (B,) root batch on the
        roots' device."""
        dev = roots.device
        n_batch = int(roots.shape[0])
        if self.all_vertices_frontier:       # CC: own id, padding = INF
            ids = torch.arange(v_pad, device=dev)
            row = torch.where(ids < n_vertices, ids,
                              int(self.identity)).to(self.torch_dtype)
            return row.expand(n_batch, -1).contiguous()
        vals = torch.full((n_batch, v_pad), self.identity,
                          dtype=self.torch_dtype, device=dev)
        vals[torch.arange(n_batch, device=dev), roots.long()] = 0
        return vals


SEMIRINGS: dict[str, Semiring] = {
    "bfs": Semiring("bfs", "int32", int(INT_INF), unit=1),
    "ksource_bfs": Semiring("ksource_bfs", "int32", int(INT_INF),
                            unit=1),
    "sssp": Semiring("sssp", "float32", float(FLOAT_INF),
                     weighted=True),
    "cc": Semiring("cc", "int32", int(INT_INF),
                   all_vertices_frontier=True),
}


def get(name: str) -> Semiring:
    """A registered semiring; KeyError lists what exists."""
    try:
        return SEMIRINGS[name]
    except KeyError:
        raise KeyError(
            f"unknown semiring {name!r}; registered: "
            f"{sorted(SEMIRINGS)}") from None
