"""Sharding annotations decoupled from model code.

Model code calls ``shard(x, "data", None, "model")`` at the natural cut
points.  Outside `logical_axis_rules` (CPU unit tests, one device) or on
a plain tensor these are no-ops; on a DTensor under the rules they
redistribute it to the placements the resolved spec gives on the
DTensor's own mesh.

Logical axes:
  "data"   — batch (mapped to the physical ('pod', 'data') mesh dims)
  "model"  — tensor-parallel (heads / ff hidden / vocab / experts)

A `Spec` stands in for jax's ``PartitionSpec``: one entry per tensor
dim, each a mesh dim name, a tuple of names, or None.  A cut the DTensor
cannot take (a mesh dim name its mesh lacks, a dim the mesh dims' sizes
do not divide) leaves ``x`` as it is, as the reference's
``with_sharding_constraint`` raises and is dropped there.
"""
from __future__ import annotations

import contextlib
import math


class _State:
    rules: dict | None = None


#: process-wide, not thread-local as in the reference: autograd runs a
#: CUDA backward pass, and the remat recompute inside it, on a thread of
#: its own, which must see the same cut points as the forward pass
_state = _State()


class Spec(tuple):
    """A partition spec: one entry per dim (a mesh dim name, a tuple of
    names, or None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec({', '.join(map(repr, self))})"


def _rules() -> dict | None:
    return _state.rules


@contextlib.contextmanager
def logical_axis_rules(rules: dict[str, tuple[str, ...] | str | None]):
    """Map logical axis names to physical mesh dim names for this scope.

    Example: {"data": ("pod", "data"), "model": "model"}.
    """
    prev = _rules()
    _state.rules = rules
    try:
        yield
    finally:
        _state.rules = prev


def resolve(*logical: str | None) -> Spec:
    """Logical names -> `Spec` under the active rules."""
    rules = _rules() or {}
    return Spec(*[rules.get(a) if a is not None else None for a in logical])


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(mesh, spec, shape=None, *,
                   lenient: bool = False) -> tuple | None:
    """DTensor placements on ``mesh`` (one per mesh dim: ``Shard(d)`` for
    the tensor dim ``d`` whose spec entry names it, else ``Replicate()``)
    under ``spec`` (mesh dim names), or None when the spec cannot apply:
    it names a dim the mesh lacks, or, given the tensor's ``shape``, a
    cut dim is not a multiple of its mesh dims' product.  ``lenient``
    replicates such an entry instead, and keeps the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names or ())
    by_name = {}
    for d, entry in enumerate(spec):
        cut = _names(entry)
        if any(n not in names for n in cut) or (
                cut and shape is not None and shape[d] % math.prod(
                    mesh.size(names.index(n)) for n in cut)):
            if lenient:
                continue
            return None
        for n in cut:
            by_name[n] = d
    return tuple(Shard(by_name[n]) if n in by_name else Replicate()
                 for n in names)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x, *logical: str | None):
    """Constrain ``x`` (no-op without rules or on a plain tensor).

    As the reference's constraint, it holds for the gradient too: the
    backward pass brings ``x``'s gradient to the same placements.  A spec
    of another rank than ``x`` leaves it as it is (the reference's
    constraint raises there, and is dropped)."""
    if _rules() is None or not is_dtensor(x) or len(logical) != x.ndim:
        return x
    placements = placements_for(x.device_mesh, resolve(*logical), x.shape)
    if placements is None:
        return x
    return x.redistribute(x.device_mesh, placements)


def pin(x):
    """Bring ``x``'s gradient to ``x``'s own placements in the backward
    pass (a no-op forward; on a plain tensor, nothing).  For a value whose
    backward view op cannot take the placement its gradient arrives in,
    such as GQA's repeated KV heads, whose split back into (KV heads,
    repeats) needs the heads unsharded when the KV heads do not divide
    the model axis."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, x.placements)


def settle(x):
    """``x`` with every partial placement reduced (to replicated); no-op
    on a plain tensor.  A gather from a vocab-sharded table leaves a
    masked partial sum that a later view op cannot carry, so it is
    reduced next to the gather."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if pl == tuple(x.placements) else \
        x.redistribute(x.device_mesh, pl)


def map_local(fn, args, specs, **kwargs):
    """``fn(*args, **kwargs)`` on each rank's own shards, when an arg is
    a DTensor; else plain ``fn(*args, **kwargs)``.

    Each arg goes to the placements of its logical spec in ``specs``
    under the active rules (a cut that does not divide replicates; a
    plain tensor arg, the same on every rank, is cut locally), ``fn``
    runs on the local tensors, and its output is a DTensor with the
    first arg's placements.  For work that is independent across the
    cut dims, such as attention across batch and heads: its inner ops
    then run on plain tensors."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args, **kwargs)
    from torch.distributed.tensor import DTensor, distribute_tensor
    local, first = [], None
    for a, spec in zip(args, specs, strict=True):
        pl = placements_for(mesh, resolve(*spec), a.shape, lenient=True)
        first = first or pl
        if is_dtensor(a):
            local.append(a.redistribute(mesh, pl).to_local())
        else:
            local.append(distribute_tensor(a, mesh, pl, src_data_rank=None)
                         .to_local())
    return DTensor.from_local(fn(*local, **kwargs), mesh, first,
                              run_check=False)


DEFAULT_RULES = {"data": ("pod", "data"), "model": "model"}
SINGLE_POD_RULES = {"data": "data", "model": "model"}
