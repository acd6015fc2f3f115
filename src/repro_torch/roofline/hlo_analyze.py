"""The op-level cost analyzer: flops, bytes, collectives and live bytes
of one call, per rank (the counterpart of ``repro.roofline.hlo_analyze``).

The reference compiles a step and re-derives the roofline inputs from
the post-SPMD HLO text, multiplying each while-loop body by its trip
count.  Torch builds no program ahead of time, so this analyzer reads
what a call of ``fn`` dispatches instead, through a
``TorchDispatchMode``:

  * flops: ``2 * M * N * K`` per matmul-class op (``mm``, ``addmm``,
    ``bmm``, ``baddbmm``; ``matmul``, ``linear`` and ``einsum`` reach
    the mode as these), the reference's dot-only count;
  * bytes: operands plus results of every op (XLA's "bytes accessed"
    rule); views, aliases (``detach``), allocations (``empty*``) and
    ops without tensors are skipped, as the reference's
    ``_SKIP_BYTES_OPS`` are, and are not counted as ops;
  * collectives: each functional collective (``_c10d_functional``:
    all-reduce, all-gather, reduce-scatter, all-to-all; DTensor's, and
    counted once where `launch.staging` stages them through the host)
    and each ``c10d`` collective that ``torch.distributed`` issues
    directly (``core.bfs_distributed``'s merges): the payload is the
    op's result (for an in-place ``c10d`` op, its output argument), the
    group size the process group's, and the wire bytes the reference's
    ring factors (`roofline.analysis._wire_factor`);
  * live bytes: every storage an op allocates is counted from its
    first appearance until it is freed (a finalizer on the storage,
    whose Python object torch keeps as long as the storage lives, so a
    tensor saved for the backward pass stays counted).  Their maximum,
    ``peak_bytes``, is the port's ``memory_analysis().temp_size``;
  * ``distinct_bytes``: the bytes counted with each storage counted
    once, by the largest tensor of it that a counted op read or wrote
    (the tighter model of what a call must move).

DTensors.  The mode declines ops on DTensors (returns
``NotImplemented``), so DTensor's own dispatch runs them and the mode
sees the ops it issues on each rank's local tensors, collectives
included: the counts are per rank, as the reference's post-SPMD module
is, not the global op that ``FlopCounterMode`` reports for a DTensor.
The fake tensors DTensor's sharding propagation runs on are not
counted.

Kernels.  The hand-written CUDA kernels are launched through ``ctypes``
(`kernels._build`), which no dispatch mode sees.  While an analyzer is
active, each public wrapper of `kernels.ops` reports itself as one op
(`Analyzer.kernel`): its bytes are its tensor arguments plus its
results, its flops 0, as a Pallas custom call is in the reference's
HLO, and the aten ops of its plain version on the CPU are not counted
again.  So a call costs the same on the CPU and on the card.

Trip counts.  Eager execution dispatches every iteration of every loop
(the layer loop, attention and cross-entropy chunks, micro-batches, the
remat recompute in the backward pass), so the counts are trip-count
exact by construction; ``unresolved_whiles`` stays 0.

Works on real tensors on either device and on ``meta`` tensors.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.roofline.analysis import _wire_factor

_aten = torch.ops.aten
#: (M, K) @ (K, N) ops, their last two arguments the operands
_MM = {_aten.mm, _aten.addmm}
#: (B, M, K) @ (B, K, N) ops
_BMM = {_aten.bmm, _aten.baddbmm}
#: op names whose bytes are not counted, besides the views and aliases
#: (``detach`` among them): allocations, and the functional collectives'
#: wait and autograd wrapper, which return their input
_SKIP_BYTES_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
                   "new_empty_strided", "_wrap_tensor_autograd",
                   "wait_tensor"}

#: collectives by op name: ``_c10d_functional`` ops (their result the
#: payload, their last string argument the group's name) and ``c10d`` ops
#: (their first argument the output and payload, a process group among
#: their arguments)
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0
    coll_payload: float = 0.0
    coll_ops: dict = field(default_factory=dict)
    unresolved_whiles: int = 0
    #: ops counted: every op dispatched outside a kernel whose bytes
    #: count (not the views, aliases and skipped ops), plus one per kernel
    #: wrapper call
    ops: int = 0
    #: kernel wrapper calls by wrapper name
    launches: dict = field(default_factory=dict)
    #: the largest sum of storages allocated during the call and alive
    peak_bytes: float = 0.0
    #: ``bytes`` with each storage counted once
    distinct_bytes: float = 0.0


def tensors_in(tree):
    """The tensors of an argument tree: tuples, lists, dicts, named
    tuples and modules (their parameters and buffers) are walked."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from tensors_in(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from tensors_in(x)


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_VIEWS: dict = {}


def _is_view(func) -> bool:
    """Does ``func`` return an alias of an input (a view, not an
    in-place write)?"""
    view = _VIEWS.get(func)
    if view is None:
        view = _VIEWS[func] = any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return view


def _group_size(group) -> int:
    import torch.distributed as dist
    if isinstance(group, str):
        from torch.distributed.distributed_c10d import _resolve_process_group
        return _resolve_process_group(group).size()
    if isinstance(group, torch.ScriptObject):
        group = dist.ProcessGroup.unbox(group)
    return group.size()


def _matmul_flops(func, args) -> float:
    packet = func.overloadpacket
    if packet in _MM:
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in _BMM:
        a, b = args[-2], args[-1]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return 0.0


class Analyzer(TorchDispatchMode):
    """Count what the code run inside ``with Analyzer(...) as a:``
    dispatches into ``a.cost`` (a `Cost`).  ``default_group`` is the
    group size of a collective that names no group."""

    def __init__(self, default_group: int = 1):
        super().__init__()
        self.default_group = default_group
        self.cost = Cost()
        self._suspended = 0
        self._live = 0
        #: id(storage object) -> (nbytes, allocated during the call)
        self._storages: dict[int, tuple[int, bool]] = {}
        #: id(storage object) -> the largest tensor of it counted
        self._distinct: dict[int, int] = {}
        self._prev = None

    # -- the kernels' report ---------------------------------------------
    def __enter__(self):
        from repro_torch.kernels import ops
        self._prev = ops.ANALYZER[0]
        ops.ANALYZER[0] = self
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.ANALYZER[0] = self._prev
        return super().__exit__(*exc)

    def kernel(self, name: str, fn, args, kwargs):
        """Run the kernel wrapper ``fn`` and count it as one op named
        ``name`` (its inner ops uncounted; a wrapper called by another
        is part of the outer one)."""
        if self._suspended:
            return fn(*args, **kwargs)
        self._suspended += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._suspended -= 1
        self.cost.ops += 1
        self.cost.launches[name] = self.cost.launches.get(name, 0) + 1
        for t in (*tensors_in((args, kwargs)), *tensors_in(out)):
            self._moved(t)
        return out

    # -- storages ----------------------------------------------------------
    def _storage(self, t: torch.Tensor, allocated: bool) -> int:
        """The key of ``t``'s storage, noted the first time it is seen:
        if the op that made it allocated it, its bytes join the live
        bytes until it is freed."""
        storage = t.untyped_storage()
        key = id(storage)
        if key not in self._storages:
            n = storage.nbytes()
            self._storages[key] = (n, allocated)
            if allocated:
                self._live += n
                self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
            weakref.finalize(storage, self._freed, key)
        return key

    def _moved(self, t: torch.Tensor) -> None:
        """A counted op reads or writes ``t``: its bytes, and its
        storage's first time (by the largest tensor of it counted) in the
        distinct bytes."""
        n = nbytes(t)
        self.cost.bytes += n
        key = self._storage(t, allocated=False)
        seen = self._distinct.get(key, 0)
        if n > seen:
            self.cost.distinct_bytes += n - seen
            self._distinct[key] = n

    def _freed(self, key: int) -> None:
        n, allocated = self._storages.pop(key, (0, False))
        self._distinct.pop(key, None)
        if allocated:
            self._live -= n

    # -- the ops ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor issues the local ops
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out                     # sharding propagation
        view = _is_view(func)
        ins = list(tensors_in((args, kwargs)))
        outs = list(tensors_in(out))
        for t in ins:
            self._storage(t, allocated=False)
        for t in outs:
            self._storage(t, allocated=not view)
        name = func.overloadpacket.__name__
        if self._suspended or view or name in _SKIP_BYTES_OPS:
            return out
        c = self.cost
        c.ops += 1
        if self._collective(func, name, args, out, c) is None:
            c.flops += _matmul_flops(func, args)
        for t in (*ins, *outs):
            self._moved(t)
        return out

    def _collective(self, func, name: str, args, out, c: Cost):
        """Count ``func`` if it is a collective; returns its kind or
        None."""
        ns = func.namespace
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            kind = _FUNCTIONAL[name]
            group = next((a for a in reversed(args) if isinstance(a, str)),
                         None)
            payload = sum(map(nbytes, tensors_in(out)))
        elif ns == "c10d" and name in _C10D:
            kind = _C10D[name]
            group = next((a for a in args
                          if isinstance(a, torch.ScriptObject)), None)
            payload = sum(map(nbytes, tensors_in(args[0])))
        else:
            return None
        g = self.default_group if group is None else _group_size(group)
        c.coll_payload += payload
        c.wire_bytes += payload * _wire_factor(kind, g)
        c.coll_ops[kind] = c.coll_ops.get(kind, 0) + 1
        return kind


def analyze(fn, *args, default_group: int = 1, **kwargs) -> Cost:
    """The `Cost` of one call ``fn(*args, **kwargs)`` (run once)."""
    with Analyzer(default_group) as a:
        fn(*args, **kwargs)
    return a.cost
