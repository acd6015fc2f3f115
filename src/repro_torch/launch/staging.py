"""Host staging of DTensor's collectives on a gloo group over CUDA tensors.

Gloo takes CUDA tensors in its synchronous collectives
(``dist.all_reduce`` and friends stage them through host memory
themselves), but DTensor issues the functional collectives
(``torch.ops._c10d_functional.*``), whose asynchronous wait on a gloo
group over CUDA tensors crashed the process (torch 2.11, one H100, four
ranks).  `install` overrides the CUDA kernels of the three that DTensor
issues on the ported path (``all_reduce`` and its in-place form,
``all_gather_into_tensor``, ``reduce_scatter_tensor``).  On a gloo group
the override copies the input to host memory, runs the gloo collective
there and copies the result back; on any other backend it calls the
op's own kernel.  The other functional collectives raise `StagingError`
on a gloo group and keep their own kernel elsewhere.  Only the
collective moves through the host; every product stays on the card.
`uninstall` takes the override away.

`make_mesh` installs it for a CUDA mesh whose process group is gloo.
`STAGED` counts, by op, the staged calls and their bytes, and over all
ops the seconds spent inside them (``"staged s"``: the host copies and
gloo, the wait for the peers included) and the seconds each first waited
for the work queued on the card (``"device wait s"``).
"""
from __future__ import annotations

import collections
import time

import torch

from repro_torch.errors import ReproError

#: {op: calls}, {op + " bytes": bytes moved to the host}, "staged s",
#: "device wait s"
STAGED: collections.Counter = collections.Counter()

#: {dispatch key: the `torch.library.Library` holding its overrides}
_LIBS: dict = {}

#: functional collectives no ported path issues: refused on gloo
_REFUSED = ("all_reduce_coalesced", "all_reduce_coalesced_",
            "all_gather_into_tensor_out", "all_gather_into_tensor_coalesced",
            "reduce_scatter_tensor_coalesced", "all_to_all_single",
            "broadcast", "broadcast_")


class StagingError(ReproError, RuntimeError):
    """A functional collective that is not staged, on a gloo group."""


def reset() -> None:
    STAGED.clear()


def _group(group_name):
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(group_name)


def _gloo(group_name) -> bool:
    import torch.distributed as dist
    return dist.get_backend(_group(group_name)) == "gloo"


def _own_kernel(name: str, *args, **kwargs):
    """The op's own kernel (registered for CompositeExplicitAutograd),
    which the override shadows."""
    op = getattr(torch.ops._c10d_functional, name).default
    return op._op_dk(torch._C.DispatchKey.CompositeExplicitAutograd, *args,
                     **kwargs)


def _op(name: str):
    import torch.distributed as dist
    return {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
            "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
            "product": dist.ReduceOp.PRODUCT}[name.lower()]


def _finish(reduce_op: str, out: torch.Tensor, group) -> torch.Tensor:
    if reduce_op.lower() == "avg":
        out /= group.size()
    return out


def _all_reduce(group, host, reduce_op):
    import torch.distributed as dist
    dist.all_reduce(host, op=_op(reduce_op), group=group)
    return _finish(reduce_op, host, group)


def _all_gather_into_tensor(group, host, group_size):
    import torch.distributed as dist
    out = host.new_empty((group_size * host.shape[0], *host.shape[1:]))
    dist.all_gather_into_tensor(out, host, group=group)
    return out


def _reduce_scatter_tensor(group, host, reduce_op, group_size):
    import torch.distributed as dist
    out = host.new_empty((host.shape[0] // group_size, *host.shape[1:]))
    # torch >= 2.13 names it reduce_scatter_single
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    scatter(out, host, op=_op(reduce_op), group=group)
    return _finish(reduce_op, out, group)


def _staged(name: str, on_host, counted: str, in_place: bool = False):
    """The override of ``name``: ``on_host(group, host copy, *args)`` on
    a gloo group, counted under ``counted``; the own kernel elsewhere.
    The group's name is each op's last argument."""
    def kernel(input, *rest):
        if not _gloo(rest[-1]):
            return _own_kernel(name, input, *rest)
        t0 = time.perf_counter()
        if input.is_cuda:
            torch.cuda.synchronize(input.device)
        t1 = time.perf_counter()
        # a copy even of a host tensor: the collectives write into it,
        # and a functional op leaves its input as it was
        host = input.detach().to("cpu", copy=True).contiguous()
        out = on_host(_group(rest[-1]), host, *rest[:-1]).to(input.device)
        if in_place:
            out = input.copy_(out)
        STAGED[counted] += 1
        STAGED[counted + " bytes"] += input.numel() * input.element_size()
        STAGED["device wait s"] += t1 - t0
        STAGED["staged s"] += time.perf_counter() - t1
        return out
    return kernel


def _refused(name: str):
    op = getattr(torch.ops._c10d_functional, name).default
    at = [a.name for a in op._schema.arguments].index("group_name")

    def kernel(*args, **kwargs):
        if _gloo(args[at]):
            raise StagingError(
                f"_c10d_functional.{name} on a gloo group is not staged "
                f"through the host (launch.staging stages all_reduce, "
                f"all_gather_into_tensor and reduce_scatter_tensor)")
        return _own_kernel(name, *args, **kwargs)
    return kernel


def install(dispatch_key: str = "CUDA") -> None:
    """Stage the functional collectives on ``dispatch_key`` tensors over
    gloo groups through host memory (once per key and process)."""
    if dispatch_key in _LIBS:
        return
    import warnings
    import torch.distributed._functional_collectives  # noqa: F401 (ops)
    kernels = {
        "all_reduce": _staged("all_reduce", _all_reduce, "all_reduce"),
        "all_reduce_": _staged("all_reduce_", _all_reduce, "all_reduce",
                               in_place=True),
        "all_gather_into_tensor": _staged(
            "all_gather_into_tensor", _all_gather_into_tensor,
            "all_gather_into_tensor"),
        "reduce_scatter_tensor": _staged(
            "reduce_scatter_tensor", _reduce_scatter_tensor,
            "reduce_scatter_tensor"),
        **{name: _refused(name) for name in _REFUSED
           if hasattr(torch.ops._c10d_functional, name)}}
    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")        # "overriding a kernel"
        for name, kernel in kernels.items():
            lib.impl(name, kernel, dispatch_key)
    _LIBS[dispatch_key] = lib


def uninstall(dispatch_key: str = "CUDA") -> None:
    """Give the functional collectives on ``dispatch_key`` back their own
    kernels."""
    lib = _LIBS.pop(dispatch_key, None)
    if lib is not None:
        lib._destroy()
