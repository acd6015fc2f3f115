"""The materialized stream's apportionment (not a TPU kernel; the
reference writes it in jnp): CUDA kernel and its plain torch version.

``n_slots`` edge slots per root are mapped onto the adjacency lists of a
(B, L) sentinel-padded vertex queue: slot s of root b is valid iff s <
min(total_b, n_slots), where total_b is the queue's degree sum; its
owner u is the entry whose degree range holds s and v the matching
entry of u's adjacency.  A hub whose adjacency overruns the slots keeps
its list prefix; ``truncated`` counts the edges that did not fit.

`apportion_plain` is the port's plain version (``engine.apportion``,
which the reference writes in jnp).  The CUDA kernel
(``csrc/apportion.cu``) writes the stream straight from K2's stream arm
(`compact.EdgeQueue`: the queue, its inclusive degree prefix and each
root's total), with no (B, n_slots) temporary; it writes ``u`` and
``v`` only where ``valid`` holds (K7 reads them nowhere else).
"""
from __future__ import annotations

import torch

from repro_torch.core.bitmap import DROP_SLOTS
from repro_torch.kernels.compact import EdgeQueue

THREADS = 256
CTAS_PER_SM = 8        # grid cap: a grid-stride loop over warp units
UNIT_SLOTS = 2048      # slots per warp unit (csrc/apportion.cu)


def apportion_plain(colstarts, rows, frontier_list, n_vertices: int,
                    n_slots: int):
    """Map ``n_slots`` edge slots onto the frontier's adjacency lists.

    ``frontier_list`` is (B, L), sentinel-padded (id >= n_vertices is
    empty).  Returns (u, v, valid, truncated), the streams (B, n_slots)
    and ``truncated`` (B,) the edges that did not fit: a hub whose
    adjacency overruns the slots keeps its list prefix.  Owners come
    from a marker scatter at each adjacency's end offset plus a prefix
    sum, as in the reference.  Every (B, n_slots) temporary is int32
    (offsets stay below the edge count, < 2**31) and each is freed as
    soon as it is used: at SCALE 22 one is 4.3 GB for 8 roots."""
    n_batch, n_list = frontier_list.shape
    dev = rows.device
    i32 = dict(dtype=torch.int32, device=dev)
    is_real = frontier_list < n_vertices
    safe = torch.where(is_real, frontier_list, 0).to(torch.int64)
    deg = torch.where(is_real, colstarts[safe + 1] - colstarts[safe], 0)
    cum = torch.cumsum(deg, dim=1, dtype=torch.int32)
    total = cum[:, -1] if n_list else cum.new_zeros((n_batch,))
    truncated = (total - n_slots).clamp(min=0).to(torch.int32)
    # sentinel entries end at ``total``, past every valid slot: their
    # markers go to dropped slots, spread over `bitmap.DROP_SLOTS`
    drop = n_slots + 1 + torch.arange(n_list, device=dev) % DROP_SLOTS
    markers = torch.zeros((n_batch, n_slots + 1 + DROP_SLOTS), **i32)
    markers.scatter_add_(
        1, torch.where(is_real, cum.clamp(max=n_slots).to(torch.int64),
                       drop),
        torch.ones((n_batch, n_list), **i32))
    owner = torch.cumsum(markers[:, :n_slots], dim=1, dtype=torch.int32)
    del markers
    owner.clamp_(0, n_list - 1)
    # per-root rows of the (B, L) lists, flattened for int32 lookups
    base = (torch.arange(n_batch, **i32) * n_list)[:, None]
    idx = (owner - 1).clamp_(min=0).add_(base)
    prev = cum.reshape(-1).index_select(0, idx.reshape(-1)) \
        .view(n_batch, n_slots)
    prev.masked_fill_(owner == 0, 0)
    idx = owner.add_(base)
    del owner
    u = frontier_list.to(torch.int32).reshape(-1) \
        .index_select(0, idx.reshape(-1)).view(n_batch, n_slots)
    del idx
    slots = torch.arange(n_slots, **i32)
    valid = slots < total[:, None]
    e_idx = colstarts.index_select(
        0, torch.where(valid, u, 0).reshape(-1)).view(n_batch, n_slots)
    e_idx.add_(slots).sub_(prev).clamp_(0, rows.shape[0] - 1)
    del prev
    v = rows.index_select(0, e_idx.reshape(-1)).view(n_batch, n_slots)
    return u, v, valid, truncated


def apportion_cuda(colstarts, rows, q: EdgeQueue, n_slots: int):
    """Launch the CUDA apportionment on K2's stream arm ``q``.  Returns
    (u, v, valid, truncated) as `apportion_plain`; u and v are written
    only where valid holds."""
    from repro_torch.kernels import _build
    n_batch, list_size = q.queue.shape
    dev = q.queue.device
    for name, t, shape in (("queue", q.queue, (n_batch, list_size)),
                           ("cum", q.cum, (n_batch, list_size)),
                           ("count", q.count, (n_batch,)),
                           ("total", q.total, (n_batch,)),
                           ("colstarts", colstarts, tuple(colstarts.shape)),
                           ("rows", rows, tuple(rows.shape))):
        if t.dtype != torch.int32 or not t.is_contiguous() \
                or tuple(t.shape) != shape or t.device != dev:
            raise ValueError(f"apportion: {name} must be a contiguous int32 "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    u = torch.empty((n_batch, int(n_slots)), dtype=torch.int32, device=dev)
    v = torch.empty_like(u)
    valid = torch.empty((n_batch, int(n_slots)), dtype=torch.bool,
                        device=dev)
    units = n_batch * -(-int(n_slots) // UNIT_SLOTS)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    grid = max(1, min(-(-units // (THREADS // 32)), CTAS_PER_SM * sms))
    _build.check(_build.load().repro_apportion(
        q.queue.data_ptr(), q.cum.data_ptr(), q.count.data_ptr(),
        q.total.data_ptr(), colstarts.data_ptr(), rows.data_ptr(),
        u.data_ptr(), v.data_ptr(), valid.data_ptr(), n_batch, list_size,
        int(n_slots), grid, _build.stream_of(u)), "apportion")
    return u, v, valid, q.truncated
