"""Distributed 1-D BFS over a `torch.distributed` device mesh — the
paper's "multi-device solutions" (§1), a port of
``repro.core.bfs_distributed``.

Decomposition (Graph500 1-D): vertices are striped in contiguous ranges
of ``v_loc`` per shard; each shard owns the out-edges of its range (a
rebased CSR slice, `partition_csr`).  The frontier and visited bitmaps
and the parent array are replicated: at 32 vertices per word a
bitmap costs V/8 bytes per rank.

Per layer, on every rank of the search's process group:
  1. the shard's top-down sweep, gated on its slice of the replicated
     frontier, writes the (v_cap,) min-parent candidate array
     (`ops.rowsweep_candidates`: one kernel launch, `kernels/rowsweep.py`;
     on the CPU its plain version, `engine.rowsweep_stream` +
     `engine.candidate_scatter`);
  2. the merge's collectives resolve the candidates across shards —
     min-parent is deterministic, so the tree does not depend on the
     shard count and is reproducible run to run;
  3. every rank derives the next frontier, visited and P locally.

The layer loop is a host loop with one popcount read per layer
(`engine.row_popcounts`: the measure kernel's count arm on the card).
After every merge the frontier is replicated, so every rank reads the
same count and leaves the loop on the same layer: the ranks' sequences
of collectives cannot diverge.

The mesh is a `torch.distributed.device_mesh.DeviceMesh` over the whole
default process group.  A search runs over its ``axis_names`` (default
all of them); a rank's shard index is its row-major coordinate over
those axes, and a mesh with more axes runs one independent search per
replica group, as ``shard_map`` replicates it.  Each rank's device is
``torch.device(mesh.device_type, local_rank)``; on a card shared by
several ranks every rank takes it.
"""
from __future__ import annotations

from dataclasses import dataclass
import functools
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bitmap as bm
from repro_torch.core import engine
from repro_torch.core.csr import Csr, round_up
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

MERGES = ("allreduce", "owner", "packed")


# ---------------------------------------------------------------------------
# Host-side partitioner (Graph500 kernel-2 equivalent for the mesh)
# ---------------------------------------------------------------------------

def partition_sizes(n_vertices: int, n_edges_directed: int,
                    n_devices: int, slack: float = 1.5):
    """Static (v_loc, e_loc) partition shapes.

    v_loc: owned vertex range per shard (128-aligned).
    e_loc: per-shard edge capacity — balanced share times ``slack`` to
      absorb R-MAT degree skew (sizes spec-only dry runs;
      `partition_csr` measures it).
    """
    v_loc = round_up(math.ceil(n_vertices / n_devices), 128)
    e_loc = round_up(math.ceil(n_edges_directed / n_devices * slack), 128)
    return v_loc, e_loc


def partition_csr(csr: Csr, n_devices: int, slack: float = 1.5):
    """Split a CSR into per-shard contiguous vertex ranges (numpy, on the
    host).  Returns (rows_sh (D, e_loc), colstarts_sh (D, v_loc + 1)) as
    int32 CPU tensors; padding slots hold the sentinel ``n_vertices``
    and a shard's colstarts past its range repeat its edge count.

    The per-shard edge capacity is the measured maximum over ranges
    (128-aligned), not the ``slack`` estimate."""
    v = csr.n_vertices
    v_loc, _ = partition_sizes(v, csr.n_edges, n_devices, slack)
    cs = csr.colstarts.cpu().numpy()
    rows = csr.rows.cpu().numpy()
    bounds = [(min(d * v_loc, v), min(d * v_loc + v_loc, v))
              for d in range(n_devices)]
    e_loc = round_up(max(int(cs[hi] - cs[lo]) for lo, hi in bounds), 128)
    rows_sh = np.full((n_devices, e_loc), v, dtype=np.int32)
    colstarts_sh = np.zeros((n_devices, v_loc + 1), dtype=np.int32)
    for d, (lo, hi) in enumerate(bounds):
        local_cs = cs[lo:hi + 1] - cs[lo]
        n_local_edges = int(local_cs[-1])
        colstarts_sh[d, :len(local_cs)] = local_cs
        colstarts_sh[d, len(local_cs):] = local_cs[-1]
        rows_sh[d, :n_local_edges] = rows[cs[lo]:cs[hi]]
    return torch.from_numpy(rows_sh), torch.from_numpy(colstarts_sh)


# ---------------------------------------------------------------------------
# The mesh: process groups, shard index, device
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardAxis:
    """The process group one search runs over, and this rank's place.

    ``index`` is this rank's shard d; ``shard_of`` lists the shard of
    each group rank (collectives order their rows by group rank), and
    is None where the two orders agree."""
    group: dist.ProcessGroup
    index: int
    size: int
    shard_of: tuple[int, ...] | None


#: (id(mesh), axis_names) -> (mesh, ShardAxis); the mesh is kept so its
#: id cannot be reused while the entry lives
_AXES: dict[tuple, tuple] = {}


def mesh_axis_size(mesh, axis_names: tuple[str, ...]) -> int:
    """The number of shards over ``axis_names``."""
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axis_names if a not in names]
    if missing:
        raise ValueError(f"axis names {missing} are not in the mesh's "
                         f"dimension names {names}")
    return int(np.prod([mesh.size(names.index(a)) for a in axis_names]))


def shard_axis(mesh, axis_names: tuple[str, ...]) -> ShardAxis:
    """The (cached) `ShardAxis` of ``axis_names`` on ``mesh``.  Built
    once per mesh and axes: every rank of the default group must make
    the first call for a (mesh, axes) pair together, since creating the
    replica groups is collective."""
    axis_names = tuple(axis_names)
    key = (id(mesh), axis_names)
    hit = _AXES.get(key)
    if hit is not None and hit[0] is mesh:
        return hit[1]
    n_shards = mesh_axis_size(mesh, axis_names)
    names = tuple(mesh.mesh_dim_names)
    dims = [names.index(a) for a in axis_names]
    other = [i for i in range(mesh.ndim) if i not in dims]
    # one row per replica group, its ranks in shard (row-major) order
    table = mesh.mesh.permute(*other, *dims).reshape(-1, n_shards).tolist()
    group, _ = dist.new_subgroups_by_enumeration(table)
    rank = dist.get_rank()
    row = next(r for r in table if rank in r)
    shard_of = tuple(row.index(r) for r in dist.get_process_group_ranks(group))
    axis = ShardAxis(group, row.index(rank), n_shards,
                     None if shard_of == tuple(range(n_shards)) else shard_of)
    _AXES[key] = (mesh, axis)
    return axis


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: ``(device_type, local_rank)``,
    the local rank taken modulo the visible cards.  A CUDA mesh without
    CUDA raises (`device.resolve_device`)."""
    dev = resolve_device(mesh.device_type)
    if dev.type != "cuda":
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def _gather(axis: ShardAxis, x: torch.Tensor) -> torch.Tensor:
    """All ranks' ``x`` (n,) as a (D, n) tensor, rows in shard order."""
    out = torch.empty((axis.size * x.shape[0],), dtype=x.dtype,
                      device=x.device)
    dist.all_gather_into_tensor(out, x, group=axis.group)
    out = out.view(axis.size, x.shape[0])
    if axis.shard_of is not None:
        rows = torch.empty_like(out)
        rows[list(axis.shard_of)] = out
        out = rows
    return out


def _root_bit(root: int) -> int:
    """The int32 word holding only ``root``'s bit."""
    bit = 1 << (root & bm.WORD_MASK)
    return bit - ((bit >> 31) << 32)


# ---------------------------------------------------------------------------
# The per-shard program
# ---------------------------------------------------------------------------

def _local_step(rows_l, colstarts_l, frontier, visited, v_loc: int,
                n_vertices: int, v_cap: int, base: int):
    """One shard's expansion: the (v_cap,) min-parent candidate array of
    its frontier slice's adjacency (LOCAL owners rebased by ``base``,
    GLOBAL neighbours) against the replicated visited words."""
    assert colstarts_l.shape[0] == v_loc + 1 \
        and frontier.shape[0] * bm.BITS_PER_WORD == v_cap
    return ops.rowsweep_candidates(rows_l, colstarts_l, frontier, visited,
                                   base=base, n_vertices=n_vertices)


def make_bfs_program(v_loc: int, n_vertices: int, n_devices: int,
                     axis_names: tuple[str, ...], max_layers: int = 64,
                     merge: str = "allreduce",
                     single_layer: bool = False):
    """Build the per-shard BFS program ``program(mesh, rows_l,
    colstarts_l, root) -> (parent (v_cap,), layers)``.

    merge = "allreduce" — one MIN all-reduce of the (v_cap,) candidates
      per layer (P replicated).
    merge = "owner" — owner computes (the Graph500 1-D classic): one
      all-to-all of the candidates, so each shard min-reduces only the
      slice of P it owns, then an all-gather of the 32x smaller frontier
      words.  P lives in slices during the search and is gathered once
      after it.
    merge = "packed" — the only per-layer collective is an all-gather +
      OR of the discovered bitmap words; parent candidates accumulate
      locally as a running min (a vertex receives candidates only in the
      layer before its bit enters the merged visited set), and one MIN
      all-reduce after the loop gives the per-layer-min tree.

    The three give the same parents.  ``single_layer`` runs exactly one
    layer (the reference's roofline probe).
    """
    if merge not in MERGES:
        raise ValueError(f"unknown merge {merge!r}; expected "
                         f"'allreduce', 'owner' or 'packed'")
    v_cap = v_loc * n_devices
    assert v_cap >= n_vertices
    w_cap = v_cap // bm.BITS_PER_WORD
    inf = n_vertices
    i32 = torch.int32

    def program(mesh, rows_l, colstarts_l, root):
        axis = shard_axis(mesh, axis_names)
        assert axis.size == n_devices, (axis.size, n_devices)
        dev = rows_l.device
        base = axis.index * v_loc
        root = int(root)
        frontier = torch.zeros((w_cap,), dtype=i32, device=dev)
        frontier[root >> bm.WORD_SHIFT] = _root_bit(root)
        visited = frontier.clone()

        def sweep(frontier, visited):
            return _local_step(rows_l, colstarts_l, frontier, visited,
                               v_loc, n_vertices, v_cap, base)

        if merge == "allreduce":
            parent = torch.full((v_cap,), inf, dtype=i32, device=dev)
            parent[root] = root

            def body(frontier, visited, parent):
                merged = sweep(frontier, visited)
                dist.all_reduce(merged, op=dist.ReduceOp.MIN,
                                group=axis.group)
                newly = merged < inf
                frontier = bm.pack_bool(newly)
                return (frontier, visited | frontier,
                        torch.where(newly, merged, parent))

            finish = None
        elif merge == "packed":
            parent = torch.full((v_cap,), inf, dtype=i32, device=dev)
            parent[root] = root

            def body(frontier, visited, parent_acc):
                cand = sweep(frontier, visited)
                parent_acc = torch.minimum(parent_acc, cand)
                newly_l = bm.pack_bool(cand < inf)
                merged = functools.reduce(
                    torch.bitwise_or, _gather(axis, newly_l).unbind(0))
                return merged, visited | merged, parent_acc

            def finish(parent_acc):
                dist.all_reduce(parent_acc, op=dist.ReduceOp.MIN,
                                group=axis.group)
                return parent_acc
        else:
            # owner computes: P holds only this shard's vertex range
            parent = torch.full((v_loc,), inf, dtype=i32, device=dev)
            if base <= root < base + v_loc:
                parent[root - base] = root
            to_group = (None if axis.shard_of is None
                        else torch.tensor(axis.shard_of, device=dev))

            def body(frontier, visited, parent_l):
                cand = sweep(frontier, visited).view(n_devices, v_loc)
                if to_group is not None:    # row g goes to group rank g
                    cand = cand[to_group]
                mine = torch.empty_like(cand)
                dist.all_to_all_single(mine, cand, group=axis.group)
                merged_l = mine.amin(dim=0)
                newly_l = (merged_l < inf) & (parent_l == inf)
                parent_l = torch.where(newly_l, merged_l, parent_l)
                frontier = _gather(axis, bm.pack_bool(newly_l)).reshape(-1)
                return frontier, visited | frontier, parent_l

            def finish(parent_l):
                return _gather(axis, parent_l).reshape(-1)

        state = (frontier, visited, parent)
        if single_layer:
            state, layers = body(*state), 1
        else:
            layers = 0
            while layers < max_layers \
                    and int(engine.row_popcounts(state[0])) > 0:
                state = body(*state)
                layers += 1
        parent = state[2] if finish is None else finish(state[2])
        return parent, layers

    return program


# ---------------------------------------------------------------------------
# Mesh-facing wrapper
# ---------------------------------------------------------------------------

def local_shard(rows_sh, colstarts_sh, mesh, axis_names):
    """This rank's rows of the partition, on its device."""
    axis = shard_axis(mesh, axis_names)
    dev = mesh_device(mesh)
    return (rows_sh[axis.index].to(dev).contiguous(),
            colstarts_sh[axis.index].to(dev).contiguous())


def _run_local(mesh, axis_names, n_vertices: int, max_layers: int,
               merge: str, rows_l, colstarts_l, root):
    """The program on this rank's shard; (parent (v_cap,), layers)."""
    n_devices = mesh_axis_size(mesh, axis_names)
    program = make_bfs_program(colstarts_l.shape[0] - 1, n_vertices,
                               n_devices, axis_names, max_layers,
                               merge=merge)
    return program(mesh, rows_l, colstarts_l, root)


def run_bfs_distributed(csr: Csr, root: int, mesh,
                        axis_names: tuple[str, ...] | None = None,
                        max_layers: int | None = None,
                        slack: float = 1.5,
                        merge: str | None = None, spec=None):
    """Partition + run the distributed BFS on a mesh; every rank of the
    mesh calls it.  Returns (P, layers) on every rank: P (V,) int32 on
    the rank's device, INF == V for unreached (``torch.where(p >= V, -1,
    p)`` for the Graph500 convention), layers a Python int.

    Pass ``spec=`` and its ``merge``/``max_layers`` fields govern the
    exchange and the layer budget (``merge="auto"`` resolves to
    "packed"); the loose ``max_layers=`` / ``merge=`` knobs default to
    64 and "allreduce" and may not be mixed with ``spec=``.
    """
    if spec is not None:
        if max_layers is not None or merge is not None:
            raise ValueError(
                "run_bfs_distributed: pass either spec= or the loose "
                "max_layers=/merge= knobs, not both")
        from repro_torch.api.plan import as_format
        from repro_torch.api.spec import warn_mesh_ignored_fields
        warn_mesh_ignored_fields(spec, "run_bfs_distributed")
        # the program never reads policy: pin a concrete one so
        # policy="auto" does not pay the autotune degree measurement
        probe = (spec.replace(policy="topdown")
                 if spec.policy == "auto" else spec)
        resolved = probe.resolve(as_format(csr))
        max_layers, merge = resolved.max_layers, resolved.merge
    else:
        max_layers = 64 if max_layers is None else max_layers
        merge = "allreduce" if merge is None else merge
    axis_names = tuple(axis_names or mesh.mesh_dim_names)
    n_devices = mesh_axis_size(mesh, axis_names)
    rows_l, colstarts_l = local_shard(
        *partition_csr(csr, n_devices, slack), mesh, axis_names)
    parent, layers = _run_local(mesh, axis_names, csr.n_vertices,
                                max_layers, merge, rows_l, colstarts_l,
                                root)
    return parent[:csr.n_vertices], layers
