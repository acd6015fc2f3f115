"""Multi-pod dry run: one analysed call of every (arch x shape x mesh)
cell on a fake process group (a port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 host devices (its
``XLA_FLAGS``) and reads memory, FLOPs, bytes and collectives off the
compiled program.  Here the production mesh is a fake process group
(``torch.distributed``'s ``"fake"`` backend over a ``FakeStore``) of
256 ranks (``single``, (data 16 x model 16)) or 512 (``multi``, (pod 2
x data 16 x model 16)), built in this one process by
`launch.mesh.make_production_mesh`; this process is rank 0, and every
collective returns at once without moving data.  Only this entry point
builds it.

Per LM cell, the parameters (on the ``meta`` device: shapes, no
memory) are placed under `param_specs` (m and v under `zero1_specs`,
the 8-bit arm's m under `optimizer.qs_specs`), and ONE call of the
port's ``make_train_step``, ``make_prefill_step`` or
``make_serve_step`` runs under `roofline.hlo_analyze.Analyzer`: the
counterpart of ``lower`` + ``compile``.  What the call dispatches on
rank 0's local shards gives the per-rank flops, bytes, collectives and
live bytes.  The reference's cell policy is kept: bf16 master weights
when ``param_count * 4 > chips * 4e9``, the 8-bit optimizer arm when
``param_count * 16 > chips * 12e9``, and `registry.cell_status` skips.

The result JSON keeps the reference's keys, with these differences:
``lower_s`` is the set-up (placing the cell's inputs on the mesh) and
``compile_s`` the wall of the analysed call; ``memory.argument_bytes``
and ``output_bytes`` are rank 0's exact shard sizes and
``temp_bytes`` / ``peak_bytes`` the analyzer's live bytes (without /
with the arguments); ``xla_cost_analysis`` (XLA's loop-blind counts)
and ``hlo_bytes`` (the HLO text's length) have no counterpart and give
way to ``dispatch``: the ops counted, the distinct bytes and the kernel
wrappers called.

The BFS cell runs `core.bfs_distributed.make_bfs_program` on rank 0's
shard, held in real tensors on ``device`` (the card by default), at the
graph's `partition_sizes`: the rowsweep kernel runs there and the
merge's collectives go to the fake group.  The whole program runs to
its end (bounded by ``max_layers``), the counterpart of the reference's
compile-success proof, and a ``single_layer`` run under the analyzer
gives the per-layer terms.  The shard's edges are drawn (each of its
vertices gets the graph's mean directed degree, to uniform random
neighbours, from seed 0): a fake group moves no data, so no rank's
shard of the real graph is needed, and a shard's shapes are what set
its kernels' bytes.  From Python, ``lower_bfs_cell(...,
device="cpu")`` runs it on the CPU.

Usage:
    python -m repro_torch.launch.dryrun            # all cells, both meshes
    python -m repro_torch.launch.dryrun --arch qwen3 --shape train_4k \
        --mesh multi
    python -m repro_torch.launch.dryrun --bfs [--bfs-graph rmat-24]
    python -m repro_torch.launch.dryrun --list
Artifacts: results/dryrun_torch/<arch>__<shape>__<mesh>.json (cached by
key; ``DRYRUN_RESULTS`` names another directory).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs import registry
from repro_torch.configs.bfs_graph500 import GRAPHS
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.launch import inputs
from repro_torch.launch.mesh import (_distribute, data_axes,
                                     distribute_batch, make_production_mesh,
                                     named_shardings, param_specs,
                                     place_on_mesh, placements, rules_for)
from repro_torch.models.config import param_count
from repro_torch.models.sharding import Spec, logical_axis_rules
from repro_torch.roofline.analysis import (Roofline, embedding_params,
                                           model_flops_for)
from repro_torch.roofline.hlo_analyze import Analyzer, nbytes, tensors_in
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (TrainConfig, make_prefill_step,
                                          make_serve_step, make_train_step)

RESULTS = Path(os.environ.get("DRYRUN_RESULTS", "results/dryrun_torch"))

#: ranks of each production mesh
MESH_CHIPS = {"single": 256, "multi": 512}


# ---------------------------------------------------------------------------
# The fake process group
# ---------------------------------------------------------------------------

def fake_group(world: int) -> None:
    """Make this process rank 0 of a fake process group of ``world``
    ranks (an existing fake group of another size is destroyed first).
    Raises if a real process group is initialised."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run builds a fake process group; "
                               "this process already has a "
                               f"{dist.get_backend()!r} one")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _mesh(mesh_name: str, device_type: str = "cpu"):
    fake_group(MESH_CHIPS[mesh_name])
    return make_production_mesh(multi_pod=(mesh_name == "multi"),
                                device_type=device_type)


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _data_size(mesh) -> int:
    return math.prod(_sizes(mesh)[a] for a in data_axes(mesh))


# ---------------------------------------------------------------------------
# Sharding policies for decode states
# ---------------------------------------------------------------------------

def _tree_map(fn, tree):
    """``fn`` of every leaf (a tensor or a `Spec`) of nested dicts,
    lists and tuples."""
    if isinstance(tree, (torch.Tensor, Spec)):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def decode_state_specs(mesh, states) -> list:
    """The `Spec` of every decode-state leaf.  KV caches (B, S, K, hd):
    B over data when divisible, cache length S over model
    (sequence-parallel decode).  SSM/WKV states: B over data, last dim
    over model when divisible.  The port's states are per layer; the
    reference's rule reads its stacked (L, ...) leaves, so it is applied
    to (1, *shape) and the layer entry dropped."""
    da = data_axes(mesh)
    d_batch = _data_size(mesh)
    d_model = _sizes(mesh)["model"]

    def one(leaf):
        shape = (1, *leaf.shape)
        ndim = len(shape)
        dims = [None] * ndim
        if ndim >= 2 and shape[1] % d_batch == 0:
            dims[1] = da                       # batch dim (after L)
        if ndim >= 3 and shape[2] % d_model == 0 and shape[2] >= 16:
            dims[2] = "model"                  # cache length / heads
        elif ndim >= 4 and shape[-1] % d_model == 0:
            dims[-1] = "model"
        if dims[1] is None and ndim >= 3 \
                and shape[2] % (d_batch * d_model) == 0 \
                and shape[2] >= 4096:
            dims[2] = (*da, "model")           # batch=1 long context
        return Spec(*dims[1:])

    return _tree_map(one, states)


def decode_state_shardings(mesh, states) -> list:
    """Placements of every decode-state leaf (`decode_state_specs`)."""
    return _tree_map(lambda s: placements(mesh, s),
                     decode_state_specs(mesh, states))


def vector_spec(mesh, n: int) -> Spec:
    da = data_axes(mesh)
    return Spec(da if n % _data_size(mesh) == 0 else None)


def vector_sharding(mesh, n: int) -> tuple:
    return placements(mesh, vector_spec(mesh, n))


def qs_axis_size(mesh):
    """The mesh size of a logical spec entry under `rules_for` (the
    ``axis_size`` of `optimizer.qs_specs`)."""
    rules, sizes = rules_for(mesh), _sizes(mesh)

    def size(logical: str) -> int:
        phys = rules.get(logical, logical)
        names = (phys,) if isinstance(phys, str) else tuple(phys or ())
        return math.prod(sizes[a] for a in names)
    return size


# ---------------------------------------------------------------------------
# Cell runners
# ---------------------------------------------------------------------------

def _local_bytes(tree) -> int:
    """Rank 0's bytes of a tree of tensors and DTensors."""
    from repro_torch.models.sharding import is_dtensor
    return sum(nbytes(t.to_local() if is_dtensor(t) else t)
               for t in tensors_in(tree))


def cell_config(cfg, shape, n_chips: int):
    """The reference's cell policy: (cfg, status, 8-bit arm)."""
    if shape.kind == "train" and param_count(cfg) * 4 > n_chips * 4e9:
        cfg = cfg.with_(param_dtype="bfloat16")
    use_8bit = shape.kind == "train" \
        and param_count(cfg) * 16 > n_chips * 12e9
    return cfg, registry.cell_status(cfg, shape), use_8bit


def lower(cfg, shape, mesh, mesh_name: str) -> dict:
    """One analysed call of ``cfg``'s ``shape`` step on ``mesh`` (a
    `DeviceMesh` over the process group; its ranks decide the policy).
    Returns the result dict."""
    from torch.distributed.tensor.experimental import implicit_replication
    n_chips = mesh.size()
    cfg, status, use_8bit = cell_config(cfg, shape, n_chips)
    if status != "run":
        return {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
                "status": status}
    sizes = _sizes(mesh)
    d_batch = _data_size(mesh)
    t0 = time.time()
    params = inputs.params_specs(cfg)
    p_specs = param_specs(params, model_divisor=sizes["model"],
                          data_divisor=d_batch)
    p_places = named_shardings(mesh, p_specs)
    params, _ = place_on_mesh(mesh, params, p_places)
    if shape.kind == "train":
        z_specs = opt.zero1_specs(p_specs, params, d_batch)
        if use_8bit:
            state = opt.init_8bit(params)
            m_places = named_shardings(mesh, opt.qs_specs(
                z_specs, params, qs_axis_size(mesh)))
        else:
            state = opt.init(params)
            m_places = named_shardings(mesh, z_specs)
        params, state = place_on_mesh(mesh, params, p_places, state,
                                      m_places)
        batch = inputs.train_batch_specs(cfg, shape)
        fn = make_train_step(cfg, TrainConfig(opt_8bit=use_8bit))
        args = (params, state, distribute_batch(mesh, batch))
        n_tokens = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        batch = inputs.train_batch_specs(cfg, shape)
        batch.pop("labels")
        fn = make_prefill_step(cfg)
        args = (params, distribute_batch(mesh, batch))
        n_tokens = shape.global_batch * shape.seq_len
    else:                                       # decode
        d = inputs.decode_input_specs(cfg, shape)
        vec = vector_sharding(mesh, shape.global_batch)
        args = [params,
                _place(mesh, d["states"],
                       decode_state_shardings(mesh, d["states"])),
                _distribute(d["tokens"], mesh, vec),
                _distribute(d["position"], mesh, vec)]
        if "memory" in d:
            args.append(distribute_batch(mesh, {"memory": d["memory"]})
                        ["memory"])
        fn = make_serve_step(cfg)
        n_tokens = shape.global_batch           # one token per sequence
    argument_bytes = _local_bytes(args)
    t_lower = time.time() - t0
    with logical_axis_rules(rules_for(mesh)), implicit_replication(), \
            Analyzer(default_group=n_chips) as an:
        out = fn(*args)
    t_compile = time.time() - t0 - t_lower
    cost = an.cost
    mf = model_flops_for("train" if shape.kind == "train" else "serve",
                         param_count(cfg, active_only=True), n_tokens,
                         embedding_params(cfg))
    roof = Roofline(flops=cost.flops, bytes_accessed=cost.bytes,
                    wire_bytes=cost.wire_bytes, n_chips=n_chips,
                    model_flops=mf)
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name,
        "status": "ok", "n_chips": n_chips,
        "opt_state": "int8-blockwise" if use_8bit else "fp32",
        "param_dtype": cfg.param_dtype,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            "argument_bytes": argument_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": cost.peak_bytes,
            "peak_bytes": argument_bytes + cost.peak_bytes,
        },
        "collectives": {"ops": cost.coll_ops,
                        "payload_bytes": cost.coll_payload,
                        "wire_bytes": cost.wire_bytes},
        "dispatch": {"ops": cost.ops, "distinct_bytes": cost.distinct_bytes,
                     "launches": cost.launches},
        "roofline": roof.to_dict(),
    }


def _place(mesh, tree, places):
    """A tree of tensors (the same on every rank) as DTensors under the
    same tree of ``places``."""
    if isinstance(tree, dict):
        return {k: _place(mesh, v, places[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(mesh, v, p) for v, p in zip(tree, places))
    return _distribute(tree, mesh, places)


def lower_cell(arch: str, shape_name: str, mesh_name: str,
               extra_cfg=None) -> dict:
    """Analyse one cell on its production mesh. Returns the result dict."""
    cfg = registry.get(arch)
    if extra_cfg:
        cfg = cfg.with_(**extra_cfg)
    shape = registry.SHAPES[shape_name]
    _, status, _ = cell_config(cfg, shape, MESH_CHIPS[mesh_name])
    if status != "run":
        return {"arch": cfg.name, "shape": shape_name, "mesh": mesh_name,
                "status": status}
    return lower(cfg, shape, _mesh(mesh_name), mesh_name)


def bfs_shard(n_vertices: int, n_edges: int, v_loc: int, e_loc: int,
              seed: int, device):
    """A shard of ``v_loc`` vertices and ``e_loc`` edge slots: each
    vertex has ``n_edges // v_loc`` uniform random neighbours in
    [0, ``n_vertices``) drawn from ``seed``; the slots past them hold the
    sentinel ``n_vertices``, as `partition_csr`'s padding does."""
    deg = min(n_edges, e_loc) // v_loc
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.full((e_loc,), n_vertices, dtype=torch.int32, device=device)
    rows[:deg * v_loc] = torch.randint(0, n_vertices, (deg * v_loc,),
                                       generator=gen, device=device,
                                       dtype=torch.int32)
    colstarts = torch.arange(v_loc + 1, dtype=torch.int32,
                             device=device) * deg
    return rows, colstarts


def lower_bfs_cell(graph_name: str, mesh_name: str,
                   merge: str = "allreduce", *,
                   device=DEFAULT_DEVICE) -> dict:
    """Dry-run the paper's distributed BFS on the production mesh: rank
    0's shard on ``device``, the collectives on the fake group."""
    from repro_torch.core.bfs_distributed import (make_bfs_program,
                                                  partition_sizes)
    from repro_torch.kernels import ops
    g = GRAPHS[graph_name]
    dev = resolve_device(device)
    mesh = _mesh(mesh_name, dev.type)
    axes = tuple(mesh.mesh_dim_names)
    n_chips = mesh.size()
    v_loc, e_loc = partition_sizes(g.n_vertices, g.n_edges_directed,
                                   n_chips)
    rows_l, colstarts_l = bfs_shard(g.n_vertices,
                                    g.n_edges_directed // n_chips, v_loc,
                                    e_loc, 0, dev)
    program = make_bfs_program(v_loc, g.n_vertices, n_chips, axes,
                               merge=merge, single_layer=True)
    program_full = make_bfs_program(v_loc, g.n_vertices, n_chips, axes,
                                    merge=merge)
    root = 0
    t0 = time.time()
    before = ops.KERNEL_LAUNCHES["rowsweep"]
    # the full program must run to its end (the dry-run proof) ...
    _, layers = program_full(mesh, rows_l, colstarts_l, root)
    # ... the single-layer probe gives the roofline terms
    with Analyzer(default_group=n_chips) as an:
        program(mesh, rows_l, colstarts_l, root)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cost = an.cost
    roof = Roofline(flops=cost.flops, bytes_accessed=cost.bytes,
                    wire_bytes=cost.wire_bytes, n_chips=n_chips,
                    model_flops=0.0)
    return {
        "arch": f"bfs-{graph_name}", "shape": "graph500",
        "mesh": mesh_name, "status": "ok", "n_chips": n_chips,
        "merge": merge, "device": str(dev), "layers_full_program": layers,
        "compile_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": nbytes(rows_l) + nbytes(colstarts_l),
            "temp_bytes": cost.peak_bytes,
        },
        "collectives": {"ops": cost.coll_ops,
                        "payload_bytes": cost.coll_payload,
                        "wire_bytes": cost.wire_bytes},
        "dispatch": {"ops": cost.ops, "distinct_bytes": cost.distinct_bytes,
                     "launches": cost.launches},
        "kernel_launches": {"rowsweep": ops.KERNEL_LAUNCHES["rowsweep"]
                            - before},
        "roofline": roof.to_dict(),
        "bytes_per_chip_edges": 4 * e_loc,
    }


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def cell_path(arch, shape, mesh) -> Path:
    return RESULTS / f"{arch}__{shape}__{mesh}.json"


def run_and_save(arch, shape, mesh_name, force=False):
    cfgname = registry.get(arch).name
    path = cell_path(cfgname, shape, mesh_name)
    if path.exists() and not force:
        print(f"[cached] {path.name}")
        return json.loads(path.read_text())
    path.parent.mkdir(parents=True, exist_ok=True)
    print(f"[dryrun] {cfgname} x {shape} x {mesh_name} ...", flush=True)
    try:
        res = lower_cell(arch, shape, mesh_name)
    except Exception as e:  # a failing cell is a bug: record it loudly
        res = {"arch": cfgname, "shape": shape, "mesh": mesh_name,
               "status": f"FAILED: {type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}
    path.write_text(json.dumps(res, indent=1))
    print(f"  -> {res['status']}"
          + (f" compile={res.get('compile_s')}s"
             f" bottleneck={res.get('roofline', {}).get('bottleneck')}"
             if res["status"] == "ok" else ""), flush=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default=None, choices=["single", "multi"])
    ap.add_argument("--bfs", action="store_true")
    ap.add_argument("--bfs-graph", default="rmat-24")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for cfg, shape, status in registry.all_cells():
            print(f"{cfg.name:28s} {shape.name:12s} {status}")
        return

    if args.bfs:
        for mesh_name in ([args.mesh] if args.mesh
                          else ["single", "multi"]):
            path = cell_path(f"bfs-{args.bfs_graph}", "graph500",
                             mesh_name)
            if path.exists() and not args.force:
                print(f"[cached] {path.name}")
                continue
            path.parent.mkdir(parents=True, exist_ok=True)
            print(f"[dryrun] BFS {args.bfs_graph} x {mesh_name}",
                  flush=True)
            try:
                res = lower_bfs_cell(args.bfs_graph, mesh_name)
            except Exception as e:
                res = {"arch": f"bfs-{args.bfs_graph}",
                       "shape": "graph500", "mesh": mesh_name,
                       "status": f"FAILED: {type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]}
            path.write_text(json.dumps(res, indent=1))
            print(f"  -> {res['status']}", flush=True)
        return

    archs = [args.arch] if args.arch else sorted(registry.ARCHS)
    shapes = [args.shape] if args.shape else list(registry.SHAPES)
    meshes = [args.mesh] if args.mesh else ["single", "multi"]
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                run_and_save(arch, shape, mesh_name, force=args.force)


if __name__ == "__main__":
    main()
