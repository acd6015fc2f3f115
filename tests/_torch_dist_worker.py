"""One rank of the spawned distributed tests (`test_torch_distributed.py`).

Imports only torch, numpy and ``repro_torch``, so a spawned rank never
loads jax.  Each rank joins a gloo group through a file store, runs
every (mesh, axes) case for every graph, merge and root, and writes what
it got to ``<out>.<rank>.npz`` for the parent test to hold to the
reference.
"""
from __future__ import annotations

import numpy as np


def case_key(graph: int, case: int, merge: str, root: int) -> str:
    return f"{graph}/{case}/{merge}/{root}"


def run_rank(rank: int, world: int, store: str, cases, jobs,
             out: str) -> None:
    """``cases``: (mesh shape, mesh dim names, axis_names or None);
    ``jobs``: (graph .npz path, roots)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import repro_torch.bfs as tbfs
    from repro_torch import interop
    from repro_torch.core import bfs_distributed as bd

    # one intra-op thread per rank: the ranks share the host's cores,
    # and tensors here are a few KB
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        got = {}
        meshes = [(init_device_mesh("cpu", tuple(shape),
                                    mesh_dim_names=tuple(names)),
                   axis_names) for shape, names, axis_names in cases]
        for j, (path, roots) in enumerate(jobs):
            g = np.load(path)
            csr = interop.csr_from_arrays(g["rows"], g["colstarts"],
                                          int(g["n_vertices"]),
                                          int(g["n_edges"]), device="cpu")
            for i, (mesh, axis_names) in enumerate(meshes):
                for merge in bd.MERGES:
                    for root in roots:
                        parent, layers = bd.run_bfs_distributed(
                            csr, root, mesh, axis_names=axis_names,
                            merge=merge)
                        key = case_key(j, i, merge, root)
                        got[key] = parent.numpy()
                        got[key + "/layers"] = np.int64(layers)
                if axis_names is None:
                    # the mesh-bound plan: one partition, the same trees
                    ct = tbfs.plan(csr, tbfs.TraversalSpec(merge="owner"),
                                   device="cpu", mesh=mesh)
                    for root in roots:
                        parent, layers = ct.run(root)
                        key = case_key(j, i, "plan", root)
                        got[key] = parent.numpy()
                        got[key + "/layers"] = np.int64(layers)
        np.savez(f"{out}.{rank}.npz", **got)
    finally:
        dist.destroy_process_group()
