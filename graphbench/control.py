"""The control of the check that decides ``correct``, at a cell's size.

    python3 -m graphbench.control --workload kron-s25.search8 \
        --seeds 11,12,13

The configuration states no precision, so the control breaks one of the
guarantees it states: in the program's place stands the reference with
a bottom-up step that tests the visited set in place of the frontier
(`reference.bfs.control_parents`).  For each seed it prints the numbers
the check compares, over the roots of the trees a run of the cell
checks, beside their limits; the control has to fail them.  The
benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from graphbench import cells, run
from graphbench.reference import bfs as ref_bfs


def readings(cell, seed: int, device) -> dict:
    import torch
    inputs = run.make_inputs(cell.config, cell.traffic, seed, device)
    keys = run.make_driver(cell.traffic, inputs, device,
                           seed).checked_roots()
    adj = ref_bfs.adjacency(inputs.src, inputs.dst, inputs.n_vertices)
    inputs.src = inputs.dst = None
    errors = {"reach": 0, "parent": 0}
    for root in keys:
        depth = ref_bfs.bfs_depths(adj, int(root))
        got = ref_bfs.tree_errors(
            adj, ref_bfs.control_parents(adj, depth, int(root)),
            int(root), depth)
        for k in errors:
            errors[k] += got[k]
    del adj
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return {"reach_errors": errors["reach"],
            "parent_errors": errors["parent"], "trees": len(keys)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    sys.path.insert(0, str(cells.ROOT / "src"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(cell, seed, "cuda")
        out.update(workload=args.workload, seed=seed, limit=0,
                   seconds=time.perf_counter() - t)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
