#!/usr/bin/env python3
"""Split the device time of one CSR ``fused_gather`` traversal (the main
path: R-MAT SCALE 22, 8 roots, all-auto spec) into the planning, the
Table-1 counters, the layer's kernels and the rest, on the port of a
given checkout of the repository.

    python3 tools/profile_planning.py [TREE] [--scale 22] [--seed 0]

TREE (default: this checkout) holds the ``src/repro_torch`` that is
profiled; the graph, the roots and the split are this checkout's
`chip_smoke.planning_split`, so two trees are split the same way.
Needs an NVIDIA GPU; prints the split as one JSON line.
"""
import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=str(HERE))
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # the tree's package first: chip_smoke's own path entry comes after
    # it, and every later import of repro_torch resolves to the tree's
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import repro_torch  # noqa: F401
    sys.path.insert(1, str(HERE))
    import torch
    if not torch.cuda.is_available():
        sys.exit("profile_planning: needs an NVIDIA GPU")
    import chip_smoke
    import repro_torch.bfs as bfs
    print(f"tree {args.tree}: repro_torch from "
          f"{Path(repro_torch.__file__).parent}", flush=True)
    g = chip_smoke.make_graph(args.scale, args.seed, "cuda")
    roots = chip_smoke.pick_roots(g, chip_smoke.BATCH, args.seed)
    ct = bfs.plan(g, bfs.TraversalSpec())
    chip_smoke.planning_split(ct, roots)
    return 0


if __name__ == "__main__":
    sys.exit(main())
