#!/usr/bin/env python3
"""Sweep the auto knobs on the card and write the port's affinity table.

    python3 tools/sweep_affinity.py [--out PATH] [--scale 22] [--reps 10]

A port of the reference's knob sweeps ((b) in its
``benchmarks/affinity.py``), with its grids:

* CSR on the main path's R-MAT graph (`configs.bfs_graph500`
  ``rmat-<scale>``, seed ``--seed``, class ``skew64``) and on the
  reference's 64 x 64 torus (class ``skew1``): tile, prefetch depth,
  pipeline, and the persistent pipeline's prefetch depth;
* SELL on the R-MAT graph: σ, pipeline, and the persistent pipeline's
  prefetch depth.

Every timing runs under an empty table (`affinity.table_at(None)`), so
a row times one knob against the built-in defaults, not against rows
committed before.  A row is the mean seconds of ``ct.run(root)`` over
the reference's roots (``default_rng(3)``, two of degree > 0), each
timed ``--reps`` times after one warm-up run, the plan built outside
the timed window and the card synchronised after each run.  Rows are
written through `affinity.key_for` as ``{"us_per_call", "derived",
"value"}`` with TEPS (E / 2 per second, the reference's count); the
file's first key, ``card``, records the card, its power limit and the
torch version.

Not written: the reference's "(a)" ``shard_skew`` rows, which no lookup
reads.  The ``persistent_prefetch`` rows are written for parity with
the reference, whose lookup never reads them either (the auto depth
comes from the ``prefetch`` rows).  Needs an NVIDIA GPU.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(1, str(HERE))

CSR_TILES = (512, 1024, 4096, 16384)
CSR_PREFETCH = (0, 1, 2)
CSR_PIPELINES = ("fused_gather", "megakernel", "persistent")
SELL_SIGMAS = (256, 1024, 4096)
SELL_PIPELINES = ("fused_gather", "megakernel", "persistent")
PERSISTENT_PREFETCH = (0, 1, 2)
TORUS_SIDE = 64       # diameter 64: within the default 64 layers


def sweep_roots(g):
    """The reference's roots: two of degree > 0 from default_rng(3)."""
    import numpy as np
    deg = g.degrees().cpu().numpy()
    rng = np.random.default_rng(3)
    return [int(r) for r in rng.choice(np.nonzero(deg > 0)[0], size=2,
                                       replace=False)]


def seconds(ct, roots, reps: int) -> float:
    """Mean seconds of one ``ct.run(root)`` over ``roots`` x ``reps``,
    after one warm-up run."""
    import torch
    ct.run(roots[0])
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        for r in roots:
            t0 = time.perf_counter()
            ct.run(r)
            torch.cuda.synchronize()
            total += time.perf_counter() - t0
    return total / (reps * len(roots))


class Table:
    """The rows written so far, printed as the reference's CSV lines."""

    def __init__(self, card: dict):
        self.rows = {"card": card}

    def emit(self, key: str, sec: float, n_edges: int,
             suffix: str = "") -> None:
        teps = n_edges / 2 / sec
        derived = f"{teps:.3e}_teps{suffix}"
        self.rows[key] = {"us_per_call": round(sec * 1e6, 1),
                          "derived": derived, "value": teps}
        print(f"{key},{sec * 1e6:.1f},{derived}", flush=True)


def sweep_csr(table: Table, g, label: str, reps: int) -> None:
    import repro_torch.bfs as bfs
    from repro_torch.formats import affinity
    from repro_torch.formats.csr_format import CsrFormat
    fmt = CsrFormat.from_csr(g)
    geom = affinity.geometry_class(fmt)
    print(f"# {label} -> affinity.csr.{geom}.*", flush=True)
    roots = sweep_roots(g)

    def run(knob, value, **fields):
        ct = bfs.plan(fmt, bfs.TraversalSpec(**fields),
                      device=str(g.device))
        table.emit(affinity.key_for("csr", geom, knob, value),
                   seconds(ct, roots, reps), g.n_edges)
        bfs.clear_plan_cache()

    for tile in CSR_TILES:
        run("tile", tile, tile=tile)
    for depth in CSR_PREFETCH:
        run("prefetch_depth", depth, prefetch_depth=depth)
    for pipe in CSR_PIPELINES:
        run("pipeline", pipe, pipeline=pipe)
    for depth in PERSISTENT_PREFETCH:
        run("persistent_prefetch", depth, pipeline="persistent",
            prefetch_depth=depth)


def sweep_sell(table: Table, g, label: str, reps: int) -> None:
    import torch
    import repro_torch.bfs as bfs
    from repro_torch.formats import affinity
    from repro_torch.formats.sell import SellFormat
    geom = affinity.geometry_class(g)
    print(f"# {label} -> affinity.sell.{geom}.*", flush=True)
    roots = sweep_roots(g)

    def run(fmt, knob, value, suffix="", **fields):
        ct = bfs.plan(fmt, bfs.TraversalSpec(**fields),
                      device=str(g.device))
        table.emit(affinity.key_for("sell", geom, knob, value),
                   seconds(ct, roots, reps), g.n_edges, suffix)
        bfs.clear_plan_cache()

    for sigma in SELL_SIGMAS:
        fmt = SellFormat.from_csr(g, sigma=sigma)
        run(fmt, "sigma", sigma, f"_slots{fmt.nnz_stored}")
        del fmt
        torch.cuda.empty_cache()
    fmt = SellFormat.from_csr(g)
    for pipe in SELL_PIPELINES:
        run(fmt, "pipeline", pipe, pipeline=pipe)
    for depth in PERSISTENT_PREFETCH:
        run(fmt, "persistent_prefetch", depth, pipeline="persistent",
            prefetch_depth=depth)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="where to write the table (default: the "
                         "package's formats/affinity_table.json)")
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10,
                    help="timed runs per root and row")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("sweep_affinity: needs an NVIDIA GPU")
    import chip_smoke
    import repro_torch.bfs as bfs
    from repro_torch.formats import SellFormat, affinity
    out = args.out or affinity._table_path()
    name, limit = (s.strip() for s in chip_smoke.card_line().split(","))
    table = Table({"name": name, "power_limit": limit,
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   "sweep": f"tools/sweep_affinity.py --scale {args.scale} "
                            f"--seed {args.seed} --reps {args.reps}"})
    print(f"# {name}, {limit}; torch {torch.__version__}", flush=True)
    t0 = time.perf_counter()
    rmat = chip_smoke.make_graph(args.scale, args.seed, "cuda")
    torus = chip_smoke.torus_graph(TORUS_SIDE, "cuda")
    with affinity.table_at(None):
        affinity.clear_cache()
        sweep_csr(table, rmat, f"R-MAT SCALE {args.scale}", args.reps)
        sweep_csr(table, torus, f"{TORUS_SIDE} x {TORUS_SIDE} torus",
                  args.reps)
        sweep_sell(table, rmat, f"R-MAT SCALE {args.scale}", args.reps)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(table.rows, indent=1) + "\n")
    print(f"# wrote {len(table.rows) - 1} rows to {out} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # what an all-auto spec resolves to under the new table
    with affinity.table_at(out):
        affinity.clear_cache()
        for label, g in (("rmat", rmat), ("torus", torus)):
            for fmt in (g, SellFormat.from_csr(g)):
                r = bfs.TraversalSpec().resolve(fmt)
                print(json.dumps({
                    "graph": label, "format": type(fmt).__name__,
                    "geometry": affinity.geometry_class(fmt),
                    "sigma": getattr(fmt, "sigma", None),
                    "resolved": {k: str(v) for k, v in
                                 r.to_dict().items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
