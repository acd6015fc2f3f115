#!/usr/bin/env python3
"""Time K6 and K10 at other minimums of resident CTAs per SM.

    python3 tools/sweep_launch_bounds.py [--scale 22] [--reps 7] [MIN ...]

Copies ``src/repro_torch/kernels/csrc`` once per MIN (default: none 4 5
6) with ``kTraversalCtas`` (``csrc/traversal_loop.cuh``) set to MIN —
``none`` drops the minimum from K6's and K10's ``__launch_bounds__`` —
and builds each copy, printing ptxas' registers and spills of the two
kernels.  Then, on the main path's graph (R-MAT at ``--scale``, the 8
roots of ``chip_smoke.py``), it holds each build's K6 and K10 to their
plain versions (``chip_smoke.traversal_gate``) and times them at each
of ``chip_smoke.CTAS_PER_SM_TRIED`` CTAs per SM, the builds in turns
(first to last, then last to first).  One JSON line per build and
source, then per (build, kernel, CTAs per SM).  Needs the GPU machine.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

BOUND = "__launch_bounds__(bfs::kThreads, bfs::kTraversalCtas)"
MINIMUM = re.compile(r"constexpr int kTraversalCtas = \d+;")
SOURCES = ("traversal_fused.cu", "sell_traversal_fused.cu")


def variant(csrc: Path, dst: Path, minimum: str) -> Path:
    """A copy of ``csrc`` whose K6 and K10 take ``minimum``."""
    shutil.copytree(csrc, dst)
    if minimum == "none":
        for name in SOURCES:
            text = (dst / name).read_text()
            assert BOUND in text, name
            (dst / name).write_text(
                text.replace(BOUND, "__launch_bounds__(bfs::kThreads)"))
    else:
        loop = dst / "traversal_loop.cuh"
        text = loop.read_text()
        assert MINIMUM.search(text), loop
        loop.write_text(MINIMUM.sub(
            f"constexpr int kTraversalCtas = {int(minimum)};", text))
    return dst


def build(csrc: Path, build_dir: Path, minimum: str):
    """Load ``csrc``'s library (built into ``build_dir``); print ptxas'
    lines of K6 and K10."""
    _build.CSRC, _build.BUILD_DIR, _build._LIB = csrc, build_dir, None
    lib = _build.load()
    for entry in _build.BUILD_LOG:
        head, *lines = entry.splitlines()
        if head[3:] in SOURCES:
            print(json.dumps({"build": minimum, "source": head[3:],
                              "ptxas": [ln.strip() for ln in lines
                                        if "Used" in ln or "spill" in ln]}),
                  flush=True)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("minimums", nargs="*", default=["none", "4", "5", "6"])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    import repro_torch.bfs as bfs
    from repro_torch import formats
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        csrc = _build.CSRC
        libs = {m: build(variant(csrc, Path(tmp) / f"csrc_{m}", m),
                         Path(tmp) / f"build_{m}", m)
                for m in args.minimums}
        g = cs.make_graph(args.scale, 0, "cuda")
        roots = cs.pick_roots(g, cs.BATCH, 0)
        cases = []
        for kind, fmt in (("csr", g), ("sell", formats.build(g, "auto"))):
            ct = bfs.plan(fmt, bfs.TraversalSpec(pipeline="persistent"))
            case = cs.traversal_case(kind, ct.fmt, ct.resolved, roots)
            _, _, plain, _, graph, state, kw = case
            cases.append((case, plain(graph, *state, **kw)))
        times = {}
        for minimum in args.minimums + args.minimums[::-1]:
            _build._LIB = libs[minimum]
            for (name, cuda, _, grid_of, graph, state, kw), want in cases:
                for n in cs.CTAS_PER_SM_TRIED:
                    with cs.ctas_per_sm(n):
                        cs.traversal_gate(name, cuda, graph, state, kw, want)
                        times.setdefault((minimum, name, n, grid_of(0)),
                                         []).append(cs.cuda_ms(
                            lambda: cuda(graph, *state, **kw), args.reps))
    for (minimum, name, n, grid), ms in times.items():
        print(json.dumps({"build": minimum, "kernel": name,
                          "ctas_per_sm": n, "grid": grid, "ms": ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
