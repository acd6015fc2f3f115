"""Render the roofline table from dry-run artifacts (a port of
``repro.roofline.report``).

    PYTHONPATH=src python -m repro_torch.roofline.report \
        [--dir results/dryrun_torch] [--mesh single] [--guidance]

One row per (arch x shape) with the three terms on the H100's constants
(`roofline.analysis`), the dominant bottleneck, the model-flops ratio
and the roofline-bounded MFU, plus per-cell one-line "what would move
the dominant term" guidance for Hopper derived from the bottleneck
class.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

GUIDANCE = {
    ("train", "compute"): "at the tensor-core roof — gains only from "
        "removing redundant flops (remat policy, causal-block skipping)",
    ("train", "memory"): "cut HBM traffic: a flash-style attention kernel "
        "(no (B, H, Cq, Ck) score and mask buffers; PERF.md section 7), "
        "bf16 residual saves, one bf16 cast of the weights per step",
    ("train", "collective"): "re-balance the mesh: less TP for this size "
        "(d_model/16 too thin for NVLink) or overlap the data-parallel "
        "reduce-scatter with the backward pass",
    ("prefill", "memory"): "fuse the attention pipeline (flash-style "
        "kernel); larger q-chunks; keep KV in bf16",
    ("prefill", "collective"): "sequence-parallel attention instead of "
        "TP-only; all-gather KV once per layer over NVLink",
    ("prefill", "compute"): "at the roof; only layout tweaks left",
    ("decode", "memory"): "weights+KV streaming bound — expected for "
        "batch-limited decode; raise batch or quantize KV (fp8 on Hopper)",
    ("decode", "collective"): "TP all-reduce per token dominates; "
        "wider data-parallel serving or an NVLink-aware layout",
    ("decode", "compute"): "unusual for decode; check batching",
}


def load_cells(d: Path):
    cells = []
    for f in sorted(d.glob("*.json")):
        r = json.loads(f.read_text())
        cells.append(r)
    return cells


def shape_kind(shape: str) -> str:
    return {"train_4k": "train", "prefill_32k": "prefill",
            "decode_32k": "decode", "long_500k": "decode",
            "graph500": "graph"}.get(shape, "train")


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def render(cells, mesh: str) -> str:
    rows = []
    header = ("| arch | shape | t_compute | t_memory | t_collective | "
              "bottleneck | MODEL/HLO flops | MFU bound |\n"
              "|---|---|---|---|---|---|---|---|")
    for r in cells:
        if r.get("mesh") != mesh:
            continue
        if r["status"].startswith("skip"):
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"N/A (skip) | — | — |")
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"FAILED | — | — |")
            continue
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(ro['t_compute_s'])} "
            f"| {fmt_s(ro['t_memory_s'])} | {fmt_s(ro['t_collective_s'])} "
            f"| {ro['bottleneck']} | {ro['useful_flops_ratio']:.2f} "
            f"| {ro['mfu_bound']*100:.1f}% |")
    return header + "\n" + "\n".join(rows)


def render_guidance(cells, mesh: str) -> str:
    lines = []
    for r in cells:
        if r.get("mesh") != mesh or r["status"] != "ok":
            continue
        kind = shape_kind(r["shape"])
        if kind == "graph":
            continue
        g = GUIDANCE.get((kind, r["roofline"]["bottleneck"]), "")
        lines.append(f"- **{r['arch']} x {r['shape']}**: {g}")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--guidance", action="store_true")
    args = ap.parse_args(argv)
    cells = load_cells(Path(args.dir))
    print(render(cells, args.mesh))
    if args.guidance:
        print()
        print(render_guidance(cells, args.mesh))


if __name__ == "__main__":
    main()
