#!/usr/bin/env python3
"""Count DTensor's second materializations of a masked gather's mask in
the dry run's cells.

    python3 tools/probe_masked_gather.py [--layers 2] [--seq 256]
        [--arch hymba-1.5b] [--shape train_4k] [--mesh single]

A vocab-cut lookup or gather leaves a masked partial sum whose mask
DTensor keeps in a `MaskBuffer`.  Materializing that buffer again
before it is released compares the two masks with ``torch.equal``,
which has no meta kernel: a dry-run cell on meta tensors then fails
with ``aten::equal``.  This tool wraps
``MaskBuffer.materialize_mask`` (it still calls the original, so the
cell runs as it would), counts the calls that find the buffer already
materialized and prints each one's Python stack.  The cell is the dry
run's `lower` of ``--arch`` x ``--shape`` on the fake ``--mesh`` group,
at ``--layers`` layers and ``--seq`` tokens (the widths are the
config's).  Prints the cell's status and the count; CPU only.
"""
import argparse
import dataclasses
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="hymba-1.5b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=256)
    args = ap.parse_args(argv)
    import torch
    from torch.distributed.tensor._ops._mask_buffer import MaskBuffer
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun

    seen = {}
    original = MaskBuffer.materialize_mask

    def counted(self, mask):
        if self.refcount != 0:
            stack = "".join(traceback.format_stack(limit=30)[:-1])
            seen[stack] = seen.get(stack, 0) + 1
        return original(self, mask)

    MaskBuffer.materialize_mask = counted
    cfg = registry.get(args.arch).with_(n_layers=args.layers)
    shape = dataclasses.replace(registry.SHAPES[args.shape],
                                seq_len=args.seq)
    print(f"torch {torch.__version__}: {cfg.name} x {shape.name} "
          f"({args.layers} layers, seq {args.seq}) x {args.mesh}",
          flush=True)
    t0 = time.time()
    try:
        status = dryrun.lower(cfg, shape, dryrun._mesh(args.mesh),
                              args.mesh)["status"]
    except Exception as e:  # the cell's failure is the finding
        status = f"FAILED: {type(e).__name__}: {e}"
    finally:
        MaskBuffer.materialize_mask = original
    print(f"status {status} in {time.time() - t0:.1f} s; second "
          f"materializations: {sum(seen.values())}", flush=True)
    for stack, n in seen.items():
        print(f"---- x{n}\n{stack}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
