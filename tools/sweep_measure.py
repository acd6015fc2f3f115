#!/usr/bin/env python3
"""Time the measure kernel (``csrc/measure.cu``) at several grid sizes.

    python3 tools/sweep_measure.py [--roots 8 33] [--scale 22] [--reps 20]

Random (B, W) frontier and visited words and a random degree array at
the shape of an R-MAT SCALE-``scale`` batch (W = 2^scale / 32), made on
the card from seed 0, then the kernel with the unvisited pair (a
BeamerHybrid layer), the frontier alone and the count-only arm, at 1,
2, 3, 4 and 8 CTAs per SM (`bitmap_kernels.CTAS_PER_SM`), for each
batch size in ``--roots``.  Times are
`chip_smoke.device_ms` (calls queued back to back behind a sleep
kernel).  Needs an NVIDIA GPU; prints one JSON line per grid.
"""
import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(1, str(HERE))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", type=int, nargs="+", default=[8, 33])
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("sweep_measure: needs an NVIDIA GPU")
    import chip_smoke
    from repro_torch.core import engine
    from repro_torch.kernels import bitmap_kernels as bk
    nw = (1 << args.scale) // 32
    gen = torch.Generator(device="cuda").manual_seed(0)
    i32 = dict(dtype=torch.int32, device="cuda", generator=gen)
    d = torch.randint(0, 5000, (32 * nw,), **i32)
    kept = bk.CTAS_PER_SM
    try:
        for nb in args.roots:
            f = torch.randint(-2**31, 2**31 - 1, (nb, nw), **i32)
            v = torch.randint(-2**31, 2**31 - 1, (nb, nw), **i32)
            code = engine.policy_code(engine.BeamerHybrid(), 32 * nw, nb,
                                      64)
            log = bk.new_log(nb, 64, code, "cuda")
            for ctas in (1, 2, 3, 4, 8):
                bk.CTAS_PER_SM = ctas
                ms = lambda fn: chip_smoke.device_ms(fn, args.reps)
                print(json.dumps(dict(
                    roots=nb, words=nw, ctas_per_sm=ctas,
                    unvisited_ms=ms(lambda: bk.measure_cuda(
                        f, v, d, log=log, layer=1)),
                    frontier_ms=ms(lambda: bk.measure_cuda(f, None, d)),
                    count_only_ms=ms(lambda: bk.measure_cuda(f)))),
                    flush=True)
    finally:
        bk.CTAS_PER_SM = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
