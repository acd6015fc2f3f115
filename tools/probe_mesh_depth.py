#!/usr/bin/env python3
"""Probe the depth of `chip_smoke.py` phase 16b on one card.

    python3 tools/probe_mesh_depth.py [--mesh-layers 22 20]
                                      [--spread-layers 22 20]

For each depth in ``--mesh-layers``, phase 16b itself (`chip_smoke.
mesh_full`: four gloo ranks on cuda:0, held to a one-rank run of the same
cut) with `chip_smoke.MESH_FULL_LAYERS` set to it; a run that fails (out
of memory, or the loss gate) prints why.  For each depth in
``--spread-layers``, the one-rank run alone with the global batch split
into 1, 2 and 4 micro-batches: the same sum in other orders, so the
losses' spread is the recipe's own rounding noise beside which the mesh's
distance from the one-rank run is read.  Needs an NVIDIA GPU; prints one
JSON line per run.
"""
import argparse
import gc
import json
import sys
import tempfile
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
sys.path.insert(1, str(HERE))


def spread(layers: int) -> None:
    import torch
    import chip_smoke as c
    from repro_torch.configs import registry
    from repro_torch.data.tokens import DataConfig, batch_at
    from repro_torch.models import lm
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step
    cfg = registry.get(c.MESH_FULL_ARCH).with_(n_layers=layers)
    dcfg = DataConfig(seed=0, batch_size=c.MESH_FULL_BATCH,
                      seq_len=c.TRAIN_SEQ)
    batches = [batch_at(cfg, dcfg, i, "cpu")
               for i in range(c.MESH_FULL_STEPS)]
    for accum in (1, 2, 4):
        params = lm.init_params(cfg, 0, device="cuda")
        state = opt.init(params)
        step_fn = make_train_step(cfg, TrainConfig(
            adamw=opt.AdamWConfig(**c.TRAIN_ADAMW), accum_steps=accum))
        losses = [float(step_fn(params, state, {
            k: v.cuda() for k, v in b.items()})[2]["loss"]) for b in batches]
        print(json.dumps({"one_rank_spread": layers, "accum_steps": accum,
                          "losses": losses}), flush=True)
        del params, state, step_fn
        gc.collect()
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh-layers", type=int, nargs="*", default=[22, 20])
    ap.add_argument("--spread-layers", type=int, nargs="*",
                    default=[22, 20])
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("probe_mesh_depth: needs an NVIDIA GPU")
    import chip_smoke as c
    smi = c.card_line()
    print(smi, flush=True)
    for layers in args.mesh_layers:
        c.MESH_FULL_LAYERS = layers
        try:
            with tempfile.TemporaryDirectory() as tmp:
                c.mesh_full(0, tmp, smi)
            print(json.dumps({"mesh_layers": layers, "ok": True}), flush=True)
        except Exception as e:                     # noqa: BLE001 (reported)
            print(json.dumps({"mesh_layers": layers, "ok": False,
                              "error": repr(e)[:800]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    for layers in args.spread_layers:
        spread(layers)
    return 0


if __name__ == "__main__":
    sys.exit(main())
