"""One rank of the spawned mesh-training test (`test_torch_multidevice_train.py`).

Imports only torch, numpy and ``repro_torch``, so a spawned rank never
loads jax.  Each rank joins a gloo group of 8 through a file store and
holds the two contracts of ``tests/test_multidevice_train.py`` on CPU
DTensors:

1. three AdamW steps on a (2 data x 4 model) mesh, from the reference's
   weights and batches (``<job>.pkl``), and the same run with m and v
   under `zero1_specs`;
2. a checkpoint saved from that mesh restores onto a (4 x 2) mesh, its
   values bitwise those saved, and one more step trains there;
3. three steps of the 8-bit arm on the (2 x 4) mesh, q and v under
   `zero1_specs`, the scales under `optimizer.qs_specs`, and the gap of
   its gathered state (and of the fp32 mesh run's) to one rank's 8-bit
   run (`optimizer.gap_8bit`).

Rank 0 writes the losses, the restore's verdict and the collective
counts to ``<out>.npz`` for the parent test.
"""
from __future__ import annotations

import json
import pickle

import numpy as np


def run_rank(rank: int, world: int, store: str, job: str, ckpt: str,
             out: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import interop
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models.sharding import logical_axis_rules
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import TrainConfig, make_train_step

    # one intra-op thread per rank: eight ranks share the host's cores
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        with open(job, "rb") as f:
            spec = pickle.load(f)
        cfg = spec["cfg"]
        batches = [{k: torch.from_numpy(v) for k, v in b.items()}
                   for b in spec["batches"]]
        step = make_train_step(cfg, TrainConfig(adamw=opt.AdamWConfig(
            lr=1e-3, warmup_steps=0)))

        def fresh():
            p = interop.lm_params_from_numpy(cfg, spec["params"], "cpu")
            return p, opt.init(p)

        def train(mesh, p, s, steps, counts=None):
            losses = []
            with logical_axis_rules(lmesh.rules_for(mesh)):
                for b in steps:
                    with CommDebugMode() as comm:
                        _, _, m = step(p, s, lmesh.distribute_batch(mesh, b))
                    losses.append(float(m["loss"]))
                    if counts is not None:
                        counts.append({str(k): v for k, v in
                                       comm.get_comm_counts().items()})
            return losses

        mesh = lmesh.make_mesh((2, 4), ("data", "model"), device_type="cpu")
        specs = lmesh.param_specs(fresh()[0], model_divisor=4)
        places = lmesh.named_shardings(mesh, specs)
        replicated = {k: (Replicate(),) * mesh.ndim for k in places}

        # contract 1: the mesh run, with replicated optimizer state ...
        p, s = fresh()
        p, s = lmesh.place_on_mesh(mesh, p, places, s, replicated)
        counts: list = []
        mesh_losses = train(mesh, p, s, batches[:3], counts)
        # ... and with m and v under ZeRO-1
        zero1 = lmesh.named_shardings(mesh, opt.zero1_specs(
            specs, fresh()[0], data_divisor=2))
        # moments made at the placed parameters' placements, then cut
        pz, _ = lmesh.place_on_mesh(mesh, fresh()[0], places)
        pz, sz = lmesh.place_on_mesh(mesh, pz, places, opt.init(pz), zero1)
        zero1_losses = train(mesh, pz, sz, batches[:3])
        zero1_sharded = sum(
            any(pl.is_shard() for pl in sz["m"][k].placements[:1])
            for k in sz["m"])
        # the ZeRO-1 update alone: it runs at the moments' placements and
        # gathers only the parameters back
        grads = {k: torch.zeros_like(t) for k, t in pz.named_parameters()}
        with CommDebugMode() as comm:
            opt.update(opt.AdamWConfig(lr=1e-3, warmup_steps=0), pz, grads,
                       sz)
        update_comm = {str(k).rpartition(".")[2]: v
                       for k, v in comm.get_comm_counts().items()}

        # contract 2: save on (2, 4), restore onto (4, 2), train on
        save(ckpt, 3, {"params": p, "opt": s}, host_id=rank)
        saved = {k: t.full_tensor() for k, t in p.named_parameters()}
        saved_m = {k: t.full_tensor() for k, t in s["m"].items()}
        mesh2 = lmesh.make_mesh((4, 2), ("data", "model"),
                                device_type="cpu")
        p2, s2 = fresh()
        places2 = lmesh.named_shardings(
            mesh2, lmesh.param_specs(p2, model_divisor=2))
        rep2 = {k: (Replicate(),) * mesh2.ndim for k in places2}
        restored, _, step_no = restore(
            ckpt, {"params": p2, "opt": s2},
            shardings=(mesh2, {"params": places2,
                               "opt": {"m": rep2, "v": rep2}}))
        p2, s2 = restored["params"], restored["opt"]
        bitwise = step_no == 3 and all(
            torch.equal(t.full_tensor(), saved[k])
            and tuple(t.placements) == places2[k]
            for k, t in p2.named_parameters()) and all(
            torch.equal(t.full_tensor(), saved_m[k])
            for k, t in s2["m"].items())
        elastic = train(mesh2, p2, s2, batches[3:4])

        # the 8-bit arm on the (2, 4) mesh
        from repro_torch.launch.dryrun import qs_axis_size
        step = make_train_step(cfg, TrainConfig(adamw=opt.AdamWConfig(
            lr=1e-3, warmup_steps=0), opt_8bit=True))
        p8 = fresh()[0]
        qs = opt.qs_specs(opt.zero1_specs(specs, p8, data_divisor=2), p8,
                          qs_axis_size(mesh))
        p8, s8 = lmesh.place_on_mesh(mesh, p8, places, opt.init_8bit(p8),
                                     lmesh.named_shardings(mesh, qs))
        losses_8bit = train(mesh, p8, s8, batches[:3])
        scales_cut = sum(any(pl.is_shard() for pl in mq["s"].placements)
                         for mq in s8["m"].values())
        # its state against one rank's 8-bit run, and the fp32 mesh run's
        # state (quantized as the 8-bit arm would store it) against the
        # same: the gate must tell the two arms apart
        snap_8bit = opt.snapshot_8bit(p8, s8)
        snap_fp32 = opt.snapshot_8bit(p, s)
        p1 = fresh()[0]
        s1 = opt.init_8bit(p1)
        for b in batches[:3]:
            step(p1, s1, b)
        one = opt.snapshot_8bit(p1, s1)
        gaps = {"mesh": opt.gap_8bit(one, snap_8bit),
                "fp32": opt.gap_8bit(one, snap_fp32)}
        if rank == 0:
            np.savez(out, mesh_losses=np.array(mesh_losses),
                     zero1_losses=np.array(zero1_losses),
                     zero1_sharded=zero1_sharded, bitwise=bitwise,
                     elastic_loss=np.array(elastic),
                     comm=np.array(json.dumps(counts[0])),
                     update_comm=np.array(json.dumps(update_comm)),
                     losses_8bit=np.array(losses_8bit),
                     scales_cut=scales_cut,
                     gaps_8bit=np.array(json.dumps(gaps)))
    finally:
        dist.destroy_process_group()
