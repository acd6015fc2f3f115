"""Checkpointing with atomic commits and keep-n retention.

Layout (the reference's):
    <dir>/step_000000123/
        manifest.json        leaf index + metadata
        leaf_00000.npy ...   one file per leaf
    <dir>/LATEST             committed step pointer (atomic rename)

* atomic: a checkpoint is written into ``.tmp_step_*`` and renamed into
  place, and becomes visible only when LATEST is renamed over it; a job
  killed mid-save never sees a torn checkpoint;
* keep_n garbage collection;
* step-indexed, so the data stream (a pure function of step) resumes
  bit-exactly.

Leaves are flattened depth first: a dict's keys in sorted order (as
``jax.tree_util`` orders them), a list or tuple in order, an
`nn.Module` as its ``state_dict()`` in registration order.  A bfloat16
leaf (the 8-bit arm's ``v``) goes to disk as its 16-bit view with
``"bfloat16"`` in the index, since numpy has no bfloat16.

Elastic: leaves are saved mesh-independently.  `save` of a tree with
DTensor leaves gathers each one (``full_tensor()``, a collective every
rank of the mesh calls, in the same order), and only ``host_id`` 0
writes; every rank then waits at a barrier for the commit.
``restore(..., shardings=(mesh, placements))`` loads the full arrays on
every rank and hands each its shard (`distribute_tensor` with no
communication), whatever mesh saved them; ``restore(..., device=)``
loads plain tensors.  Checkpoints the reference wrote are not read.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.models.sharding import is_dtensor


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in _flatten(node)]
    if isinstance(tree, nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    return [tree]


def _flatten_guided(like, sh) -> list:
    """The leaves of ``sh``, a tree shaped like ``like`` (None standing
    for a whole subtree of None), in `_flatten`'s order of ``like``; a
    module's node is a {name: leaf} dict over its ``state_dict()``."""
    if isinstance(like, dict):
        return [x for k in sorted(like)
                for x in _flatten_guided(like[k], None if sh is None
                                         else sh.get(k))]
    if isinstance(like, (list, tuple)):
        return [x for i, node in enumerate(like)
                for x in _flatten_guided(node, None if sh is None
                                         else sh[i])]
    if isinstance(like, nn.Module):
        return [None if sh is None else sh.get(k)
                for k in like.state_dict(keep_vars=True)]
    return [sh]


def _unflatten(like, leaves):
    """``like``'s structure over the iterator ``leaves``; a module is
    loaded in place: its tensors keep their identity, except that a
    DTensor leaf replaces its parameter (re-sharding onto a mesh)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(node, leaves) for node in like)
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for name, t in like.state_dict(keep_vars=True).items():
                new = next(leaves)
                if is_dtensor(new):
                    owner, _, leaf = name.rpartition(".")
                    module = like.get_submodule(owner) if owner else like
                    module._parameters[leaf] = nn.Parameter(
                        new, requires_grad=t.requires_grad)
                else:
                    t.copy_(new)
        return like
    return next(leaves)


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy(), "bfloat16"
    arr = leaf.numpy()
    return arr, str(arr.dtype)


def save(directory: str | Path, step: int, tree, *, host_id: int = 0,
         keep_n: int = 3, metadata: dict | None = None) -> Path:
    """Write a checkpoint; atomic LATEST commit; GC old steps.  With
    DTensor leaves every rank calls it (the gathers are collectives),
    only ``host_id`` 0 writes, and all return after the commit."""
    directory = Path(directory)
    final = directory / f"step_{step:09d}"
    leaves = _flatten(tree)
    sharded = any(is_dtensor(t) for t in leaves)
    if sharded:
        leaves = [t.full_tensor() if is_dtensor(t) else t for t in leaves]
    if host_id == 0 or not sharded:
        _write(directory, step, final, leaves, host_id, keep_n, metadata)
    if sharded:
        import torch.distributed as dist
        dist.barrier()
    return final


def _write(directory: Path, step: int, final: Path, leaves: list,
           host_id: int, keep_n: int, metadata: dict | None) -> None:
    tmp = directory / f".tmp_step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    index = []
    for i, leaf in enumerate(leaves):
        arr, dtype = _to_numpy(leaf)
        np.save(tmp / f"leaf_{i:05d}.npy", arr)
        index.append({"file": f"leaf_{i:05d}.npy",
                      "shape": list(arr.shape), "dtype": dtype})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "index": index,
        "time": time.time(),
        "host_id": host_id,
        "metadata": metadata or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    # atomic LATEST pointer
    latest_tmp = directory / ".LATEST.tmp"
    latest_tmp.write_text(str(step))
    os.rename(latest_tmp, directory / "LATEST")
    _gc(directory, keep_n)


def _gc(directory: Path, keep_n: int):
    steps = sorted(p for p in directory.glob("step_*") if p.is_dir())
    for p in steps[:-keep_n]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(directory: str | Path) -> int | None:
    latest = Path(directory) / "LATEST"
    if not latest.exists():
        return None
    return int(latest.read_text().strip())


def _load(path: Path, entry: dict) -> torch.Tensor:
    arr = np.load(path / entry["file"])
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if entry["dtype"] == "bfloat16" else t


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore(directory: str | Path, tree_like, *, step: int | None = None,
            device=None, shardings=None):
    """Load into the structure of ``tree_like``.  Returns (tree,
    metadata, step).

    Each tensor leaf goes to ``device``, or to its ``tree_like`` leaf's
    device when ``device`` is None; a module is loaded in place.
    ``shardings``: ``(mesh, placements)``, ``placements`` a tree shaped
    like ``tree_like`` (a module's node a {parameter name: placements}
    dict, None for a leaf or subtree to load plainly): the ELASTIC path,
    each leaf becomes a DTensor on ``mesh``, whatever mesh saved it.
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in "
                                    f"{directory}")
    d = directory / f"step_{step:09d}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves_like = _flatten(tree_like)
    if manifest["n_leaves"] != len(leaves_like):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"model expects {len(leaves_like)}")
    mesh, places = shardings if shardings is not None \
        else (None, None)
    places = _flatten_guided(tree_like, places)
    loaded = []
    for i, (entry, like, place) in enumerate(zip(manifest["index"],
                                                  leaves_like, places)):
        t = _load(d, entry)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: ckpt {tuple(t.shape)} vs model "
                             f"{tuple(like.shape)}")
        if place is not None:
            from torch.distributed.tensor import distribute_tensor
            t = distribute_tensor(t.to(_mesh_device(mesh)), mesh, place,
                                  src_data_rank=None)
        else:
            t = t.to(like.device if device is None else device)
        loaded.append(t)
    return _unflatten(tree_like, iter(loaded)), manifest["metadata"], step


class CheckpointManager:
    """Every-N-steps saving with keep_n retention."""

    def __init__(self, directory: str | Path, every: int = 100,
                 keep_n: int = 3):
        self.directory = Path(directory)
        self.every = every
        self.keep_n = keep_n

    def maybe_save(self, step: int, tree, metadata=None) -> bool:
        if step % self.every != 0:
            return False
        save(self.directory, step, tree, keep_n=self.keep_n,
             metadata=metadata)
        return True

    def restore_latest(self, tree_like, device=None, shardings=None):
        return restore(self.directory, tree_like, device=device,
                       shardings=shardings)
