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

``restore(..., device=)`` takes the place of the reference's
``shardings=``; re-sharding onto a mesh comes with the port's sharding
slice.  Checkpoints the reference wrote are not read.
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


def _flatten(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for node in tree for x in _flatten(node)]
    if isinstance(tree, nn.Module):
        return list(tree.state_dict(keep_vars=True).values())
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure over the iterator ``leaves``; a module is
    loaded in place (its parameters keep their identity)."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(node, leaves) for node in like)
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for t in like.state_dict(keep_vars=True).values():
                t.copy_(next(leaves))
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
    """Write a checkpoint; atomic LATEST commit; GC old steps."""
    directory = Path(directory)
    tmp = directory / f".tmp_step_{step:09d}"
    final = directory / f"step_{step:09d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    leaves = _flatten(tree)
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
    return final


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


def restore(directory: str | Path, tree_like, *, step: int | None = None,
            device=None):
    """Load into the structure of ``tree_like``.  Returns (tree,
    metadata, step).

    Each tensor leaf goes to ``device``, or to its ``tree_like`` leaf's
    device when ``device`` is None; a module is loaded in place.
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
    loaded = []
    for i, (entry, like) in enumerate(zip(manifest["index"], leaves_like)):
        t = _load(d, entry)
        if tuple(t.shape) != tuple(like.shape):
            raise ValueError(f"leaf {i}: ckpt {tuple(t.shape)} vs model "
                             f"{tuple(like.shape)}")
        loaded.append(t.to(like.device if device is None else device))
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

    def restore_latest(self, tree_like, device=None):
        return restore(self.directory, tree_like, device=device)
