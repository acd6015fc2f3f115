"""Crossing state between the reference and the port as numpy arrays.

Graphs and bitmaps built by either package travel as numpy arrays:

* numpy <-> torch with `to_torch` / `to_numpy`;
* 32-bit bitmap words as uint32 on the reference side and the same
  bits viewed as int32 here (`words_to_torch` / `words_to_numpy`);
* a CSR as its (rows, colstarts, n_vertices, n_edges) parts
  (`csr_from_arrays`);
* a traversal spec as the ``to_dict()`` dict both packages write
  (`spec_from_dict`).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.spec import TraversalSpec
from repro_torch.core.csr import Csr
from repro_torch.device import DEFAULT_DEVICE, resolve_device


def to_torch(arr, device=DEFAULT_DEVICE, dtype=None) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor on ``device``."""
    t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(resolve_device(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def words_to_torch(words, device=DEFAULT_DEVICE) -> torch.Tensor:
    """uint32 bitmap words -> the same bits as an int32 tensor."""
    arr = np.ascontiguousarray(np.asarray(words, dtype=np.uint32))
    return to_torch(arr.view(np.int32), device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 bitmap words -> the same bits as a uint32 numpy array."""
    return to_numpy(words.to(torch.int32)).view(np.uint32)


def csr_from_arrays(rows, colstarts, n_vertices: int, n_edges: int,
                    device=DEFAULT_DEVICE) -> Csr:
    """A `Csr` from the reference CSR's parts as numpy arrays."""
    return Csr(rows=to_torch(rows, device, torch.int32),
               colstarts=to_torch(colstarts, device, torch.int32),
               n_vertices=int(n_vertices), n_edges=int(n_edges))


def spec_from_dict(d: dict) -> TraversalSpec:
    """Load a ``TraversalSpec.to_dict()`` dict from either package."""
    return TraversalSpec.from_dict(d)
