"""Crossing state between the reference and the port as numpy arrays.

Graphs and bitmaps built by either package travel as numpy arrays:

* numpy <-> torch with `to_torch` / `to_numpy`;
* 32-bit bitmap words as uint32 on the reference side and the same
  bits viewed as int32 here (`words_to_torch` / `words_to_numpy`);
* a CSR as its (rows, colstarts, n_vertices, n_edges) parts
  (`csr_from_arrays`);
* a traversal spec as the ``to_dict()`` dict both packages write
  (`spec_from_dict`);
* an LM's parameters and decode states as the reference's trees of
  numpy arrays (`lm_params_from_numpy`, `decode_state_from_numpy`).
  The reference stacks layers as a tuple over the moe_stride positions,
  each leaf (n_layers / stride, ...); the port keeps them in layer
  order (`unstack_layers`).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.api.spec import TraversalSpec
from repro_torch.core.csr import Csr
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models import common as cm, lm, transformer
from repro_torch.models.config import ModelConfig


def to_torch(arr, device=DEFAULT_DEVICE, dtype=None) -> torch.Tensor:
    """A numpy array (or array-like) as a tensor on ``device``; a
    bfloat16 array (ml_dtypes', as jax gives it) keeps its bits."""
    arr = np.array(arr, copy=True)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
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


# LM substrate ----------------------------------------------------------------

def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack_layers(stacked) -> list:
    """The reference's stacked layers (a tuple over stride positions j,
    each leaf (n_groups, ...)) as a list in layer order: layer
    ``g * stride + j`` is ``stacked[j][...][g]``."""
    stride = len(stacked)
    first = stacked[0]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_tree_map(lambda a, g=i // stride: a[g], stacked[i % stride])
            for i in range(stride * first.shape[0])]


def params_from_numpy(tree: dict, device=DEFAULT_DEVICE,
                      cls=cm.Params) -> cm.Params:
    """A reference parameter dict tree of numpy arrays as a ``cls``."""
    return cls(_tree_map(lambda a: to_torch(a, device), tree))


def lm_params_from_numpy(cfg: ModelConfig, tree: dict,
                         device=DEFAULT_DEVICE) -> lm.LM:
    """The reference's ``lm.init_params`` tree (numpy leaves) as a port
    `lm.LM` holding the same weights."""
    p = lm.LM()
    for key, node in tree.items():
        if key in ("layers", "encoder"):
            p[key] = nn.ModuleList(
                params_from_numpy(layer, device, transformer.Block)
                for layer in unstack_layers(node))
        else:
            p[key] = params_from_numpy(node, device)
    n_layers = cfg.n_layers + cfg.encoder_layers
    assert sum(len(p[k]) for k in ("layers", "encoder") if k in p) \
        == n_layers, f"{cfg.name}: the tree does not hold {n_layers} layers"
    return p


def decode_state_from_numpy(states, device=DEFAULT_DEVICE) -> list:
    """The reference's ``lm.init_decode_state`` layout (numpy leaves) as
    the port's per-layer list."""
    return [_tree_map(lambda a: to_torch(a, device), st)
            for st in unstack_layers(states)]
