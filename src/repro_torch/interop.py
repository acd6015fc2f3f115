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
  order (`unstack_layers`, and back with `stack_layers`);
* a port tree keyed by parameter name (parameters, gradients, optimizer
  moments, the 8-bit arm's {"q", "s"}) as the reference's nested,
  stacked tree (`lm_tree_to_numpy`) and back (`named_from_numpy`), and
  a reference optimizer state as the port's (`opt_state_from_numpy`).
  A 0-d leaf of a stacked tree is one value for the whole stack: the
  8-bit arm's fallback scale, which the reference keeps once per
  stacked leaf and the port in every member of the leaf's scale group.
"""
from __future__ import annotations

import numpy as np
import torch

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
    ``g * stride + j`` is ``stacked[j][...][g]``; a 0-d leaf goes to
    every layer of its position."""
    stride = len(stacked)
    first = stacked[0]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    return [_tree_map(lambda a, g=i // stride: a[g] if a.ndim else a,
                      stacked[i % stride])
            for i in range(stride * first.shape[0])]


def _stack_leaves(leaves: list):
    if leaves[0].ndim:
        return np.stack(leaves)
    for leaf in leaves[1:]:
        assert np.array_equal(leaf, leaves[0]), \
            "a 0-d leaf differs across the layers of one stack"
    return leaves[0]


def stack_layers(layers: list, stride: int) -> tuple:
    """The inverse of `unstack_layers`: per-layer trees (numpy leaves) in
    layer order as the reference's tuple over stride positions, each
    leaf stacked over groups; a 0-d leaf, equal in every layer of a
    position, stays one 0-d leaf."""
    assert len(layers) % stride == 0

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return _stack_leaves(nodes)

    return tuple(stack(layers[j::stride]) for j in range(stride))


def _leaf_to_numpy(t):
    """A tensor as numpy; bfloat16 as float32 (exact)."""
    if isinstance(t, dict):
        return {k: _leaf_to_numpy(v) for k, v in t.items()}
    if t.dtype == torch.bfloat16:
        t = t.float()
    return to_numpy(t)


def lm_tree_to_numpy(params: lm.LM, by_name: dict) -> dict:
    """A port tree keyed by ``params``' parameter names (``params``
    itself with ``dict(params.named_parameters())``, gradients, m, v,
    the 8-bit arm's {"q", "s"} leaves) as the reference's nested tree of
    numpy arrays, each `transformer.Stack` stacked by `stack_layers`."""
    tree: dict = {}
    for name, leaf in by_name.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = _leaf_to_numpy(leaf)
    for key, stack in params.named_children():
        if isinstance(stack, transformer.Stack):
            tree[key] = stack_layers(
                [tree[key][str(i)] for i in range(len(stack))],
                stack.stride)
    return tree


def named_from_numpy(params: lm.LM, tree: dict,
                     device=DEFAULT_DEVICE) -> dict:
    """A reference tree shaped like ``init_params``' (numpy leaves:
    gradients, m, v, {q, s}) as tensors keyed by ``params``' names; the
    inverse of `lm_tree_to_numpy`."""
    layers = {key: unstack_layers(node) for key, node in tree.items()
              if isinstance(params[key], transformer.Stack)}
    out = {}
    for name, _ in params.named_parameters():
        head, *path = name.split(".")
        node = layers[head][int(path.pop(0))] if head in layers \
            else tree[head]
        for key in path:
            node = node[key]
        out[name] = _tree_map(lambda a: to_torch(a, device), node)
    return out


def opt_state_from_numpy(params: lm.LM, state: dict,
                         device=DEFAULT_DEVICE) -> dict:
    """The reference's ``opt.init``/``init_8bit`` state (numpy leaves; a
    later step's too) as the port's, keyed by ``params``' names."""
    return {"m": named_from_numpy(params, state["m"], device),
            "v": named_from_numpy(params, state["v"], device),
            "step": to_torch(state["step"], device, torch.int32)}


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
            p[key] = transformer.Stack(
                (params_from_numpy(layer, device, transformer.Block)
                 for layer in unstack_layers(node)), stride=len(node))
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
