"""`launch/inputs.py` against the reference: the meta-device specs equal
the reference's ``ShapeDtypeStruct`` shapes and dtypes for every (arch,
shape) cell the registry runs, at full size; `concrete_batch` meets
its contract (it draws from a `torch.Generator`, not ``jax.random``).

The port keeps decode states per layer and parameters unstacked, so
each of their leaves is held to the reference's stacked leaf minus its
leading layer axis (layer i at stride position i % stride).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.launch import inputs as ref_inputs

from repro_torch.configs import registry
from repro_torch.launch import inputs

CELLS = [(cfg.name, shape.name)
         for cfg, shape, status in registry.all_cells() if status == "run"]
ARCHS = sorted(registry.ARCHS)


def test_cells_match_reference():
    assert CELLS == [(c.name, s.name) for c, s, status
                     in ref_registry.all_cells() if status == "run"]


def sig(x) -> tuple:
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    name = str(x.dtype).removeprefix("torch.")
    return tuple(x.shape), name


def unstacked(x) -> tuple:
    """A stacked reference leaf's signature minus the layer axis."""
    shape, dtype = sig(x)
    return shape[1:], dtype


def flat(tree) -> list:
    if isinstance(tree, dict):
        return [(f"{k}.{p}" if p else k, v) for k in sorted(tree)
                for p, v in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [(f"{i}.{p}" if p else str(i), v)
                for i, node in enumerate(tree) for p, v in flat(node)]
    return [("", tree)]


@functools.lru_cache(maxsize=None)
def ref_params(name: str):
    return ref_inputs.params_specs(ref_registry.ARCHS[name])


@pytest.mark.parametrize("arch,shape", CELLS)
def test_train_batch_specs(arch, shape):
    want = ref_inputs.train_batch_specs(ref_registry.ARCHS[arch],
                                        ref_registry.SHAPES[shape])
    got = inputs.train_batch_specs(registry.ARCHS[arch],
                                   registry.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].device.type == "meta"
        assert sig(got[k]) == sig(want[k]), (k, sig(got[k]), sig(want[k]))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_decode_input_specs(arch, shape):
    cfg = registry.ARCHS[arch]
    want = ref_inputs.decode_input_specs(ref_registry.ARCHS[arch],
                                         ref_registry.SHAPES[shape])
    got = inputs.decode_input_specs(cfg, registry.SHAPES[shape])
    assert sorted(got) == sorted(want)
    for k in ("tokens", "position", "memory"):
        if k in want:
            assert sig(got[k]) == sig(want[k]), k
    states = want["states"]
    assert len(got["states"]) == cfg.n_layers
    for i, layer in enumerate(got["states"]):
        ref = states[i % len(states)]
        want_leaves = dict(flat(ref))
        got_leaves = dict(flat(layer))
        assert sorted(got_leaves) == sorted(want_leaves), i
        for k, leaf in got_leaves.items():
            assert leaf.device.type == "meta"
            assert sig(leaf) == unstacked(want_leaves[k]), (i, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs(arch):
    want = ref_params(arch)
    got = inputs.params_specs(registry.ARCHS[arch])
    names = set()
    for name, p in got.named_parameters():
        head, *rest = name.split(".")
        node = want[head]
        stacked = head in ("layers", "encoder")
        if stacked:
            i = int(rest.pop(0))
            node = node[i % len(node)]
        for key in rest:
            node = node[key]
        assert p.device.type == "meta"
        assert sig(p) == (unstacked(node) if stacked else sig(node)), name
        names.add(name)
    n_ref = sum(np.prod(x.shape) for x in jax.tree.leaves(want))
    assert sum(p.numel() for p in got.parameters()) == n_ref
    assert len(names) == len(list(got.parameters()))


@pytest.mark.parametrize("arch", ARCHS)
def test_concrete_batch_contract(arch):
    cfg = registry.ARCHS[arch].reduced()
    b, t = 3, 40
    got = inputs.concrete_batch(cfg, 7, b, t, device="cpu")
    want = ref_inputs.concrete_batch(ref_registry.ARCHS[arch].reduced(),
                                     jax.random.PRNGKey(7), b, t)
    assert sorted(got) == sorted(want)
    for k in want:
        assert sig(got[k]) == sig(want[k]), k
    tok, lab = got["tokens"], got["labels"]
    assert int(tok.min()) >= 0 and int(tok.max()) < cfg.vocab_size
    assert torch.equal(tok[:, 1:], lab[:, :-1])      # labels shift by one
    for k in ("prefix", "src_embeddings"):
        if k in got:
            x = got[k]
            assert x.shape[1] == (cfg.prefix_len if k == "prefix"
                                  else inputs._frames(t))
            assert abs(float(x.std()) - 0.02) < 0.002, (k, float(x.std()))
            assert abs(float(x.mean())) < 0.002
    again = inputs.concrete_batch(cfg, torch.Generator().manual_seed(7),
                                  b, t, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)
    assert all(x.device.type == "cpu" for x in got.values())


def test_concrete_batch_long_stub_frames():
    cfg = registry.get("seamless", reduced=True)
    got = inputs.concrete_batch(cfg, 0, 2, 12, device="cpu")
    assert got["src_embeddings"].shape == (2, 8, cfg.d_model)  # >= 8


def test_concrete_batch_defaults_to_the_card():
    """Like every entry point, the batch lands on the card unless the
    caller asks for the CPU; with no card that default raises."""
    cfg = registry.get("qwen3", reduced=True)
    if torch.cuda.is_available():
        got = inputs.concrete_batch(cfg, 0, 2, 8)
        assert all(x.is_cuda for x in got.values())
    else:
        with pytest.raises(RuntimeError, match="device='cuda'"):
            inputs.concrete_batch(cfg, 0, 2, 8)
