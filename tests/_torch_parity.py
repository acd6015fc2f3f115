"""Shared fixtures of the port's parity tests (``tests/test_torch_*``).

Graphs are built once by the JAX reference and handed to the port as
numpy arrays; both packages then run the same configuration.  The
reference always runs its ``fused_gather`` path explicitly
(``pipeline="fused_gather", prefetch_depth=0, packed=True,
algorithm="simd"``): its auto pipeline reads benchmark rows that pick
kernels this container's jax cannot run.  The port gets the
reference's resolved tile, because off a TPU the reference floors the
tile at ``e_pad // 32``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as ref_plan
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import csr as ref_csr
from repro.core import engine as ref_engine
from repro.core import rmat as ref_rmat
from repro.core.rmat import EdgeList

import repro_torch.bfs as tbfs
from repro_torch import interop


def csr_from_pairs(pairs, n):
    src = jnp.asarray([a for a, b in pairs] + [b for a, b in pairs],
                      jnp.int32)
    dst = jnp.asarray([b for a, b in pairs] + [a for a, b in pairs],
                      jnp.int32)
    return ref_csr.from_edges(EdgeList(src, dst, n))


def star_graph(n=128):
    """Hub 0 <-> 1..n-1: maximal §3.3.2 word collisions."""
    return csr_from_pairs([(0, i) for i in range(1, n)], n)


def path_graph(n=96):
    """A chain: one vertex per layer."""
    return csr_from_pairs([(i, i + 1) for i in range(n - 1)], n)


def disconnected_graph(n=128):
    """A star [0, n/2) and a path [n/2, n)."""
    half = n // 2
    pairs = [(0, i) for i in range(1, half)]
    pairs += [(i, i + 1) for i in range(half, n - 1)]
    return csr_from_pairs(pairs, n)


def rmat_graph(scale=9, seed=3):
    return ref_csr.from_edges(
        ref_rmat.generate(jax.random.PRNGKey(seed), scale=scale,
                          edgefactor=16))


#: (single root, batch of 4) per graph family
ROOTS = {
    "rmat9": (17, [3, 7, 11, 100]),
    "star": (0, [0, 5, 17, 127]),
    "path": (0, [0, 5, 47, 95]),
    "disconnected": (0, [0, 64, 1, 127]),
}
BUILDERS = {"rmat9": rmat_graph, "star": star_graph, "path": path_graph,
            "disconnected": disconnected_graph}

#: (reference policy, port policy) pairs, the reference's test set
POLICY_PAIRS = [
    (ref_engine.TopDown(), tbfs.TopDown()),
    (ref_engine.ThresholdSimd(2048), tbfs.ThresholdSimd(2048)),
    (ref_engine.PaperLiteralLayers((1, 2)), tbfs.PaperLiteralLayers((1, 2))),
    (ref_engine.BeamerHybrid(), tbfs.BeamerHybrid()),
]
POLICY_IDS = [type(p).__name__ for p, _ in POLICY_PAIRS]


def to_port(csr):
    """A reference `Csr` as the port's CPU `Csr`."""
    return interop.csr_from_arrays(np.asarray(csr.rows),
                                   np.asarray(csr.colstarts),
                                   csr.n_vertices, csr.n_edges,
                                   device="cpu")


def ref_spec(policy, max_layers=128, algorithm="simd"):
    return RefSpec(policy=policy, algorithm=algorithm,
                   pipeline="fused_gather", prefetch_depth=0, packed=True,
                   max_layers=max_layers)


def run_reference(csr, policy, roots, max_layers=128, algorithm="simd"):
    """(compiled traversal, result) of the reference's fused_gather path."""
    ct = ref_plan.plan(csr, ref_spec(policy, max_layers, algorithm))
    return ct, ct.run_batched(np.asarray(roots, np.int32))


def run_port(csr_t, policy, roots, tile, max_layers=128,
             algorithm="simd"):
    spec = tbfs.TraversalSpec(policy=policy, tile=tile,
                              max_layers=max_layers, algorithm=algorithm)
    return tbfs.plan(csr_t, spec, device="cpu").run_batched(roots)


def words_np(t: torch.Tensor) -> np.ndarray:
    return interop.words_to_numpy(t)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def check_slice(graphs, graph_name, policy_index, batched):
    """The slice end to end: the port's CPU path against the reference's
    fused_gather path on one graph, policy and root set.  Visited,
    depths, the whole stats buffer and the direction log must match
    bitwise; parents (whose racy tie-breaks are unspecified in both
    frameworks) must pass both validators against `bfs_serial`."""
    from repro.core import bfs_serial as ref_serial
    from repro.core.validate import validate as ref_validate
    from repro_torch.core.validate import validate as t_validate

    g = graphs[graph_name]
    gt = to_port(g)
    single, batch = ROOTS[graph_name]
    roots = batch if batched else [single]
    ref_pol, t_pol = POLICY_PAIRS[policy_index]
    ct, ref = run_reference(g, ref_pol, roots)
    got = run_port(gt, t_pol, roots, ct.resolved.tile)
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(words_np(got.state.frontier),
                                  np.asarray(ref.state.frontier))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    assert int(got.state.layer) == int(ref.state.layer)
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)
    parents = tbfs.parents_graph500(got.state, g.n_vertices).numpy()
    rows, cs = np.asarray(g.rows), np.asarray(g.colstarts)
    for b, root in enumerate(roots):
        _, depth = ref_serial.bfs_serial(rows, cs, g.n_vertices, root)
        assert t_validate(gt, torch.from_numpy(parents[b]), root,
                          reference_depth=depth).ok
        assert ref_validate(g, jnp.asarray(parents[b]), root,
                            reference_depth=depth).ok
