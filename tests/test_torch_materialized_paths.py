"""The materialized pipeline (``pipeline="materialized"``) end to end.

``plan(fmt, TraversalSpec(pipeline="materialized"))`` on the ``csr``
format (K2 + the apportioned stream + K7 + K1) and the ``sell`` format
(K8 over every slab group + K1) equals the reference's materialized
pipeline at its resolved tile, under the four policies: visited,
depths, layers, the whole stats buffer and the direction log bitwise;
trees pass both validators with depths equal to `bfs_serial`.  K7 on
its own is in ``test_torch_materialized.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import plan as ref_plan
from repro.api.spec import TraversalSpec as RefSpec
from repro.core import bfs_serial as ref_serial
from repro.core import engine as ref_engine
from repro.core.validate import validate as ref_validate
from repro.formats.sell import SellFormat as RefSell

from _torch_parity import (BUILDERS, POLICY_IDS, POLICY_PAIRS, ROOTS,
                           to_port, words_np)
import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.core.validate import validate as t_validate
from repro_torch.kernels import ops
from repro_torch.obs.metrics import clear_degrade_log, degrade_log

SIGMA = 1024
CASES = [("rmat9", f, p) for f in ("csr", "sell") for p in range(4)] + [
    ("disconnected", f, 3) for f in ("csr", "sell")]


@pytest.fixture(scope="module")
def graphs():
    return {name: BUILDERS[name]() for name in ("rmat9", "disconnected")}


@pytest.mark.parametrize("graph_name,fmt_name,policy_index", CASES,
                         ids=[f"{g}-{f}-{POLICY_IDS[p]}"
                              for g, f, p in CASES])
def test_materialized_matches_reference(graphs, graph_name, fmt_name,
                                        policy_index):
    g = graphs[graph_name]
    roots = ROOTS[graph_name][1]
    ref_pol, t_pol = POLICY_PAIRS[policy_index]
    ref_fmt = g if fmt_name == "csr" else RefSell.from_csr(g, sigma=SIGMA)
    ct = ref_plan.plan(ref_fmt, RefSpec(
        policy=ref_pol, algorithm="simd", pipeline="materialized",
        prefetch_depth=0, packed=True, max_layers=128))
    ref = ct.run_batched(np.asarray(roots, np.int32))
    gt = to_port(g)
    fmt = gt if fmt_name == "csr" \
        else formats.SellFormat.from_csr(gt, sigma=SIGMA)
    clear_degrade_log()
    before = dict(ops.KERNEL_LAUNCHES)
    got = tbfs.plan(fmt, tbfs.TraversalSpec(
        policy=t_pol, pipeline="materialized", tile=ct.resolved.tile,
        max_layers=128), device="cpu").run_batched(roots)
    assert not degrade_log()
    assert ops.KERNEL_LAUNCHES == before     # no CUDA launch on the CPU
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    assert int(got.state.layer) == int(ref.state.layer)
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)
    assert not got.stats[:, 6].any()         # nothing truncated
    parents = tbfs.parents_graph500(got.state, g.n_vertices).numpy()
    rows, cs = np.asarray(g.rows), np.asarray(g.colstarts)
    for b, root in enumerate(roots):
        _, depth = ref_serial.bfs_serial(rows, cs, g.n_vertices, root)
        assert t_validate(gt, torch.from_numpy(parents[b]), root,
                          reference_depth=depth).ok
        assert ref_validate(g, jnp.asarray(parents[b]), root,
                            reference_depth=depth).ok
