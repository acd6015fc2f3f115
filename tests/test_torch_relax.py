"""K11 and K12, the semiring relax kernels, against the reference.

Layers are captured from the port's own CPU traversals of rmat9 (every
call of `ops.gather_relax_batched` / `ops.sell_relax_batched`, the
layer with the most listed blocks kept) for the three value types of
the portfolio: int32 with unit 1 (ksource_bfs), int32 with unit 0 (cc)
and float32 weighted (sssp).  On each, the plain version
(`gather_expand.gather_relax_plain`, `sell_expand.sell_relax_plain`)
must equal the reference's Pallas kernel (``gather_relax_batched``,
``sell_relax_batched``, interpret mode) bitwise: ``out_vals`` and
``p_layer``.  The dense case hands both the full work-list (the CC
endgame's arm).  The CUDA kernels rely on every value being >= 0 (or
+inf) and never NaN, so one int32 atomicMin orders both types; the
captured layers assert it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gather_expand as ref_ge
from repro.kernels import sell_expand as ref_se

from _torch_parity import (ROOTS, recorded_calls, rmat_graph, to_port,
                           words_np)
import repro_torch.bfs as tbfs
from repro_torch import formats
from repro_torch.algorithms import semiring as sr
from repro_torch.kernels import gather_expand as ge
from repro_torch.kernels import ops
from repro_torch.kernels import sell_expand as se
from repro_torch.kernels.layer_fused import compact_worklist

ALGORITHMS = ("ksource_bfs", "cc", "sssp")    # i32/1, i32/0, f32/weighted
CSR_TILE = 256       # several rows-blocks on rmat9
SELL_SPP = 2         # the port's auto slabs per group
CASES = [(a, f, d) for a in ALGORITHMS for f in ("csr", "sell")
         for d in (False, True)]


@pytest.fixture(scope="module")
def layers():
    """{(algorithm, format): (kind, captured args, kw, all calls)}."""
    g = to_port(rmat_graph())
    roots = ROOTS["rmat9"][1]
    sell = formats.SellFormat.from_csr(g, sigma=1024)
    out = {}
    for alg in ALGORITHMS:
        spec = dict(algorithm=alg, max_layers=512)
        for fmt_name, fmt, tile, plan_at in (
                ("csr", g, CSR_TILE, 0), ("sell", sell, SELL_SPP, 1)):
            name = ("gather_relax_batched" if fmt_name == "csr"
                    else "sell_relax_batched")
            with recorded_calls(ops, name) as calls:
                tbfs.plan(fmt, tbfs.TraversalSpec(tile=tile, **spec),
                          device="cpu").run_batched(roots)
            best = max(calls, key=lambda c: int(c[0][plan_at].na.sum()))
            out[(alg, fmt_name)] = best, calls
    return out


def _jnp(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("algorithm,fmt_name,dense", CASES,
                         ids=[f"{a}-{f}-{'dense' if d else 'planned'}"
                              for a, f, d in CASES])
def test_relax_plain_equals_the_reference_kernel(layers, algorithm,
                                                 fmt_name, dense):
    (args, kw, _), _ = layers[(algorithm, fmt_name)]
    semiring = sr.get(algorithm)
    assert (kw["unit"], kw["weighted"]) == (semiring.unit,
                                            semiring.weighted)
    if fmt_name == "csr":
        plan, rows, colstarts, frontier, vals = args
        n_list, n = plan.ulist.shape[0], kw["n_vertices"]
    else:
        graph, plan, frontier, vals = args
        n_list, n = graph.n_steps, graph.n_vertices
    # the reference takes the per-root lists the plan folds
    wl, na = compact_worklist(plan.listed(), n_list)
    if dense:      # every block / group, for every root
        wl = torch.arange(n_list, dtype=torch.int32) \
            .expand(wl.shape[0], -1).contiguous()
        na = torch.full_like(na, n_list)
        plan = ge.UnionPlan.of_lists(wl, na, n_list)
    assert int(na.sum()) > 0
    if fmt_name == "csr":
        got = ge.gather_relax_plain(plan, rows, colstarts, frontier, vals,
                                    **kw)
        want = ref_ge.gather_relax_batched(
            _jnp(wl), _jnp(na), _jnp(rows), _jnp(colstarts),
            jnp.asarray(words_np(frontier)), _jnp(vals), **kw,
            interpret=True)
    else:
        got = se.sell_relax_plain(graph, plan, frontier, vals,
                                  unit=kw["unit"], weighted=kw["weighted"])
        want = ref_se.sell_relax_batched(
            _jnp(graph.cols), _jnp(graph.slab_rows), _jnp(wl), _jnp(na),
            jnp.asarray(words_np(frontier)), _jnp(vals),
            n_vertices=graph.n_vertices, slabs_per_step=graph.spp,
            unit=kw["unit"], weighted=kw["weighted"], interpret=True)
    out_vals, p_layer = got
    assert out_vals.dtype == vals.dtype
    np.testing.assert_array_equal(out_vals.numpy().view(np.int32),
                                  np.asarray(want[0]).view(np.int32))
    np.testing.assert_array_equal(p_layer.numpy(), np.asarray(want[1]))
    improved = out_vals < vals
    assert bool(improved.any())
    assert bool((p_layer[improved] < n).all())
    assert bool((p_layer[~improved] == ge.P_UNSET).all())


@pytest.mark.parametrize("algorithm", ALGORITHMS)
def test_values_are_nonnegative_and_never_nan(layers, algorithm):
    """The invariant the CUDA kernels' int32 atomicMin on float bits
    rests on: every value in and out of every layer is >= +0.0 (or
    +inf), never NaN or -0.0."""
    for fmt_name in ("csr", "sell"):
        _, calls = layers[(algorithm, fmt_name)]
        vals_arg = 4 if fmt_name == "csr" else 3
        for args, _, (out_vals, _) in calls:
            for t in (args[vals_arg], out_vals):
                assert bool((t >= 0).all())     # NaN fails this too
                if t.is_floating_point():       # no -0.0 bit pattern
                    assert bool((t.view(torch.int32) >= 0).all())


def test_wrappers_charge_one_launch_and_no_cuda_launch_on_cpu(layers):
    (args, kw, _), _ = layers[("sssp", "csr")]
    (sargs, skw, _), _ = layers[("sssp", "sell")]
    before = dict(ops.KERNEL_LAUNCHES)
    with ops.count_launches() as c:
        a = ops.gather_relax_batched(*args, **kw)
    assert c.count == 1
    with ops.count_launches() as c:
        b = ops.sell_relax_batched(*sargs, **skw)
    assert c.count == 1
    assert ops.KERNEL_LAUNCHES == before
    want_a = ge.gather_relax_plain(*args, **kw)
    want_b = se.sell_relax_plain(*sargs, **skw)
    for got, want in ((a, want_a), (b, want_b)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cuda_wrappers_refuse_bad_arguments(layers):
    """The checks run before anything touches the card."""
    (args, kw, _), _ = layers[("cc", "csr")]
    plan, rows, colstarts, frontier, vals = args
    with pytest.raises(ValueError, match="int32 or float32"):
        ge.gather_relax_cuda(plan, rows, colstarts, frontier,
                             vals.to(torch.int64), **kw)
    with pytest.raises(ValueError, match="weighted needs float32"):
        ge.gather_relax_cuda(plan, rows, colstarts, frontier, vals,
                             n_vertices=kw["n_vertices"], tile=kw["tile"],
                             weighted=True)
    with pytest.raises(ValueError, match="frontier has shape"):
        ge.gather_relax_cuda(plan, rows, colstarts, frontier[:1], vals,
                             **kw)
    (sargs, skw, _), _ = layers[("cc", "sell")]
    graph, splan, sfr, svals = sargs
    with pytest.raises(ValueError, match="plan.ulist has shape"):
        se.sell_relax_cuda(graph, splan._replace(
            ulist=splan.ulist[:1].contiguous()), sfr, svals, **skw)
