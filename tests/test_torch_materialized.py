"""K7, the expansion of the materialized pipeline.

K7, the expansion over an apportioned (nbr, cand, valid) stream, is
held to K3's contract against the reference's ``frontier_expand_batched``
(interpret mode) on streams captured from the port's own rmat9
traversal, top-down and bottom-up: after restoration ``out``,
``visited`` and the marked set are bitwise equal, and every mark names
the ``nbr`` of a valid slot offering that vertex (a frontier vertex,
bottom-up).  Parents race in both and are not compared bitwise.  The
pipeline end to end is in ``test_torch_materialized_paths.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import frontier_expand as ref_fe

from _torch_parity import ROOTS, recorded_calls, rmat_graph, to_port, words_np
import repro_torch.bfs as tbfs
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import ops
from repro_torch.kernels.restoration import restoration_plain

REF_TILE = 1024     # the reference's stream tile (a multiple pads it)


@pytest.fixture(scope="module")
def streams():
    """K7's inputs on the port's materialized BeamerHybrid traversal of
    rmat9: {check_frontier: the call with the most valid slots}."""
    with recorded_calls(ops, "expand_batched") as recorded:
        tbfs.plan(to_port(rmat_graph()), tbfs.TraversalSpec(
            policy=tbfs.BeamerHybrid(), pipeline="materialized"),
            device="cpu").run_batched(ROOTS["rmat9"][1])
    names = ("nbr", "cand", "valid", "frontier", "visited", "out", "p")
    best = {}
    for args, kw, _ in recorded:
        c = dict(zip(names, args), **kw)
        key = c["check_frontier"]
        if key not in best or c["valid"].sum() > best[key]["valid"].sum():
            best[key] = c
    assert set(best) == {False, True}, "need top-down and bottom-up"
    return best


def _pad(t, width):
    pad = width - t.shape[1]
    return np.concatenate([t, np.zeros((t.shape[0], pad), t.dtype)], 1)


@pytest.mark.parametrize("check_frontier", (False, True),
                         ids=("topdown", "bottomup"))
def test_k7_plain_meets_k3_contract_against_reference(streams,
                                                      check_frontier):
    s = streams[check_frontier]
    n = s["n_vertices"]
    out, p = s["out"].clone(), s["p"].clone()
    fe.frontier_expand_plain(s["nbr"], s["cand"], s["valid"],
                             s["frontier"], s["visited"], out, p,
                             n_vertices=n, check_frontier=check_frontier)
    n_slots = s["cand"].shape[1]
    width = -(-n_slots // REF_TILE) * REF_TILE
    out_r, p_r = ref_fe.frontier_expand_batched(
        *(jnp.asarray(_pad(s[k].to(torch.int32).numpy(), width))
          for k in ("nbr", "cand", "valid")),
        *(jnp.asarray(words_np(s[k])) for k in ("frontier", "visited",
                                                  "out")),
        jnp.asarray(s["p"].numpy()), n_vertices=n, tile=REF_TILE,
        check_frontier=check_frontier, interpret=True)
    p_r = torch.from_numpy(np.array(p_r))
    out_r = torch.from_numpy(np.array(out_r).view(np.int32))
    _, delta = restoration_plain(p, n)
    _, delta_r = restoration_plain(p_r, n)
    assert torch.equal(p < 0, p_r < 0), "the marked sets differ"
    assert torch.equal(out | delta, out_r | delta_r)
    assert torch.equal(s["visited"] | delta, s["visited"] | delta_r)
    assert int((p < 0).sum()) > 0
    # every mark names a valid slot's nbr offering that vertex
    for b in range(p.shape[0]):
        marked = torch.nonzero(p[b] < 0).flatten()
        gate = p[b, marked] + n
        ok = s["valid"][b] != 0
        offered = set(zip(s["cand"][b][ok].tolist(),
                          s["nbr"][b][ok].tolist()))
        assert all((c, g) in offered
                   for c, g in zip(marked.tolist(), gate.tolist()))
        if check_frontier:
            fw = s["frontier"][b, gate >> 5]
            assert bool((((fw >> (gate & 31)) & 1) == 1).all())


def test_single_root_expand_is_the_batched_call(streams):
    """K7 at B = 1 (`ops.expand`) meets the batched call's contract row
    by row: the same marked set and the same repaired ``out`` (which
    duplicate discovery survives in P is unspecified in either)."""
    s = streams[True]
    n = s["n_vertices"]
    out, p = s["out"].clone(), s["p"].clone()
    ops.expand_batched(s["nbr"], s["cand"], s["valid"], s["frontier"],
                       s["visited"], out, p, n_vertices=n,
                       check_frontier=True)
    _, delta = restoration_plain(p, n)
    for b in range(p.shape[0]):
        o1, p1 = s["out"][b].clone(), s["p"][b].clone()
        with ops.count_launches() as c:
            ops.expand(s["nbr"][b], s["cand"][b], s["valid"][b],
                       s["frontier"][b], s["visited"][b], o1, p1,
                       n_vertices=n, check_frontier=True)
        assert c.count == 1
        _, delta1 = restoration_plain(p1, n)
        assert torch.equal(p1 < 0, p[b] < 0)
        assert torch.equal(o1 | delta1, out[b] | delta[b])


def test_cuda_wrapper_refuses_bad_arguments(streams):
    s = streams[False]
    with pytest.raises(ValueError, match="cand must be a contiguous"):
        fe.frontier_expand_cuda(s["nbr"], s["cand"].to(torch.int64),
                                s["valid"], s["frontier"], s["visited"],
                                s["out"].clone(), s["p"].clone(),
                                n_vertices=s["n_vertices"])
