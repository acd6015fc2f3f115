"""K7, the expansion of the materialized pipeline.

K7, the expansion over an apportioned (nbr, cand, valid) stream, is
held to K3's contract against the reference's ``frontier_expand_batched``
(interpret mode) on streams captured from the port's own rmat9
traversal and on a synthetic stream (``valid`` not a prefix of a row,
a slot count that is not a multiple of 16, a hub run longer than the
kernel's 16-slot chunk), top-down and bottom-up: after restoration
``out``, ``visited`` and the marked set are bitwise equal, and every
mark names the ``nbr`` of a valid slot offering that vertex (a frontier
vertex, bottom-up).  Parents race in both and are not compared bitwise.
The ``cuda`` twins hold the kernel to its plain version on the same
contract, with 16-byte-aligned streams (its chunked path) and offset
ones (its scalar path).  The pipeline end to end is in
``test_torch_materialized_paths.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import frontier_expand as ref_fe

from _torch_parity import (ROOTS, cuda_device, recorded_calls,  # noqa: F401
                           rmat_graph, to_port, words_np)
import repro_torch.bfs as tbfs
from repro_torch.kernels import frontier_expand as fe
from repro_torch.kernels import ops
from repro_torch.kernels.restoration import restoration_plain

REF_TILE = 1024     # the reference's stream tile (a multiple pads it)
SYN_VERTICES = 2000
SYN_SLOTS = 16 * 37 + 7   # not a multiple of the kernel's 16-slot chunk
HUB_RUN = 40              # one owner's run, longer than a chunk


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


def _pack(dense):
    """(B, n) bool -> (B, n / 32) int32 words, bit i of word w vertex
    32 w + i."""
    n_batch = dense.shape[0]
    words = (dense.reshape(n_batch, -1, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)
    return torch.from_numpy(words.view(np.int32))


def synthetic_stream(check_frontier: bool, n_batch: int = 3, seed: int = 0):
    """K7's inputs on a stream made from a seed: each root's slots in
    runs of one owner (nbr top-down, cand bottom-up), the first run
    `HUB_RUN` long and starting mid-chunk, the other side random; about
    70% of the slots valid, at random (not a prefix), the last 3 valid;
    `SYN_SLOTS` slots.  Top-down owners are frontier vertices."""
    rng = np.random.default_rng(seed + 7 * check_frontier)
    n, n_slots = SYN_VERTICES, SYN_SLOTS
    v_pad = -(-n // 32) * 32
    owner = np.empty((n_batch, n_slots), np.int32)
    for b in range(n_batch):
        lens = np.concatenate([[5, HUB_RUN], rng.integers(1, 21, n_slots)])
        owner[b] = np.repeat(rng.integers(0, n, lens.size), lens)[:n_slots]
    other = rng.integers(0, n, (n_batch, n_slots)).astype(np.int32)
    valid = rng.random((n_batch, n_slots)) < 0.7
    valid[:, -3:] = True
    dense_f = np.zeros((n_batch, v_pad), bool)
    dense_f[:, :n] = rng.random((n_batch, n)) < 0.15
    if not check_frontier:
        np.put_along_axis(dense_f, owner.astype(np.int64), True, 1)
    dense_v = dense_f | (rng.random((n_batch, v_pad)) < 0.3)
    dense_v[:, n:] = True                       # padding premarked
    nbr, cand = (other, owner) if check_frontier else (owner, other)
    frontier = _pack(dense_f)
    return dict(nbr=torch.from_numpy(nbr), cand=torch.from_numpy(cand),
                valid=torch.from_numpy(valid), frontier=frontier,
                visited=_pack(dense_v), out=torch.zeros_like(frontier),
                p=torch.full((n_batch, v_pad), n, dtype=torch.int32),
                n_vertices=n, check_frontier=check_frontier)


def _stream(streams, kind, check_frontier):
    return streams[check_frontier] if kind == "captured" \
        else synthetic_stream(check_frontier)


def _contract(s, got, want):
    """K3's contract between two arms' (out, p) on stream ``s``: the
    marked sets, ``out|delta`` and ``visited|delta`` bitwise."""
    n = s["n_vertices"]
    (out, p), (out_w, p_w) = got, want
    _, delta = restoration_plain(p, n)
    _, delta_w = restoration_plain(p_w, n)
    assert torch.equal(p < 0, p_w < 0), "the marked sets differ"
    assert torch.equal(out | delta, out_w | delta_w)
    assert torch.equal(s["visited"] | delta, s["visited"] | delta_w)
    assert int((p < 0).sum()) > 0


def _against_reference(s, check_frontier):
    """K7's plain version against the reference's on stream ``s``:
    `_contract`, and every mark names a valid slot's nbr offering that
    vertex (bottom-up, a frontier vertex)."""
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
    _contract(s, (out, p), (torch.from_numpy(np.array(out_r).view(np.int32)),
                            torch.from_numpy(np.array(p_r))))
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


@pytest.mark.parametrize("check_frontier", (False, True),
                         ids=("topdown", "bottomup"))
def test_k7_plain_meets_k3_contract_against_reference(streams,
                                                      check_frontier):
    _against_reference(streams[check_frontier], check_frontier)


@pytest.mark.parametrize("check_frontier", (False, True),
                         ids=("topdown", "bottomup"))
def test_k7_plain_on_a_synthetic_stream_meets_k3_contract(check_frontier):
    _against_reference(synthetic_stream(check_frontier), check_frontier)


def test_synthetic_stream_has_what_the_kernel_must_not_assume():
    """``valid`` is no prefix of a row, the slot count no multiple of 16,
    and an owner's run is longer than a chunk."""
    for check_frontier in (False, True):
        s = synthetic_stream(check_frontier)
        valid = s["valid"]
        first_gap = (~valid).int().argmax(1)
        assert bool((valid.int().cumsum(1)[:, -1] > first_gap).all())
        assert s["cand"].shape[1] % 16
        owner = s["cand" if check_frontier else "nbr"]
        assert bool((owner[:, 5:5 + HUB_RUN] == owner[:, 5:6]).all())


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


def _on_card(s, device, aligned: bool):
    """Stream ``s`` on the card; with ``aligned`` False its nbr, cand and
    valid start 4 (valid: 1) bytes past a 16-byte boundary, so the
    kernel takes its scalar path."""
    out = dict(s)
    for k in ("nbr", "cand", "valid", "frontier", "visited", "out", "p"):
        t = s[k].to(device)
        if not aligned and k in ("nbr", "cand", "valid"):
            flat = torch.empty((t.numel() + 1,), dtype=t.dtype, device=device)
            t = flat[1:].view(t.shape).copy_(t)
            assert t.data_ptr() % 16 != 0
        out[k] = t
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", (True, False), ids=("chunked", "scalar"))
@pytest.mark.parametrize("kind", ("captured", "synthetic"))
@pytest.mark.parametrize("check_frontier", (False, True),
                         ids=("topdown", "bottomup"))
def test_cuda_k7_matches_plain(cuda_device, streams, kind, check_frontier,
                               aligned):
    s = _stream(streams, kind, check_frontier)
    kw = dict(n_vertices=s["n_vertices"], check_frontier=check_frontier)
    names = ("nbr", "cand", "valid", "frontier", "visited")
    out, p = s["out"].clone(), s["p"].clone()
    fe.frontier_expand_plain(*(s[k] for k in names), out, p, **kw)
    d = _on_card(s, cuda_device, aligned)
    fe.frontier_expand_cuda(*(d[k] for k in names), d["out"], d["p"], **kw)
    _contract(s, (d["out"].cpu(), d["p"].cpu()), (out, p))
