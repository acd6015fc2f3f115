"""The measure kernel (K13 redesigned) against the reference.

`ops.measure`'s plain arm (`bitmap_kernels.measure_plain`) must give the
reference's per-root counters — `engine.row_popcounts` and vmapped
`bitmap.masked_degree_sum`, on the frontier and on ``~visited`` — and
K13's total (the Pallas ``popcount`` in interpret mode), with batch sums
the float32 of the exact int64 sums; with a layer log, the host loop's
stats row, depths and, for the four registered policies, the decision
the policy objects take.  End to end the port's host loop, which now
measures and decides in one call, keeps the reference's stats buffers,
depths, visited sets and direction logs for all four policies on
rmat8/rmat9, at a layer cap that cuts the search too.  The ``cuda``
twins hold the CUDA arm to the plain one (bitwise) on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as ref_bm
from repro.core import engine as ref_engine
from repro.kernels import bitmap_kernels as ref_bk

from _torch_parity import (POLICY_IDS, POLICY_PAIRS, cuda_device,  # noqa: F401
                           rmat_graph, run_port, run_reference, to_port,
                           words_np)
import repro_torch.bfs as tbfs
from repro_torch import interop
from repro_torch.core import engine as t_engine
from repro_torch.kernels import bitmap_kernels as t_bk
from repro_torch.kernels import ops
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

#: (roots, words): one root, a word count that is not a multiple of 4,
#: the main path's batch and two root-mask words
SHAPES = [(1, 1), (3, 7), (8, 64), (33, 300)]


def _inputs(n_batch, n_words, seed=0):
    """Random frontier and visited words (sign bits included) and a
    random (32 W,) degree array, from numpy."""
    rng = np.random.default_rng(seed + 97 * n_batch + n_words)
    frontier = (rng.integers(0, 2**32, (n_batch, n_words), dtype=np.uint64)
                & rng.integers(0, 2**32, (n_batch, n_words),
                               dtype=np.uint64)).astype(np.uint32)
    visited = rng.integers(0, 2**32, (n_batch, n_words),
                           dtype=np.uint64).astype(np.uint32)
    deg = rng.integers(0, 5000, (32 * n_words,)).astype(np.int32)
    return frontier, visited, deg


def _reference_counters(words, deg):
    """Per-root (count, degree sum) by the reference's own functions."""
    deg_mat = ref_bm.degree_matrix(jnp.asarray(deg), deg.shape[0])
    count = ref_engine.row_popcounts(jnp.asarray(words))
    edges = jax.vmap(lambda w: ref_bm.masked_degree_sum(w, deg_mat))(
        jnp.asarray(words))
    return np.asarray(count), np.asarray(edges)


def _port(frontier, visited, deg):
    return (interop.words_to_torch(frontier, "cpu"),
            interop.words_to_torch(visited, "cpu"), torch.from_numpy(deg))


@pytest.mark.parametrize("n_batch,n_words", SHAPES)
def test_measure_plain_matches_reference(n_batch, n_words):
    frontier, visited, deg = _inputs(n_batch, n_words)
    f_count, f_edges = _reference_counters(frontier, deg)
    u_count, u_edges = _reference_counters(~visited, deg)
    total = ref_bk.popcount(jnp.asarray(frontier.reshape(-1)),
                            interpret=True)
    c = ops.measure(*_port(frontier, visited, deg))
    want = np.stack([f_count, f_edges, u_count, u_edges], axis=1)
    np.testing.assert_array_equal(c.per_root.numpy(), want)
    assert c.per_root.dtype == torch.int32 and c.total.shape == ()
    assert int(c.total) == int(total)
    exact = want.astype(np.int64).sum(axis=0).astype(np.float32)
    np.testing.assert_array_equal(c.sums.numpy(), exact)


@pytest.mark.parametrize("n_batch,n_words", SHAPES)
def test_count_only_arm_matches_reference(n_batch, n_words):
    """Without degrees: per-root counts only; `ops.popcount` is this
    arm."""
    frontier, _, _ = _inputs(n_batch, n_words)
    f_count, _ = _reference_counters(frontier, np.zeros(32 * n_words,
                                                        np.int32))
    words = interop.words_to_torch(frontier, "cpu")
    c = ops.measure(words)
    np.testing.assert_array_equal(c.per_root[:, 0].numpy(), f_count)
    assert not c.per_root[:, 1:].any()
    total = ref_bk.popcount(jnp.asarray(frontier.reshape(-1)),
                            interpret=True)
    assert int(ops.popcount(words)) == int(total) == int(c.total)


def _codes(n_batch, n_words, max_layers):
    v = 32 * n_words - 40
    return [t_engine.policy_code(p, v, n_batch, max_layers)
            for _, p in POLICY_PAIRS]


@pytest.mark.parametrize("bottom_up", [False, True])
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
@pytest.mark.parametrize("n_batch,n_words", SHAPES[1:])
def test_measure_log_decides_like_the_policy(n_batch, n_words, policy_index,
                                             bottom_up):
    """With a log the measure writes stats columns 0, 1, 4 (and the
    previous row's 2), adds to the depths and decides as the policy
    object does on the measure's `Workload`."""
    frontier, visited, deg = _inputs(n_batch, n_words, seed=policy_index)
    f, vis, d = _port(frontier, visited, deg)
    f[0] = 0                                   # one root with no frontier
    policy = POLICY_PAIRS[policy_index][1]
    v = 32 * n_words - 40
    layer, max_layers = 1, 4
    code = t_engine.policy_code(policy, v, n_batch, max_layers)
    log = t_bk.new_log(n_batch, max_layers, code, "cpu")
    log.ctrl[2] = int(bottom_up)
    c = ops.measure(f, vis if policy.needs_unvisited else None, d, log=log,
                    layer=layer)
    w = t_engine.Workload(layer, *c.sums, v, torch.tensor(bottom_up),
                          n_roots=n_batch)
    mode, next_bu = policy.decide(w)
    row = log.stats[layer].tolist()
    assert row[0] == int(c.total) and row[1] == int(
        c.per_root[:, 1].to(torch.int64).sum())
    assert row[3] == int(mode) and row[4] == 1
    assert log.stats[0, 2] == int(c.total)      # the previous discovered
    assert log.ctrl.tolist() == [1, int(mode), int(next_bu)]
    np.testing.assert_array_equal(log.depths.numpy(),
                                  (c.per_root[:, 0] > 0).int().numpy())


def test_measure_log_leaves_an_empty_layer_and_past_the_cap():
    """An empty frontier writes only the previous discovered column and
    active = 0; a call at layer == max_layers only the discovered
    column."""
    frontier, visited, deg = _inputs(2, 8)
    f, vis, d = _port(frontier, visited, deg)
    code = t_engine.policy_code(tbfs.BeamerHybrid(), 200, 2, 3)
    log = t_bk.new_log(2, 3, code, "cpu")
    ops.measure(torch.zeros_like(f), vis, d, log=log, layer=1)
    assert not log.stats[1].any() and log.ctrl[0] == 0
    ops.measure(f, log=log, layer=3)
    assert int(log.stats[2, 2]) == int(ops.popcount(f))
    assert not log.depths.any() and not log.stats[:2].any()


@pytest.mark.parametrize("max_layers", [128, 2])
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
@pytest.mark.parametrize("scale", [8, 9])
def test_host_loop_matches_reference(scale, policy_index, max_layers):
    """Stats buffer, depths, visited and direction log bitwise."""
    g = rmat_graph(scale)
    roots = [3, 7, 11, 100]
    ref_pol, t_pol = POLICY_PAIRS[policy_index]
    ct, ref = run_reference(g, ref_pol, roots, max_layers)
    got = run_port(to_port(g), t_pol, roots, ct.resolved.tile, max_layers)
    np.testing.assert_array_equal(got.stats.numpy(), np.asarray(ref.stats))
    np.testing.assert_array_equal(got.depths.numpy(), np.asarray(ref.depths))
    np.testing.assert_array_equal(words_np(got.state.visited),
                                  np.asarray(ref.state.visited))
    assert int(got.state.layer) == int(ref.state.layer)
    assert tbfs.direction_log(got) == ref_engine.direction_log(ref)


class _Unregistered:
    """A policy with no kernel encoding: ThresholdSimd(2048)'s rule,
    decided in torch from the measure's `Workload`."""
    modes = (t_engine.MODE_SCALAR, t_engine.MODE_SIMD)
    needs_unvisited = False

    def decide(self, w):
        return tbfs.ThresholdSimd(2048).decide(w)


def test_unregistered_policy_decides_in_torch():
    g = to_port(rmat_graph(9))
    spec = dict(tile=256, max_layers=64)
    want = tbfs.plan(g, tbfs.TraversalSpec(policy=tbfs.ThresholdSimd(2048),
                                           **spec), device="cpu") \
        .run_batched([3, 7])
    assert t_engine.policy_code(_Unregistered(), 512, 2, 64) is None
    got = tbfs.plan(g, tbfs.TraversalSpec(policy=_Unregistered(), **spec),
                    device="cpu").run_batched([3, 7])
    assert torch.equal(got.stats, want.stats)
    assert torch.equal(got.depths, want.depths)


# ---------------------------------------------------------------------------
# The CUDA arm against the plain one (needs the card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("unvisited", [False, True])
@pytest.mark.parametrize("n_batch,n_words", SHAPES + [(515, 40)])
def test_cuda_measure_matches_plain(cuda_device, n_batch, n_words,
                                    unvisited):
    frontier, visited, deg = _inputs(n_batch, n_words)
    f, vis, d = _port(frontier, visited, deg)
    want = t_bk.measure_plain(f, vis if unvisited else None, d)
    got = t_bk.measure_cuda(f.to(cuda_device), vis.to(cuda_device)
                            if unvisited else None, d.to(cuda_device))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    got = t_bk.measure_cuda(f.to(cuda_device))
    assert torch.equal(got.per_root.cpu()[:, 0], want.per_root[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
@pytest.mark.parametrize("n_batch,n_words", [(8, 64), (33, 300)])
def test_cuda_measure_log_matches_plain(cuda_device, n_batch, n_words,
                                        policy_index):
    frontier, visited, deg = _inputs(n_batch, n_words, seed=policy_index)
    f, vis, d = _port(frontier, visited, deg)
    code = _codes(n_batch, n_words, 6)[policy_index]
    logs = [t_bk.new_log(n_batch, 6, code, dev)
            for dev in ("cpu", cuda_device)]
    for layer in range(7):                   # the last one past the cap
        for log, dev in zip(logs, ("cpu", cuda_device)):
            arm = t_bk.measure_cuda if log.stats.is_cuda \
                else t_bk.measure_plain
            arm(f.to(dev), vis.to(dev) if code.needs_unvisited else None,
                d.to(dev), log=log, layer=layer)
        for a, b in zip(logs[1][:4], logs[0][:4]):
            assert torch.equal(a.cpu(), b), f"layer {layer}"
        f = f >> 1                           # a smaller frontier next


@pytest.mark.cuda
def test_cuda_host_loop_matches_cpu(cuda_device):
    g = to_port(rmat_graph(9))
    for _, pol in POLICY_PAIRS:
        spec = tbfs.TraversalSpec(policy=pol, tile=256, max_layers=64)
        a = tbfs.plan(g, spec, device=cuda_device).run_batched([3, 7, 11])
        c = tbfs.plan(g, spec, device="cpu").run_batched([3, 7, 11])
        assert torch.equal(a.stats.cpu(), c.stats)
        assert torch.equal(a.depths.cpu(), c.depths)


def test_policy_codes_are_the_persistent_kernels():
    """The host loop and K6/K10 take the same numbers."""
    for _, pol in POLICY_PAIRS:
        assert t_engine.policy_code(pol, 1000, 8, 64) == \
            t_engine.encode_policy(pol, 1000, 8, 64)
    with pytest.raises(NotImplementedError):
        t_engine.encode_policy(_Unregistered(), 1000, 8, 64)
