"""The benchmark's plain reference: the generator, the search keys, the
Graph500 counts and the BFS with its tree check, on hand-made graphs."""
import numpy as np
import pytest
import torch

from graphbench.reference import bfs, graph500, rmat


def edges_of(pairs, n):
    s = torch.tensor([a for a, b in pairs] + [b for a, b in pairs],
                     dtype=torch.int32)
    d = torch.tensor([b for a, b in pairs] + [a for a, b in pairs],
                     dtype=torch.int32)
    return s, d, n


@pytest.mark.parametrize("initiator,skew_ok", [
    (rmat.KRON, lambda s: s >= 4), ((0.25,) * 4, lambda s: s < 4)])
@pytest.mark.parametrize("scale", [10, 12])
def test_generator_degrees(initiator, skew_ok, scale):
    src, dst, v, _ = rmat.generate(3, scale, 16, initiator, device="cpu")
    assert v == 1 << scale and src.shape[0] == 2 * 16 * v
    deg = graph500.degrees(src, v).double()
    mean = float(deg.mean())
    assert mean == 32.0
    assert skew_ok(float(deg.max()) / mean)


def test_generator_repeats_per_seed():
    a = rmat.generate(2**31 + 5, 9, 16, device="cpu")
    b = rmat.generate(2**31 + 5, 9, 16, device="cpu")
    c = rmat.generate(2**31 + 6, 9, 16, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert rmat.checksum(a[0], a[1]) == rmat.checksum(b[0], b[1])
    assert rmat.checksum(a[0], a[1]) != rmat.checksum(c[0], c[1])


def test_generator_labels_one_graph():
    """Another label seed gives the same graph under other labels."""
    a = rmat.generate(41, 9, 16, device="cpu", label_seed=1)
    b = rmat.generate(41, 9, 16, device="cpu", label_seed=2)
    assert not torch.equal(a[0], b[0])
    # relabel b's edges back through a's labels: the same tuples
    back = torch.empty_like(a[3])
    back[b[3].long()] = a[3]
    assert torch.equal(back[b[0].long()], a[0])
    assert torch.equal(back[b[1].long()], a[1])


def test_generator_rejects_bad_initiator():
    with pytest.raises(ValueError):
        rmat.generate(1, 4, 2, (0.5, 0.5, 0.5, 0.5), device="cpu")


def test_search_keys():
    deg = torch.tensor([0, 3, 0, 1, 2, 0, 0, 5] * 8)
    k1 = graph500.search_keys(7, deg, 12)
    assert len(k1) == 12 and (deg[torch.as_tensor(k1)] > 0).all()
    assert np.array_equal(k1, graph500.search_keys(7, deg, 12))
    assert not np.array_equal(k1, graph500.search_keys(8, deg, 12))
    with pytest.raises(ValueError):
        graph500.search_keys(1, torch.zeros(16, dtype=torch.int64), 4)


# path 0-1-2-3, a triangle 4-5-6 with a self-loop on 6 and a duplicate
# 4-5, an isolated vertex 7, a star 8-{9, 10, 11}
HAND = [(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (6, 4), (6, 6), (4, 5),
        (8, 9), (8, 10), (8, 11)]


@pytest.mark.parametrize("root,want", [
    (0, [0, 1, 2, 3] + [-1] * 8),
    (2, [2, 1, 0, 1] + [-1] * 8),
    (6, [-1] * 4 + [1, 1, 0] + [-1] * 5),
    (7, [-1] * 7 + [0] + [-1] * 4),
    (9, [-1] * 8 + [1, 0, 2, 2]),
])
def test_bfs_depths_hand(root, want):
    adj = bfs.adjacency(*edges_of(HAND, 12))
    assert bfs.bfs_depths(adj, root).tolist() == want


def test_bfs_depths_in_blocks(monkeypatch):
    src, dst, v, _ = rmat.generate(11, 10, 16, device="cpu")
    adj = bfs.adjacency(src, dst, v)
    root = int(graph500.search_keys(1, graph500.degrees(src, v), 1)[0])
    whole = bfs.bfs_depths(adj, root)
    monkeypatch.setattr(bfs, "EXPAND_CHUNK", 97)
    assert torch.equal(bfs.bfs_depths(adj, root), whole)
    assert int((whole >= 0).sum()) > v // 2


def test_tree_errors_hand():
    adj = bfs.adjacency(*edges_of(HAND, 12))
    depth = bfs.bfs_depths(adj, 0)
    good = torch.tensor([0, 0, 1, 2] + [-1] * 8)
    assert bfs.tree_errors(adj, good, 0, depth) == {"reach": 0,
                                                   "parent": 0}
    # the program's sentinel V means unreached as -1 does
    sent = torch.where(good < 0, 12, good)
    assert bfs.tree_errors(adj, sent, 0, depth)["reach"] == 0
    wrong_layer = good.clone()
    wrong_layer[3] = 1           # a vertex two layers up, not adjacent
    assert bfs.tree_errors(adj, wrong_layer, 0, depth)["parent"] == 1
    missing = good.clone()
    missing[3] = -1
    assert bfs.tree_errors(adj, missing, 0, depth)["reach"] == 1
    extra = good.clone()
    extra[5] = 4
    assert bfs.tree_errors(adj, extra, 0, depth)["reach"] == 1
    root_wrong = good.clone()
    root_wrong[0] = 1
    assert bfs.tree_errors(adj, root_wrong, 0, depth)["parent"] == 1


def test_control_fails_the_check():
    src, dst, v, _ = rmat.generate(5, 10, 16, device="cpu")
    adj = bfs.adjacency(src, dst, v)
    for root in graph500.search_keys(9, graph500.degrees(src, v), 3):
        depth = bfs.bfs_depths(adj, int(root))
        got = bfs.tree_errors(adj, bfs.control_parents(adj, depth,
                                                       int(root)),
                              int(root), depth)
        assert got["reach"] == 0 and got["parent"] > 0


def test_components_and_edges():
    s, d, v = edges_of(HAND, 12)
    label = graph500.components(s, d, v)
    assert label.tolist() == [0, 0, 0, 0, 4, 4, 4, 7, 8, 8, 8, 8]
    deg = graph500.degrees(s, v)
    comp = graph500.component_edges(label, deg)
    # the input tuples of each component, self-loop and duplicate kept
    assert graph500.traversed_edges(label, comp, [3, 5, 7, 10]).tolist() \
        == [3, 5, 0, 3]
    reached = graph500.batch_reached(label, [1, 9])
    assert reached.tolist() == [True] * 4 + [False] * 4 + [True] * 4
    # two parent rows, one entry for each reached vertex but the roots
    assert graph500.floor_bytes(reached, 2, 2) == 4 * 2 * 12 + 4 * (8 - 2)
