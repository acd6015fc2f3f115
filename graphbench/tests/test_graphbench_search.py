"""A search cell run end to end on the CPU: ``correct`` holds for the
port, and comes out false with the timed path broken underneath or the
control in the program's place."""
import numpy as np
import pytest
import torch

from graphbench.reference import bfs as ref_bfs
from graphbench import run
from graphbench.tests._drive import SEED, drive, small
from repro_torch.api import plan as plan_mod
from repro_torch.core import engine


def init_rows(bound, roots):
    return engine._init_batched(roots, bound.fmt.n_vertices,
                                bound.fmt.n_vertices_padded)


def unchanged(orig):
    """A traversal that returns its state as it was given."""
    def run(self, roots):
        res = orig(self, roots)
        f, v, p = init_rows(self, roots)
        return res._replace(state=engine.BfsState(f, v, p,
                                                  res.state.layer))
    return run


def half_batch(orig):
    """Only the first half of the roots searched; the rest left as
    they started."""
    def run(self, roots):
        n = roots.shape[0]
        res = orig(self, roots[:max(1, n // 2)])
        f, v, p = init_rows(self, roots)
        k = res.state.parent.shape[0]
        p[:k] = res.state.parent
        return res._replace(state=engine.BfsState(f, v, p,
                                                  res.state.layer))
    return run


def altered(orig):
    """One answer altered where it is produced: in every root's tree a
    reached vertex other than the root becomes its own parent."""
    def run(self, roots):
        res = orig(self, roots)
        p = res.state.parent
        for b in range(p.shape[0]):
            hit = torch.nonzero((p[b] < self.fmt.n_vertices)
                                & (p[b] != roots[b])).flatten()
            if hit.numel():
                p[b, hit[-1]] = hit[-1].to(p.dtype)
        return res
    return run


def control(orig):
    """The control: the reference's tree with a bottom-up step that
    tests the visited set, put in the program's place."""
    src, dst, v, _ = run.make_edges(small("kron-s25.search8").config,
                                    SEED, "cpu")
    adj = ref_bfs.adjacency(src, dst, v)

    def run_(self, roots):
        res = orig(self, roots)
        p = res.state.parent
        for b, r in enumerate(roots.tolist()):
            depth = ref_bfs.bfs_depths(adj, r)
            p[b, :v] = ref_bfs.control_parents(adj, depth, r)
        return res
    return run_


@pytest.mark.parametrize("cell", ["kron-s25.search8", "urand-s25.search8",
                                  "kron-s25.search1"])
def test_search_cell_correct(cell):
    out = drive(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["checks"]["trees_checked"]["value"] >= 8
    names = {m["name"] for m in small(cell).end_to_end}
    assert set(out["metrics"]) == names and "setup_s" in names
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


def test_seeds_relabel_one_graph():
    """Two seeds: the same graph and the same search keys under other
    labels, and the batches run in another order."""
    c = small("kron-s25.search8")
    a = run.make_inputs(c.config, c.traffic, SEED, "cpu")
    b = run.make_inputs(c.config, c.traffic, SEED + 1, "cpu")
    assert not np.array_equal(a.keys, b.keys)
    assert torch.equal(a.degree[torch.as_tensor(a.keys)],
                       b.degree[torch.as_tensor(b.keys)])
    assert torch.equal(torch.sort(a.degree).values,
                       torch.sort(b.degree).values)
    da = run.make_driver(c.traffic, a, "cpu", SEED)
    db = run.make_driver(c.traffic, b, "cpu", SEED + 1)
    assert sorted(map(tuple, a.degree[torch.as_tensor(da.batches)]
                      .tolist())) \
        == sorted(map(tuple, b.degree[torch.as_tensor(db.batches)]
                      .tolist()))
    assert da.checked_roots() == [int(r) for r in da.batches[:2].ravel()]


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered,
                                   control])
def test_search_cell_faults(monkeypatch, fault):
    monkeypatch.setattr(plan_mod._Bound, "run",
                        fault(plan_mod._Bound.run))
    out = drive("kron-s25.search8")
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
def test_search_cell_on_card(cuda_device):
    out = run.execute(small("kron-s25.search8", scale=16), SEED, 1.0,
                      False, device=cuda_device)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
