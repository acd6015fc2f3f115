"""The slice end to end on the star, path and disconnected graphs: the
port's CPU path against the reference's fused_gather path (the R-MAT
graph is in ``test_torch_engine.py``)."""
import numpy as np
import pytest

from _torch_parity import BUILDERS, POLICY_IDS, check_slice, to_port
import repro_torch.bfs as tbfs
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")


@pytest.fixture(scope="module")
def graphs():
    return {k: BUILDERS[k]() for k in ("star", "path", "disconnected")}


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch4"])
@pytest.mark.parametrize("policy_index", range(4), ids=POLICY_IDS)
@pytest.mark.parametrize("graph_name", ["star", "path", "disconnected"])
def test_slice_matches_reference(graphs, graph_name, policy_index,
                                 batched):
    check_slice(graphs, graph_name, policy_index, batched)


def test_path_graph_runs_one_layer_per_vertex(graphs):
    res = tbfs.plan(to_port(graphs["path"]),
                    tbfs.TraversalSpec(policy="topdown", max_layers=128),
                    device="cpu").run(0)
    assert int(res.state.layer) == 96 and int(res.depths) == 96


def test_disconnected_component_stays_unreached(graphs):
    g = graphs["disconnected"]
    res = tbfs.plan(to_port(g), tbfs.TraversalSpec(policy="beamer"),
                    device="cpu").run(0)
    p = tbfs.parents_graph500(res.state, g.n_vertices).numpy()
    assert (p[64:] == -1).all() and (p[:64] >= 0).all()
    assert np.array_equal(p[:1], [0])
