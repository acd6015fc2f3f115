"""The bytes behind ``search_roofline`` depend on the inputs alone: the
same graph and keys give the same count from a CSR run of the port, a
SELL run, and the components the benchmark works out itself."""
import numpy as np
import pytest

from graphbench.reference import graph500, rmat
from repro_torch import bfs, formats
from repro_torch.core.csr import from_edges
from repro_torch.core.rmat import EdgeList


@pytest.mark.parametrize("initiator", [rmat.KRON, (0.25,) * 4])
def test_floor_bytes_same_under_csr_and_sell(initiator):
    src, dst, v, _ = rmat.generate(21, 9, 16, initiator, device="cpu")
    deg = graph500.degrees(src, v)
    keys = graph500.search_keys(4, deg, 8)
    n_keys = len(np.unique(keys))
    csr = from_edges(EdgeList(src, dst, v), device="cpu")
    counts = []
    for name in ("csr", "sell"):
        fmt = formats.build(csr, name)
        res = bfs.plan(fmt, device="cpu").run_batched(keys)
        reached = (res.state.parent[:, :v] < v).any(0)
        counts.append(graph500.floor_bytes(reached, len(keys), n_keys))
    label = graph500.components(src, dst, v)
    reached = graph500.batch_reached(label, keys)
    counts.append(graph500.floor_bytes(reached, len(keys), n_keys))
    assert counts[0] == counts[1] == counts[2]
    # 8 parent rows written, one entry read per reached vertex but a root
    assert counts[0] == 4 * 8 * v + 4 * (int(reached.sum()) - n_keys)
    # under a top-down search's reads of every reached vertex's list
    assert counts[0] < 4 * 8 * v + 4 * int(deg[reached].sum())
