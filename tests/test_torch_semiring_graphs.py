"""The semiring portfolio end to end on the small graph families of the
reference's algorithm tests (star, path, disconnected), on the ``csr``
and ``sell`` formats: the comparison of ``test_torch_semiring.py``
(values, parents, layers, depths, visited, frontier and the whole stats
buffer bitwise against the reference, and the port's own oracles).
"""
import pytest

from _torch_parity import BUILDERS
from _torch_semiring import ALGORITHMS, FORMATS, check_portfolio
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

FAMILIES = ("star", "path", "disconnected")
CASES = [(g, f, a) for g in FAMILIES for f in FORMATS for a in ALGORITHMS]


@pytest.fixture(scope="module")
def graphs():
    return {name: BUILDERS[name]() for name in FAMILIES}


@pytest.mark.parametrize("graph_name,fmt_name,algorithm", CASES,
                         ids=[f"{g}-{f}-{a}" for g, f, a in CASES])
def test_portfolio_matches_reference(graphs, graph_name, fmt_name,
                                     algorithm):
    check_portfolio(graphs, graph_name, fmt_name, algorithm)
