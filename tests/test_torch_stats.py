"""The port's Graph500 harness (`repro_torch.core.stats`) and graph
configs held against the reference's, case by case of
``tests/test_graph500_harness.py`` and ``tests/test_stats_harness.py``.

Both harnesses run on the same explicit roots (the reference draws them
from ``jax.random``, which the port cannot reproduce); each run's
``edges``, ``reached`` and ``valid`` must equal the reference's.
Times, and so TEPS, are each side's own."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bfs_graph500 as ref_cfg
from repro.core import csr as ref_csr
from repro.core import rmat
from repro.core.bfs_parallel import run_bfs as ref_run_bfs
from repro.core.rmat import EdgeList
from repro.core.stats import choose_roots as ref_choose_roots
from repro.core.stats import run_harness as ref_run_harness

from _torch_parity import cuda_device, to_port  # noqa: F401
import repro_torch.bfs as tbfs
from repro_torch.configs import bfs_graph500 as cfg
from repro_torch.core.bfs_parallel import run_bfs
from repro_torch.core.stats import (HarnessResult, RunResult, choose_roots,
                                    run_harness)
from _torch_parity import builtin_knobs  # noqa: F401

# the reference's pinned fused_gather depth-0 results hold the port's
# built-in knobs, not the affinity table's picks
pytestmark = pytest.mark.usefixtures("builtin_knobs")

N = 8          # vertices 0..6 form a path; vertex 7 is isolated
ISOLATED = 7


@pytest.fixture(scope="module")
def path_graph():
    """0-1-2-3-4-5-6 path (both directions) + degree-0 vertex 7."""
    src = [i for i in range(N - 2)] + [i + 1 for i in range(N - 2)]
    dst = [i + 1 for i in range(N - 2)] + [i for i in range(N - 2)]
    return ref_csr.from_edges(EdgeList(
        src=jnp.asarray(src, jnp.int32),
        dst=jnp.asarray(dst, jnp.int32),
        n_vertices=N))


@pytest.fixture(scope="module")
def g10():
    return ref_csr.from_edges(
        rmat.generate(jax.random.PRNGKey(1), scale=10, edgefactor=16))


def _bfs(c, r):
    return run_bfs(c, r, device="cpu")


def _path_depths(root: int) -> np.ndarray:
    d = np.full(N, -1, np.int64)
    d[:N - 1] = np.abs(np.arange(N - 1) - root)
    return d


def _both(g, roots, port_fn=_bfs, ref_fn=ref_run_bfs, **kw):
    """Both harnesses on the same roots; each run's root, edges, reached
    and valid must match.  Returns (reference, port) results."""
    ref = ref_run_harness(g, ref_fn, jax.random.PRNGKey(0), roots=roots,
                          **kw)
    got = run_harness(to_port(g), port_fn, 0, roots=roots, **kw)
    fields = lambda res: [(r.root, r.edges, r.reached, r.valid)
                          for r in res.runs]
    assert fields(got) == fields(ref)
    for r in got.runs:
        assert r.teps == (r.edges / r.seconds if r.seconds > 0 else 0.0)
    return ref, got


def test_roots_override(path_graph):
    _, res = _both(path_graph, [0, 3, 6])
    assert [r.root for r in res.runs] == [0, 3, 6]
    # every root reaches the whole 7-vertex path, never the isolate
    assert all(r.reached == N - 1 for r in res.runs)
    assert all(r.edges == N - 2 for r in res.runs)  # 6 undirected edges


def test_disconnected_root_is_zero_run(path_graph):
    ref, res = _both(path_graph, [ISOLATED])
    (run,) = res.runs
    assert run.reached == 1          # only the root itself
    assert run.edges == 0 and run.teps == 0.0
    assert res.n_zero_runs == ref.n_zero_runs == 1
    # no connected run -> harmonic mean degenerates to 0, not a crash
    assert res.hmean_teps == res.max_teps == 0.0
    assert "zero_runs=1" in res.summary()


def test_mixed_roots_filtered_hmean(path_graph):
    _, res = _both(path_graph, [0, ISOLATED, 3])
    assert len(res.runs) == 3 and res.n_zero_runs == 1
    # hmean is over the two connected runs only (documented deviation)
    ts = [r.teps for r in res.runs if r.teps > 0]
    assert len(ts) == 2
    assert res.hmean_teps == pytest.approx(2 / sum(1 / t for t in ts))


def test_validate_wiring(path_graph):
    calls = []

    def ref(root):
        calls.append(root)
        return _path_depths(root)

    _, res = _both(path_graph, [0, 4], validate_runs=True,
                   reference_depths_fn=ref)
    assert calls == [0, 4, 0, 4]      # reference fn called per run, twice
    assert all(r.valid is True for r in res.runs)
    # without validate_runs the field stays None
    _, res2 = _both(path_graph, [0])
    assert res2.runs[0].valid is None


def test_validate_accepts_isolated_root(path_graph):
    _, res = _both(path_graph, [ISOLATED], validate_runs=True)
    assert res.runs[0].valid is True


def test_hmean_on_hand_built_results():
    for runs in ([], [RunResult(0, 0.0, 0, 0.0, 1)],
                 [RunResult(0, 0.5, 10, 20.0, 5),
                  RunResult(1, 0.1, 10, 100.0, 5),
                  RunResult(2, 0.2, 0, 0.0, 1)]):
        got = HarnessResult(list(runs))
        from repro.core.stats import HarnessResult as RefResult
        from repro.core.stats import RunResult as RefRun
        want = RefResult([RefRun(**dataclasses.asdict(r)) for r in runs])
        assert (got.hmean_teps, got.max_teps, got.n_zero_runs) == \
            (want.hmean_teps, want.max_teps, want.n_zero_runs)
        if runs:
            assert got.summary() == want.summary()
    assert got.hmean_teps == pytest.approx(2 / (1 / 20 + 1 / 100))
    assert got.n_zero_runs == 1 and got.max_teps == 100.0


def test_choose_roots_connected_filter(path_graph):
    deg = to_port(path_graph).degrees()
    roots = choose_roots(3, N, n_roots=16, degrees=deg,
                         require_connected=True)
    assert ISOLATED not in roots and len(roots) > 0
    assert ((roots >= 0) & (roots < N)).all()
    # the reference's contract: 4 * n_roots draws, filtered, then cut
    gen = torch.Generator().manual_seed(3)
    draws = torch.randint(0, N, (64,), generator=gen).numpy()
    assert np.array_equal(roots, draws[draws != ISOLATED][:16])
    unfiltered = choose_roots(torch.Generator().manual_seed(3), N,
                              n_roots=16)
    assert np.array_equal(unfiltered, draws[:16])
    ref = ref_choose_roots(jax.random.PRNGKey(3), N, n_roots=16,
                           degrees=np.asarray(path_graph.degrees()),
                           require_connected=True)
    assert ISOLATED not in ref


def test_harness_runs_and_validates(g10):
    """The reference's random draw, held on the port's harness with a
    SIMD run_bfs and with the plan API."""
    roots = ref_choose_roots(jax.random.PRNGKey(0), g10.n_vertices, 8)
    _, res = _both(g10, roots,
                   port_fn=lambda c, r: run_bfs(c, r, algorithm="simd",
                                                device="cpu"),
                   ref_fn=lambda c, r: ref_run_bfs(c, r, algorithm="simd"),
                   validate_runs=True)
    assert len(res.runs) == 8 and all(r.valid for r in res.runs)
    assert res.max_teps >= res.hmean_teps > 0
    assert "hmean_teps" in res.summary()
    ct = tbfs.plan(to_port(g10), device="cpu")
    planned = run_harness(to_port(g10), lambda c, r: ct.run(r).state, 0,
                          roots=roots, validate_runs=True)
    assert [(r.edges, r.reached, r.valid) for r in planned.runs] == \
        [(r.edges, r.reached, r.valid) for r in res.runs]


def test_hmean_is_harmonic(g10):
    res = run_harness(to_port(g10), _bfs, 2, n_roots=4)
    assert len(res.runs) == 4
    ts = [r.teps for r in res.runs if r.teps > 0]
    assert abs(res.hmean_teps - len(ts) / sum(1 / t for t in ts)) < 1e-6
    with pytest.raises(ValueError, match="seed"):
        run_harness(to_port(g10), _bfs)


def test_configs_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in cfg.GRAPHS.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_cfg.GRAPHS.items()}
    assert cfg.PAPER_GRAPHS == ref_cfg.PAPER_GRAPHS
    assert dataclasses.asdict(cfg.SERVE) == \
        dataclasses.asdict(ref_cfg.SERVE)
    assert dataclasses.asdict(cfg.FORMAT_SWEEP) == \
        dataclasses.asdict(ref_cfg.FORMAT_SWEEP)
    g = cfg.GRAPHS["rmat-22"]
    assert (g.n_vertices, g.n_edges_directed, g.n_roots) == \
        (1 << 22, 1 << 27, 64)


def test_new_modules_import_without_jax():
    """The slice's modules import with jax blocked and without the
    reference."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.obs, repro_torch.obs.cost_drift\n"
        "import repro_torch.serve.graph_engine, repro_torch.serve.robust\n"
        "import repro_torch.core.stats\n"
        "import repro_torch.configs.bfs_graph500\n"
        "import repro_torch.launch.dryrun\n"
        "import repro_torch.roofline.analysis, repro_torch.roofline.report\n"
        "import repro_torch.roofline.hlo_analyze\n"
        "from repro_torch.obs.cost_drift import measure_drift\n"
        "bad = [m for m in sys.modules if m == 'repro' "
        "or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run(
        [sys.executable, "-c", code],
        env={**os.environ,
             "PYTHONPATH": str(Path(__file__).resolve().parents[1] / "src")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.cuda
def test_harness_on_the_card(g10, cuda_device):
    """The harness on the card gives the CPU run's edges, reached and
    valid for the same roots."""
    roots = ref_choose_roots(jax.random.PRNGKey(0), g10.n_vertices, 8)
    cpu = run_harness(to_port(g10), _bfs, 0, roots=roots,
                      validate_runs=True)
    gt = to_port(g10)
    g = gt._replace(rows=gt.rows.to(cuda_device),
                    colstarts=gt.colstarts.to(cuda_device))
    ct = tbfs.plan(g, device=cuda_device)
    gpu = run_harness(g, lambda c, r: ct.run(r).state, 0, roots=roots,
                      validate_runs=True)
    assert [(r.edges, r.reached, r.valid) for r in gpu.runs] == \
        [(r.edges, r.reached, r.valid) for r in cpu.runs]
