"""Parity of the port's core substrate with the JAX reference: bitmap
helpers bitwise, CSR construction and validation, the oracles, the
R-MAT generator's distribution and the device rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bfs_serial as ref_serial
from repro.core import bitmap as ref_bm
from repro.core import csr as ref_csr
from repro.core import rmat as ref_rmat
from repro.core import validate as ref_validate
from repro.core.rmat import EdgeList as RefEdgeList
from repro.errors import GraphValidationError as RefGraphValidationError

from _torch_parity import rmat_graph, to_port, words_np
from repro_torch import interop
from repro_torch.core import bfs_serial as t_serial
from repro_torch.core import bitmap as t_bm
from repro_torch.core import csr as t_csr
from repro_torch.core import rmat as t_rmat
from repro_torch.core import validate as t_validate
from repro_torch.errors import GraphValidationError


def _words(seed, n_words, density=0.5):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, n_words, dtype=np.uint32)
    if density < 0.5:
        a &= rng.integers(0, 2**32, n_words, dtype=np.uint32)
    return a


def _eq_words(t_words, ref_words):
    np.testing.assert_array_equal(words_np(t_words),
                                  np.asarray(ref_words, np.uint32))


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 4096])
def test_num_words_and_zeros(n):
    assert t_bm.num_words(n) == ref_bm.num_words(n)
    _eq_words(t_bm.zeros(n), ref_bm.zeros(n))


def test_word_and_bit():
    v = np.arange(0, 5000, 7, dtype=np.int32)
    w_r, b_r = ref_bm.word_and_bit(jnp.asarray(v))
    w_t, b_t = t_bm.word_and_bit(torch.from_numpy(v))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_r))
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_r))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_test_bits(seed):
    words = _words(seed, 64)
    rng = np.random.default_rng(seed + 10)
    v = rng.integers(0, 64 * 32 + 40, 500).astype(np.int32)  # some OOB
    ref = ref_bm.test_bits(jnp.asarray(words), jnp.asarray(v))
    got = t_bm.test_bits(interop.words_to_torch(words, "cpu"),
                         torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_unpack_word_bits(seed):
    rng = np.random.default_rng(seed)
    dense = rng.random(32 * 50) < 0.3
    dense[31::32] |= rng.random(50) < 0.5          # exercise the top bit
    _eq_words(t_bm.pack_bool(torch.from_numpy(dense)),
              ref_bm.pack_bool(jnp.asarray(dense)))
    words = _words(seed, 50)
    tw = interop.words_to_torch(words, "cpu")
    np.testing.assert_array_equal(t_bm.unpack_bool(tw).numpy(),
                                  np.asarray(ref_bm.unpack_bool(
                                      jnp.asarray(words))))
    np.testing.assert_array_equal(t_bm.word_bits(tw).numpy(),
                                  np.asarray(ref_bm.word_bits(
                                      jnp.asarray(words))))


@pytest.mark.parametrize("with_valid", [False, True])
def test_set_bits_exact(with_valid):
    rng = np.random.default_rng(5)
    base = _words(5, 40, density=0.25)
    v = rng.integers(0, 40 * 32, 300).astype(np.int32)
    valid = rng.random(300) < 0.6 if with_valid else None
    ref = ref_bm.set_bits_exact(jnp.asarray(base), jnp.asarray(v),
                                None if valid is None
                                else jnp.asarray(valid))
    got = t_bm.set_bits_exact(interop.words_to_torch(base, "cpu"),
                              torch.from_numpy(v),
                              None if valid is None
                              else torch.from_numpy(valid))
    _eq_words(got, ref)


def test_set_bits_racy_distinct_words_is_exact():
    """One lane per word: no race, so racy == reference bitwise."""
    base = _words(7, 64, density=0.25)
    rng = np.random.default_rng(7)
    words = rng.permutation(64)[:40]
    v = (words * 32 + rng.integers(0, 32, 40)).astype(np.int32)
    valid = rng.random(40) < 0.7
    ref = ref_bm.set_bits_racy(jnp.asarray(base), jnp.asarray(v),
                               jnp.asarray(valid))
    got = t_bm.set_bits_racy(interop.words_to_torch(base, "cpu"),
                             torch.from_numpy(v), torch.from_numpy(valid))
    _eq_words(got, ref)


def test_set_bits_racy_collisions_keep_race_invariants():
    """Colliding lanes may drop bits (§3.3.2) but never invent one, and
    every written word keeps at least one of its lanes' bits."""
    base = np.zeros(4, np.uint32)
    v = np.arange(0, 128, 3, dtype=np.int32)
    got = words_np(t_bm.set_bits_racy(interop.words_to_torch(base, "cpu"),
                                      torch.from_numpy(v)))
    exact = np.asarray(ref_bm.set_bits_exact(jnp.asarray(base),
                                             jnp.asarray(v)))
    assert np.all((got & ~exact) == 0)
    assert np.all(got != 0)


@pytest.mark.parametrize("n_words", [1, 33, 4096])
def test_popcount(n_words):
    words = _words(n_words, n_words)
    got = int(t_bm.popcount(interop.words_to_torch(words, "cpu")))
    assert got == int(ref_bm.popcount(jnp.asarray(words)))


@pytest.mark.parametrize("size,fill", [(2048, 2048), (100, 7), (0, 1)])
def test_compact(size, fill):
    words = _words(3, 64, density=0.25)
    ref = ref_bm.compact(jnp.asarray(words), size, fill)
    got = t_bm.compact(interop.words_to_torch(words, "cpu"), size, fill)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bit2vertex():
    w = np.arange(0, 100, dtype=np.int32)
    b = (w * 7) % 32
    ref = ref_bm.bit2vertex(jnp.asarray(w), jnp.asarray(b))
    got = t_bm.bit2vertex(torch.from_numpy(w), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("batched", [False, True])
def test_degree_matrix_and_masked_degree_sum(batched):
    rng = np.random.default_rng(11)
    deg = rng.integers(0, 1000, 1000).astype(np.int32)
    n_bits = 1024
    ref_mat = ref_bm.degree_matrix(jnp.asarray(deg), n_bits)
    t_mat = t_bm.degree_matrix(torch.from_numpy(deg), n_bits)
    np.testing.assert_array_equal(t_mat.numpy(), np.asarray(ref_mat))
    words = np.stack([_words(s, n_bits // 32) for s in range(3)])
    got = t_bm.masked_degree_sum(interop.words_to_torch(words, "cpu"),
                                 t_mat)
    want = [int(ref_bm.masked_degree_sum(jnp.asarray(w), ref_mat))
            for w in words]
    if batched:
        assert got.tolist() == want
    else:
        assert int(t_bm.masked_degree_sum(
            interop.words_to_torch(words[0], "cpu"), t_mat)) == want[0]


def test_words_interop_round_trip():
    words = np.array([0, 1, 2**31, 2**32 - 1, 0xDEADBEEF], np.uint32)
    t = interop.words_to_torch(words, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(interop.words_to_numpy(t), words)


# ---------------------------------------------------------------------------
# CSR
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,seed", [(50, 300, 0), (1000, 5000, 1),
                                      (128, 1, 2)])
def test_from_edges_matches_reference(n, m, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    src[: m // 10] = dst[: m // 10]                   # self-loops
    ref = ref_csr.from_edges(RefEdgeList(jnp.asarray(src),
                                         jnp.asarray(dst), n))
    got = t_csr.from_edges(t_rmat.EdgeList(torch.from_numpy(src),
                                           torch.from_numpy(dst), n),
                           device="cpu")
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_array_equal(got.colstarts.numpy(),
                                  np.asarray(ref.colstarts))
    assert (got.n_vertices, got.n_edges) == (ref.n_vertices, ref.n_edges)
    assert got.n_vertices_padded == ref.n_vertices_padded


@pytest.mark.parametrize("n", [1, 127, 128, 1000])
def test_padding_premarked_visited(n):
    _eq_words(t_csr.padding_premarked_visited(n, device="cpu"),
              ref_csr.padding_premarked_visited(n))


def test_traversed_edges():
    g = rmat_graph(8)
    gt = to_port(g)
    rng = np.random.default_rng(0)
    reached = rng.random(g.n_vertices) < 0.4
    assert int(t_csr.traversed_edges(gt, torch.from_numpy(reached))) == \
        int(ref_csr.traversed_edges(g, jnp.asarray(reached)))


def _broken_csrs():
    rows = np.array([1, 2, 0, 0, 3, 3], np.int32)
    cs = np.array([0, 2, 3, 4, 6], np.int32)
    yield "colstarts_len", rows, cs[:-1], 4, 6
    yield "colstarts0", rows, cs + 1, 4, 6
    yield "non_monotone", rows, np.array([0, 3, 2, 4, 6], np.int32), 4, 6
    yield "edge_count", rows, cs, 4, 5
    yield "truncated", rows[:4], np.array([0, 1, 2, 3, 6], np.int32), 4, 6
    yield "neighbor_range", np.array([1, 2, 0, 9, 3, 3], np.int32), cs, 4, 6
    yield "padding_tail", np.array([1, 2, 0, 0, 3, 3, 4, 7], np.int32), \
        cs, 4, 6
    yield "zero_vertices", rows, cs, 0, 6
    yield "nan_geometry", rows, cs, float("nan"), 6
    yield "negative_edges", rows, cs, 4, -1


@pytest.mark.parametrize("case", list(_broken_csrs()),
                         ids=lambda c: c[0])
def test_check_structure_messages_match(case):
    _, rows, cs, n, e = case
    with pytest.raises(RefGraphValidationError) as ref_err:
        ref_csr.check_structure(ref_csr.Csr(jnp.asarray(rows),
                                            jnp.asarray(cs), n, e))
    with pytest.raises(GraphValidationError) as got_err:
        t_csr.check_structure(t_csr.Csr(torch.from_numpy(rows),
                                        torch.from_numpy(cs), n, e))
    assert str(got_err.value) == str(ref_err.value)
    assert isinstance(got_err.value, ValueError)


def test_check_structure_dtype_names_torch_cast():
    g = t_csr.Csr(torch.zeros(4), torch.zeros(3, dtype=torch.int32), 2, 0)
    with pytest.raises(GraphValidationError, match="to\\(torch.int32\\)"):
        t_csr.check_structure(g)


def test_check_structure_accepts_a_real_graph():
    gt = to_port(rmat_graph(8))
    assert t_csr.check_structure(gt) is gt


# ---------------------------------------------------------------------------
# Oracles
# ---------------------------------------------------------------------------

def test_bfs_serial_matches_reference():
    g = rmat_graph(8)
    rows, cs = np.asarray(g.rows), np.asarray(g.colstarts)
    for root in (0, 5, 77):
        p_r, d_r = ref_serial.bfs_serial(rows, cs, g.n_vertices, root)
        p_t, d_t = t_serial.bfs_serial(rows, cs, g.n_vertices, root)
        np.testing.assert_array_equal(p_t, p_r)
        np.testing.assert_array_equal(d_t, d_r)


def _corruptions(parent, root, depth):
    yield "valid", parent.copy()
    bad = parent.copy()
    bad[root] = (root + 1) % len(parent)
    yield "root", bad
    reached = np.nonzero((parent >= 0) & (np.arange(len(parent)) != root))
    v = int(reached[0][-1])
    bad = parent.copy()
    bad[v] = v                                   # self-parent: a cycle
    yield "cycle", bad
    bad = parent.copy()
    far = int(np.argmax(depth))
    bad[far] = root                              # likely not an edge
    yield "non_edge", bad
    bad = parent.copy()
    unreached = np.nonzero(parent < 0)[0]
    if len(unreached):
        bad[unreached[0]] = root
    yield "closure", bad


@pytest.mark.parametrize("kind", ["valid", "root", "cycle", "non_edge",
                                  "closure"])
def test_validate_agrees_with_reference(kind):
    g = rmat_graph(8)
    gt = to_port(g)
    rows, cs = np.asarray(g.rows), np.asarray(g.colstarts)
    root = 3
    parent, depth = ref_serial.bfs_serial(rows, cs, g.n_vertices, root)
    cases = dict(_corruptions(parent, root, depth))
    p = cases[kind]
    ref = ref_validate.validate(g, jnp.asarray(p), root,
                                reference_depth=depth)
    got = t_validate.validate(gt, torch.from_numpy(p), root,
                              reference_depth=depth)
    assert tuple(got[:7]) == tuple(ref[:7])
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    assert got.ok == (kind == "valid")


# ---------------------------------------------------------------------------
# R-MAT generator (distribution, not bits) and the device rule
# ---------------------------------------------------------------------------

def test_rmat_shape_and_symmetry():
    e = t_rmat.generate(1, 8, edgefactor=4, device="cpu")
    n = 1 << 8
    assert e.n_vertices == n and e.src.shape[0] == 2 * n * 4
    assert e.src.dtype == torch.int32
    assert int(e.src.min()) >= 0 and int(e.src.max()) < n
    m = n * 4
    assert torch.equal(e.src[:m], e.dst[m:])
    assert torch.equal(e.dst[:m], e.src[m:])
    again = t_rmat.generate(1, 8, edgefactor=4, device="cpu")
    assert torch.equal(e.src, again.src)          # seeded: reproducible


def test_rmat_distribution_matches_reference():
    """Same model, different random bits: the degree statistics of a
    SCALE-10 graph must agree within sampling noise (isolated-vertex
    share within 0.05 absolute, max/mean degree skew within a factor 2,
    both above the BeamerHybrid skew floor of 4)."""
    import jax
    n = 1 << 10
    ref = ref_rmat.generate(jax.random.PRNGKey(0), 10, 16)
    ref_deg = np.bincount(np.asarray(ref.src), minlength=n)
    got = t_rmat.generate(0, 10, 16, device="cpu")
    got_deg = np.bincount(got.src.numpy(), minlength=n)
    assert abs((ref_deg == 0).mean() - (got_deg == 0).mean()) < 0.05
    skew_r = ref_deg.max() / ref_deg.mean()
    skew_t = got_deg.max() / got_deg.mean()
    assert skew_r >= 4 and skew_t >= 4
    assert 0.5 < skew_t / skew_r < 2.0


@pytest.mark.parametrize("entry", ["rmat", "from_edges", "csr_from_arrays",
                                   "padding_premarked_visited"])
def test_default_device_is_cuda_and_raises_without_it(entry):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    e = t_rmat.EdgeList(torch.zeros(2, dtype=torch.int32),
                        torch.ones(2, dtype=torch.int32), 2)
    calls = {
        "rmat": lambda: t_rmat.generate(0, 4),
        "from_edges": lambda: t_csr.from_edges(e),
        "csr_from_arrays": lambda: interop.csr_from_arrays(
            np.zeros(128, np.int32), np.zeros(3, np.int32), 2, 0),
        "padding_premarked_visited":
            lambda: t_csr.padding_premarked_visited(10),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
