"""The port's dry run (`repro_torch.launch.dryrun`) and roofline report
held against the reference's (`repro.launch.dryrun`,
`repro.roofline.report`).

* A reduced arch dry-runs to ``status: "ok"`` on every shape kind
  (train, prefill, decode), on a fake (2 x 2) mesh and on one rank; the
  mesh's per-rank flops are the one-rank flops / 4 within
  `MESH_FLOPS_SLACK` of each kind, and the cross-entropy's exactly.
* `decode_state_specs` and `vector_spec` give the reference's
  ``PartitionSpec``s at production size (the reference on
  ``AbstractMesh((16, 16))`` and ``((2, 16, 16))``, the port on fake
  process groups of 256 and 512 ranks), over every arch's decode states.
* `optimizer.qs_specs`, the reference dry run's ``qs_spec`` rule, case
  by case; the cell policy; ``--list``; the BFS cell on the CPU; the
  report's rendering.

Every fake process group is destroyed when its test ends (the
``fake`` fixture asserts that none is left), and the reference's
dry-run module, which sets ``XLA_FLAGS`` on import, is imported with
that variable saved and restored.
"""
import contextlib
import dataclasses
import io
import json
import os

import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as ref_registry
from repro.models.config import param_count as ref_param_count

from repro_torch.configs import registry
from repro_torch.launch import dryrun, inputs
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.sharding import Spec
from repro_torch.roofline import report
from repro_torch.roofline.analysis import _wire_factor
from repro_torch.train import optimizer as opt

#: the (2 x 2) mesh's per-rank flops over one rank's / 4, by shape kind,
#: a few percent above what was measured: prefill splits exactly
#: (1.000); train measured 1.081, all of it in the backward pass, whose
#: products DTensor places with a replicated operand here and there;
#: decode 1.105, the attention over the length-cut KV cache, which runs
#: whole on both model ranks (the decode cell's gathered cache, ROADMAP
#: §3b)
MESH_FLOPS_SLACK = {"train": 1.1, "prefill": 1.01, "decode": 1.12}


@pytest.fixture
def fake():
    """`dryrun.fake_group`; the group is destroyed after the test."""
    yield dryrun.fake_group
    if dist.is_initialized():
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module, ``XLA_FLAGS`` left as it was."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as mod
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return mod


# -- reduced cells on a fake mesh and on one rank -----------------------------

SHAPES = {"train": ("train_4k", 4, 64), "prefill": ("prefill_32k", 4, 64),
          "decode": ("decode_32k", 4, 64)}


@pytest.mark.parametrize("kind", list(SHAPES))
def test_reduced_cell_on_mesh_and_one_rank(kind, fake):
    name, batch, seq = SHAPES[kind]
    shape = dataclasses.replace(registry.SHAPES[name], global_batch=batch,
                                seq_len=seq)
    cfg = registry.get("qwen3", reduced=True).with_(n_layers=1)
    res = {}
    for world, mesh_shape in ((1, (1, 1)), (4, (2, 2))):
        fake(world)
        mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
        r = dryrun.lower(cfg, shape, mesh, f"{world}")
        assert r["status"] == "ok", r
        assert r["n_chips"] == world and r["opt_state"] == "fp32"
        assert r["memory"]["peak_bytes"] == \
            r["memory"]["argument_bytes"] + r["memory"]["temp_bytes"] > 0
        res[world] = r
    one, mesh = (res[w]["roofline"]["flops_per_chip"] for w in (1, 4))
    assert one / 4 <= mesh <= MESH_FLOPS_SLACK[kind] * one / 4, (one, mesh)
    assert res[1]["collectives"]["ops"] == {}
    assert res[4]["collectives"]["ops"].get("all-gather", 0) > 0
    assert res[4]["memory"]["argument_bytes"] \
        < res[1]["memory"]["argument_bytes"]


def test_cross_entropy_splits_over_the_mesh(fake):
    """The chunked cross-entropy, forward and backward, on the (2 x 2)
    mesh: each rank's products are one rank's / 4 exactly (its chunks
    keep their batch rows on their data ranks, and its logits are cut
    over the vocab on the model ranks)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import (distribute_batch, named_shardings,
                                         param_specs, place_on_mesh,
                                         rules_for)
    from repro_torch.models import lm
    from repro_torch.models.sharding import logical_axis_rules
    from repro_torch.roofline.hlo_analyze import analyze
    cfg = registry.get("qwen3", reduced=True).with_(n_layers=1,
                                                    vocab_chunk=64)
    flops = {}
    for world, mesh_shape in ((1, (1, 1)), (4, (2, 2))):
        fake(world)
        mesh = make_mesh(mesh_shape, ("data", "model"), device_type="cpu")
        params = inputs.params_specs(cfg)
        params, _ = place_on_mesh(mesh, params, named_shardings(
            mesh, param_specs(params, model_divisor=mesh_shape[1])))
        batch = distribute_batch(mesh, {
            "hidden": torch.empty((4, 64, cfg.d_model), device="meta"),
            "labels": torch.zeros((4, 64), dtype=torch.int32,
                                  device="meta")})
        wrt = [batch["hidden"].requires_grad_(),
               params.lm_head.emb.requires_grad_()]

        def ce():
            loss = lm.chunked_ce(params, cfg, batch["hidden"],
                                 batch["labels"])
            torch.autograd.grad(loss, wrt)

        with logical_axis_rules(rules_for(mesh)), implicit_replication():
            flops[world] = analyze(ce, default_group=world).flops
        dist.destroy_process_group()
    assert flops[1] > 0 and flops[4] == flops[1] / 4, flops


# -- decode-state and vector specs at production size -------------------------

def _norm(entry):
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _ref_leaf_specs(ref_dryrun, mesh, states, shape):
    import jax
    shardings = ref_dryrun.decode_state_shardings(mesh, states, shape)
    return jax.tree.map(lambda sh, leaf: tuple(
        _norm(e) for e in tuple(sh.spec) + (None,) * (
            leaf.ndim - len(sh.spec))), shardings, states)


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_decode_state_specs_match_reference(multi, ref_dryrun, fake):
    from jax.sharding import AbstractMesh
    from repro.launch import inputs as ref_inputs
    ref_mesh = AbstractMesh((2, 16, 16) if multi else (16, 16),
                            ("pod", "data", "model") if multi
                            else ("data", "model"))
    fake(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    n_leaves = 0
    for arch in registry.ARCHS:
        for shape_name in ("decode_32k", "long_500k"):
            rshape = ref_registry.SHAPES[shape_name]
            rstates = ref_inputs.decode_input_specs(
                ref_registry.get(arch), rshape)["states"]
            want = _ref_leaf_specs(ref_dryrun, ref_mesh, rstates, rshape)
            states = inputs.decode_input_specs(
                registry.get(arch), registry.SHAPES[shape_name])["states"]
            got = dryrun.decode_state_specs(mesh, states)
            stride = len(want)
            for i, layer in enumerate(got):
                ref_layer = want[i % stride]
                for key, spec in _leaves(layer):
                    ref_spec = _at(ref_layer, key)
                    assert tuple(_norm(e) for e in spec) == ref_spec[1:], \
                        (arch, shape_name, i, key)
                    n_leaves += 1
    assert n_leaves > 0
    for n in (1, 7, 32, 128, 256):
        want = tuple(_norm(e) for e in
                     ref_dryrun.vector_sharding(ref_mesh, n).spec)
        assert tuple(_norm(e) for e in dryrun.vector_spec(mesh, n)) == want


def _leaves(tree, prefix=()):
    if isinstance(tree, Spec):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))


def _at(tree, key):
    for k in key:
        tree = tree[k]
    return tree


# -- the 8-bit arm's scale specs, the cell policy, the CLI --------------------

SIZES = {"data": 16, "model": 16, "pod": 2}


@pytest.mark.parametrize("spec,shape,want_s", [
    (Spec(None, "model"), (64, 128 * 32), Spec(None, "model")),   # divides
    (Spec(None, "model"), (64, 256), Spec(None, None)),     # 2 blocks / 16
    (Spec(), (), Spec()),                                    # scalar
    (Spec("data", None), (64, 80), Spec()),                  # n % 128
    (Spec("data", None), (64, 128), Spec("data", None)),     # last uncut
    (Spec(None, ("pod", "data")), (8, 128 * 64), Spec(None, ("pod", "data"))),
    (Spec(None, ("pod", "data")), (8, 128 * 16), Spec(None, None)),
    (Spec("model"), (4, 8, 128 * 16), Spec("model", None, None)),  # padded
], ids=["divisible", "not-divisible", "scalar", "n%128", "last-uncut",
        "pod-data", "pod-data-not", "short-spec"])
def test_qs_specs_rule(spec, shape, want_s):
    got = opt.qs_specs({"w": spec}, {"w": shape}, SIZES.__getitem__)["w"]
    assert got["q"] == Spec(*spec, *[None] * (len(shape) - len(spec)))
    assert got["s"] == want_s


def test_qs_axis_size_reads_the_mesh_rules(fake):
    fake(512)
    size = dryrun.qs_axis_size(make_production_mesh(multi_pod=True,
                                                    device_type="cpu"))
    assert (size("data"), size("model")) == (32, 16)


@pytest.mark.parametrize("arch", sorted(registry.ARCHS))
def test_cell_policy_matches_reference(arch):
    shape = registry.SHAPES["train_4k"]
    for chips in (256, 512):
        cfg, status, eight = dryrun.cell_config(registry.get(arch), shape,
                                                chips)
        ref = ref_registry.get(arch)
        if ref_param_count(ref) * 4 > chips * 4e9:
            ref = ref.with_(param_dtype="bfloat16")
        assert cfg.param_dtype == ref.param_dtype
        assert status == ref_registry.cell_status(ref, shape)
        assert eight == (ref_param_count(ref) * 16 > chips * 12e9)


def test_list_matches_reference():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(["--list"])
    want = [f"{cfg.name:28s} {shape.name:12s} {status}"
            for cfg, shape, status in ref_registry.all_cells()]
    assert out.getvalue().splitlines() == want


def test_run_and_save_caches_and_records(tmp_path, monkeypatch):
    """A skipped cell's record is written and then read back cached; a
    cell that raises is recorded as FAILED with its traceback."""
    monkeypatch.setattr(dryrun, "RESULTS", tmp_path)
    res = dryrun.run_and_save("qwen3", "long_500k", "single")
    assert res["status"].startswith("skip")
    path = dryrun.cell_path("qwen3-14b", "long_500k", "single")
    assert json.loads(path.read_text()) == res
    assert dryrun.run_and_save("qwen3", "long_500k", "single") == res

    def boom(*a, **k):
        raise RuntimeError("no rule")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    res = dryrun.run_and_save("qwen3", "train_4k", "single", force=True)
    assert res["status"] == "FAILED: RuntimeError: no rule"
    assert "traceback" in res


def test_bfs_cell_on_the_cpu(fake):
    from repro_torch.configs.bfs_graph500 import GRAPHS
    from repro_torch.core.bfs_distributed import partition_sizes
    r = dryrun.lower_bfs_cell("rmat-18", "single", device="cpu")
    g = GRAPHS["rmat-18"]
    v_loc, e_loc = partition_sizes(g.n_vertices, g.n_edges_directed, 256)
    assert r["status"] == "ok" and r["n_chips"] == 256
    assert 1 <= r["layers_full_program"] <= 64
    assert r["dispatch"]["launches"] == {"rowsweep_candidates": 1}
    assert r["kernel_launches"] == {"rowsweep": 0}       # the plain arm
    payload = 256 * v_loc * 4                             # (v_cap,) int32
    assert r["collectives"]["ops"] == {"all-reduce": 1}
    assert r["collectives"]["payload_bytes"] == payload
    assert r["collectives"]["wire_bytes"] == pytest.approx(
        payload * _wire_factor("all-reduce", 256))
    assert r["bytes_per_chip_edges"] == 4 * e_loc


# -- the report ---------------------------------------------------------------

def test_report_renders_as_reference():
    from repro.roofline import report as ref_report
    ro = {"t_compute_s": 0.5, "t_memory_s": 2e-4, "t_collective_s": 3.0,
          "bottleneck": "collective", "useful_flops_ratio": 0.42,
          "mfu_bound": 0.031}
    cells = [
        {"arch": "a", "shape": "train_4k", "mesh": "single", "status": "ok",
         "roofline": ro},
        {"arch": "b", "shape": "long_500k", "mesh": "single",
         "status": "skip: quadratic"},
        {"arch": "c", "shape": "decode_32k", "mesh": "single",
         "status": "FAILED: x"},
        {"arch": "d", "shape": "graph500", "mesh": "single", "status": "ok",
         "roofline": ro},
        {"arch": "e", "shape": "train_4k", "mesh": "multi", "status": "ok",
         "roofline": ro},
    ]
    for mesh in ("single", "multi"):
        assert report.render(cells, mesh) == ref_report.render(cells, mesh)
    assert set(report.GUIDANCE) == set(ref_report.GUIDANCE)
    for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k",
              "graph500", "other"):
        assert report.shape_kind(s) == ref_report.shape_kind(s)
    for x in (0, 1e-5, 0.25, 3.0):
        assert report.fmt_s(x) == ref_report.fmt_s(x)
    lines = report.render_guidance(cells, "single").splitlines()
    assert lines == ["- **a x train_4k**: "
                     + report.GUIDANCE[("train", "collective")]]


def test_report_cli_reads_the_cells(tmp_path):
    cell = {"arch": "a", "shape": "decode_32k", "mesh": "single",
            "status": "ok", "roofline": {
                "t_compute_s": 1e-4, "t_memory_s": 0.02,
                "t_collective_s": 0.0, "bottleneck": "memory",
                "useful_flops_ratio": 0.5, "mfu_bound": 0.001}}
    (tmp_path / "a__decode_32k__single.json").write_text(json.dumps(cell))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report.main(["--dir", str(tmp_path), "--guidance"])
    text = out.getvalue()
    assert "| a | decode_32k | 100us | 20.0ms | 0 | memory | 0.50 | 0.1% |" \
        in text
    assert report.GUIDANCE[("decode", "memory")] in text


def test_meta_inputs_allocate_nothing():
    params = inputs.params_specs(registry.get("arctic-480b"))
    assert all(p.device.type == "meta" for p in params.parameters())
    assert torch.device("meta") == next(params.parameters()).device
