"""The sharding slice against the reference: `models/sharding.py`,
`launch/mesh.py`'s specs and rules, `train/optimizer.py:zero1_specs`.

Every arch of `configs.registry` at its FULL config: the port's
parameters on the meta device, the reference's through
``jax.eval_shape``.  The port keeps layers unstacked, so each port leaf
of a stack is held to the reference's stacked leaf's spec minus its
leading layer axis.  The rules, `resolve`, `shard` and the placements
run on a one-rank gloo group in this process.
"""
from __future__ import annotations

import functools
import types

import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import registry as ref_registry
from repro.launch import inputs as ref_inputs, mesh as ref_mesh
from repro.models import sharding as ref_sharding
from repro.train import optimizer as ref_opt

from repro_torch.configs import registry
from repro_torch.launch import inputs, mesh as lmesh
from repro_torch.models import sharding
from repro_torch.train import optimizer as opt

ARCHS = sorted(registry.ARCHS)
MODEL_DIVISORS = (2, 4, 16)
DATA_DIVISORS = (0, 2, 16)
STACKS = ("layers", "encoder")


@functools.lru_cache(maxsize=None)
def shapes(name: str):
    """(reference ShapeDtypeStruct tree, port meta LM) of the full arch."""
    return (ref_inputs.params_specs(ref_registry.ARCHS[name]),
            inputs.params_specs(registry.ARCHS[name]))


def ref_leaf(tree, name: str):
    """The reference leaf of the port's parameter ``name``: a stack's
    layer i sits at stride position i % stride of the stacked tuple."""
    head, *rest = name.split(".")
    node = tree[head]
    if head in STACKS:
        i = int(rest.pop(0))
        node = node[i % len(node)]
    for key in rest:
        node = node[key]
    return node


def held_to_reference(got: dict, want_tree, what: str) -> None:
    assert got, what
    for name, spec in got.items():
        assert isinstance(spec, sharding.Spec), (what, name)
        want = tuple(ref_leaf(want_tree, name))
        if name.split(".")[0] in STACKS:
            assert want[0] is None, (what, name, want)  # the layer axis
            want = want[1:]
        assert tuple(spec) == want, (what, name, spec, want)


@pytest.mark.parametrize("data_divisor", DATA_DIVISORS)
@pytest.mark.parametrize("model_divisor", MODEL_DIVISORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, model_divisor, data_divisor):
    ref_shapes, port = shapes(arch)
    want = ref_mesh.param_specs(ref_shapes, model_divisor, data_divisor)
    got = lmesh.param_specs(port, model_divisor, data_divisor)
    assert set(got) == {k for k, _ in port.named_parameters()}
    held_to_reference(got, want, f"{arch} {model_divisor}/{data_divisor}")


@pytest.mark.parametrize("data_divisor", [d for d in DATA_DIVISORS if d])
@pytest.mark.parametrize("model_divisor", MODEL_DIVISORS)
@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_specs_match_reference(arch, model_divisor, data_divisor):
    ref_shapes, port = shapes(arch)
    ref_specs = ref_mesh.param_specs(ref_shapes, model_divisor,
                                     data_divisor)
    specs = lmesh.param_specs(port, model_divisor, data_divisor)
    want = ref_opt.zero1_specs(ref_specs, ref_shapes, data_divisor)
    got = opt.zero1_specs(specs, port, data_divisor)
    held_to_reference(got, want, f"{arch} zero1 {data_divisor}")
    # a leaf cut over data nowhere only when no free dim divides
    for name, spec in got.items():
        if "data" not in spec:
            shape = dict(port.named_parameters())[name].shape
            assert all(s is not None or n % data_divisor
                       for s, n in zip(spec, shape)), (name, spec)


def test_zero1_needs_a_data_divisor():
    """Data divisor 0 (no data axis) divides by zero in both packages."""
    ref_shapes, port = shapes("h2o-danube-1.8b")
    with pytest.raises(ZeroDivisionError):
        ref_opt.zero1_specs(ref_mesh.param_specs(ref_shapes, 2),
                            ref_shapes, 0)
    with pytest.raises(ZeroDivisionError):
        opt.zero1_specs(lmesh.param_specs(port, 2), port, 0)


def test_zero1_specs_take_shapes_too():
    _, port = shapes("qwen3-14b")
    specs = lmesh.param_specs(port, 16)
    by_shape = {k: tuple(p.shape) for k, p in port.named_parameters()}
    assert opt.zero1_specs(specs, by_shape, 16) \
        == opt.zero1_specs(specs, port, 16)


# ---------------------------------------------------------------------------
# Rules, resolve, shard
# ---------------------------------------------------------------------------

LOGICAL = [("data", None, "model"), ("data", "model", None),
           ("model", None, None, None), (None, "model"), ("data",),
           (None, None)]


@pytest.mark.parametrize("rules", ["DEFAULT_RULES", "SINGLE_POD_RULES"])
def test_resolve_matches_reference(rules):
    assert getattr(sharding, rules) == getattr(ref_sharding, rules)
    for logical in LOGICAL:
        with ref_sharding.logical_axis_rules(getattr(ref_sharding, rules)):
            want = ref_sharding.resolve(*logical)
        with sharding.logical_axis_rules(getattr(sharding, rules)):
            got = sharding.resolve(*logical)
        assert tuple(got) == tuple(want), (rules, logical, got, want)
    # outside the rules every name resolves to None, as there
    assert tuple(sharding.resolve("data", "model")) \
        == tuple(ref_sharding.resolve("data", "model")) == (None, None)


@pytest.mark.parametrize("axes", [("data", "model"),
                                  ("pod", "data", "model")])
def test_rules_for_and_data_axes_match_reference(axes):
    ref = types.SimpleNamespace(axis_names=axes)
    port = types.SimpleNamespace(mesh_dim_names=axes)
    assert lmesh.rules_for(port) == ref_mesh.rules_for(ref)
    assert lmesh.data_axes(port) == ref_mesh.data_axes(ref)


def test_rules_nest_and_restore():
    assert sharding.resolve("data") == sharding.Spec(None)
    with sharding.logical_axis_rules(sharding.DEFAULT_RULES):
        with sharding.logical_axis_rules(sharding.SINGLE_POD_RULES):
            assert sharding.resolve("data") == sharding.Spec("data")
        assert sharding.resolve("data") == sharding.Spec(("pod", "data"))
    assert sharding.resolve("data") == sharding.Spec(None)


def test_spec_stands_in_for_partition_spec():
    s = sharding.Spec("data", None, ("pod", "model"))
    assert tuple(s) == tuple(P("data", None, ("pod", "model")))
    assert s == ("data", None, ("pod", "model")) and hash(s)
    assert repr(s) == "Spec('data', None, ('pod', 'model'))"


def test_shard_is_a_no_op_without_rules_or_on_plain_tensors():
    x = torch.arange(12.0).reshape(3, 4)
    assert sharding.shard(x, "data", "model") is x
    with sharding.logical_axis_rules(sharding.SINGLE_POD_RULES):
        assert sharding.shard(x, "data", "model") is x
        assert sharding.pin(x) is x and sharding.settle(x) is x
    assert sharding.map_local(torch.add, (x, x), ((None,), (None,))) \
        .equal(x + x)


def test_make_mesh_needs_its_world_size():
    with pytest.raises(lmesh.MeshSizeError, match="world size 256"):
        lmesh.make_production_mesh()
    with pytest.raises(lmesh.MeshSizeError, match="world size 512"):
        lmesh.make_production_mesh(multi_pod=True)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """One in-process gloo rank."""
    store = tmp_path_factory.mktemp("gloo") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_and_placements(group):
    with pytest.raises(lmesh.MeshSizeError, match="world size 4; this "
                                                  "one has 1"):
        lmesh.make_mesh((2, 2), ("data", "model"), device_type="cpu")
    mesh = lmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    assert mesh.device_type == "cpu" and mesh.mesh_dim_names == (
        "data", "model")
    assert lmesh.placements(mesh, sharding.Spec(None, "model")) \
        == (Replicate(), Shard(1))
    assert lmesh.placements(mesh, sharding.Spec("data", None)) \
        == (Shard(0), Replicate())
    specs = {"a": sharding.Spec("model", None), "b": sharding.Spec()}
    assert lmesh.named_shardings(mesh, specs) == {
        "a": (Replicate(), Shard(0)), "b": (Replicate(), Replicate())}
    batch = {"tokens": torch.zeros(4, 8, dtype=torch.int32)}
    assert lmesh.batch_specs(mesh, batch) == {
        "tokens": (Shard(0), Replicate())}
    pod = lmesh.make_mesh((1, 1, 1), ("pod", "data", "model"),
                          device_type="cpu")
    assert lmesh.placements(pod, sharding.Spec("data", "model")) \
        == (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="names a mesh dim"):
        lmesh.placements(mesh, sharding.Spec(("pod", "data")))


def test_shard_redistributes_a_dtensor(group):
    mesh = lmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    x = torch.arange(24.0).reshape(4, 6)
    d = lmesh.distribute_batch(mesh, {"x": x})["x"]
    assert isinstance(d, DTensor) and d.placements == (Shard(0),
                                                       Replicate())
    assert sharding.shard(d, "data", "model") is d      # no rules: as is
    with sharding.logical_axis_rules(lmesh.rules_for(mesh)):
        y = sharding.shard(d, None, "model")
        assert y.placements == (Replicate(), Shard(1))
        assert sharding.shard(d, "data") is d           # another rank
        assert torch.equal(y.full_tensor(), x)
        out = sharding.map_local(lambda a, b: a * 2 + b, (d, x),
                                 (("data", None), (None, "model")))
        assert out.placements == d.placements
        assert torch.equal(out.full_tensor(), 3 * x)


def test_place_on_mesh(group):
    from repro_torch.models import lm
    cfg = registry.get("qwen3", reduced=True).with_(dtype="float32",
                                                    n_layers=2)
    p = lm.init_params(cfg, 0, device="cpu")
    full = {k: t.detach().clone() for k, t in p.named_parameters()}
    mesh = lmesh.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    places = lmesh.named_shardings(mesh, lmesh.param_specs(p, 1))
    p, _ = lmesh.place_on_mesh(mesh, p, places)
    state = opt.init(p)
    zero1 = lmesh.named_shardings(mesh, opt.zero1_specs(
        lmesh.param_specs(p, 1), p, 1))
    p, state = lmesh.place_on_mesh(mesh, p, places, state, zero1)
    for k, t in p.named_parameters():
        assert isinstance(t, DTensor) and t.placements == places[k]
        assert torch.equal(t.full_tensor(), full[k])
        assert state["m"][k].placements == zero1[k]
    # the 8-bit state: q and s under qs_specs, v at q's placements
    p8 = lm.init_params(cfg, 0, device="cpu")
    s8 = opt.init_8bit(p8)
    want = {k: {part: t.clone() for part, t in mq.items()}
            for k, mq in s8["m"].items()}
    qs = lmesh.named_shardings(mesh, opt.qs_specs(
        opt.zero1_specs(lmesh.param_specs(p8, 1), p8, 1), p8, lambda a: 1))
    p8, s8 = lmesh.place_on_mesh(mesh, p8, places, s8, qs)
    for k, mq in s8["m"].items():
        for part in ("q", "s"):
            assert mq[part].placements == qs[k][part]
            assert torch.equal(mq[part].full_tensor(), want[k][part])
        assert s8["v"][k].placements == qs[k]["q"]


# ---------------------------------------------------------------------------
# Host staging of DTensor's collectives (gloo over CUDA tensors)
# ---------------------------------------------------------------------------

def _staged_round_trip(x: torch.Tensor, key: str) -> None:
    """With the staging installed on ``key``, every staged collective on
    a one-rank gloo group returns its input, on its device, and is
    counted with its bytes and seconds; a collective that is not staged
    is refused on gloo."""
    from repro_torch.launch import staging
    f = torch.ops._c10d_functional
    name = dist.group.WORLD.group_name
    staging.install(key)
    try:
        staging.reset()
        for out in (f.all_reduce(x, "sum", name),
                    f.all_reduce(x, "avg", name),
                    f.all_gather_into_tensor(x, 1, name),
                    f.reduce_scatter_tensor(x, "sum", 1, name)):
            out = f.wait_tensor(out)
            assert out.device == x.device and torch.equal(out, x)
        y = x.clone()
        out = f.all_reduce_(y, "sum", name)
        assert out.data_ptr() == y.data_ptr() and torch.equal(y, x)
        nbytes = x.numel() * x.element_size()
        assert staging.STAGED["all_reduce"] == 3
        assert staging.STAGED["all_reduce bytes"] == 3 * nbytes
        for op in ("all_gather_into_tensor", "reduce_scatter_tensor"):
            assert staging.STAGED[op] == 1, op
        assert staging.STAGED["staged s"] > 0
        assert staging.STAGED["device wait s"] >= 0
        with pytest.raises(staging.StagingError, match="broadcast"):
            f.broadcast(x, 0, name)
        staging.reset()
        assert not staging.STAGED
    finally:
        staging.uninstall(key)


def test_staging_runs_each_collective_through_the_host(group):
    _staged_round_trip(torch.arange(12.0).reshape(4, 3), "CPU")


def test_staging_leaves_other_backends_and_uninstalls(group):
    """A group of another backend beside the gloo one keeps the ops' own
    kernels, and `uninstall` gives the gloo group its own back."""
    from torch.testing._internal.distributed import fake_pg  # noqa: F401
    from repro_torch.launch import staging
    f = torch.ops._c10d_functional
    other = dist.new_group([0], backend="fake")
    assert dist.get_backend(other) != "gloo"
    x = torch.arange(6.0)
    staging.install("CPU")
    try:
        staging.reset()
        for out in (f.all_reduce(x, "sum", other.group_name),
                    f.all_gather_into_tensor(x, 1, other.group_name),
                    f.broadcast(x, 0, other.group_name)):
            assert f.wait_tensor(out).shape == x.shape
        assert not staging.STAGED
        f.wait_tensor(f.all_reduce(x, "sum", dist.group.WORLD.group_name))
        assert staging.STAGED["all_reduce"] == 1
    finally:
        staging.uninstall("CPU")
    assert "CPU" not in staging._LIBS
    staging.reset()
    out = f.wait_tensor(f.all_reduce(x, "sum", dist.group.WORLD.group_name))
    assert torch.equal(out, x) and not staging.STAGED
    dist.destroy_process_group(other)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


@pytest.mark.cuda
def test_staging_on_the_card(group):
    _cuda()
    _staged_round_trip(torch.arange(12.0, device="cuda").reshape(4, 3),
                       "CUDA")


@pytest.mark.cuda
def test_cuda_mesh_on_gloo_stages_its_collectives(group):
    """A CUDA mesh over gloo installs the staging, and a DTensor's
    redistribution on it runs through the host."""
    _cuda()
    from repro_torch.launch import staging
    mesh = lmesh.make_mesh((1, 1), ("data", "model"))
    assert mesh.device_type == "cuda" and "CUDA" in staging._LIBS
    x = torch.arange(24.0, device="cuda").reshape(4, 6)
    d = lmesh.distribute_batch(mesh, {"x": x})["x"]
    assert torch.equal(d.full_tensor(), x)
