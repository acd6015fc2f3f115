"""Mesh construction, sharding rules and parameter / batch placements.

The reference's `launch/mesh.py` on a `torch.distributed` `DeviceMesh`
with DTensor placements in place of ``NamedSharding``.
``make_production_mesh`` is a FUNCTION: importing this module touches no
device and no process group.  Single pod: (data=16, model=16) = 256
ranks.  Multi-pod: (pod=2, data=16, model=16) = 512 ranks; the
data-parallel axis is (pod x data).

The process group comes first (`torch.distributed.init_process_group`
with its address, world size and rank); a mesh spans all of it.

Parameter specs follow the reference's path rules over its stacked
tree.  The port keeps layers unstacked (a `transformer.Stack` of
blocks), so ``layers.3.attn.wq.w`` reads as the reference's path
``layers/attn/wq/w`` and takes that stacked leaf's spec minus its
leading layer axis.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.errors import ReproError
from repro_torch.models.sharding import (DEFAULT_RULES, SINGLE_POD_RULES,
                                         Spec, is_dtensor, placements_for)


class MeshSizeError(ReproError, ValueError):
    """The process group's world size is not the mesh's rank count."""


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type=None):
    """A `DeviceMesh` of ``shape`` named ``axes`` over the initialised
    process group, on ``device_type`` (``"cuda"`` by default, as every
    entry point; ``"cpu"`` when asked; on a gloo group a CUDA mesh's
    collectives are staged through host memory, `launch.staging`).
    Raises `MeshSizeError` unless the world size is the mesh's rank
    count, then, for a CUDA mesh without CUDA, as
    `device.resolve_device` does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or world != need:
        raise MeshSizeError(
            f"a {shape} mesh {axes} needs a process group of world size "
            f"{need}; "
            + (f"this one has {world}" if dist.is_initialized()
               else "none is initialised"))
    dev = resolve_device(DEFAULT_DEVICE if device_type is None
                         else device_type)
    if dev.type == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.launch import staging
        staging.install()
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def rules_for(mesh) -> dict:
    return DEFAULT_RULES if "pod" in mesh.mesh_dim_names \
        else SINGLE_POD_RULES


def data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


# ---------------------------------------------------------------------------
# Parameter / batch shardings
# ---------------------------------------------------------------------------

_MODEL_DIM_BY_PATH = (
    # (path substring, candidate dims to cut over "model", priority
    #  order; indices are for the UNSTACKED leaf, negatives from the
    #  end).  First candidate divisible by the model-axis size wins;
    #  otherwise the leaf replicates (GQA head counts like 40 or kv=1
    #  fall back to the d_model / ff dim).
    ("moe/w_gate/w", (0,)), ("moe/w_up/w", (0,)),   # expert dim
    ("moe/w_down/w", (0,)),
    ("embed/emb", (0,)), ("lm_head/emb", (0,)),     # vocab dim
    ("wq/w", (1, 0)), ("wk/w", (1, 0)), ("wv/w", (1, 0)),
    ("wo/w", (0, -1)),
    ("w_gate/w", (-1,)), ("w_up/w", (-1,)), ("w_down/w", (-2,)),
    ("moe/router", ()),
    ("in_proj/w", (-1,)), ("out_proj/w", (-2,)),
    ("bc_proj/w", ()), ("dt_proj/w", (-1,)),
    ("time_mix/w_k/w", (-1,)), ("time_mix/w_v/w", (-1,)),
    ("time_mix/w_r/w", (-1,)), ("time_mix/w_g/w", (-1,)),
    ("time_mix/w_o/w", (-2,)),
    ("channel_mix/w_k/w", (-1,)), ("channel_mix/w_v/w", (-2,)),
)


# FSDP: giant parameter stacks additionally cut a SECOND dim over the
# DATA axis (fully-sharded weights), so the 400B-class MoE experts do
# not replicate across the data axis.
_DATA_DIM_BY_PATH = (
    ("moe/w_gate/w", (-1,)), ("moe/w_up/w", (-1,)),   # expert ff dim
    ("moe/w_down/w", (-1,)),                          # expert out dim
)

#: the `transformer.Stack` children of an `lm.LM`, whose leaves the
#: reference stacks over layers
_STACKS = ("layers", "encoder")


def _spec_for_path(path: str, shape, stacked: bool, divisor: int,
                   data_divisor: int = 0) -> Spec:
    ndim = len(shape)
    spec = [None] * ndim
    for frag, dims in _MODEL_DIM_BY_PATH:
        if frag in path:
            for dim in dims:
                d = dim if dim >= 0 else ndim + dim
                if dim >= 0 and stacked:
                    d += 1        # skip the leading layer-stack axis
                if 0 <= d < ndim and shape[d] % divisor == 0 \
                        and shape[d] >= divisor:
                    spec[d] = "model"
                    break
            break
    if data_divisor > 1:
        for frag, dims in _DATA_DIM_BY_PATH:
            if frag in path:
                for dim in dims:
                    d = dim if dim >= 0 else ndim + dim
                    if dim >= 0 and stacked:
                        d += 1
                    if 0 <= d < ndim and spec[d] is None \
                            and shape[d] % data_divisor == 0 \
                            and shape[d] >= data_divisor:
                        spec[d] = "data"
                        break
                break
    return Spec(*spec)


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def spec_for_name(name: str, shape, model_divisor: int = 16,
                  data_divisor: int = 0) -> Spec:
    """The `Spec` of the port's parameter ``name`` of ``shape``: a leaf
    of a stack (``layers.<i>.<rest>``) takes the reference's stacked
    leaf's spec at ``layers/<rest>`` minus the layer axis."""
    head, *rest = name.split(".")
    if head in _STACKS and rest and rest[0].isdigit():
        path = "/".join([head, *rest[1:]])
        spec = _spec_for_path(path, (1, *shape), True, model_divisor,
                              data_divisor)
        return Spec(*spec[1:])
    return _spec_for_path(name.replace(".", "/"), tuple(shape), False,
                          model_divisor, data_divisor)


def param_specs(params, model_divisor: int = 16,
                data_divisor: int = 0) -> dict:
    """{name: `Spec`} for a model's parameters (an `nn.Module`, on any
    device, ``meta`` included, or a flat dict of tensors).

    ``model_divisor`` is the model-axis size; dims that don't divide
    fall back through the candidates or replicate.  ``data_divisor`` > 1
    enables FSDP cuts for the paths in _DATA_DIM_BY_PATH (the MoE expert
    stacks).
    """
    return {name: spec_for_name(name, p.shape, model_divisor, data_divisor)
            for name, p in _named(params).items()}


def placements(mesh, spec) -> tuple:
    """A `Spec` of logical names, resolved through `rules_for`, as
    DTensor placements on ``mesh``: ``Shard(d)`` on each mesh dim that
    the entry of tensor dim ``d`` names, ``Replicate()`` elsewhere."""
    rules = rules_for(mesh)
    phys = Spec(*[rules.get(e) if isinstance(e, str) else e for e in spec])
    pl = placements_for(mesh, phys)
    if pl is None:
        raise ValueError(f"spec {spec} names a mesh dim the mesh "
                         f"{mesh.mesh_dim_names} lacks: {phys}")
    return pl


def named_shardings(mesh, spec_tree: dict) -> dict:
    """{name: placements} of a {name: `Spec`} tree on ``mesh`` (nested
    dicts, such as `train.optimizer.qs_specs`' {"q", "s"}, kept)."""
    return {k: named_shardings(mesh, s) if isinstance(s, dict)
            else placements(mesh, s) for k, s in spec_tree.items()}


def batch_specs(mesh, batch: dict) -> dict:
    """Shard the leading (batch) dim of every batch leaf over data."""
    da = data_axes(mesh)
    return {k: placements(mesh, Spec(da, *[None] * (x.ndim - 1)))
            for k, x in batch.items()}


def _distribute(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """``t`` as a DTensor under ``place``, each rank keeping a copy of
    its own shard (so the full tensor can be freed).  A plain ``t`` is
    the same full value on every rank and is cut with no communication;
    a DTensor ``t`` is redistributed, itself if already there."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if is_dtensor(t):
        if tuple(t.placements) == tuple(place):
            return t
        d = t.detach().redistribute(mesh, place)
    else:
        d = distribute_tensor(t.detach(), mesh, place, src_data_rank=None)
    return DTensor.from_local(d.to_local().clone(), mesh, d.placements,
                              run_check=False, shape=d.shape,
                              stride=d.stride())


def distribute_batch(mesh, batch: dict) -> dict:
    """A batch (the same on every rank) as DTensors under `batch_specs`."""
    return {k: _distribute(x, mesh, p)
            for (k, x), p in zip(batch.items(),
                                 batch_specs(mesh, batch).values())}


def place_on_mesh(mesh, params: nn.Module, param_placements: dict,
                  opt_state: dict | None = None,
                  state_placements: dict | None = None):
    """Put a model's parameters, and an optimizer state, onto ``mesh``.

    A plain tensor is the same full value on every rank (one seed, one
    checkpoint), and each rank keeps its shard; a DTensor is
    redistributed.  ``params``' parameters are replaced in place by
    DTensor parameters under ``param_placements`` ({name: placements});
    one already there is kept.  ``opt_state``'s ``m`` and ``v`` go under
    ``state_placements`` ({name: placements}; the parameters' when
    None, `train.optimizer.zero1_specs` for ZeRO-1); its ``step`` stays
    a plain tensor.  An 8-bit state's m holds {"q", "s"} per leaf, and
    takes {name: {"q": placements, "s": placements}}
    (`train.optimizer.qs_specs`), its v the "q" placements.
    `optimizer.init` of placed parameters makes its moments at their
    placements, so the full-size fp32 state never exists.  Returns
    (params, opt_state)."""
    for name, p in list(params.named_parameters()):
        placed = _distribute(p, mesh, param_placements[name])
        if placed is not p:
            owner, _, leaf = name.rpartition(".")
            module = params.get_submodule(owner) if owner else params
            module._parameters[leaf] = nn.Parameter(
                placed, requires_grad=p.requires_grad)
    if opt_state is None:
        return params, None
    places = state_placements or param_placements

    def one(t, place):
        if isinstance(t, dict):                 # the 8-bit arm's q and s
            return {part: _distribute(x, mesh, place[part])
                    for part, x in t.items()}
        if isinstance(place, dict):             # its v, at q's placements
            place = place["q"]
        return _distribute(t, mesh, place)

    def moments(tree):
        return {k: one(t, places[k]) for k, t in tree.items()}

    return params, {"m": moments(opt_state["m"]),
                    "v": moments(opt_state["v"]),
                    "step": opt_state["step"]}
