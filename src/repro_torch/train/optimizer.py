"""AdamW on a model's named parameters: schedule, clipping, fp32 and
8-bit state.

The reference's `train/optimizer.py` on torch.  Parameters are an
`nn.Module` (its ``named_parameters()``) or a flat dict of tensors;
gradients and state are dicts keyed by the same names:

    fp32 state   {"m": {name: fp32}, "v": {name: fp32}, "step": int32}
    8-bit state  {"m": {name: {"q": int8, "s": fp32}},
                  "v": {name: bf16}, "step": int32}

`update` and `update_8bit` write the new parameters and state in place
under ``torch.no_grad`` and return them, with the reference's formulas
in fp32.

On a mesh (`launch.mesh.place_on_mesh`) the parameters, gradients, m and
v of the fp32 arm are DTensors.  A gradient is first brought to its
parameter's placements (the data-parallel reduction); m and v may sit
at other placements (`zero1_specs`: cut over "data" as well), and are
brought to the parameter's for the update and written back to their
own.  The update itself runs on each rank's local shards.  The 8-bit
arm's q and v sit at the moments' placements and its scales at
`qs_specs`' (each rank keeps the scales of its own blocks where they
divide), and it updates each rank's local shards the same way.

Scale groups of the 8-bit arm.  The reference quantises each *stacked*
leaf: the same parameter of every layer at one stride position of a
`transformer.Stack`, stacked over layers.  When a leaf's last dim is a
multiple of `Q_BLOCK`, each 128-wide block has its own scale, so
per-layer blocks are the reference's blocks.  When it is not (every
leaf at reduced width; wq/wk/wv at head_dim 80), the reference keeps ONE
scale over the whole stack, so the port quantises such a group of
per-layer leaves with one scale too (`scale_groups`), and every member
of the group holds that scale as its ``s``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.models.sharding import Spec, is_dtensor
from repro_torch.models.transformer import Stack


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _named(params) -> dict:
    """{name: tensor} of a module's parameters or of a flat dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup + cosine decay to min_lr_frac (fp32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    progress = torch.clamp((step - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
        * 0.5 * (1 + torch.cos(math.pi * progress))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _step0(params: dict) -> torch.Tensor:
    device = _local(next(iter(params.values()))).device
    return torch.zeros((), dtype=torch.int32, device=device)


def init(params) -> dict:
    """Zero fp32 moments, each like its parameter (a DTensor's at its
    placements), and step 0."""
    params = _named(params)

    def zeros(p):
        return torch.zeros_like(p.detach(), dtype=torch.float32)

    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": _step0(params)}


def global_norm(grads: dict):
    """sqrt of the sum over leaves of each leaf's fp32 sum of squares.
    With DTensor leaves (none partial), each rank sums its shards, each
    divided by its number of replicas, and one all-reduce adds the
    ranks' sums."""
    leaves = list(grads.values())
    mesh = next((g.device_mesh for g in leaves if is_dtensor(g)), None)
    if mesh is None:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    from torch.distributed.tensor import DTensor, Partial

    def replicas(g) -> int:
        if not is_dtensor(g):
            return mesh.size()
        return math.prod(mesh.size(i) for i, pl in enumerate(g.placements)
                         if pl.is_replicate())

    total = sum(torch.sum(torch.square(_local(g).float())) / replicas(g)
                for g in leaves)
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim,
                               run_check=False).full_tensor()
    return torch.sqrt(total)


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writes reach the DTensor), or
    ``t``."""
    return t.to_local() if is_dtensor(t) else t


def _to(t: torch.Tensor, placements) -> torch.Tensor:
    """DTensor ``t`` at ``placements`` (itself when they agree, or when
    ``placements`` is None), or ``t``."""
    if placements is None or not is_dtensor(t) \
            or tuple(t.placements) == placements:
        return t
    return t.redistribute(t.device_mesh, placements)


def _at(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """DTensor ``t`` at ``like``'s placements, or ``t``."""
    return _to(t, tuple(like.placements)) if is_dtensor(like) else t


def _write_back(leaf: torch.Tensor, updated: torch.Tensor) -> None:
    """Store ``updated`` (``leaf`` brought to other placements and
    updated there) into ``leaf`` at its own placements."""
    if updated is not leaf:
        _local(leaf).copy_(_local(_at(updated, leaf)))


#: leaves above this many elements are updated in slices of their
#: leading dim, so the fp32 temporaries stay bounded (the embeddings)
_CHUNK_ELEMS = 64 * 1024 * 1024


def _slices(p: torch.Tensor):
    """Index slices of ``p``'s leading dim of at most ~`_CHUNK_ELEMS`."""
    if p.numel() <= _CHUNK_ELEMS or p.ndim < 2:
        yield slice(None)
        return
    rows = max(1, _CHUNK_ELEMS // (p.numel() // p.shape[0]))
    for i in range(0, p.shape[0], rows):
        yield slice(i, i + rows)


def _coefficients(cfg: AdamWConfig, grads: dict, state: dict):
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    return step, lr, gnorm, scale, b1c, b2c


@torch.no_grad()
def update(cfg: AdamWConfig, params, grads: dict, state: dict):
    """One AdamW step with global-norm clipping, in place.  Returns
    (params, state, {"lr", "grad_norm"}).

    On a mesh the update runs at the moments' placements: each gradient
    is brought there (a gradient partial over data, one reduce-scatter)
    and so is each parameter (from a replicated one, a local slice with
    no collective), each rank updates its slices, and only the parameter
    goes back to its own placement (under `zero1_specs`, one all-gather
    per leaf)."""
    named = _named(params)
    grads = {k: _at(g, state["m"][k]) for k, g in grads.items()}
    step, lr, gnorm, scale, b1c, b2c = _coefficients(cfg, grads, state)
    for name, p_all in named.items():
        p_at = _at(p_all, state["m"][name])
        p, m_all, v_all, g_all = (_local(t) for t in (
            p_at, state["m"][name], state["v"][name], grads[name]))
        for sl in _slices(p):
            g = g_all[sl].to(torch.float32)
            m = cfg.b1 * m_all[sl] + (1 - cfg.b1) * g * scale
            v = cfg.b2 * v_all[sl] + (1 - cfg.b2) * torch.square(g * scale)
            p32 = p[sl].to(torch.float32)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            upd = upd + cfg.weight_decay * p32
            p[sl] = (p32 - lr * upd).to(p.dtype)
            m_all[sl] = m
            v_all[sl] = v
        _write_back(p_all, p_at)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Quantized optimizer state (bitsandbytes-style)
#
# m: int8, one fp32 scale per 128-wide block of the last dim (one scale
#    per stacked leaf when the last dim doesn't divide).  m is
#    zero-centered, so symmetric int8 works.
# v: bf16.  Symmetric int8 on the second moment zeros-out small entries
#    within a block, which 1/sqrt(v) then amplifies; bf16 keeps fp32's
#    exponent range with ~0.4% relative error.
# ---------------------------------------------------------------------------

Q_BLOCK = 128


def _blocked(x: torch.Tensor) -> bool:
    return x.ndim > 0 and x.shape[-1] % Q_BLOCK == 0


def _fallback_scale(absmax):
    return absmax / 127.0 + 1e-12


def _quantize(x: torch.Tensor, scale=None) -> dict:
    """{"q": int8, "s": fp32}: per-block scales, or one scale (``scale``
    when given: the leaf's group's) when the last dim does not divide."""
    if not _blocked(x):
        if scale is None:
            scale = _fallback_scale(torch.max(torch.abs(x)))
        q = torch.round(x / scale).to(torch.int8)
        return {"q": q, "s": scale.to(torch.float32)}
    n = x.shape[-1]
    blocked = x.reshape(*x.shape[:-1], n // Q_BLOCK, Q_BLOCK)
    scale = torch.amax(torch.abs(blocked), dim=-1, keepdim=True) / 127.0 \
        + 1e-12
    q = torch.round(blocked / scale).to(torch.int8)
    return {"q": q.reshape(x.shape),
            "s": scale.squeeze(-1).to(torch.float32)}


def _dequantize(qs: dict, like_shape) -> torch.Tensor:
    q, s = qs["q"], qs["s"]
    if q.ndim == 0 or s.ndim == 0:
        return q.to(torch.float32) * s
    blocked = q.reshape(*q.shape[:-1], q.shape[-1] // Q_BLOCK, Q_BLOCK)
    return (blocked.to(torch.float32) * s[..., None]).reshape(like_shape)


def init_8bit(params) -> dict:
    params = _named(params)
    return {"m": {k: _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device))
                  for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.bfloat16,
                                 device=p.device)
                  for k, p in params.items()},
            "step": _step0(params)}


def scale_groups(params) -> list[list[str]]:
    """Parameter names in the reference's stacked leaves: for a
    `transformer.Stack` at ``prefix``, the parameter at relative path
    ``rel`` of every layer i with i % stride == j is one group; every
    other parameter is a group of its own.  Groups are in
    ``named_parameters()`` order of their first member."""
    key_of = {}
    if isinstance(params, nn.Module):
        for prefix, mod in params.named_modules():
            if isinstance(mod, Stack):
                for i, block in enumerate(mod):
                    for rel, _ in block.named_parameters():
                        key_of[f"{prefix}.{i}.{rel}"] = \
                            (prefix, i % mod.stride, rel)
    groups: dict = {}
    for name in _named(params):
        groups.setdefault(key_of.get(name, name), []).append(name)
    return list(groups.values())


def _work_placements(mq: dict):
    """Where a leaf's 8-bit update runs: at q's placements, except that a
    cut of the last dim is dropped where the scales keep no cut of their
    blocks (`qs_specs`: the blocks do not divide over it), so that every
    rank holds whole blocks and their scales.  None off a mesh."""
    q, s = mq["q"], mq["s"]
    if not is_dtensor(q):
        return None
    last = q.ndim - 1
    pl = list(q.placements)
    if s.ndim:
        from torch.distributed.tensor import Replicate
        for i, p in enumerate(pl):
            if p.is_shard(last) and not s.placements[i].is_shard(last):
                pl[i] = Replicate()
    return tuple(pl)


def _global_max(x: torch.Tensor, mesh) -> torch.Tensor:
    """The maximum of each rank's ``x`` over every rank of ``mesh`` (one
    all-reduce with MAX per mesh dim), or ``x`` off a mesh."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, Partial
    return DTensor.from_local(x, mesh, [Partial("max")] * mesh.ndim,
                              run_check=False).full_tensor()


@torch.no_grad()
def update_8bit(cfg: AdamWConfig, params, grads: dict, state: dict):
    """AdamW on int8-blockwise m and bf16 v (dequant -> update -> requant),
    in place.  A group that shares one scale is walked twice: first for
    the new m's absolute maximum over every member, then to write each
    member with the group's new scale; each member is brought to its work
    placements once for both walks, and no more than one member's fp32
    temporaries live at a time.

    On a mesh each leaf is updated at its work placements
    (`_work_placements`: q's, so the moments' under `zero1_specs`).  The
    gradients are brought there first (a gradient partial over data is
    reduced), so that the clipping norm is taken of reduced gradients,
    as `update` does; the parameter, q and v follow, each rank updates
    its local shards against its local scales, and what moved goes back
    to its own placements.  A group's shared scale needs its
    absolute maximum over every shard of every member: each rank takes
    the maximum of its shards, and one all-reduce with MAX per mesh dim
    (DTensor's ``Partial("max")`` made replicated) gives every rank the
    group's."""
    by_name = _named(params)
    grads = {k: _to(g, _work_placements(state["m"][k]))
             for k, g in grads.items()}
    step, lr, gnorm, scale, b1c, b2c = _coefficients(cfg, grads, state)
    groups = scale_groups(params)
    mesh = next((p.device_mesh for p in by_name.values() if is_dtensor(p)),
                None)

    def leaf(name):
        """The leaf's (p, g, q, s, v) at its work placements, and the
        DTensors to write back (own, moved)."""
        mq = state["m"][name]
        wp = _work_placements(mq)
        own = (by_name[name], mq["q"], state["v"][name])
        moved = tuple(_to(t, wp) for t in own)
        p, q, v = (_local(t) for t in moved)
        return ((p, _local(grads[name]), q, _local(mq["s"]), v),
                tuple(zip(own, moved)))

    def new_m(t, sl):
        p, g, q, s, v = t
        g = g[sl].to(torch.float32) * scale
        s = s[sl] if s.ndim else s
        m = cfg.b1 * _dequantize({"q": q[sl], "s": s}, g.shape) \
            + (1 - cfg.b1) * g
        return g, m

    def write(t, sl, g, m, group_scale=None):
        p, _, q, s, vb = t
        v = cfg.b2 * vb[sl].to(torch.float32) + (1 - cfg.b2) * torch.square(g)
        u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p[sl].to(torch.float32)
        p[sl] = (p[sl].to(torch.float32) - lr * u).to(p.dtype)
        qs = _quantize(m, group_scale)
        q[sl] = qs["q"]
        if group_scale is None:
            s[sl] = qs["s"]
        else:
            s.copy_(qs["s"])
        vb[sl] = v.to(torch.bfloat16)

    def written(pairs):
        for own, moved in pairs:
            _write_back(own, moved)

    for group in groups:
        if state["m"][group[0]]["s"].ndim:          # per-block scales
            for name in group:
                t, pairs = leaf(name)
                for sl in _slices(t[0]):
                    write(t, sl, *new_m(t, sl))
                written(pairs)
            continue
        everything = slice(None)
        members = [leaf(name) for name in group]
        absmax = torch.stack([torch.max(torch.abs(new_m(t, everything)[1]))
                              for t, _ in members]).max()
        group_scale = _fallback_scale(_global_max(absmax, mesh))
        for t, pairs in members:
            write(t, everything, *new_m(t, everything), group_scale)
            written(pairs)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def snapshot_8bit(params, state: dict) -> dict:
    """The full values of an 8-bit run's parameters and state on the CPU,
    {"p", "q", "s", "v"} each {name: tensor} (v as fp32), gathered from
    DTensors.  An fp32 state's m is quantized first under the 8-bit arm's
    rule (`scale_groups`), and its v rounded to bf16: what the 8-bit arm
    would store of those moments."""
    def full(t):
        t = t.full_tensor() if is_dtensor(t) else t
        return t.detach().cpu()

    named = _named(params)
    m = state["m"]
    if isinstance(next(iter(m.values())), dict):
        qs = {k: {"q": full(x["q"]), "s": full(x["s"])} for k, x in m.items()}
    else:
        qs = {}
        for group in scale_groups(params):
            ms = [full(m[k]) for k in group]
            scale = None
            if not _blocked(ms[0]):
                scale = _fallback_scale(torch.stack(
                    [torch.max(torch.abs(x)) for x in ms]).max())
            qs.update({k: _quantize(x, scale) for k, x in zip(group, ms)})
    return {"p": {k: full(t).float() for k, t in named.items()},
            "q": {k: x["q"] for k, x in qs.items()},
            "s": {k: x["s"] for k, x in qs.items()},
            "v": {k: full(t).to(torch.bfloat16).float()
                  for k, t in state["v"].items()}}


#: one bf16 unit in the last place, relative (the widest: just below a
#: power of two)
BF16_ULP = 2.0 ** -7


def gap_8bit(a: dict, b: dict, p_atol: float = 1e-5) -> dict:
    """How far two `snapshot_8bit`s are apart: the share of q entries that
    differ and the most levels any differs by, the largest relative gap
    of a scale, the share of v entries more than `BF16_ULP` apart
    (relative), and the share of parameter entries more than ``p_atol``
    apart with the largest such gap."""
    def total(part, fn):
        return sum(int(fn(a[part][k], b[part][k]).sum()) for k in a[part])

    def count(part):
        return sum(a[part][k].numel() for k in a[part])

    dq = [(a["q"][k].int() - b["q"][k].int()).abs() for k in a["q"]]
    return {
        "q_share": sum(int((d > 0).sum()) for d in dq) / count("q"),
        "q_levels": max(int(d.max()) if d.numel() else 0 for d in dq),
        "s_rel": max(float(((x - b["s"][k]).abs()
                            / x.abs().clamp_min(1e-30)).max())
                     for k, x in a["s"].items()),
        "v_share": total("v", lambda x, y: (x - y).abs()
                         > BF16_ULP * x.abs()) / count("v"),
        "p_share": total("p", lambda x, y: (x - y).abs() > p_atol)
        / count("p"),
        "p_abs": max(float((x - b["p"][k]).abs().max())
                     for k, x in a["p"].items())}


# ---------------------------------------------------------------------------
# ZeRO-1: optimizer-state sharding over the data axis
# ---------------------------------------------------------------------------

def zero1_specs(param_spec_tree: dict, params_shape, data_divisor: int):
    """m/v specs: param spec + cut the largest free dim over "data".

    A dim is eligible if unsharded in the param spec and divisible by
    the data-axis size.  Falls back to the param spec (replicated over
    data) when nothing divides — correctness never depends on it.
    ``param_spec_tree`` is {name: `Spec`} (`launch.mesh.param_specs`),
    ``params_shape`` the parameters (a module, on any device) or
    {name: tensor or shape}.
    """
    shapes = {k: tuple(getattr(v, "shape", v))
              for k, v in _named(params_shape).items()}

    def one(spec: Spec, shape) -> Spec:
        dims = list(spec) + [None] * (len(shape) - len(spec))
        if "data" in dims:
            return Spec(*dims)    # FSDP leaf: data axis already used
        best, best_size = None, 0
        for i, (s, n) in enumerate(zip(dims, shape)):
            if s is None and n % data_divisor == 0 and n > best_size:
                best, best_size = i, n
        if best is not None:
            dims[best] = "data"
        return Spec(*dims)

    return {k: one(spec, shapes[k]) for k, spec in param_spec_tree.items()}


def qs_specs(spec_tree: dict, params_shape, axis_size) -> dict:
    """The 8-bit arm's m specs, {name: {"q": spec, "s": spec}}, from the
    moments' specs (`zero1_specs`, or the parameters'): q shares the
    leaf's spec; the per-block scale (``(..., n // Q_BLOCK)``) keeps its
    leading dims' entries, and the last dim's only when the block count
    divides by that entry's size (``axis_size(name)``: the mesh size of a
    spec entry's name), else replicates it.  A leaf whose last dim is no
    multiple of `Q_BLOCK` has one 0-d scale (its group's), replicated
    (the reference's rule there gives the scale its leading dims' spec,
    which a 0-d scale cannot take).  This is the reference dry run's
    ``qs_spec`` rule."""
    shapes = {k: tuple(getattr(v, "shape", v))
              for k, v in _named(params_shape).items()}

    def one(spec: Spec, shape) -> dict:
        dims = list(spec) + [None] * (len(shape) - len(spec))
        q = Spec(*dims)
        if not shape or shape[-1] % Q_BLOCK:
            return {"q": q, "s": Spec()}
        last = dims[-1]
        if last is not None:
            names = [last] if isinstance(last, str) else list(last)
            div = math.prod(axis_size(a) for a in names)
            if (shape[-1] // Q_BLOCK) % div:
                last = None
        return {"q": q, "s": Spec(*dims[:-1], last)}

    return {k: one(spec, shapes[k]) for k, spec in spec_tree.items()}
