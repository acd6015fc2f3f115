"""Shared model primitives: the parameter tree, init, norms, RoPE,
embeddings, dense.

Parameters live in `Params`, an `nn.Module` whose children carry the
reference's dict keys, so ``p["wq"]["w"]`` reads as it does there and a
``state_dict()`` key is the reference's key path joined by dots.  Shapes
are the reference's too (wq is (D, H, hd), wo (H, hd, D)), so weights
cross as plain copies (`repro_torch.interop.lm_params_from_numpy`).

Init takes an explicit `torch.Generator` on the target device; the
draws differ from the reference's `jax.random` ones, their
distributions do not.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.models.sharding import settle


class Params(nn.Module):
    """A tree of parameters keyed like the reference's dict tree."""

    def __init__(self, tree: dict | None = None):
        super().__init__()
        for key, value in (tree or {}).items():
            self[key] = value

    def __setitem__(self, key: str, value) -> None:
        if isinstance(value, dict):
            value = Params(value)
        if isinstance(value, nn.Module):
            self.add_module(key, value)
        else:
            self.register_parameter(key, nn.Parameter(
                value, requires_grad=value.is_floating_point()))

    def __getitem__(self, key: str):
        if key in self._parameters:
            return self._parameters[key]
        return self._modules[key]

    def __contains__(self, key: str) -> bool:
        return key in self._parameters or key in self._modules

    def get(self, key: str, default=None):
        return self[key] if key in self else default


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype string (``"bfloat16"``, ``"float32"``) as a torch
    dtype."""
    dt = getattr(torch, name)
    assert isinstance(dt, torch.dtype), name
    return dt


def make_generator(seed_or_gen, device=DEFAULT_DEVICE) -> torch.Generator:
    """``seed_or_gen`` as a generator on ``device`` (an int seeds one; on
    the meta device, which draws nothing, a CPU one)."""
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    dev = torch.device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta"
                          else resolve_device(dev))
    gen.manual_seed(int(seed_or_gen))
    return gen


def cast_floats(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``module``'s float32 parameters to ``dtype`` in place."""
    if dtype == torch.float32:
        return module
    for p in module.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(dtype)
    return module


def truncated_normal(gen, shape, std, device):
    """std * N(0, 1) truncated to [-2, 2], float32 (the reference's)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=gen)


def dense_init(gen, d_in: int, d_out, device, std: float | None = None):
    """(d_in, *d_out) kernel with fan-in scaling (no bias, LLaMA-style)."""
    if isinstance(d_out, int):
        d_out = (d_out,)
    std = std if std is not None else d_in ** -0.5
    return {"w": truncated_normal(gen, (d_in, *d_out), std, device)}


def _operands(x, w, dtype):
    """``x`` and ``w`` in the dtype jnp's einsum would compute in: ``w`` is
    cast to ``dtype`` and a mixed pair promotes (bf16 x fp32 -> fp32)."""
    common = torch.promote_types(x.dtype, dtype)
    return x.to(common), w.to(common)


def dense_apply(params, x, dtype):
    x, w = _operands(x, params["w"], dtype)
    out = x @ w.reshape(w.shape[0], -1)
    return out.reshape(*x.shape[:-1], *w.shape[1:])


def dense_apply_out(params, x, dtype):
    """Attention output projection: (...,H,hd) x (H,hd,D) -> (...,D)."""
    x, w = _operands(x, params["w"], dtype)
    h, k, d = w.shape
    return x.reshape(*x.shape[:-2], h * k) @ w.reshape(h * k, d)


def rmsnorm_init(d: int, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm_apply(params, x, eps: float = 1e-6):
    """fp32 statistics, cast back to the input dtype.  On a mesh a
    residual stream that is a pending partial sum (a row-cut projection
    added in) is reduced first: normalised as a partial sum, it would
    reach the next column-cut projection as one, which then runs whole
    on every rank of the cut."""
    x = settle(x)
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    return out.to(dt)


def embedding_init(gen, vocab: int, d: int, device):
    return {"emb": truncated_normal(gen, (vocab, d), 1.0, device)}


def embedding_lookup(params, tokens, dtype):
    # rows first, then the cast: the reference casts the whole table.
    # F.embedding, not indexing: DTensor shards its backward over a
    # vocab-cut table, where index_put's rule fails (torch 2.11)
    return F.embedding(tokens, params["emb"]).to(dtype)


def embedding_logits(params, h):
    """Tied read-out: (..., d) @ (d, vocab) in fp32 for stability."""
    return h.float() @ params["emb"].float().T


# RoPE ----------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), -exps / head_dim)


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, D); positions: (..., T) int."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)           # (D/2,)
    angles = positions[..., None].float() * freqs          # (..., T, D/2)
    cos = torch.cos(angles)[..., None, :]                  # (..., T, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x):
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")
