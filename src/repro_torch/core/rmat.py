"""Graph500 Kronecker (R-MAT) graph generator — paper §5.2, in torch.

``V = 2**SCALE`` vertices and ``M = V * edgefactor`` generated edge
tuples, ``2*M`` directed edges after symmetrization.  Standard
initiator A=0.57, B=0.19, C=0.19, D=0.05; self-loops and duplicates
kept; vertex labels randomly permuted (Graph500 kernel 1).

Same model as ``repro.core.rmat`` with a different random source: a
`torch.Generator` on the target device, seeded with an int.  The two
packages draw different bits from the same seed, so they match in
distribution, not bit for bit; parity tests hand reference-built graphs
to both.  The reference materializes all ``(scale, 2, M)`` uniforms at
once (11.8 GB at SCALE 22); this generator draws one bit level at a
time, so the peak is two (M,) float32 draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

# Graph500 standard initiator parameters (paper §5.2).
A, B, C, D = 0.57, 0.19, 0.19, 0.05


class EdgeList(NamedTuple):
    """COO edge list.  ``src``/``dst`` are int32 tensors of equal length."""
    src: torch.Tensor
    dst: torch.Tensor
    n_vertices: int


def generate(seed: int, scale: int, edgefactor: int = 16,
             symmetrize: bool = True,
             device=DEFAULT_DEVICE) -> EdgeList:
    """Generate a Graph500 R-MAT edge list on ``device``.

    Args:
      seed: integer seed of the device generator.
      scale: log2 of the vertex count.
      edgefactor: generated edges per vertex (Graph500 default 16).
      symmetrize: append the reversed edges (undirected adjacency).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n_vertices = 1 << scale
    m = n_vertices * edgefactor
    ab = A + B
    c_norm = C / (C + D)
    a_norm = A / (A + B)
    src = torch.zeros((m,), dtype=torch.int32, device=dev)
    dst = torch.zeros((m,), dtype=torch.int32, device=dev)
    for level in range(scale):
        ii_bit = torch.rand((m,), generator=gen, device=dev) > ab
        jj_thresh = torch.where(ii_bit, c_norm, a_norm)
        jj_bit = torch.rand((m,), generator=gen, device=dev) > jj_thresh
        src |= ii_bit.to(torch.int32) << level
        dst |= jj_bit.to(torch.int32) << level
        del ii_bit, jj_bit, jj_thresh
    perm = torch.randperm(n_vertices, generator=gen, device=dev,
                          dtype=torch.int64).to(torch.int32)
    src = perm[src.long()]
    dst = perm[dst.long()]
    if symmetrize:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    return EdgeList(src=src, dst=dst, n_vertices=n_vertices)
