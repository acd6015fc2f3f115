"""R-MAT edge lists from a seed, with the initiator as a parameter.

A frozen copy of the Graph500 Kronecker generator (paper §5.2; the
port's ``core.rmat.generate`` as of this benchmark's first version):
``V = 2**scale`` vertices, ``V * edgefactor`` generated tuples, one
quadrant draw per bit level from a `torch.Generator` on the device,
vertex labels permuted, self-loops and duplicates kept, then the
reversed tuples appended.  ``initiator=(0.25,) * 4`` draws both
endpoints uniformly (Erdős–Rényi, GAP's "Urand").

The permutation may come from a seed of its own (``label_seed``): one
set of tuples under different labels is one graph, so searches on it do
the same work in every labelling.
"""
from __future__ import annotations

import torch

KRON = (0.57, 0.19, 0.19, 0.05)


def generate(seed: int, scale: int, edgefactor: int,
             initiator=KRON, device="cuda", label_seed: int | None = None):
    """Return ``(src, dst, n_vertices, perm)``: int32 tensors of the
    ``2 * V * edgefactor`` directed edges on ``device`` and the (V,)
    int32 labels of the drawn vertices.  The tuples come from ``seed``,
    the labels from ``label_seed`` (else from ``seed`` after them)."""
    a, b, c, d = (float(x) for x in initiator)
    if min(a, b, c, d) < 0 or abs(a + b + c + d - 1.0) > 1e-9:
        raise ValueError(f"initiator {initiator} is not a distribution")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    n_vertices = 1 << int(scale)
    m = n_vertices * int(edgefactor)
    ab = a + b
    c_norm = c / (c + d)
    a_norm = a / (a + b)
    src = torch.zeros((m,), dtype=torch.int32, device=device)
    dst = torch.zeros((m,), dtype=torch.int32, device=device)
    for level in range(int(scale)):
        ii_bit = torch.rand((m,), generator=gen, device=device) > ab
        jj_thresh = torch.where(ii_bit, c_norm, a_norm)
        jj_bit = torch.rand((m,), generator=gen, device=device) > jj_thresh
        src |= ii_bit.to(torch.int32) << level
        dst |= jj_bit.to(torch.int32) << level
        del ii_bit, jj_bit, jj_thresh
    if label_seed is not None:
        gen.manual_seed(int(label_seed))
    perm = torch.randperm(n_vertices, generator=gen, device=device,
                          dtype=torch.int64).to(torch.int32)
    src = perm[src.long()]
    dst = perm[dst.long()]
    return torch.cat([src, dst]), torch.cat([dst, src]), n_vertices, perm


def checksum(src: torch.Tensor, dst: torch.Tensor) -> int:
    """An order-sensitive fingerprint of an edge list, to show that a
    second generation from the same seed gave the same inputs."""
    total = torch.zeros((), dtype=torch.int64, device=src.device)
    step = 1 << 26
    for lo in range(0, src.shape[0], step):
        hi = min(lo + step, src.shape[0])
        w = torch.arange(lo + 1, hi + 1, device=src.device,
                         dtype=torch.int64) % 1_000_003
        total += ((src[lo:hi].long() * 31 + dst[lo:hi].long()) * w).sum()
    return int(total)
