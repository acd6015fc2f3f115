"""repro_torch: the BFS vectorization engine in PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside ``repro`` (the JAX/Pallas reference).  It
imports ``torch`` only — never ``jax`` and nothing of ``repro`` — and
keeps its own copies of what it needs.  The public surface is
``repro_torch.bfs``:

    import repro_torch.bfs as bfs
    ct = bfs.plan(csr, bfs.TraversalSpec())      # device="cuda" default
    res = ct.run_batched([3, 7, 11])

Importing the package builds nothing: the CUDA kernels compile at
their first launch (`repro_torch.kernels._build`).
"""
__version__ = "0.1.0"
