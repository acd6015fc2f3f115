"""Core substrate: bitmaps, CSR, R-MAT, oracles and the traversal engine.

Layers:
  bitmap          packed int32 bitmap frontier/visited sets (§3.3.1)
  rmat            Graph500 Kronecker generator (§5.2)
  csr             padded CSR + alignment policy (§3.3.1, §4.2)
  bfs_serial      Algorithm 1 oracle
  engine          the batched traversal engine + direction policies
  bfs_parallel    Algorithms 2/3 wrapper (scalar expanders)
  bfs_vectorized  §4 SIMD pipeline wrapper (ThresholdSimd/PaperLiteral)
  bfs_hybrid      direction-optimizing wrapper (BeamerHybrid policy)
  bfs_distributed 1-D multi-device BFS on torch.distributed
  validate        Graph500 soft validator (§5.3)
  stats           64-root TEPS harness (§5.3)
"""
