"""Core substrate: bitmaps, CSR, R-MAT, oracles and the traversal engine."""
