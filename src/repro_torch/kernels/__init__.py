"""Main-path kernels: hand-written CUDA (csrc/) with plain torch versions."""
