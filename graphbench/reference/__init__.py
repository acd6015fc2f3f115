"""The benchmark's yardstick: plain PyTorch, independent of the program
under test.  Nothing here imports ``repro_torch``, ``repro`` or ``jax``."""
