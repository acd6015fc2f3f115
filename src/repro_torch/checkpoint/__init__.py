"""LM substrate: checkpoints with an atomic commit."""
