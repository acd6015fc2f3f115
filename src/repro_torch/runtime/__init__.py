"""LM substrate: the fault-tolerant training loop."""
