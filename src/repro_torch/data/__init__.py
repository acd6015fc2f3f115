"""LM substrate: the synthetic token stream."""
