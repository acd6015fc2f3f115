"""Graph formats (CSR so far)."""
