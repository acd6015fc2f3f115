"""Roofline terms of a dry-run cell on the H100, the op analyzer that
counts them, and the report that renders them."""
