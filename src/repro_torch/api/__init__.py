"""Traversal spec and the plan/run layer."""
