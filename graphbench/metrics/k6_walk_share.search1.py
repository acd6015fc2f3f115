"""The share of K6's time spent walking edges in the traced stretch of
single searches, counted as ``k6_walk_share.search`` is."""
from pathlib import Path

from graphbench.cells import load_reader

read = load_reader(Path(__file__).with_name("k6_walk_share.search.py"))
