"""K6's barrier waits over its whole time in the traced stretch of
single searches, counted as ``k6_wait_share.search`` is."""
from pathlib import Path

from graphbench.cells import load_reader

read = load_reader(Path(__file__).with_name("k6_wait_share.search.py"))
