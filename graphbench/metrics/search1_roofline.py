"""The single searches' share of the memory roofline, in %, counted as
``search_roofline`` is (`reference.graph500.floor_bytes`)."""
from graphbench.readers import roofline_share as read  # noqa: F401
