"""The batched searches' share of the memory roofline, in %: the bytes
that the traced stretch's searches cannot move less of
(`reference.graph500.floor_bytes`, from the inputs alone: the parent
rows written, one adjacency entry per reached vertex) over the H100's
3.35e12 B/s, divided by the device time of that stretch."""
from graphbench.readers import roofline_share as read  # noqa: F401
