"""Configs: the paper's graphs (`bfs_graph500`) and the LM substrate's
ten architectures with their registry (`registry`)."""
