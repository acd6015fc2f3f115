"""The paper's graph configs (`bfs_graph500`)."""
