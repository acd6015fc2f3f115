"""Serve tier of the port.

  graph_engine  continuous-batching BFS query service
  robust        admission control, backoff, fault injection
"""
