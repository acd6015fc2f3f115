"""Serve tier of the port.

  engine        continuous-batching LM decode engine
  graph_engine  continuous-batching BFS query service (same design)
  robust        admission control, backoff, fault injection
"""
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.serve.graph_engine import GraphEngine

__all__ = ["GraphEngine", "Request", "ServeEngine"]
