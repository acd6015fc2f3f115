"""Share of the traced stretch of single searches in which no device
event ran: per-search host work and launches show here."""
from graphbench.readers import idle_share as read  # noqa: F401
