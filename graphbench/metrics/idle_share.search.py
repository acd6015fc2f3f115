"""Share of the traced stretch of batched searches in which no device
event ran."""
from graphbench.readers import idle_share as read  # noqa: F401
