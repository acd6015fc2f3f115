"""What the per-layer readers under ``metrics/`` share: each reads one
cell's `run.Record`, and returns None where it finds nothing to read."""
from __future__ import annotations

from graphbench.reference.graph500 import H100_BYTES_PER_S


def idle_share(rec):
    """Share of the traced stretch in which no device event ran."""
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 1.0 - rec.trace.busy_s() / rec.trace.window_s


def roofline_share(rec):
    """The traced stretch's floor bytes (``rec.traced["bytes"]``) over
    the H100's 3.35e12 B/s, divided by the stretch's device time
    (kernels, copies and memsets), in %."""
    if rec.trace is None or not rec.traced.get("bytes"):
        return None
    device_s = rec.trace.device_s()
    if device_s <= 0:
        return None
    return 100.0 * rec.traced["bytes"] / H100_BYTES_PER_S / device_s
