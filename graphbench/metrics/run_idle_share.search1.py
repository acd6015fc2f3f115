"""Share of the traced stretch of single searches in which the device
was idle while the host was inside the port's own call: the idle
intervals of the stretch (`Trace.intervals`' complement in the window)
intersected with the ``bfs.run`` ranges that `CompiledTraversal.run`
opens while the profiler records (`repro_torch.obs.trace.traced_call`).
What is left of ``idle_share.search1`` is the caller's loop.  None
where the trace holds no ``bfs.run`` range."""

RUN = "bfs.run"


def _merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def _overlap(a, b) -> float:
    """The length two sorted lists of disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(rec):
    t = rec.trace
    if t is None or t.window_s <= 0:
        return None
    lo, hi = t.t0_us, t.t0_us + t.window_s * 1e6
    runs = _merged((max(ts, lo), min(ts + dur, hi))
                   for ts, dur, name in t.host if name == RUN)
    if not runs:
        return None
    edges = [lo, *t.intervals().reshape(-1).tolist(), hi]
    idle = [[s, e] for s, e in zip(edges[::2], edges[1::2]) if e > s]
    return _overlap(runs, idle) / (hi - lo)
