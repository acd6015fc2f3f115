"""K6's barrier waits over its whole time, in the traced stretch of
batched searches: every CTA's cycles from arriving at a grid barrier of
the layer loop (2 at start-up, 4 a layer) to leaving it, summed, over
every CTA's entry-to-exit cycles, summed, over the stretch's K6
launches (the kernel's ``waits`` buffer, kept by
`repro_torch.obs.trace.PHASES` while the profiler records).  Cycles are
divided by cycles, so the SM clock rate never enters.  High: the grid
waits on a few CTAs (a hub's items, one CTA each) at the barriers.

The launches read are the collector's last N of K6, N the K6 events of
the traced stretch, so launches of a profiler session that recorded no
device event and was run again are left out."""

K6 = "traversal_fused"


def read(rec):
    if rec.trace is None:
        return None
    n = sum(1 for _, _, name, cat in rec.trace.device
            if cat == "kernel" and "traversal_fused_kernel" in name
            and "sell_" not in name)
    try:
        from repro_torch.obs.trace import PHASES, read_phases
    except ImportError:
        return None
    got = [read_phases(x) for x in PHASES.last(K6, n)]
    cycles = sum(p.cta_cycles for p in got)
    return sum(p.wait_total for p in got) / cycles if cycles else None
