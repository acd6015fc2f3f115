"""The share of K6's time spent walking edges, in the traced stretch of
batched searches: each layer's walk phase (the stamp after its second
grid barrier to the stamp after its third; the kernel's ``stamps``,
%globaltimer ns written by CTA 0, kept by
`repro_torch.obs.trace.PHASES` while the profiler records) over each
launch's entry to its last stamp, summed over the stretch's K6
launches.  The rest is start-up, planning, the union, the update and
barrier bookkeeping.

A faster walk alone lowers this share, so read it beside
``search_roofline``: a faster walk moves the roofline up and this share
down, a cut in the per-layer sweeps moves both up.  The launches read
are the collector's last N of K6, N the K6 events of the traced
stretch, as for ``k6_wait_share.search``."""

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
    span = sum(p.span_ns for p in got)
    return sum(p.walk_ns for p in got) / span if span else None
