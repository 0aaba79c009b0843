"""device_idle_share: percent of a query's time in which no operation
(kernel, copy or memset) ran on the card: one less the card's busy time
per query of the traced window (the union of its operations in
torch.profiler's timeline) over the mean latency of the untraced window
that a traced run makes just before its traced one.  The profiler slows
the host's side of a query and not the card's operations, so the
untraced latency keeps its cost out."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops or not run.shards \
            or not run.plain_latency:
        return None
    plain = sum(run.plain_latency) / len(run.plain_latency)
    busy = tr.busy_seconds() / len(run.shards)
    return 100.0 * (1.0 - busy / plain)
