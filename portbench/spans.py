"""The program's span recorder (sregex_tpu_torch.diag), read for the
per-layer metrics of a query's host time.

A traced run makes an untraced window just before its traced one.  Its
queries are the last len(run.plain_latency) root spans of the cell's
call (sregex.<call>) that end before the traced window opens: the
recorder stamps spans with the clock of torch.profiler's events.  They
were recorded without the profiler, so the host's times are not
inflated by it.  They read where the traced window ran operations on
the card, as glue_ms and device_idle_share do: the split is that of a
query whose scan ran there.  Where the program records no spans (an
older program, or none ran: a control), or no card ran, the readers
find nothing and read None."""

import sys

# a root span lies inside its query's latency, timed around the call on
# another clock: this much of the two clocks' disagreement is let pass
SLACK_NS = 50_000


def recorder():
    """The program's span recorder where it is loaded and has one."""
    diag = sys.modules.get("sregex_tpu_torch.diag")
    return diag if hasattr(diag, "recent_spans") else None


def plain_queries(run):
    """[(root span, [its other spans])] of each query of the untraced
    window, in order, or None."""
    diag = recorder()
    tr = run.trace
    if diag is None or tr is None or not run.plain_latency \
            or not tr.device_ops:
        return None
    opened = tr.window[0] * 1e3          # microseconds -> ns
    call = "sregex." + run.cell.traffic["call"]
    spans = diag.recent_spans()
    roots = [s for s in spans if s.parent is None and s.name == call
             and s.end_ns < opened]
    n = len(run.plain_latency)
    if len(roots) < n:
        return None
    roots = roots[-n:]
    if any(r.end_ns - r.start_ns > lat * 1e9 + SLACK_NS
           for r, lat in zip(roots, run.plain_latency)):
        return None     # not the window's queries
    kids = {r.query: [] for r in roots}
    for s in spans:
        if s.parent is not None and s.query in kids:
            kids[s.query].append(s)
    return [(r, kids[r.query]) for r in roots]


def mean_ms(run, name):
    """Mean over the untraced window's queries of the ms of their spans
    named ``name``, summed a query, or None."""
    queries = plain_queries(run)
    if not queries:
        return None
    total = sum(s.end_ns - s.start_ns for _, kids in queries
                for s in kids if s.name == name)
    return total / len(queries) / 1e6
