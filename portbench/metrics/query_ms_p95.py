"""query_ms_p95: the 95th percentile (nearest rank) of the latency of
every query of the window, each timed on the host clock from the call
to its result on the host."""

import math


def read(run):
    if not run.latency:
        return None
    lat = sorted(run.latency)
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
