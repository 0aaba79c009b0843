"""glue_ms: what a query spends besides its scan kernel, in
milliseconds: the mean latency of the untraced window that a traced run
makes just before its traced one, less the device time per query of the
operation that took the most device time in the traced window (the scan
kernel).  So it holds the Python path, the summary's launches, the
readback and the host fold, without the profiler's own cost."""


def read(run):
    if run.trace is None or not run.trace.device_ops or not run.shards \
            or not run.plain_latency:
        return None
    plain = sum(run.plain_latency) / len(run.plain_latency)
    kernel = max(run.trace.seconds_by_name().values()) / len(run.shards)
    return (plain - kernel) * 1e3
