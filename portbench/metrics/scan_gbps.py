"""scan_gbps: all corpus bytes that the window's queries scanned
(decimal GB) over the window's wall time (host clock)."""


def read(run):
    if not run.shards or run.window_s <= 0:
        return None
    return len(run.shards) * run.shard_bytes / run.window_s / 1e9
