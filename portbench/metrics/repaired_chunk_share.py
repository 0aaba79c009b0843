"""repaired_chunk_share: percent of the window's chunks that the host
fold re-walked (Scanner.stats(): repaired over chunks, summed over the
traced window's queries).  A scan that found a match records no chunk
count, so only counts give one."""


def read(run):
    stats = [s for s in run.stats if s is not None]
    chunks = sum(s[1] for s in stats)
    if chunks <= 0:
        return None
    return 100.0 * sum(s[0] for s in stats) / chunks
