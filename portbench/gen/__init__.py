"""Corpus generators, one file a generator, named by a configuration's
``generator``; each exposes ``make_ring(params, shard_bytes, ring,
seed)`` and returns ``ring`` distinct shards (bytearrays) made from the
seed with vectorised numpy, a thread a shard."""

from concurrent.futures import ThreadPoolExecutor

THREADS = 8


def fill(out, period, offset):
    """Write ``period`` from its ``offset`` on over ``out``, repeated
    (each copy doubles what is written)."""
    n = min(len(out), len(period) - offset)
    out[:n] = period[offset:offset + n]
    while n < len(out):
        m = min(n, len(out) - n)
        out[n:n + m] = out[:m]
        n += m


def in_threads(make, args):
    """[make(a) for a in args], in threads: numpy's copies let go of
    the interpreter's lock, and first touch of a shard's pages is most
    of its cost."""
    with ThreadPoolExecutor(min(THREADS, len(args))) as pool:
        return list(pool.map(make, args))
