"""The corpus of the Computer Language Benchmarks Game's regex-redux:
the output of its fasta program, with the headers and newlines that
regex-redux strips before it counts.  A shard is fasta's three sections
end to end: the ALU sequence repeated (``sections[0]`` tenths of the
shard), then letters drawn through fasta's linear congruential
generator from the IUB table (``sections[1]`` tenths) and from the
Homo sapiens table (the rest), each draw the first entry whose
cumulative probability exceeds last / IM, in float64 as fasta computes
it.  fasta starts its generator at 42 and the ALU at its first letter;
here each shard of a ring starts both at places drawn from the seed,
without replacement over the ring.

The generator's modulus is small, so the drawn letters repeat with
period ``im``: one period of each table's letters is worked out once,
and a section is that period, rotated to the shard's start, copied
over and over."""

import numpy as np

from portbench.gen import fill, in_threads


def _cycle(im, ia, ic, start):
    """The generator's states in the order it visits them from
    ``start`` (a full period: ia - 1 and ic suit the modulus)."""
    states = np.empty(im, np.int64)
    last = start
    for i in range(im):
        states[i] = last
        last = (last * ia + ic) % im
    if last != start:
        raise ValueError("the generator's period is not its modulus")
    return states


def _letters(table, values):
    """fasta's selectRandom over an array of draws in [0, 1)."""
    chars = np.frombuffer("".join(c for c, _ in table).encode(), np.uint8)
    cum = np.cumsum([p for _, p in table])
    at = np.searchsorted(cum, values, side="right")
    return chars[np.minimum(at, len(chars) - 1)]


def make_ring(params, shard_bytes, ring, seed):
    im, ia, ic = params["im"], params["ia"], params["ic"]
    states = _cycle(im, ia, ic, params["start"])
    draws = states / im
    iub = _letters(params["iub"], draws)
    homo = _letters(params["homosapiens"], draws)
    alu = np.frombuffer(params["alu"].encode(), np.uint8)
    tenths = params["sections"]
    n_alu = shard_bytes * tenths[0] // sum(tenths)
    n_iub = shard_bytes * tenths[1] // sum(tenths)
    rng = np.random.default_rng(np.random.SeedSequence([seed, 3]))
    # a shard's first draw is the state after its start state
    starts = rng.choice(im, ring, replace=False)
    alu_at = rng.integers(0, len(alu), ring)
    def make(start):
        first, a0 = start
        buf = bytearray(shard_bytes)
        arr = np.frombuffer(buf, np.uint8)
        fill(arr[:n_alu], alu, int(a0))
        at = (int(first) + 1) % im
        fill(arr[n_alu:n_alu + n_iub], iub, at)
        fill(arr[n_alu + n_iub:], homo, (at + n_iub) % im)
        return buf
    return in_threads(make, list(zip(starts, alu_at)))
