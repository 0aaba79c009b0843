"""The plain reference's answers over a shard, and the comparison that
decides ``correct``.

A configuration's reference (configs/<config>.py) says where matches
end: ``end_mask(rows, lead)`` over a uint8 [R, W] tensor marks each
column whose byte is the last of a match read from that row alone, for
the columns from ``lead`` on; ``ids_ending(data, end)`` names the
patterns that end at one boundary; ``MAXLEN`` bounds a match's length.
Here the shard goes to the device in blocks, each with MAXLEN - 1 bytes
of the block before it, so every match is read whole exactly once; the
count is the number of boundaries where a match ends (the end of the
shard included), the first answer the least of them."""

import warnings
from dataclasses import dataclass, field

import numpy as np
import torch

BLOCK = 64 << 20

# a query that raised in place of its answer
FAILED = object()


@dataclass
class Answer:
    first: object       # the first boundary where a match ends, or None
    count: int          # the number of boundaries where a match ends
    ids: set = field(default_factory=set)   # the patterns ending at first


def _host_u8(shard):
    """A uint8 CPU tensor over the shard's bytes, without a copy; nothing
    here writes to it (bytes are read-only, which torch warns of)."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.frombuffer(shard, np.uint8))


def _blocks(ref, host, spans, device, lead, chunk):
    """(count, first end) over the blocks ``spans`` of the shard, read
    on ``device``."""
    count, first = 0, None
    for lo, hi in spans:
        start = max(0, lo - lead)
        win = host[start:hi].to(device)
        rows = win.view(-1, chunk) if chunk else win.view(1, -1)
        mask = ref.end_mask(rows, lo - start).reshape(-1)
        found = int(mask.sum())
        if found and first is None:
            first = lo + int(mask.to(torch.uint8).argmax()) + 1
        count += found
    return count, first


def answers(ref, shard, device, chunk=None):
    """Answer of ``ref`` over ``shard``, read on ``device``.  ``chunk``:
    read each ``chunk`` bytes alone, from nothing before them (a
    control's way; the shard's length a multiple of it)."""
    host = _host_u8(shard)
    n = len(host)
    lead = 0 if chunk else ref.MAXLEN - 1
    block = BLOCK - BLOCK % chunk if chunk else BLOCK
    spans = [(lo, min(n, lo + block)) for lo in range(0, n, block)]
    count, first = _blocks(ref, host, spans, device, lead, chunk)
    ids = ref.ids_ending(shard, first) if first is not None else set()
    return Answer(first, count, ids)


def as_result(call, ans):
    """An Answer in the form the Scanner's ``call`` returns it."""
    if call == "count":
        return ans.count
    if call == "scan":
        return None if ans.first is None else (min(ans.ids), ans.first)
    raise ValueError("no reference for the call %r" % call)


def judge(call, got, ref, nbytes):
    """(wrong, gap) of one query's result against the reference's
    Answer: gap is the distance of a count or of a first match end from
    the reference's (the shard's length where one side found no match),
    0 for a right answer; a scan whose end is right names a pattern
    that ends there."""
    if got is FAILED:
        return True, nbytes
    if call == "count":
        gap = abs(int(got) - ref.count)
        return gap != 0, gap
    if call == "scan":
        if got is None or ref.first is None:
            gap = 0 if got is None and ref.first is None else nbytes
            return gap != 0, gap
        rid, end = got
        gap = abs(int(end) - ref.first)
        return gap != 0 or int(rid) not in ref.ids, gap
    raise ValueError("no judge for the call %r" % call)
