"""The port's streaming events engine (events.py) under
Scanner.finditer_stream / sub_stream, against the JAX package's.

For the twelve patterns of the JAX package's tests/test_stream_events.py
(bounded and unbounded, empty-matching, anchored, with captures), every
segmentation of a stream (whole, byte at a time, random cuts, cuts with
empty segments) yields the events of the port's whole-corpus finditer,
and the output of its sub, with DEVICE_THRESHOLD lowered so that the
fire map takes spec_chunk_map on the device path's plain versions
(device="cpu"); the same streams through the JAX Scanner's
(use_device=False) finditer_stream / sub_stream give the same.  Also
the pattern past the eager DFA budget (the Pike re-arm stream and the
StreamEditor), a callable repl with a count, a multi-regex set and the
engine's memory bound.  Every quantity is an integer or bytes, so the
tolerance is exact equality; inputs come from seeded generators.
"""

import random
import re

import pytest
import torch

from sregex_tpu.stream import compile_pattern as jax_compile
from test_stream_events import PATTERNS
from test_stream_events import _corpus as _events_corpus
from test_stream_events import _segmentations

import sregex_tpu_torch
from sregex_tpu_torch.native import NativeDfa

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CHUNK = 128
WINDOW = 512


def _scanners(pattern):
    """The JAX host Scanner, and the port on the device path's plain
    versions with the fire map on spec_chunk_map from 256 bytes."""
    sc = sregex_tpu_torch.compile_pattern(pattern, device="cpu")
    sc.DEVICE_THRESHOLD = 256
    return jax_compile(pattern), sc


@pytest.mark.parametrize("idx", range(len(PATTERNS)))
def test_finditer_stream_equals_whole_and_jax(idx):
    pat = PATTERNS[idx]
    jsc, sc = _scanners(pat)
    data = _events_corpus(pat, 1000, idx)
    want = list(sc.finditer(data))
    assert want == list(jsc.finditer(data))
    for segs in _segmentations(data, random.Random(idx)):
        got = list(sc.finditer_stream(segs, chunk_len=CHUNK,
                                      map_window=WINDOW))
        assert got == want, (pat, len(segs))
    assert list(jsc.finditer_stream(segs, chunk_len=CHUNK,
                                    map_window=WINDOW)) == want
    eng = sc._events_engine(CHUNK, WINDOW)
    for lo in range(0, len(data), 300):
        eng.push(data[lo:lo + 300])
    eng.push(b"", eof=True)
    assert eng.device_chunks > 0, "the device map never engaged"


@pytest.mark.parametrize("idx", range(len(PATTERNS)))
def test_sub_stream_equals_whole_and_jax(idx):
    pat = PATTERNS[idx]
    jsc, sc = _scanners(pat)
    repl = b"<$0|$1>"
    data = _events_corpus(pat, 900, idx + 100)
    want, _ = sc.sub(repl, data)
    assert want == jsc.sub(repl, data)[0]
    for segs in _segmentations(data, random.Random(idx + 100)):
        got = b"".join(sc.sub_stream(repl, segs, chunk_len=CHUNK,
                                     map_window=WINDOW))
        assert got == want, (pat, len(segs))
    assert b"".join(jsc.sub_stream(repl, segs, chunk_len=CHUNK,
                                   map_window=WINDOW)) == want


def test_sub_stream_count_and_callable():
    jsc, sc = _scanners(rb"\d+")
    data = b"a1 b22 c333 d4444 e5 f66" * 40
    segs = [data[i:i + 13] for i in range(0, len(data), 13)]
    want, k = sc.sub(b"#", data, count=7)
    assert k == 7 and want == jsc.sub(b"#", data, count=7)[0]
    for s in (sc, jsc):
        assert b"".join(s.sub_stream(b"#", segs, count=7, chunk_len=64,
                                     map_window=256)) == want

    def up(rid, ov, window):
        return window[ov[0]:ov[1]].upper()

    jsc2, sc2 = _scanners(rb"[a-z]{2,6}")
    data2 = b"ab cde f ghij " * 30
    segs2 = [data2[i:i + 7] for i in range(0, len(data2), 7)]
    want2, _ = sc2.sub(up, data2)
    for s in (sc2, jsc2):
        assert b"".join(s.sub_stream(up, segs2, chunk_len=64,
                                     map_window=256)) == want2
    want3, _ = sc2.sub(up, data2, count=5)
    for s in (sc2, jsc2):
        assert b"".join(s.sub_stream(up, segs2, count=5, chunk_len=64,
                                     map_window=256)) == want3


def test_finditer_stream_multi_regex():
    pats = [rb"foo", rb"bar\d{1,3}", rb"[A-Z]{2,4}="]
    jsc, sc = _scanners(pats)
    data = _events_corpus(rb"cat|dog", 1500, 11)
    data = data.replace(b"cat", b"foo").replace(b"dog", b"bar12")
    data += b" AB= foo bar9 XYZW= tail"
    want = list(sc.finditer(data))
    assert want == list(jsc.finditer(data))
    assert len({rid for rid, _ in want}) >= 2
    for segs in _segmentations(data, random.Random(9)):
        assert list(sc.finditer_stream(segs, chunk_len=CHUNK,
                                       map_window=WINDOW)) == want


def test_lazy_machine_streams_through_the_pike_loop():
    """Past the eager DFA budget: no events engine, the Pike re-arm
    stream and the StreamEditor serve."""
    pat = rb"foo[a-z]{20,40}z"
    jsc, sc = _scanners(pat)
    assert sc.dfa is None and sc._events_engine(CHUNK, WINDOW) is None
    data = (b"foo" + b"abc" * 9 + b"z" + b" filler " * 20) * 8
    segs = [data[i:i + 97] for i in range(0, len(data), 97)]
    want = list(sc.finditer(data))
    assert want and want == list(jsc.finditer(data))
    assert list(sc.finditer_stream(segs)) == want
    assert list(jsc.finditer_stream(segs)) == want
    want2, _ = sc.sub(b"[$0]", data)
    assert b"".join(sc.sub_stream(b"[$0]", segs)) == want2
    assert b"".join(jsc.sub_stream(b"[$0]", segs)) == want2


def test_events_engine_memory_is_bounded():
    """A sparse bounded pattern over a long stream: the held bytes stay
    O(map_window), and the Pike probe teleports."""
    _, sc = _scanners(rb"needle")
    eng = sc._events_engine(256, 4 << 10)
    seg = b"x" * (64 << 10)
    peak = 0
    events = []
    for i in range(8):
        events += eng.push(seg if i != 4 else
                           seg[:100] + b"needle" + seg[106:])
        peak = max(peak, len(eng.buf))
    events += eng.push(b"", eof=True)
    assert events == [(0, [4 * len(seg) + 100, 4 * len(seg) + 106])]
    assert peak <= 80 << 10, peak
    assert eng.teleports >= 1 and eng.device_chunks > 0


@pytest.mark.parametrize("case", ["dense", "straddle"])
def test_refine_walk_is_linear_in_the_fires(case):
    """Dense fires over several chunks, and fires that straddle a chunk
    edge: finditer_stream and sub_stream give the JAX package's results
    and re's, and the fire map's native walk (StreamEvents._refine)
    makes a number of calls linear in the fires: it resumes where it
    stopped in a chunk instead of walking again from the chunk's entry
    state past every earlier fire."""
    if case == "dense":
        # a fire every 4 bytes, 32 to a 128-byte chunk
        pat, data = rb"(a+)(b)", b"xaab" * 600
    else:
        # the 130-byte period drifts the matches across the 128-byte
        # grid: some end on a chunk's last byte, some straddle an edge
        pat, data = rb"a+b", b"." * 126 + (b"." * 127 + b"aab") * 12
    jsc, sc = _scanners(pat)
    want = [(0, [x for g in range(re.compile(pat).groups + 1)
                 for x in m.span(g)])
            for m in re.finditer(pat, data)]
    assert list(sc.finditer(data)) == want
    segs = [data[i:i + 301] for i in range(0, len(data), 301)]
    assert list(jsc.finditer_stream(segs, chunk_len=CHUNK,
                                    map_window=WINDOW)) == want
    eng = sc._events_engine(CHUNK, WINDOW)
    got = []
    for s in segs:
        got += eng.push(s)
    got += eng.push(b"", eof=True)
    assert got == want and eng.device_chunks > 0
    fires, _ = NativeDfa(sc.dfa).count(data)
    chunks = -(-len(data) // eng.K)
    if case == "straddle":
        assert any(m[1][0] < c * eng.K < m[1][1]
                   for m in want for c in range(1, chunks))
    # one call per fire and per refined chunk's end; the walk from the
    # entry state would make about fires * fires_per_chunk / 2
    assert eng.refine_calls <= fires + 2 * chunks, \
        (eng.refine_calls, fires, chunks)
    sub_want = re.sub(pat, b"<\\g<0>>", data)
    assert b"".join(sc.sub_stream(b"<$0>", segs, chunk_len=CHUNK,
                                  map_window=WINDOW)) == sub_want
    assert b"".join(jsc.sub_stream(b"<$0>", segs, chunk_len=CHUNK,
                                   map_window=WINDOW)) == sub_want
