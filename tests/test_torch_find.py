"""The port's Scanner.find on device="cpu" (the plain torch versions of
the tagged-DFA kernel and the scan kernels) against the JAX package's
Scanner(use_device=True).find (Pallas in interpret mode) and the native
Pike engine in exact mode, with DEVICE_THRESHOLD lowered as the JAX
tests lower it; and spec_scan_last_bytes, the reverse start locator,
against the JAX function and the native engine.

Cases: a certified one-pass match, a certified no-match, tiny and empty
inputs, a speculation miss and a match span past the chunk window both
repaired chunk-wise, a span past the repair budget (the multi-pass
path), a multi-regex id, several table rows and a prepared corpus.  Inputs are made from seeded
generators; results are integers, compared exactly.
"""

import random

import numpy as np
import pytest
import torch

import sregex_tpu
from sregex_tpu.dfa import build_dfa
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.stream import _build_spec_tables as jax_spec_tables

import sregex_tpu_torch
from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.native import NativeDfa
from sregex_tpu_torch.native_pike import NativePikeCtx
from sregex_tpu_torch.ops import spec_scan as tscan

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")
THRESHOLD = 1024


def _log_corpus(n, seed, plant_at=None):
    """Log-like lines full of near misses ("status=" not followed by a
    number and a user), with one full match planted at plant_at."""
    rng = np.random.default_rng(seed)
    pieces = [b"status= user=x ", b"GET /index status=ok ",
              b"status=200 user= ", b"user=alice status= ",
              b"ts=1760623528 lvl=info ", b"status=5 usr=bob\n"]
    out = bytearray()
    while len(out) < n:
        out += pieces[rng.integers(len(pieces))]
    out = out[:n]
    if plant_at is not None:
        m = b" status=404 user=bob_x "
        out[plant_at:plant_at + len(m)] = m
    return bytes(out)


def _miss_corpus():
    """tests/test_tdfa_device.py's corpus of word runs, with runs of x
    longer than the warmup window and one planted match."""
    rng = random.Random(4)
    data = bytearray()
    while len(data) < 30000:
        data += bytes(rng.choice(b"ab de ")
                      for _ in range(rng.randrange(50, 300)))
        data += b"x" * rng.randrange(40, 90)
    data = bytes(data[:30000])
    return data[:17000] + b" foo@bar " + data[17009:]


def _spanning_corpus():
    rng = random.Random(1)
    return bytes(rng.choice(b"X  xx\n") for _ in range(12000))


def _wide_corpus():
    rng = random.Random(13)
    data = bytearray(rng.choice(b"fobarqz x") for _ in range(20000))
    data[15000:15007] = b"barquxx"
    return bytes(data)


# name -> (pattern, corpus, expect the one-pass result to be certified)
CASES = {
    "certified": (rb"status=([0-9]+) user=([a-z_]+)",
                  lambda: _log_corpus(40000, 1, 30001), True),
    "no-match": (rb"status=([0-9]+) user=([a-z_]+)",
                 lambda: _log_corpus(20000, 2), True),
    # 40 bytes of history outrun the 32-byte warmup: chunks entered 33
    # to 40 bytes after an x miss their speculated entry state
    "speculation-miss": (rb"x([^x]{40})y", lambda: (b"x" + b"z" * 59) * 250
                         + b"x" + b"z" * 40 + b"yzz", True),
    "word-runs": (rb"(\w+)@(\w+)", _miss_corpus, True),
    "window-repair": (rb"(a+)b", lambda: b"a" * 9000 + b"b", True),
    "window-exceeding": (rb"(a+)b", lambda: b"a" * 80000 + b"b", False),
    "spanning-winner": (rb".[X](.+)+[X]", _spanning_corpus, None),
    "multi-regex": (["foo", "ba(r+)"],
                    lambda: (b"zzzz" * 4000)[:15995] + b"obarr", True),
    "wide-rows": (rb"(foo|bar)(baz|qux)x", _wide_corpus, True),
}


def _scanners(pat):
    if isinstance(pat, list):
        jast, _ = sregex_tpu.parse_multi(pat)
        tast, _ = sregex_tpu_torch.parse_multi(pat)
    else:
        jast, _ = sregex_tpu.parse(pat)
        tast, _ = sregex_tpu_torch.parse(pat)
    js = sregex_tpu.Scanner(sregex_tpu.compile_regex(jast), use_device=True,
                            ast=jast)
    ts = tstream.Scanner(sregex_tpu_torch.compile_regex(tast),
                         device="cpu", ast=tast)
    js.DEVICE_THRESHOLD = ts.DEVICE_THRESHOLD = THRESHOLD
    return js, ts


def _pike(sc, data):
    """The native Pike engine in exact mode over the whole corpus."""
    ctx = NativePikeCtx(sc.program, exact=True)
    rc, _ = ctx.exec(data, True)
    return None if rc < 0 else (rc, [int(v) for v in ctx.ovector])


@pytest.mark.parametrize("name", sorted(CASES))
def test_find_matches_jax_and_pike(name):
    pat, make, certified = CASES[name]
    data = make()
    js, ts = _scanners(pat)
    assert ts._tdfa_spec is not None and js._tdfa_spec is not None
    got = ts.find(data)
    assert got == js.find(data) == _pike(ts, data)
    st = ts.stats()
    assert st.api == "find" and st.nbytes == len(data)
    if certified is not None:
        assert st.certified is certified, st
        assert st.tier == ("TdfaSpecTables" if certified
                           else type(ts._spec).__name__)
    if name in ("speculation-miss", "window-repair"):
        assert 0 < st.repaired <= st.chunks      # chunk-wise repair
    if name == "multi-regex":
        assert got[0] == 1


def test_find_tiny_and_empty_inputs():
    js, ts = _scanners(rb"(a+)(b+)")
    ts.DEVICE_THRESHOLD = js.DEVICE_THRESHOLD = 1
    for data in (b"", b"ab", b"zzz", b"xaab", b"aab" * 700):
        assert ts.find(data) == js.find(data) == _pike(ts, data), data
    assert ts.stats().tier == "TdfaSpecTables"


def test_find_with_a_prepared_corpus_and_below_the_threshold():
    pat = rb"status=([0-9]+) user=([a-z_]+)"
    js, ts = _scanners(pat)
    data = _log_corpus(30000, 3, 20000)
    want = js.find(data)
    prep = ts.prepare(data)
    assert ts.find(data, prepared=prep) == want
    assert ts.stats().certified is True
    assert (id(ts._tdfa_spec), prep.chunk_len) in prep._by_tables
    ts.DEVICE_THRESHOLD = 1 << 20
    assert ts.find(data) == want
    st = ts.stats()
    assert (st.tier, st.certified) == ("native", None)
    host = sregex_tpu_torch.compile_pattern(pat, device=None)
    assert host._tdfa_spec is None and host.find(data) == want


def test_tagged_tier_declines_as_the_jax_package():
    """A machine past the CPU budget has no dense tagged tables on either
    side; find takes the hot core sampled from the corpus in both
    (TdfaCoreTables, certified in one pass), with the same result.  (The
    name predates the hot core: find took the multi-pass path here.)"""
    pat = rb"(money|parted|fool|kilo|victor|zebra)x([0-9]+)"
    js, ts = _scanners(pat)
    assert js._tdfa_spec is None and ts._tdfa_spec is None
    rng = np.random.default_rng(5)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789 ", np.uint8)
    data = bytearray(rng.choice(alpha, 12000).tobytes())
    data[9000:9012] = b"partedx31415"
    data = bytes(data)
    assert ts.find(data) == js.find(data) == _pike(ts, data)
    assert type(js._tdfa_coret).__name__ == "TdfaCoreTables"
    st = ts.stats()
    assert (st.tier, st.certified) == ("TdfaCoreTables", True)


# spec_scan_last_bytes: name -> (pattern, corpus); the chunk length is
# 256 so a few kilobytes make many chunks
LAST_CASES = {
    "many-fires": ("ab+", lambda rng: bytes(rng.choice(
        np.frombuffer(b"abx", np.uint8), 5000))),
    "ragged-none": ("zq", lambda rng: bytes(rng.choice(
        np.frombuffer(b"abx", np.uint8), 4999))),
    "speculation-miss": ("a{40}b", lambda rng: (b"a" * 300 + b"b") * 17),
    "one-fire": ("(?:foo|bar)baz", lambda rng: b"." * 3000 + b"barbaz"
                 + b"." * 1111),
}


@pytest.mark.parametrize("name", sorted(LAST_CASES))
def test_spec_scan_last_bytes_matches_jax_and_native(name):
    pat, make = LAST_CASES[name]
    data = make(np.random.default_rng(len(name)))
    jast, _ = sregex_tpu.parse(pat)
    tast, _ = sregex_tpu_torch.parse(pat)
    jdfa = build_dfa(sregex_tpu.compile_regex(jast))
    tdfa = sregex_tpu_torch.build_dfa(sregex_tpu_torch.compile_regex(tast))
    jt = jax_spec_tables(jdfa)
    tt = tstream._build_spec_tables(tdfa, CPU)
    assert type(jt).__name__ == type(tt).__name__
    got = tscan.spec_scan_last_bytes(tt, data, chunk_len=256)
    assert got == jscan.spec_scan_last_bytes(jt, data, chunk_len=256)
    last, state = NativeDfa(tdfa).scan_last(data, 0)
    assert got == (state, last)
