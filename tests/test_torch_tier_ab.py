"""The forward Scanner's first-scan tier A/B of the "ab" band
(stream._core_band, Scanner._core_eligible, Scanner._maybe_tier_ab,
Scanner.tier_ab) against the JAX package on the CPU.

The JAX side contributes only what runs no Pallas kernel: its band, the
cores its Scanner builds (CoreTables is host numpy) and its host engine's
counts.  The port runs on device="cpu" (the plain torch versions) and is
held to the JAX package's choices and to the native engine's counts; the
tolerance is exact equality.  Which arm wins an A/B on the CPU is a matter
of host timing, so the cases that check what follows a win set
TIER_AB_MARGIN on the instance: 0 makes the static tier win, infinity the
core.
"""

import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex as jcompile_regex
from sregex_tpu import parse as jparse
from sregex_tpu.dfa import build_dfa as jbuild_dfa
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.pallas_big import SpecTablesBig as JaxBig
from sregex_tpu.ops.pallas_pair import SpecTablesPair as JaxPair
from sregex_tpu.stream import _core_band as jcore_band
from sregex_tpu.stream import compile_pattern as jcompile

from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.big import SpecTablesBig
from sregex_tpu_torch.ops.layout import GROUPS, TILE
from sregex_tpu_torch.ops.mesh import make_mesh
from sregex_tpu_torch.ops.pair import SpecTablesPair

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
# the two mid-band machines: wide rows 4 (the legacy core's arm) and wide
# rows 6 (the fused core's arm)
MID = {4: rb"(foo|bar|baz|qux)=[0-9a-f]{2,8}",
       6: rb"(GET|POST|PUT|HEAD) /[a-z]{1,12}\.(html|php|js)"}
PLANTS = {4: (b"foo=1a2b", b"qux=ff", b"bar=0c0ffee1"),
          6: (b"GET /index.html", b"POST /a.php", b"HEAD /zz.js")}
N = 128 << 10
SAMPLE = 16 << 10                # CORE_SAMPLE on both packages' Scanners
# DEVICE_THRESHOLD and TIER_AB_BYTES on the port's Scanners: the A/B
# times the corpus's first half
THRESHOLD = 1 << 16
# the core sample's four slices (Scanner._core_sample at SAMPLE bytes)
SLICES = sorted({0, N // 3, 2 * N // 3, N - SAMPLE})


def _corpus(rows, n=N, every=12_000, skip=SLICES):
    """Digit and symbol filler, in which no prefix of a match starts
    (the production log-scan shape the fast core needs), with matches
    planted every ``every`` bytes outside the sample slices that start
    at the offsets ``skip``.  With the sample free of matches both the
    fast legacy core and the fused core build; with matches in it (skip
    empty) only the fused core, whose escape budget is looser."""
    unit = b"0123 456 789 -- 01 2345 "
    out = bytearray((unit * (n // len(unit) + 1))[:n])
    words = PLANTS[rows]
    for i, pos in enumerate(range(every // 2, n - 32, every)):
        if any(lo - 32 <= pos < lo + SAMPLE for lo in skip):
            continue
        w = words[i % len(words)]
        out[pos:pos + len(w)] = w
    return bytes(out)


_EXPECT = {}


def _expect(rows, data):
    """(count, first match) from the JAX package's host engine, held
    equal to the port's NativeDfa; memoised per machine and corpus."""
    key = (rows, len(data), hash(data))
    if key not in _EXPECT:
        jsc = jcompile(MID[rows], use_device=False)
        host = tstream.compile_pattern(MID[rows], device=None)
        c, st = host._native.count(data, 0)
        c += int(host.dfa.match_eof[st])
        assert jsc.count(data) == c
        first = host.scan(data)
        assert jsc.scan(data) == first
        _EXPECT[key] = (c, first)
    return _EXPECT[key]


def _scanner(rows, mesh=None):
    sc = tstream.compile_pattern(MID[rows], device="cpu", mesh=mesh)
    sc.CORE_SAMPLE = SAMPLE
    sc.DEVICE_THRESHOLD = sc.TIER_AB_BYTES = THRESHOLD
    return sc


def _docs(rows, data):
    """A document set of DEVICE_THRESHOLD bytes (the batch path's least)
    cut from the end of ``data``, where its matches are, and each
    document's native count."""
    docs = [data[i:i + 8192] for i in range(len(data) - THRESHOLD,
                                            len(data), 8192)]
    host = tstream.compile_pattern(MID[rows], device=None)
    return docs, [host.count(d) for d in docs]


def _jax_scanner(rows):
    jsc = jcompile(MID[rows], use_device=True)
    jsc.CORE_SAMPLE = SAMPLE
    return jsc


@pytest.fixture
def ab_on(monkeypatch):
    """The A/B on, as outside the test suite (tests/conftest.py turns it
    off for the JAX package's tier assertions)."""
    monkeypatch.setenv("SREGEX_TIER_AB", "1")


class _FakeWide:
    """Tables of a given wide row count, for the band alone (the JAX
    test's trick)."""

    def __init__(self, rows):
        self.rows = rows


def _jax_fake(rows):
    return type("F", (_FakeWide, jscan.SpecTablesWide), {})(rows)


def _torch_fake(rows):
    return type("F", (_FakeWide, tscan.SpecTablesWide), {})(rows)


def _band_case(name):
    """(JAX tables, port tables) of one band case."""
    if name.startswith("fake"):
        rows = int(name[4:])
        return _jax_fake(rows), _torch_fake(rows)
    if name == "none":
        return None, None
    if name == "big":
        # the band reads the class alone; JAX's big tables take a second
        return type("F", (_FakeWide, JaxBig), {})(144), \
            SpecTablesBig(tstream.compile_pattern("a.{11}b",
                                                  device=None).dfa, CPU)
    pattern, jcls, tcls = {
        "wide4": (MID[4], jscan.SpecTablesWide, tscan.SpecTablesWide),
        "wide6": (MID[6], jscan.SpecTablesWide, tscan.SpecTablesWide),
        "narrow": ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", jscan.SpecTables,
                   tscan.SpecTables),
        "pair": ("ab", JaxPair, SpecTablesPair),
    }[name]
    dfa = jbuild_dfa(jcompile_regex(jparse(pattern)[0]))
    tdfa = tstream.compile_pattern(pattern, device=None).dfa
    return jcls(dfa), tcls(tdfa, CPU)


@pytest.mark.parametrize("name,band", [
    ("fake2", "static"), ("wide4", "ab"), ("wide6", "ab"),
    ("fake16", "ab"), ("fake17", "static"), ("narrow", "static"),
    ("pair", "static"), ("none", "core"), ("big", "static")])
def test_core_band_matches_the_jax_package(name, band):
    """The port's band equals the JAX package's up to 16 wide rows and
    for no static tier; past 16 rows and for the big tier the port's
    documented departure is "static" where the JAX package says
    "core"."""
    jt, tt = _band_case(name)
    if jt is not None and hasattr(jt, "dfa"):
        assert getattr(jt, "rows", 1) == getattr(tt, "rows", 1)
    assert tstream._core_band(tt) == band
    if name in ("fake17", "big"):
        assert jcore_band(jt) == "core"
    else:
        assert jcore_band(jt) == band


@pytest.mark.parametrize("rows,attr", [(4, "_coret"), (6, "_fusedct")])
def test_the_band_builds_the_jax_core(ab_on, rows, attr):
    """A mid-band machine gets the core the JAX Scanner builds from the
    same sample, in the Scanner's order (the fused core, else the fast
    legacy one), and an A/B is scheduled; once the fused core is
    declined, both build the fast legacy core next."""
    data = _corpus(rows)
    sc, jsc = _scanner(rows), _jax_scanner(rows)
    assert sc._spec.rows == jsc._spec.rows == rows
    assert not sc._ab_pending
    for s in (sc, jsc):
        if s._fused_core_tables(data) is None:
            s._core_tables(data)
        assert s._ab_pending
    built = {a for a in ("_coret", "_fusedct")
             if isinstance(getattr(sc, a, None), tcore.CoreTables)}
    jbuilt = {a for a in ("_coret", "_fusedct") if getattr(jsc, a, None)}
    assert built == jbuilt == {attr}
    if attr == "_fusedct":
        assert sc._fusedct.H == jsc._fusedct.H
        assert sc._coret is None
        sc._fusedct = jsc._fusedct = False
        sc._ab_pending = jsc._ab_pending = False
        for s in (sc, jsc):
            assert s._core_tables(data) is not None and s._ab_pending
    # the fast legacy core's hot set, as the JAX package's
    assert sc._coret.H == jsc._coret.H
    assert sc._core_eligible(sc._spec) is True
    assert jsc._core_eligible(jsc._spec) is True


# (arm's rows, api of the first call, winner forced by the margin); the
# legacy arm's count that the static tier wins is
# test_tier_ab_waits_and_batches_follow_it
RUNS = [(4, "scan", "core"), (6, "count", "core"), (6, "scan", "static")]


@pytest.mark.parametrize("rows,api,winner", RUNS)
def test_tier_ab_runs_and_sticks(ab_on, rows, api, winner):
    """The first count or scan of an "ab"-band machine is served by its
    core and times that core against the static tier; tier_ab has the
    JAX package's keys, and the winner serves the next call, of the
    other api.  (A fused core that loses gives way to the fast legacy
    core where one fits the sample: test_the_band_builds_the_jax_core.)"""
    # the fused arm's sample holds matches: no fast legacy core follows it
    data = _corpus(rows, skip=SLICES if rows == 4 else ())
    count, first = _expect(rows, data)
    sc = _scanner(rows)
    sc.TIER_AB_MARGIN = 0.0 if winner == "static" else float("inf")
    attr = "_coret" if rows == 4 else "_fusedct"
    call = {"count": (sc.count, count), "scan": (sc.scan, first)}
    other = "scan" if api == "count" else "count"
    fn, want = call[api]
    assert fn(data) == want
    assert sc.stats().tier == "CoreTables" and sc.stats().api == api
    ab = sc.tier_ab
    assert set(ab) == {"bytes", "static_s", "core_s", "winner", "core_arm",
                       "static_gbps", "core_gbps"}
    assert ab["bytes"] == THRESHOLD and ab["core_arm"] == attr
    assert ab["winner"] == winner and not sc._ab_pending
    assert ab["static_s"] > 0 and ab["core_s"] > 0
    assert ab["static_gbps"] == THRESHOLD / ab["static_s"] / 1e9
    fn, want = call[other]
    assert fn(data) == want
    tier = "CoreTables" if winner == "core" else "SpecTablesWide"
    assert sc.stats().tier == tier
    if winner == "core":
        assert isinstance(getattr(sc, attr), tcore.CoreTables)
        assert sc.tier_ab is ab
        # count_many, which runs no A/B, rides the kept core (the
        # static winner's: test_tier_ab_waits_and_batches_follow_it)
        docs, counts = _docs(rows, data)
        assert sum(counts) > 0
        assert sc.count_many(docs) == counts
        assert sc.stats().tier == tier
    else:
        assert getattr(sc, attr) is False and sc._coret is False


def test_tier_ab_waits_and_batches_follow_it(ab_on):
    """The batch and stream paths run no A/B and take the static tier
    until an A/B keeps the core, building none; a core built and pending
    waits while the corpus is below DEVICE_THRESHOLD; the first count at
    the threshold runs the A/B, and once the static tier has won, scan
    and count_many take it.  Every result equals the native
    engine's."""
    data = _corpus(4)
    count, first = _expect(4, data)
    sc = _scanner(4)
    docs, want = _docs(4, data)
    assert sum(want) > 0
    assert sc.count_many(docs) == want
    assert sc.stats().tier == "SpecTablesWide"
    assert sc._coret is None and not sc._ab_pending
    assert sc._core_tables(data) is not None and sc._ab_pending
    assert sc.count_many(docs) == want
    assert sc.stats().tier == "SpecTablesWide"
    assert sc.count_stream([data]) == count
    assert sc.stats().tier == "SpecTablesWide"
    assert sc.count(docs[0]) == want[0]
    assert sc.stats().tier == "native"
    sc._maybe_tier_ab(docs[0])
    assert sc._ab_pending and not hasattr(sc, "tier_ab")
    sc.TIER_AB_MARGIN = 0.0
    assert sc.count(data) == count
    assert sc.tier_ab["winner"] == "static" and sc._coret is False
    assert sc.tier_ab["core_arm"] == "_coret"
    assert sc.scan(data) == first
    assert sc.stats().tier == "SpecTablesWide"
    assert sc.count_many(docs) == want
    assert sc.stats().tier == "SpecTablesWide"


@pytest.mark.parametrize("rows", [4, 6])
def test_tier_ab_disabled_keeps_the_static_tier(monkeypatch, rows):
    """tests/test_tier_ab.py::test_tier_ab_disabled_keeps_legacy on the
    port: under SREGEX_TIER_AB=0 no core is built and no A/B scheduled,
    and the static wide tier serves, as before the A/B was ported."""
    monkeypatch.setenv("SREGEX_TIER_AB", "0")
    data = _corpus(rows)
    sc = _scanner(rows)
    assert sc.count(data) == _expect(rows, data)[0]
    assert getattr(sc, "tier_ab", None) is None and not sc._ab_pending
    assert sc._coret is False and sc._fusedct is False
    assert sc.stats().tier == "SpecTablesWide"
    assert sc._core_eligible(sc._spec) is None


def test_reverse_core_and_stream_scanner_keep_their_rule(ab_on):
    """The band and its A/B are the forward Scanner's: the reverse core
    and StreamScanner of a mid-band machine take _core_requirement's
    choice, so no core, and the stream's chunk goes to the static
    tier."""
    data = _corpus(4)
    sc = _scanner(4)
    rev = sc._rev_dfa()
    assert rev is not None
    assert sc._rev_core_tables(data) is None
    assert sc._rev_coret is False
    assert tstream._core_requirement(sc._rev_spec) is None
    assert not sc._ab_pending
    ss = tstream.StreamScanner(sc.dfa, device="cpu")
    ss.DEVICE_THRESHOLD = THRESHOLD
    assert ss._core_tables(data) is None
    before = tscan.spec_scan_launches, tscan.pair_scan_launches
    first, st = sc._native.scan_first(data, 0)
    assert ss.exec(data) == (0, first)
    # CPU tensors take the plain version, which counts no launch
    assert (tscan.spec_scan_launches, tscan.pair_scan_launches) == before
    assert ss._coret is False


def test_tier_ab_raises_when_the_arms_disagree(ab_on, monkeypatch):
    """A core arm that counts wrong makes the A/B raise, where the JAX
    package would keep the core."""
    real = tstream.core_count_bytes

    def off_by_one(*args, **kw):
        st, c = real(*args, **kw)
        return st, c + 1

    # the served call takes _TIER_CALLS' own reference; the A/B's arm
    # the module's name
    monkeypatch.setattr(tstream, "core_count_bytes", off_by_one)
    data = _corpus(4)
    sc = _scanner(4)
    with pytest.raises(RuntimeError, match="disagree"):
        sc.count(data)
    assert not hasattr(sc, "tier_ab")


def test_an_overflowing_fused_arm_loses(ab_on, monkeypatch):
    """A fused core past the device cap (one phase-2 block row) is
    declined by the port's overflow rule on the call it served, which is
    exact; the A/B then has no core to time and the static tier serves."""
    monkeypatch.setattr(tcore, "FUSED_CAP", GROUPS * TILE)
    n = 9_000_000
    skip = sorted({0, n // 3, 2 * n // 3, n - SAMPLE})
    # a match every 2000 bytes outside the sample slices: ~4400 escaped
    # chunks of 2048 bytes
    data = _corpus(6, n, every=2000, skip=skip)
    sc = _scanner(6)
    host = tstream.compile_pattern(MID[6], device=None)
    want = host.count(data)
    assert sc.count(data) == want
    fct = sc._fused_core_tables(data)
    assert fct is None and sc._fusedct is False
    st = sc.stats()
    assert st.tier == "CoreTables" and st.repaired > GROUPS * TILE
    assert not sc._ab_pending and not hasattr(sc, "tier_ab")


def test_tier_ab_on_a_mesh_counts_what_one_device_counts(ab_on):
    """A Scanner(mesh=) over two CPU shards (tests/test_torch_mesh.py's
    virtual mesh) runs the A/B through the sharded arms and counts what
    one device and the native engine count."""
    data = _corpus(4)
    count, _ = _expect(4, data)
    sc = _scanner(4, mesh=make_mesh([CPU] * 2))
    sc.TIER_AB_MARGIN = float("inf")
    assert sc.count(data) == count
    assert sc.stats().tier == "CoreTables"
    assert sc.tier_ab["winner"] == "core"
    assert sc.tier_ab["core_arm"] == "_coret"
    assert isinstance(sc._coret, tcore.CoreTables) and not sc._ab_pending
