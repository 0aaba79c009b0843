"""find's reverse routes past the static tiers and Scanner.precompile,
the port against the JAX package.

core_scan_last_bytes (ops/core.py) on the legacy core of a reverse
machine with no static tier (CoreTables) and on the lazy reverse core
(LazyCoreTables) equals the JAX one (pallas_core.core_scan_last_bytes,
the Pallas kernels in interpret mode on the CPU mesh) and the native
walk, in its return and last_repair: from entry state 0 and a hot state
past it, on corpora the core validates whole and corpora it repairs,
and at n = 0.  Scanner.find on device="cpu" with DEVICE_THRESHOLD
lowered locates the start on each reverse core and equals the JAX
Scanner and Python re; a drifted reverse core re-cores
itself and leaves the forward core alone.  precompile returns 0.0
where the JAX one does, and otherwise a count after it is exact on the
static and on the fused route.  Every quantity is an integer: the
tolerance is exact equality.
"""

import re

import numpy as np
import pytest
import torch

import sregex_tpu
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan

import sregex_tpu_torch
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
# no static tier forward or reversed: the legacy cores
NO_TIER = "a.{10}b|cdefghijklmnopqrstuvwxyz"
# past the eager budget forward and reversed, and no hot tagged core on
# text full of a's: find locates the start on the lazy reverse core
LAZY = "a.{13}b|cdefghijklmnopqrstuvwxyz"
WORDS = np.array([w.encode() for w in (
    "alpha delta golf hotel kilo lima mike oscar papa sierra tango "
    "victor xray yankee zulu").split()], dtype=object)
K = 512


@pytest.fixture
def jax_caps(monkeypatch):
    """The JAX package caps its wide tier at 4096 entries on the CPU;
    cores are held against the JAX package's at that cap."""
    monkeypatch.setattr(tscan.SpecTablesWide, "MAX_ENTRIES",
                        jscan.SpecTablesWide.MAX_ENTRIES)


def _filler(n, seed):
    """Words without a b, so neither machine's b-states are visited."""
    rng = np.random.default_rng(seed)
    text = b" ".join(WORDS[rng.integers(0, len(WORDS), n // 4)])
    return bytearray(text[:n])


def _planted(n, seed, plants, lit=()):
    """Filler with "a", ``gap`` digits and "b" at each (offset, gap) of
    ``plants`` and the literal at each offset of ``lit``."""
    data = _filler(n, seed)
    for at, gap in plants:
        data[at:at + gap + 2] = b"a" + b"0123456789012"[:gap] + b"b"
    for at in lit:
        data[at:at + 24] = b"cdefghijklmnopqrstuvwxyz"
    return bytes(data)


def _last(native, rdata, entry):
    """The native walk's (final state, last boundary)."""
    q, st = native.scan_last(rdata, entry)
    return st, q


def test_core_scan_last_bytes_equals_jax_on_the_legacy_core(jax_caps):
    tsc = sregex_tpu_torch.compile_pattern(NO_TIER, device=None)
    jsc = sregex_tpu.compile_pattern(NO_TIER)
    trev, jrev = tsc._rev_dfa(), jsc._rev_dfa()
    assert np.array_equal(trev.dfa.trans, jrev.dfa.trans)
    # sampled from a corpus with plants: their states are in the core
    sample = _planted(64 << 10, 1, [(p, 10) for p in range(500, 60000,
                                                           3000)])[::-1]
    tct = tcore.CoreTables(trev.dfa, sample, device=CPU)
    jct = jcore.CoreTables(jrev.dfa, sample)
    assert np.array_equal(tct.hot2full, jct.hot2full)
    entry = int(tct.hot2full[1])
    clean = _planted(96 << 10, 2, [(p, 10) for p in (900, 40000, 90000)])
    # b-runs and the literal leave the reverse core: repaired chunks
    drift = bytearray(clean)
    for at in range(1000, len(drift) - 100, 7000):
        drift[at:at + 30] = b"b" * 30
    drift[50000:50024] = b"cdefghijklmnopqrstuvwxyz"
    for data, e in ((clean, 0), (clean, entry), (bytes(drift), 0),
                    (bytes(drift), entry), (_filler(96 << 10, 3), 0),
                    (b"", entry)):
        rdata = bytes(data)[::-1]
        got = tcore.core_scan_last_bytes(tct, rdata, K, entry_state=e)
        assert got == jcore.core_scan_last_bytes(jct, rdata, K,
                                                 entry_state=e)
        assert got == _last(trev, rdata, e)
        assert tct.last_repair == jct.last_repair
    rdata = bytes(drift)[::-1]
    tcore.core_scan_last_bytes(tct, rdata, K)
    assert tct.last_repair[0] > 0         # the drift repaired chunks
    tcore.core_scan_last_bytes(tct, clean[::-1], K)
    assert tct.last_repair == (0, -(-len(clean) // K))


def test_core_scan_last_bytes_equals_jax_on_the_lazy_core(jax_caps):
    """The lazy reverse machine is its own native engine: escapes re-scan
    on it and the last firing chunk is pinned by its scan_last."""
    tsc = sregex_tpu_torch.compile_pattern(LAZY, device=None)
    jsc = sregex_tpu.compile_pattern(LAZY)
    assert tsc.dfa is None and tsc._rev_dfa() is None
    tl, jl = tsc._rev_lazy_dfa(), jsc._rev_lazy_dfa()
    sample = _planted(64 << 10, 4, [(p, 13) for p in range(500, 60000,
                                                           5000)])[::-1]
    tct = tcore.LazyCoreTables(tl, sample, device=CPU)
    jct = jcore.LazyCoreTables(jl, sample)
    assert tct.H == jct.H and np.array_equal(tct.hot2full, jct.hot2full)
    entry = int(tct.hot2full[1])
    clean = _planted(96 << 10, 5, [(p, 13) for p in (900, 40000, 90000)])
    drift = bytearray(clean)
    for at in range(1000, len(drift) - 100, 9000):
        drift[at:at + 40] = b"b" * 40
    for data, e in ((clean, 0), (clean, entry), (bytes(drift), 0),
                    (bytes(drift), entry), (b"", 0)):
        rdata = bytes(data)[::-1]
        got = tcore.core_scan_last_bytes(tct, rdata, K, entry_state=e)
        assert got == jcore.core_scan_last_bytes(jct, rdata, K,
                                                 entry_state=e)
        # both lazy machines walk the same bytes, so they number the
        # states they meet alike
        assert got == _last(tl, rdata, e) == _last(jl, rdata, e)
        assert tct.last_repair == jct.last_repair
    tcore.core_scan_last_bytes(tct, bytes(drift)[::-1], K)
    assert tct.last_repair[0] > 0


def _pike(pattern, data):
    """Python re's leftmost-first match as (regex id, [start, end])."""
    m = re.search(pattern.encode(), data)
    return None if m is None else (0, [m.start(), m.end()])


@pytest.mark.parametrize("pattern", [NO_TIER, LAZY])
def test_find_locates_the_start_on_the_reverse_core(pattern):
    """One match near the end of a corpus with a's everywhere: the hot
    tagged core declines, and the reverse core serves the start
    locator; the result equals the JAX Scanner's (its host engines: its
    device routes here cost 15-45 s of interpret-mode compiles, and are
    held against the port's in the two tests above) and Python re's."""
    gap = 10 if pattern == NO_TIER else 13
    n = 384 << 10
    data = _planted(n, 6, [(n - 3000, gap)])
    sc = sregex_tpu_torch.compile_pattern(pattern, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 16
    got = sc.find(data)
    assert got == sregex_tpu.compile_pattern(pattern).find(data)
    assert got == _pike(pattern, data)
    assert sc._tdfa_coret is False and sc.stats().certified is None
    rct = sc._rev_coret if pattern == NO_TIER else sc._rev_lz_coret
    cls = tcore.CoreTables if pattern == NO_TIER else tcore.LazyCoreTables
    assert type(rct) is cls
    assert rct.last_repair is not None and rct.last_repair[1] == n // 2048
    assert not sc.find(_filler(n, 7))       # the prefilter: no match


def test_a_drifted_reverse_core_recores_itself():
    """Two finds whose reversed corpora leave the reverse core in most
    chunks (two b's 3 bytes apart, a state its sample never met) re-core
    it (back to None, rebuilt by the next find), counted
    in recore_events; the forward core, which those corpora do not
    drift, stays as it was."""
    n = 256 << 10
    sc = sregex_tpu_torch.compile_pattern(NO_TIER, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 16
    data = _planted(n, 8, [(n - 3000, 10)])
    assert sc.find(data) == _pike(NO_TIER, data)
    fwd, rev = sc._coret, sc._rev_coret
    assert isinstance(fwd, tcore.CoreTables)
    assert isinstance(rev, tcore.CoreTables) and rev.last_repair[0] == 0
    drift = bytearray(data)
    for at in range(100, n - 4000, 1000):     # two b's every 1000 bytes
        drift[at] = drift[at + 3] = ord("b")
    drift = bytes(drift)
    want = _pike(NO_TIER, drift)
    assert sc.find(drift) == want and sc._rev_coret is rev
    assert rev.last_repair[0] > rev.last_repair[1] * sc.CORE_DRIFT_FRAC
    assert sc.find(drift) == want
    assert sc._rev_coret is None and sc._rev_core_rebuilds == 1
    assert sc._coret is fwd and sc._core_rebuilds == 0
    assert sc.stats().recore_events == 1
    assert sc.find(drift) == want
    assert isinstance(sc._rev_coret, tcore.CoreTables)
    assert sc._rev_coret is not rev


def test_precompile_returns_zero_where_the_jax_one_does():
    lazy = sregex_tpu_torch.compile_pattern(LAZY, device="cpu")
    host = sregex_tpu_torch.compile_pattern("ab", device=None)
    sc = sregex_tpu_torch.compile_pattern("ab", device="cpu")
    assert lazy.precompile(1 << 20) == 0.0
    assert host.precompile(1 << 20) == 0.0
    assert sc.precompile(0) == sc.precompile(-5) == 0.0
    assert sregex_tpu.compile_pattern(LAZY, use_device=True) \
        .precompile(1 << 20) == 0.0
    assert sregex_tpu.compile_pattern("ab").precompile(1 << 20) == 0.0
    assert sregex_tpu.compile_pattern("ab", use_device=True) \
        .precompile(0) == 0.0


def _native_count(sc, data):
    c, st = sc._native.count(data, 0)
    return c + int(sc.dfa.match_eof[st])


@pytest.mark.parametrize("fused", [False, True])
def test_precompile_then_an_exact_count(monkeypatch, fused):
    """precompile on a zero stand-in of the corpus's length, then count:
    exact, on the static pair tier ("ab") and, under SREGEX_FUSED=1 with
    the corpus's head as the sample, on the fused tier over a big-tier
    machine (a.{11}b), whose core precompile built."""
    if fused:
        monkeypatch.setenv("SREGEX_FUSED", "1")
    pattern = "a.{11}b" if fused else "ab"
    rng = np.random.default_rng(9)
    text = rng.choice(np.frombuffer(b"bcdxyz ", np.uint8), 300_000)
    text[rng.integers(0, len(text) - 16, 200)] = ord("a")
    data = text.tobytes()
    sc = sregex_tpu_torch.compile_pattern(pattern, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 14
    before = tscan.spec_scan_launches
    sample = data[:64 << 10] if fused else b""
    assert sc.precompile(len(data), sample=sample) > 0
    assert tscan.spec_scan_launches == before     # the plain versions ran
    fct = sc._fusedct
    assert isinstance(fct, tcore.CoreTables) == fused
    assert sc.count(data) == _native_count(sc, data)
    st = sc.stats()
    assert st.tier == ("CoreTables" if fused else "SpecTablesPair")
    assert sc._fusedct is fct if fused else True
