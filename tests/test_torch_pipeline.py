"""The port's pipelined stream scan (ops/pipeline.py) and the Scanner's
count_stream / scan_stream / match_stream against the JAX package's.

Folds: the port's four segment folds equal the JAX four on the same
seeded numpy planes (speculation misses, a ragged tail, firing chunks,
and for the core tier ESC exits and entries outside the core), and the
whole stream's native walk.  pipelined_count / pipelined_scan
on device="cpu" (the same staging code as on the card, on CPU tensors)
equal the native engine and the port's spec_count_bytes /
spec_scan_bytes on the concatenation, over the JAX test's four cases
(tests/test_pipeline.py) at adversarial segmentations and in_flight 1-3;
one small shape against the JAX pipeline itself (Pallas in interpret
mode).  Scanner: the stream methods equal the JAX Scanner(use_device=
False)'s and the port's whole-corpus count / scan, on the static tiers,
the legacy core and the lazy machine's core.  Every quantity is an
integer or bytes, so the tolerance is exact equality.  Inputs come from
seeded generators.
"""

import random

import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex as jax_compile_regex
from sregex_tpu import parse as jax_parse
from sregex_tpu.dfa import build_dfa as jax_build_dfa
from sregex_tpu.native import NativeDfa as JaxNativeDfa
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops import pipeline as jpipe
from sregex_tpu.stream import compile_pattern as jax_compile
from test_fused_count import _corpus as _multi_corpus
from test_fused_count import _multi_machine

import sregex_tpu_torch
from sregex_tpu_torch import compile_regex, parse
from sregex_tpu_torch.dfa import build_dfa
from sregex_tpu_torch.native import NativeDfa
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import pipeline as tpipe
from sregex_tpu_torch.ops import prep as tprep
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS
from sregex_tpu_torch.ops.pair import SpecTablesPair

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 240

# (pattern, the port's tables class, alphabet, plant): the JAX test's
CASES = [
    ("ab", tscan.SpecTables, b"aabbc ", b"ab"),
    ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", SpecTablesPair, b"abc", b"baaaacca"),
    (r"\bword\b", tscan.SpecTables, b"word x", b" word "),
    ("a{60}b", tscan.SpecTablesWide, b"aaaaaab", b"c" + b"a" * 60 + b"b"),
]
NO_TIER = "a.{10}b|cdefghijklmnopqrstuvwxyz"


@pytest.fixture
def jax_caps(monkeypatch):
    """The JAX package caps its wide tier at 4096 entries on the CPU;
    cores are held against the JAX package's at that cap."""
    monkeypatch.setattr(tscan.SpecTablesWide, "MAX_ENTRIES",
                        jscan.SpecTablesWide.MAX_ENTRIES)


def _machines(pattern):
    """The port's and the JAX package's DFA of ``pattern``."""
    return (build_dfa(compile_regex(parse(pattern)[0])),
            jax_build_dfa(jax_compile_regex(jax_parse(pattern)[0])))


def _segments(data, rng):
    """Adversarial random segmentation (the JAX test's): tiny,
    sub-warmup, ragged and chunk-multiple lengths mixed."""
    segs, i = [], 0
    while i < len(data):
        k = rng.choice([1, 3, 17, 100, 240, 480, 1000, 4096])
        segs.append(data[i:i + k])
        i += k
    return segs


def _corpus(rng, alphabet, n, plants):
    data = bytes(rng.choice(alphabet) for _ in range(n))
    for pos, s in plants:
        data = data[:pos] + s + data[pos:]
    return data


def _reusing(data, size):
    """A producer that refills one bytearray between yields (the
    readinto pattern)."""
    buf = bytearray(size)
    for i in range(0, len(data), size):
        chunk = data[i:i + size]
        buf[:len(chunk)] = chunk
        yield memoryview(buf)[:len(chunk)]


# --- the folds ------------------------------------------------------------


def _spec_planes(native, raw, C, entry, nstates, ncls, rng, miss=0.2):
    """Planes of a speculative scan: each chunk entered at its true state
    or, with probability ``miss``, at a random one; phi, the count (or
    fire flag) and swarm premultiplied, as the kernel leaves them."""
    phi = np.zeros(C, np.int64)
    cnt = np.zeros(C, np.int64)
    swarm = np.zeros(C, np.int64)
    true = entry
    for c in range(C):
        chunk = raw[c * K:(c + 1) * K].tobytes()
        spec = true if rng.random() > miss else int(rng.integers(nstates))
        k, ex = native.count(chunk, spec)
        phi[c], cnt[c], swarm[c] = ex * ncls, k, spec * ncls
        _, true = native.count(chunk, true)
    return phi, cnt, swarm


@pytest.mark.parametrize("ragged", [False, True])
def test_static_folds_equal_jax(ragged):
    pattern = rb"a[^b]{2,12}b|cat"
    tdfa, jdfa = _machines(pattern)
    tnat, jnat = NativeDfa(tdfa), JaxNativeDfa(jdfa)
    rng = np.random.default_rng(7 + ragged)
    n = 40 * K + (97 if ragged else 0)
    raw = rng.choice(np.frombuffer(b"abc xt", np.uint8), n)
    C = -(-n // K)
    ncls, S = tdfa.nclasses, tdfa.nstates
    for trial in range(4):
        entry = int(rng.integers(S)) if trial else 0
        phi, cnt, swarm = _spec_planes(tnat, raw, C, entry, S, ncls, rng,
                                       miss=(0.0, 0.05, 0.3, 1.0)[trial])
        fm = (cnt > 0).astype(np.int64)
        args = (raw, n, C, K, ncls, phi, cnt, swarm, entry * ncls)
        got = tpipe._fold_count(tnat, *args)
        assert got == jpipe._fold_count(jnat, *args)
        k, st = tnat.count(raw.tobytes(), entry)
        assert got[:2] == (st * ncls, k)
        fargs = (raw, n, C, K, ncls, phi, fm, swarm, entry * ncls)
        got = tpipe._fold_first(tnat, *fargs)
        assert got == jpipe._fold_first(jnat, *fargs)
        f, st = tnat.scan_first(raw.tobytes(), entry)
        assert got[1] == f and got[0] == st * ncls


def _core_packed(ct, raw, C, e_full, rng, miss=0.2):
    """Wide planes [3, 1, G, 8, 128] of a core scan: each chunk entered
    at its true state's core id (a random core state where that is not
    hot, or with probability ``miss``), walked on the core machine, whose
    sticky ESC marks a chunk that left the hot set."""
    core = NativeDfa(ct.core)
    ncls = ct.inner.ncls
    planes = np.zeros((3, GROUPS * 1024), np.int64)
    true = e_full
    for c in range(C):
        chunk = raw[c * K:(c + 1) * K].tobytes()
        cp = ct.to_core_premult(true)
        spec = (cp // ncls if cp >= 0 and rng.random() > miss
                else int(rng.integers(ct.H)))
        k, ex = core.count(chunk, spec)
        planes[:, c] = ex * ncls, k, spec * ncls
        _, true = ct.native.count(chunk, true)
    return planes.astype(np.int32).reshape(3, 1, GROUPS, 8, 128)


def test_core_folds_equal_jax(jax_caps):
    dfa, words = _multi_machine()
    sample = _multi_corpus(words, 64 << 10, seed=6, plant_every=1 << 30)
    tct = tcore.CoreTables(dfa, sample, device=CPU)
    jct = jcore.CoreTables(dfa, sample)
    assert np.array_equal(tct.hot2full, jct.hot2full)
    rng = np.random.default_rng(3)
    n = 30 * K + 55
    raw = np.frombuffer(_multi_corpus(words, n, seed=5, plant_every=900),
                        np.uint8).copy()
    # a run of bytes the sample never saw: the core escapes there
    raw[7 * K + 5:7 * K + 40] = np.frombuffer(b"abcdefghijklmn" * 2 +
                                              b"abcdefg", np.uint8)
    C = -(-n // K)
    cold = next(s for s in range(dfa.nstates) if tct.to_core_premult(s) < 0)
    escaped = 0
    for e_full, miss in ((0, 0.0), (0, 0.3), (cold, 0.1)):
        packed = _core_packed(tct, raw, C, e_full, rng, miss)
        escaped += int((packed[0].reshape(-1)[:C] == tct.esc_premult).sum())
        args = (packed, raw, n, C, K, e_full)
        got = tpipe._fold_core_count(tct, *args)
        assert got == jpipe._fold_core_count(jct, *args)
        k, st = tct.native.count(raw.tobytes(), e_full)
        assert got[:2] == (st, k)
        got = tpipe._fold_core_first(tct, *args)
        assert got == jpipe._fold_core_first(jct, *args)
        f, st = tct.native.scan_first(raw.tobytes(), e_full)
        assert got[:2] == (st, f)
    assert escaped > 0


# --- pipelined_count / pipelined_scan on device="cpu" ----------------------


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_pipelined_count_and_scan_equal_native(idx):
    pattern, cls, alphabet, plant = CASES[idx]
    dfa, _ = _machines(pattern)
    tables = cls(dfa, CPU)
    native = NativeDfa(dfa)
    rng = random.Random(idx)
    for trial in range(3):
        n = rng.choice([900, 5000, 9000])
        plants = [] if trial == 0 else [(n // 3, plant),
                                        (2 * n // 3, plant)]
        data = _corpus(rng, alphabet, n, plants)
        segs = _segments(data, rng)
        in_flight = 1 + trial
        exp, est = native.count(data, 0)
        got = tpipe.pipelined_count(tables, segs, chunk_len=K,
                                    in_flight=in_flight)
        assert got == (est, exp)
        assert got == tscan.spec_count_bytes(tables, data, K)
        assert tables.last_fold_bytes == len(data)
        first, st = native.scan_first(data, 0)
        st2, got, byte, folded = tpipe.pipelined_scan(
            tables, segs, chunk_len=K, in_flight=in_flight)
        assert (got, st2) == (first, st)
        assert (st2, got) == tscan.spec_scan_bytes(tables, data, K)
        if first < 0:
            assert folded == len(data) and byte == -1
        else:
            assert byte == data[first] and folded <= len(data)


def test_pipelined_single_empty_and_entry_state():
    dfa, _ = _machines("ab")
    tables = tscan.SpecTables(dfa, CPU)
    native = NativeDfa(dfa)
    data = b"xxabxx" * 100
    exp, est = native.count(data, 0)
    assert tpipe.pipelined_count(tables, [b"", data, b""],
                                 chunk_len=K) == (est, exp)
    assert tpipe.pipelined_count(tables, [], chunk_len=K) == (0, 0)
    assert tpipe.pipelined_scan(tables, iter([]))[:2] == (0, -1)
    # a non-zero entry: the state after "a" threads into the first
    # segment's frozen warmup
    _, mid = native.count(b"xa", 0)
    data = b"b" + b"xab" * 400
    exp, est = native.count(data, mid)
    assert tpipe.pipelined_count(tables, [data[:7], data[7:]], chunk_len=K,
                                 entry_state=mid) == (est, exp)
    f, st = native.scan_first(data, mid)
    assert tpipe.pipelined_scan(tables, [data[:7], data[7:]], chunk_len=K,
                                entry_state=mid)[:2] == (st, f)


def test_pipelined_pair_odd_segments():
    """Pair-unit tables stay pair-aligned across odd-length segments
    (the odd-byte holdback), from a reused buffer too."""
    dfa, _ = _machines("(?:a|b)aa(?:aa|bb)cc(?:a|b)")
    tables = SpecTablesPair(dfa, CPU)
    assert tables.bpu == 2
    native = NativeDfa(dfa)
    rng = random.Random(99)
    data = _corpus(rng, b"abc", 4001, [(1234, b"baaaacca"),
                                       (3999, b"abbbcca")])
    exp, est = native.count(data, 0)
    segs = [data[i:i + 333] for i in range(0, len(data), 333)]
    assert all(len(s) % 2 for s in segs[:-1])
    assert tpipe.pipelined_count(tables, segs, chunk_len=K) == (est, exp)
    assert tpipe.pipelined_count(tables, [data[:1], data[1:2], data[2:]],
                                 chunk_len=K) == (est, exp)
    assert tpipe.pipelined_count(tables, _reusing(data, 333), chunk_len=K,
                                 in_flight=3) == (est, exp)
    first, st = native.scan_first(data, 0)
    assert tpipe.pipelined_scan(tables, _reusing(data, 333),
                                chunk_len=K)[:2] == (st, first)


def test_pipeline_snapshots_reused_buffers():
    dfa, _ = _machines("ab")
    tables = tscan.SpecTables(dfa, CPU)
    native = NativeDfa(dfa)
    rng = random.Random(99)
    data = _corpus(rng, b"aabbc ", 20000, [(9000, b"abab")])
    exp, est = native.count(data, 0)
    for in_flight in (1, 2, 3):
        assert tpipe.pipelined_count(tables, _reusing(data, 1700),
                                     chunk_len=K,
                                     in_flight=in_flight) == (est, exp)


def test_pipelined_core_tier_equals_native():
    """The legacy core rides the pipeline: segment folds walk the trusted
    runs in FULL-machine states, and escapes (bytes the sampled core
    never saw) repair natively, whatever the sample."""
    dfa, _ = _machines("a{10,30}b")
    native = NativeDfa(dfa)
    rng = random.Random(13)
    ct = tcore.CoreTables(dfa, bytes(rng.choice(b"abx ")
                                     for _ in range(2000)), device=CPU)
    data = _corpus(rng, b"abx ", 6000,
                   [(1500, b"c" + b"a" * 20 + b"b"),
                    (3000, b"a" * 40),          # escape, no match
                    (4500, b"a" * 12 + b"b")])
    exp, est = native.count(data, 0)
    assert tpipe.pipelined_count(ct, _segments(data, rng),
                                 chunk_len=K) == (est, exp)
    assert ct.last_repair is not None and ct.last_repair[0] > 0
    first, st = native.scan_first(data, 0)
    st2, got, byte, _ = tpipe.pipelined_scan(ct, _segments(data, rng),
                                             chunk_len=K)
    assert (got, st2) == (first, st) and byte == data[first]
    # an entry outside the core cannot be frozen: chunk 0 speculates and
    # the fold repairs it on the full machine
    _, deep = native.count(b"a" * 15, 0)
    assert ct.to_core_premult(deep) < 0
    data = b"a" * 10 + b"b" + b"x ab" * 500
    exp, est = native.count(data, deep)
    assert tpipe.pipelined_count(ct, [data[:7], data[7:]], chunk_len=K,
                                 entry_state=deep) == (est, exp)


def test_pipelined_lazy_core_equals_the_lazy_machine():
    sc = sregex_tpu_torch.compile_pattern(b"a.{13}b", device=None)
    lazy = sc._lazy_dfa()
    rng = np.random.default_rng(4)
    text = rng.choice(np.frombuffer(b"bcdfgz ", np.uint8), 12000)
    text[rng.integers(0, 11000, 40)] = ord("a")
    data = text.tobytes()
    ct = tcore.LazyCoreTables(lazy, data[:4000], device=CPU)
    exp, est = lazy.count(data, 0)
    assert exp > 0
    assert tpipe.pipelined_count(ct, _segments(data, random.Random(2)),
                                 chunk_len=K) == (est, exp)
    first, st = lazy.scan_first(data, 0)
    assert tpipe.pipelined_scan(ct, _segments(data, random.Random(3)),
                                chunk_len=K)[:2] == (st, first)


def test_pipelined_equals_the_jax_pipeline(monkeypatch):
    """One small shape against the JAX pipeline (Pallas in interpret
    mode), its SpecTables beside the port's: the results, the repair
    statistics and, segment by segment, chunk 0's warmup classes (the
    port's _tail_cls against the JAX package's prev_tail_cls)."""
    tdfa, jdfa = _machines("ab")
    tables, jtables = tscan.SpecTables(tdfa, CPU), jscan.SpecTables(jdfa)
    rng = random.Random(21)
    data = _corpus(rng, b"aabbc ", 3000, [(1500, b"abab")])
    # two segments under the warmup first: the tail classes are then
    # right-aligned after zeros
    segs = [data[:5], data[5:17]] + [data[i:i + 700]
                                      for i in range(17, len(data), 700)]
    tails, jtails = [], []

    def record(prep, into):
        def wrapped(*args, prev_tail_cls=None, **kw):
            into.append(None if prev_tail_cls is None
                        else np.asarray(prev_tail_cls).tolist())
            return prep(*args, prev_tail_cls=prev_tail_cls, **kw)
        return wrapped

    monkeypatch.setattr(tpipe, "prepare_on_device",
                        record(tpipe.prepare_on_device, tails))
    monkeypatch.setattr(jpipe, "prepare_auto",
                        record(jpipe.prepare_auto, jtails))
    assert tpipe.pipelined_count(tables, segs, chunk_len=K) == \
        tuple(jpipe.pipelined_count(jtables, segs, chunk_len=K))
    # every segment ends in a ragged chunk, repaired natively
    assert tables.last_repair == jtables.last_repair
    assert tables.last_repair[0] >= len(segs)
    assert tails == jtails and len(tails) == len(segs)
    assert tails[0] is None and tails[1][:-5] == [0] * (len(tails[1]) - 5)
    assert all(t is not None and any(t) for t in tails[1:])
    assert tpipe.pipelined_scan(tables, segs, chunk_len=K) == \
        tuple(jpipe.pipelined_scan(jtables, segs, chunk_len=K))
    assert tables.last_repair == jtables.last_repair


def test_pipeline_cuts_large_segments_into_device_prep_pieces(monkeypatch):
    """A segment past MAX_SEGMENT goes in pieces of whole chunks, each
    through the device prep (never the host prep past 2 GiB, which would
    read the segment back from the device), with results unchanged and
    pair alignment kept."""
    def no_host_prep(*args, **kw):
        raise AssertionError("the pipeline reached the host prep")

    monkeypatch.setattr(tprep, "_prepare", no_host_prep)
    rng = random.Random(5)
    for pattern, cls, alphabet, plant in CASES[:2]:
        dfa, _ = _machines(pattern)
        tables = cls(dfa, CPU)
        native = NativeDfa(dfa)
        data = _corpus(rng, alphabet, 7001, [(959, plant), (5000, plant)])
        exp, est = native.count(data, 0)
        first, st = native.scan_first(data, 0)
        for segs in ([data], [data[:2999], data[2999:]]):
            monkeypatch.setattr(tpipe, "MAX_SEGMENT", 1 << 30)
            assert tpipe.pipelined_count(tables, segs, chunk_len=K) == \
                (est, exp)
            whole = tables.last_repair
            monkeypatch.setattr(tpipe, "MAX_SEGMENT", 1000)
            assert tpipe.pipelined_count(tables, segs, chunk_len=K) == \
                (est, exp)
            # the pieces are whole chunks: no chunk more, none repaired
            assert tables.last_repair == whole
            assert tpipe.pipelined_scan(tables, segs,
                                        chunk_len=K)[:2] == (st, first)


# --- the Scanner ------------------------------------------------------------

# (pattern, alphabet, plant, the tier that serves the streams: None for
# the static tier)
SCANNER_CASES = [
    ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"abc", b"baaaacca", None),
    ([b"cat", b"dog(s)?", b"bird", b"fish"], b"catdogsbirdfish x", b"dogs",
     None),
    (b"a.{13}b", b"bcdfgz ", b"a" + b"c" * 13 + b"b", "LazyCoreTables"),
    (NO_TIER, b"bcdefgh ", b"cdefghijklmnopqrstuvwxyz", "CoreTables"),
    (r"tail\z", b"x", b"tail", None),
]


@pytest.mark.parametrize("idx", range(len(SCANNER_CASES)))
def test_scanner_stream_methods_equal_jax(idx, jax_caps):
    pattern, alpha, plant, tier = SCANNER_CASES[idx]
    jsc = jax_compile(pattern)
    tsc = sregex_tpu_torch.compile_pattern(pattern, device="cpu")
    host = sregex_tpu_torch.Scanner(tsc.program, device=None, ast=tsc.ast,
                                    dfa=tsc.dfa)
    tsc.DEVICE_THRESHOLD = 2048
    tsc.CORE_SAMPLE = 1024
    tier = tier or type(tsc._spec).__name__
    rng = random.Random(idx)
    n = 10000
    for trial, at in enumerate((None, n // 2, n - len(plant))):
        data = bytearray(rng.choice(alpha) for _ in range(n))
        if at is not None:
            data[at:at + len(plant)] = plant
        data = bytes(data)
        want = (jsc.count(data), jsc.scan(data), jsc.match(data))
        assert want == (tsc.count(data), tsc.scan(data), tsc.match(data))
        # the first segment holds the core's sample; odd lengths after it
        step = (1777, 2500, 3001)[trial]
        segs = [data[:2500]] + [data[i:i + step]
                                for i in range(2500, n, step)]
        jwant = (jsc.count_stream(list(segs)), jsc.scan_stream(list(segs)),
                 jsc.match_stream(list(segs)))
        assert jwant == want
        got = (tsc.count_stream(list(segs), chunk_len=512,
                                in_flight=1 + trial),
               tsc.scan_stream(list(segs), chunk_len=512),
               tsc.match_stream(iter(segs), chunk_len=512))
        assert got == want
        assert tsc.stats().tier == tier, tsc.stats()
        assert tsc.stats().api == "scan_stream"
        assert (host.count_stream(segs), host.scan_stream(segs),
                host.match_stream(segs)) == want
    if pattern == r"tail\z":
        assert want[1] == (0, n)            # the match ends at EOF


def test_scanner_stream_below_the_threshold_gates_to_the_host():
    sc = sregex_tpu_torch.compile_pattern("(?:a|b)aa(?:aa|bb)cc(?:a|b)",
                                          device="cpu")
    rng = random.Random(7)
    data = _corpus(rng, b"abc", 5000, [(2500, b"baaaacca")])
    segs = _segments(data, rng)
    assert sc.DEVICE_THRESHOLD > len(data)
    tables, it, is_core = sc._stream_tables(list(segs))
    assert tables is None and not is_core
    assert b"".join(bytes(s) for s in it) == data     # the stream intact
    assert sc.count_stream(list(segs)) == sc.count(data)
    assert sc.stats().tier == "native"
    assert sc.scan_stream(_reusing(data, 600)) == sc.scan(data)
    assert sc.stats().tier == "native"
