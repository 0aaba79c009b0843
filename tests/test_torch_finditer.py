"""The port's finditer family and its device index against the JAX
package's and brute force.

The host walker: NativeTdfa.findall rows equal the JAX walker's.
finditer / findall / sub (template and callable) / split: the port on
the walker (device=None), on device="cpu" through the reverse index
(make_index, DEVICE_THRESHOLD lowered), and under SREGEX_FINDITER=pike
equal the JAX Scanner(use_device=False).  StreamEditor: its output
equals sub for random chunkings, and the JAX editor's.  The chunk maps
(spec_chunk_map, core_chunk_map, core_chunk_map_fused) are held against
the JAX functions in tests/test_torch_finditer_maps.py.
_StartLocator.next_start equals brute force (Python's re
with a lookahead), and the device-flip prep of the reversed corpus packs
the same words as the host prep of the reversed bytes.  Every quantity
is an integer or bytes, so the tolerance is exact equality.
"""

import random
import re

import numpy as np
import pytest
import torch

from sregex_tpu.native_tdfa import NativeTdfa as JaxNativeTdfa
from sregex_tpu.stream import compile_pattern as jax_compile
from sregex_tpu.tdfa import TdfaTooLarge as JaxTdfaTooLarge
from test_fused_count import _corpus, _multi_machine

import sregex_tpu_torch
from sregex_tpu_torch import compile_regex, parse
from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.dfa import build_dfa
from sregex_tpu_torch.native_tdfa import NativeTdfa
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.core import LazyCoreTables
from sregex_tpu_torch.ops.pair import SpecTablesPair
from sregex_tpu_torch.ops.prep import _host_u8, prepare_auto
from sregex_tpu_torch.ops.prep import prepare_on_device
from sregex_tpu_torch.tdfa import TdfaTooLarge

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 512

# (pattern, alphabet, the same pattern for Python's re, or None)
CASES = [
    ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"abc x", rb"(?:a|b)aa(?:aa|bb)cc(?:a|b)"),
    (r"\bword\b", b"word abc ", rb"\bword\b"),
    ("^line", b"text\nline ", None),
    ("a[^b]{0,40}b", b"a b xyz", rb"a[^b]{0,40}b"),
    ("(a+)(b+)?", b"aabb xy", rb"a+"),
    ("x*", b"xy ", rb""),
    ([b"cat", b"dog(s)?", b"bird"], b"catdogsbird x", rb"cat|dogs?|bird"),
]


def _data(alpha, n, seed):
    rng = random.Random(seed)
    return bytes(rng.choice(alpha) for _ in range(n))


def _scanners(pattern):
    """The JAX host Scanner, and the port on the host walker and on the
    device index's plain versions."""
    host = sregex_tpu_torch.compile_pattern(pattern, device=None)
    dev = sregex_tpu_torch.compile_pattern(pattern, device="cpu")
    dev.DEVICE_THRESHOLD = 1 << 10
    return jax_compile(pattern), host, dev


def _template_repl(rid, ov, data):
    return b"[%d:%s]" % (rid, data[ov[0]:ov[1]].upper())


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_finditer_sub_split_equal_jax(idx, monkeypatch):
    pattern, alpha, _ = CASES[idx]
    jsc, host, dev = _scanners(pattern)
    for seed, n in ((idx, 3000), (idx + 50, 9000)):
        data = _data(alpha, n, seed)
        want = list(jsc.finditer(data))
        assert host.findall(data) == want
        idx_ = dev.make_index(data)
        assert idx_ is not None and idx_.route == "host copy"
        assert list(dev.finditer(data, index=idx_)) == want
        assert dev.findall(data) == want
        for repl in (b"<$0|$1|${2}|$$|$9>", _template_repl):
            jwant = jsc.sub(repl, data)
            assert host.sub(repl, data) == jwant
            assert dev.sub(repl, data, index=idx_) == jwant
            assert dev.sub(repl, data, count=3, index=idx_) == \
                jsc.sub(repl, data, count=3)
        assert dev.split(data, index=idx_) == jsc.split(data)
        assert host.split(data, maxsplit=2) == jsc.split(data, maxsplit=2)
    monkeypatch.setenv("SREGEX_FINDITER", "pike")
    pike = sregex_tpu_torch.compile_pattern(pattern, device=None)
    assert pike._tdfa_walker() is None
    assert pike.findall(data) == want
    assert pike.sub(b"<$0>", data) == jsc.sub(b"<$0>", data)


def test_native_tdfa_rows_equal_the_jax_walker():
    for pattern, alpha, _ in CASES:
        try:
            jw = JaxNativeTdfa(jax_compile(pattern).program)
        except JaxTdfaTooLarge:
            # past the walker's budget in both packages
            with pytest.raises(TdfaTooLarge):
                NativeTdfa(compile_pattern_prog(pattern))
            continue
        tw = NativeTdfa(compile_pattern_prog(pattern))
        data = _data(alpha, 5000, 3)
        for start, skip in ((0, False), (17, True)):
            assert np.array_equal(tw.findall(data, start, skip),
                                  jw.findall(data, start, skip))
        assert list(tw.iter_ovectors(data)) == list(jw.iter_ovectors(data))


def compile_pattern_prog(pattern):
    return sregex_tpu_torch.compile_pattern(pattern, device=None).program


def test_walker_declines_only_on_too_large_and_the_knob(monkeypatch):
    pat = rb"bar[a-z]{30,70}rab"
    sc = sregex_tpu_torch.compile_pattern(pat, device=None)
    assert sc.dfa is None and sc._tdfa_walker() is None
    ok = sregex_tpu_torch.compile_pattern(rb"(a+)b", device=None)
    assert isinstance(ok._tdfa_walker(), NativeTdfa)
    monkeypatch.setattr(NativeTdfa, "available", staticmethod(lambda: False))
    nog = sregex_tpu_torch.compile_pattern(rb"(a+)b", device=None)
    assert nog._tdfa_walker() is None
    assert nog.findall(b"xaab ab") == [(0, [1, 4, 1, 3]), (0, [5, 7, 5, 6])]


def _chunkings(data, rng):
    n = len(data)
    yield [data]
    yield [data[i:i + 1] for i in range(n)] or [b""]
    for _ in range(3):
        cuts = sorted(rng.randrange(n + 1)
                      for _ in range(rng.randrange(1, 6)))
        pieces, prev = [], 0
        for c in cuts:
            pieces.append(data[prev:c])
            prev = c
        pieces.append(data[prev:])
        for _ in range(rng.randrange(0, 3)):
            pieces.insert(rng.randrange(len(pieces) + 1), b"")
        yield pieces


def _edit(sc, repl, pieces, count=0):
    ed = sc.editor(repl, count=count)
    out = []
    for i, p in enumerate(pieces):
        out.append(ed.feed(p, eof=i == len(pieces) - 1))
        if ed.finished:
            break
    assert ed.finished
    return b"".join(out), ed.n_replacements


@pytest.mark.parametrize("idx", [0, 3, 4, 5, 6])
def test_stream_editor_equals_sub_and_jax(idx):
    pattern, alpha, _ = CASES[idx]
    jsc, host, _ = _scanners(pattern)
    rng = random.Random(idx)
    for n in (0, 300):
        data = _data(alpha, n, idx + n)
        for repl, count in ((b"<$0:$1>", 0), (_template_repl, 2)):
            want = host.sub(repl, data, count=count)
            for pieces in _chunkings(data, rng):
                got = _edit(host, repl, pieces, count)
                assert got == want
                assert got == _edit(jsc, repl, pieces, count)
    ed = host.editor(b"x")
    ed.feed(b"ab", eof=True)
    with pytest.raises(RuntimeError):
        ed.feed(b"more")


def _brute_map(native, data, k, entry=0):
    """Entries, counts and final state of a native walk, chunk by
    chunk."""
    entries, counts, s = [], [], entry
    for lo in range(0, len(data), k):
        entries.append(s)
        c, s = native.count(data[lo:lo + k], s)
        counts.append(c)
    return np.array(entries), np.array(counts), s


def _starts(pattern_re, data):
    """Every position where a match of ``pattern_re`` starts."""
    return sorted({m.start() for m in re.finditer(b"(?=(?:%s))"
                                                  % pattern_re, data)})


def _brute_next(starts, pos):
    i = int(np.searchsorted(starts, pos))
    return int(starts[i]) if i < len(starts) else None


@pytest.mark.parametrize("idx", [0, 1, 3, 4, 5, 6])
def test_next_start_equals_brute_force(idx):
    pattern, alpha, pre = CASES[idx]
    sc = sregex_tpu_torch.compile_pattern(pattern, device="cpu")
    data = _data(alpha, 5 * K + 123, idx)
    loc = sc.make_index(data)
    starts = np.array(_starts(pre, data), dtype=np.int64)
    for pos in range(0, len(data) + 1):
        assert loc.next_start(pos) == _brute_next(starts, pos), pos


def test_device_flip_prep_equals_the_host_prep_of_the_reversed_bytes():
    rng = random.Random(8)
    data = bytes(rng.choice(b"abcdxyz\n") for _ in range(9 * K + 33))
    rev = data[::-1]
    for pattern, cls in ((rb"ab+c", SpecTablesPair), (rb"ab+c|xy",
                                                      tscan.SpecTables),
                         (rb"(?:cat|dog|a{3,70}b)", tscan.SpecTablesWide)):
        dfa = build_dfa(compile_regex(parse(pattern)[0]))
        tables = (cls(dfa, CPU, narrow_only=True) if cls is SpecTablesPair
                  else cls(dfa, CPU))
        flipped = torch.flip(_host_u8(data), [0])
        got = prepare_on_device(tables, flipped, K)
        want = prepare_auto(tables, rev, K)
        assert got[1:] == want[1:]
        assert torch.equal(got[0], want[0])


def test_index_routes_agree(monkeypatch):
    """The device-flip route (SREGEX_DEVICE_PREP=1) and the host-copy
    route build the same index; a Scanner with no AST, or on the host,
    has none, and finditer takes the walker."""
    pattern, alpha, _ = CASES[6]
    data = _data(alpha, 6 * K, 4)
    sc = sregex_tpu_torch.compile_pattern(pattern, device="cpu")
    a = sc.make_index(data)
    monkeypatch.setenv("SREGEX_DEVICE_PREP", "1")
    b = sc.make_index(data)
    assert (a.route, b.route) == ("host copy", "device flip")
    assert np.array_equal(a.entries, b.entries)
    assert np.array_equal(a.counts, b.counts)
    assert sregex_tpu_torch.compile_pattern(
        pattern, device=None).make_index(data) is None
    noast = tstream.Scanner(sc.program, device="cpu")
    assert noast.make_index(data) is None
    noast.DEVICE_THRESHOLD = 1 << 10
    assert noast.findall(data) == jax_compile(pattern).findall(data)


def test_index_on_the_legacy_reverse_core():
    """a.{10}b|cdef...z: its reverse machine has no static tier, so the
    index runs on the reverse machine's legacy core."""
    pat = "a.{10}b|cdefghijklmnopqrstuvwxyz"
    sc = sregex_tpu_torch.compile_pattern(pat, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(3)
    data = bytearray(rng.choice(b"cdxyz ") for _ in range(12 * K))
    for pos in (1000, 3333, 5000):
        data[pos:pos + 12] = b"a0123456789b"
    data[4100:4124] = b"cdefghijklmnopqrstuvwxyz"
    data = bytes(data)
    loc = sc.make_index(data)
    assert sc._rev_spec is None
    assert isinstance(sc._rev_coret, tcore.CoreTables)
    assert [loc.next_start(p) for p in (0, 1001, 3334, 4101, 5001)] == \
        [1000, 3333, 4100, 5000, None]
    assert sc.findall(data) == jax_compile(pat).findall(data)


def test_index_on_the_lazy_reverse_core(monkeypatch):
    """Past the eager budget both ways and past the walker's: the index
    runs on the lazy reverse machine's core (tests/test_finditer_device.py
    's monster pattern), exactly as the Pike loop."""
    pat = rb"bar[a-z]{30,70}rab"
    dev = sregex_tpu_torch.compile_pattern(pat, device="cpu")
    assert dev.dfa is None and dev._rev_dfa() is None \
        and dev._tdfa_walker() is None
    dev.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(3)
    data = bytearray(rng.choice(b"barxyz ") for _ in range(30000))
    m = b"bar" + b"qwertyuiopasdfghjklzxcvbnmqwertyuiopasdf"[:40] + b"rab"
    data[7000:7000 + len(m)] = m
    data[21000:21000 + len(m)] = m
    data = bytes(data)
    monkeypatch.setenv("SREGEX_FINDITER", "pike")
    want = list(jax_compile(pat).finditer(data))
    assert len(want) == 2
    assert list(dev.finditer(data)) == want
    assert isinstance(dev._rev_lz_coret, LazyCoreTables)


def test_index_on_the_fused_reverse_core(monkeypatch):
    """SREGEX_FUSED=1 over a reverse machine with a long-chain wide tier:
    the index runs on core_chunk_map_fused."""
    monkeypatch.setenv("SREGEX_FUSED", "1")
    dfa, words = _multi_machine()
    sc = sregex_tpu_torch.compile_pattern(words, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 12
    data = _corpus(words, 20 * K, seed=3, plant_every=1500)
    loc = sc.make_index(data)
    assert isinstance(sc._rev_fusedct, tcore.CoreTables)
    assert sc._rev_fusedct.last_escapes[0] > 0
    rdata = data[::-1]
    want = _brute_map(sc._rev_dfa(), rdata, loc.CHUNK)
    assert np.array_equal(loc.entries, want[0])
    assert np.array_equal(loc.counts, want[1])
    assert sc.findall(data, index=loc) == jax_compile(words).findall(data)
