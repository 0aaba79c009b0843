"""The port's batched document surface (ops/batch.py, ops/core._fused_batch,
ops/tdfa_scan.tdfa_find_many and the Scanner's *_many methods) against
the JAX package's.

Prep: batch_prepare's spans and packed words equal the JAX
batch_prepare's for narrow, pair, wide and tagged tables.  Planes: the
narrow _batch_dispatch planes equal the JAX ones (its Pallas kernel in
interpret mode).  The fused batch: _fused_batch's summary, merged
planes and core planes equal the JAX _fused_batch's on the 14-keyword
set of tests/test_batch.py, its tables and preps carried across
(convert.core_tables_from_jax, prepared_from_jax), with escapes in
document-start chunks.  tdfa_find_many equals the JAX one.  Those are
the three JAX interpret-mode programs, each at one small shape; they are
in tests/test_torch_batch_kernels.py.

Scanner: count_many, scan_many, match_many, find_many, finditer_many and
sub_many on device="cpu" equal the JAX host Scanner's per-document
count / scan / find / findall / sub (no JAX compile) on the narrow,
pair, wide, 8-bit-class, affine and big tiers, the legacy core, the
fused batch (SREGEX_FUSED=1) and its overflow fold, over empty
documents and documents under one chunk, at chunk_len 256, through
prepare_many handles (reused, and re-prepped for other documents),
across a match straddling two documents, and where the tier declines
(BatchUnsupported: the per-document loop serves).  Every quantity is an
integer or bytes, so the tolerance is exact equality.  Inputs come from
seeded generators.
"""

import random

import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex as jax_compile_regex
from sregex_tpu import parse as jax_parse
from sregex_tpu import parse_multi as jax_parse_multi
from sregex_tpu.dfa import build_dfa as jax_build_dfa
from sregex_tpu.ops import batch as jbatch
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.tdfa_scan import TdfaSpecTables as JaxTdfa
from sregex_tpu.stream import Scanner as JaxScanner
from sregex_tpu.stream import compile_pattern as jax_compile

from sregex_tpu_torch import compile_pattern, compile_regex, parse, parse_multi
from sregex_tpu_torch.dfa import build_dfa
from sregex_tpu_torch.ops import batch as tbatch
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.pair import SpecTablesPair
from sregex_tpu_torch.ops.tdfa_scan import TdfaSpecTables
from sregex_tpu_torch.stream import Scanner

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
# tests/test_batch.py's adversarial sizes: empty, under one chunk, one
# chunk less one, exact, one more, several
SIZES = [0, 1, 13, 2047, 2048, 2049, 6000, 30011, 4096]


def _docs(rng, alpha, plant, sizes):
    """tests/test_batch.py's documents: random bytes of ``alpha``, the
    plant at a random place in most documents past 40 bytes."""
    out = []
    for n in sizes:
        d = bytearray(rng.choice(alpha) for _ in range(n))
        if n > 40 and rng.random() < 0.7:
            at = rng.randrange(0, n - len(plant))
            d[at:at + len(plant)] = plant
        out.append(bytes(d))
    return out


def _scanners(pattern, threshold=1):
    """The port's Scanner on the CPU plain versions with DEVICE_THRESHOLD
    lowered, and the JAX host Scanner (the oracle)."""
    sc = compile_pattern(pattern, device="cpu")
    sc.DEVICE_THRESHOLD = threshold
    return sc, jax_compile(pattern, use_device=False)


def _kw_scanners(seed=2, nwords=14):
    """tests/test_batch.py::_kw_scanner's keyword set in both packages:
    the port's Scanner on the CPU, the JAX host Scanner, the JAX device
    Scanner (its tables only; nothing is compiled here) and the words."""
    rng = random.Random(seed)
    words = list({("".join(rng.choice("abcdefghijklmn")
                           for _ in range(4))).encode()
                  for _ in range(nwords)})
    tast, _ = parse_multi(words)
    sc = Scanner(compile_regex(tast), device="cpu", ast=tast)
    sc.DEVICE_THRESHOLD = 1 << 12
    jast, _ = jax_parse_multi(words)
    host = JaxScanner(jax_compile_regex(jast), use_device=False, ast=jast)
    jsc = JaxScanner(jax_compile_regex(jast), use_device=True, ast=jast)
    jsc.DEVICE_THRESHOLD = 1 << 12
    return sc, host, jsc, words


def _kw_docs(words, n_docs=18, plant_every=4096, doc0_plant=False):
    """tests/test_batch.py::_kw_docs: filler words with keywords planted
    every ``plant_every`` bytes (and at three documents' first byte with
    ``doc0_plant``: those first chunks escape, and their phase-2 redo
    must enter at the frozen document-start j0), then an empty and a
    two-byte document."""
    filler = [("".join(random.Random(77 + i).choice("nopqrstuv")
                       for _ in range(5))).encode() for i in range(12)]
    docs = []
    for i in range(n_docs):
        r = random.Random(i)
        n = 3000 + 977 * i
        piece = b" ".join(r.choice(filler) for _ in range(40)) + b" "
        out = bytearray((piece * (n // len(piece) + 1))[:n])
        for pos in range(2048, n - 16, plant_every):
            w = words[r.randrange(len(words))]
            out[pos:pos + len(w) + 2] = b" " + w + b" "
        docs.append(bytes(out))
    if doc0_plant:
        for i in (0, 3, 7):
            w = words[i % len(words)]
            docs[i] = w + b" " + docs[i][len(w) + 1:]
    return docs + [b"", b"xy"]


def _abutting(docs, words):
    """Documents 2 and 6 cut to whole 512-byte chunks, ending in the first
    three letters of a keyword: the warmup windows of documents 3 and 7,
    which start with a keyword (doc0_plant) and escape the core, then end
    mid-keyword, so a phase-2 redo that warmed up over them would not
    enter at the seed."""
    docs = list(docs)
    for i in (2, 6):
        n = len(docs[i]) // 512 * 512
        docs[i] = docs[i][:n - 4] + b" " + words[0][:3]
    return docs


def _machines(pattern):
    """The port's and the JAX package's DFA of ``pattern``."""
    return (build_dfa(compile_regex(parse(pattern)[0])),
            jax_build_dfa(jax_compile_regex(jax_parse(pattern)[0])))


# ---------------------------------------------------------------------
# the batch prep against the JAX one (the planes, the fused batch and
# tdfa_find_many: tests/test_torch_batch_kernels.py)
# ---------------------------------------------------------------------

PREP_CASES = {
    "narrow": (rb"(?:a|b)aa(?:aa|bb)cc(?:a|b)", tscan.SpecTables,
               jscan.SpecTables),
    "pair": (rb"xyzw", SpecTablesPair, None),
    "wide": (rb"foo[a-z]{8,18}bar", tscan.SpecTablesWide,
             jscan.SpecTablesWide),
    "tagged": (rb"(\w+)@(\w+)", None, None),
}


@pytest.mark.parametrize("name", list(PREP_CASES))
def test_batch_prepare_equals_jax(name):
    pattern, tcls, jcls = PREP_CASES[name]
    if name == "tagged":
        tt = TdfaSpecTables(compile_regex(parse(pattern)[0]), CPU)
        jt = JaxTdfa(jax_compile_regex(jax_parse(pattern)[0]))
    elif name == "pair":
        from sregex_tpu.ops.pallas_pair import SpecTablesPair as JaxPair
        tdfa, jdfa = _machines(pattern)
        tt = SpecTablesPair(tdfa, CPU, narrow_only=True)
        jt = JaxPair(jdfa, narrow_only=True)
    else:
        tdfa, jdfa = _machines(pattern)
        tt, jt = tcls(tdfa, CPU), jcls(jdfa)
    docs = _docs(random.Random(31), b"abcfoxyzw@ 1", b"fooabcdefghbar",
                 SIZES)
    for chunk_len in (256, 2048):
        tp = tbatch.batch_prepare(tt, docs, chunk_len)
        jp = jbatch.batch_prepare(jt, docs, chunk_len)
        assert (tp.K, tp.spans, tp.nbytes, tp._key) \
            == (jp.K, jp.spans, jp.nbytes, jp._key)
        assert tp.prepared[1:] == tuple(jp.prepared[1:])
        assert np.array_equal(tp.prepared[0].numpy(),
                              np.asarray(jp.prepared[0]))
        assert tp.starts.tolist() == [s for s, _, _ in jp.spans]


# ---------------------------------------------------------------------
# the Scanner's *_many methods against the JAX host Scanner
# ---------------------------------------------------------------------

ALPHA18 = b"abcdefghijklmnopqrstuvwxyz "
SCANNER_CASES = {
    # name: (pattern, alphabet, plant, seed, chunk_len, the port's tier)
    "narrow": (rb"(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"abc x", b"baaaaccb", 11,
               2048, "SpecTables"),
    "pair": (rb"[a-f]+[0-9]{2,5}", b"abcdef012345 xyz", b"abc123", 16,
             2048, "SpecTablesPair"),
    "wide": (rb"foo[a-z]{8,18}bar", b"abfor z", b"fooabcdefghijbar", 12,
             2048, "SpecTablesWide"),
    "8bit": (rb"alpha|bravo|charlie|delta|echo|foxtrot|golf|hotel|india|"
             rb"juliet|kilo|lima|mike|november|oscar|papa|quebec|romeo",
             ALPHA18, b" november ", 13, 2048, "SpecTablesWide"),
    "affine": (rb"q[ab]{40,190}z", b"ab x", b"q" + b"ab" * 30 + b"z", 22,
               2048, "SpecTablesAffine"),
    "big": (rb"a.{11}b", b"abq xyz", b"a" + b"q" * 11 + b"b", 23, 2048,
            "SpecTablesBig"),
    "small_chunks": (rb"er+or", b"erox ", b"errror", 15, 256,
                     "SpecTablesPair"),
}


@pytest.mark.parametrize("name", list(SCANNER_CASES))
def test_count_scan_match_many_equal_the_jax_host(name):
    pattern, alpha, plant, seed, chunk_len, tier = SCANNER_CASES[name]
    sc, host = _scanners(pattern)
    assert type(sc._spec).__name__ == tier
    if name == "8bit":
        assert sc._spec.bits == 8
    docs = _docs(random.Random(seed), alpha, plant, SIZES)
    want_counts = [host.count(d) for d in docs]
    want_scans = [host.scan(d) for d in docs]
    assert sc.count_many(docs, chunk_len=chunk_len) == want_counts
    st = sc.stats()
    assert (st.api, st.tier) == ("count_many", tier), st
    assert st.chunks > 0 and st.nbytes == sum(map(len, docs))
    assert sc.scan_many(docs, chunk_len=chunk_len) == want_scans
    assert (sc.stats().api, sc.stats().tier) == ("scan_many", tier)
    assert sc.match_many(docs, chunk_len=chunk_len) \
        == [s is not None for s in want_scans]
    assert any(c > 0 for c in want_counts)


def test_the_legacy_core_serves_a_machine_with_no_static_tier():
    pattern = b"a.{10}b|cdefghijklmnopqrstuvwxyz"
    sc, host = _scanners(pattern)
    assert sc._spec is None
    plant = b"a" + b"x" * 10 + b"b"
    docs = _docs(random.Random(24), b"abcdefg xyz", plant, SIZES)
    assert sc.count_many(docs) == [host.count(d) for d in docs]
    st = sc.stats()
    assert (st.api, st.tier) == ("count_many", "CoreTables"), st
    assert sc.scan_many(docs) == [host.scan(d) for d in docs]
    assert sc.stats().tier == "CoreTables"
    # a handle packs for the core's inner machine
    h = sc.prepare_many(docs)
    assert h is not None and h._key == tbatch._pack_key(sc._coret.inner)
    assert sc.count_many(docs, prepared=h) == [host.count(d) for d in docs]


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("SREGEX_FUSED", "1")


def test_the_fused_batch_redoes_escapes_on_the_device(fused):
    sc, host, _, words = _kw_scanners()
    docs = _abutting(_kw_docs(words, doc0_plant=True), words)
    exp_c = [host.count(d) for d in docs]
    exp_s = [host.scan(d) for d in docs]
    assert sc.count_many(docs) == exp_c
    st = sc.stats()
    assert (st.api, st.tier) == ("count_many", "CoreTables"), st
    assert sc._fusedct not in (None, False)
    n_esc, overflow = sc._fusedct.last_escapes
    assert n_esc > 0 and not overflow
    # the device redo absorbed the escapes, those of the document starts
    # too: only the ragged tails repair
    K = tcore.fused_chunk(sc._fusedct.inner, sc._spec)
    assert st.repaired == sum(1 for d in docs if len(d) % K), st
    assert sc.scan_many(docs) == exp_s
    h = sc.prepare_many(docs)
    assert h is not None and h.full is not None
    assert sc.count_many(docs, prepared=h) == exp_c
    assert sc.scan_many(docs, prepared=h) == exp_s
    assert h.aux is not None    # the document metadata, cached


def test_the_fused_overflow_folds_the_core_planes(fused, monkeypatch):
    """More escapes than the device cap: the legacy fold over the core
    planes, per document (forced, as tests/test_batch.py forces it: no
    CPU-sized corpus passes one phase-2 block row of escapes)."""
    real = tcore._fused_batch

    def overflow(*args, **kw):
        summary, merged, packed, flags = real(*args, **kw)
        summary = summary.clone()
        summary[0] = 0
        summary[1] = 1 << 30
        return summary, merged, packed, flags

    monkeypatch.setattr(tbatch, "_fused_batch", overflow)
    sc, host, _, words = _kw_scanners(seed=5, nwords=10)
    docs = _kw_docs(words, n_docs=10, plant_every=256)
    assert sc.count_many(docs, chunk_len=512) == [host.count(d)
                                                   for d in docs]
    assert sc._fusedct.last_escapes[1]
    assert sc.stats().tier == "CoreTables"
    assert sc.scan_many(docs, chunk_len=512) == [host.scan(d) for d in docs]


def test_fused_merged_fold_on_a_broken_chain(fused, monkeypatch):
    """Where the merged chain breaks (all_ok 0, no overflow), the fold
    walks the merged planes per document."""
    real = tcore._fused_batch

    def broken(*args, **kw):
        summary, merged, packed, flags = real(*args, **kw)
        summary = summary.clone()
        summary[0] = 0
        merged = merged.clone()
        merged[2, 1::3] = -7          # speculated entries that never match
        return summary, merged, packed, flags

    monkeypatch.setattr(tbatch, "_fused_batch", broken)
    sc, host, _, words = _kw_scanners(seed=9)
    docs = _kw_docs(words, n_docs=8)
    assert sc.count_many(docs, chunk_len=512) == [host.count(d)
                                                   for d in docs]
    assert sc.stats().repaired > 8
    assert sc.scan_many(docs, chunk_len=512) == [host.scan(d) for d in docs]


def test_find_finditer_sub_many_equal_the_jax_host():
    sc, host = _scanners(rb"(er+)or")
    docs = _docs(random.Random(21), b"eorx ", b"errror", SIZES)
    docs += [b"x" * 5000]                      # match-free
    assert sc.find_many(docs, chunk_len=256) == [host.find(d) for d in docs]
    st = sc.stats()
    assert (st.api, st.tier) == ("find_many", "TdfaSpecTables"), st
    got = sc.finditer_many(docs, chunk_len=256)
    assert got == [host.findall(d) for d in docs]
    assert got[-1] == []
    assert sc.sub_many(b"<$1>", docs, chunk_len=256) \
        == [host.sub(b"<$1>", d) for d in docs]
    # a nullable pattern fires everywhere, on empty documents too
    scn, hostn = _scanners(rb"a*")
    small = [b"", b"b", b"aab"]
    assert scn.finditer_many(small) == [hostn.findall(d) for d in small]


def test_find_many_with_captures_and_prepared_handles():
    sc, host = _scanners(rb"(\w+)@(\w+)")
    docs = _docs(random.Random(18), b"abc@12 .,", b"user@host", SIZES)
    want = [host.find(d) for d in docs]
    assert sc.find_many(docs) == want
    h = sc.prepare_many(docs, for_find=True)
    assert h is not None and h._key == tbatch._pack_key(sc._tdfa_spec)
    assert sc.find_many(docs, prepared=h) == want
    # a handle of other documents is re-prepped, never decoded
    other = _docs(random.Random(19), b"abc@12 .,", b"user@host", SIZES[::-1])
    assert sc.find_many(other, prepared=h) == [host.find(d) for d in other]


def test_prepared_handles_are_reused_and_re_prepped():
    pattern, alpha, plant, seed, _, _ = SCANNER_CASES["narrow"]
    sc, host = _scanners(pattern)
    docs = _docs(random.Random(seed), alpha, plant, SIZES)
    h = sc.prepare_many(docs)
    assert h is not None and h.nbytes == sum(map(len, docs))
    assert h.full is None       # no fused tier without SREGEX_FUSED=1
    want = [host.count(d) for d in docs]
    for _ in range(2):
        assert sc.count_many(docs, prepared=h) == want
    assert sc.scan_many(docs, prepared=h) == [host.scan(d) for d in docs]
    other = _docs(random.Random(seed + 1), alpha, plant, SIZES[::-1])
    assert sc.count_many(other, prepared=h) == [host.count(d)
                                                 for d in other]
    assert sc.count_many(other[:-1], prepared=h) \
        == [host.count(d) for d in other[:-1]]
    # below DEVICE_THRESHOLD the set takes no handle
    sc.DEVICE_THRESHOLD = 1 << 30
    assert sc.prepare_many(docs) is None


def test_a_match_across_two_documents_is_not_reported():
    sc, _ = _scanners(rb"xyzw")
    docs = [b"a" * 2046 + b"xy", b"zw" + b"b" * 2046]
    assert sc.count_many(docs) == [0, 0]
    assert sc.scan_many(docs) == [None, None]
    assert sc.match_many(docs) == [False, False]
    assert sc.stats().api == "scan_many"
    fs, _ = _scanners(rb"(xy)(zw)")
    got = fs.find_many(docs + [b"c" * 1000 + b"xyzw" + b"c" * 3000])
    assert got[0] is None and got[1] is None
    assert got[2] == (0, [1000, 1004, 1000, 1002, 1002, 1004])
    assert fs.stats().api == "find_many"


def test_eof_matches_empty_documents_and_an_empty_set():
    sc, host = _scanners(rb"ab\z")
    docs = [b"", b"ab", b"xab", b"ab" * 3000, (b"x" * 2046) + b"ab"]
    assert sc.count_many(docs) == [host.count(d) for d in docs]
    assert sc.scan_many(docs) == [host.scan(d) for d in docs]
    assert sc.count_many([]) == []
    assert sc.find_many([]) == []


def test_a_tier_without_a_pad_byte_loops_over_the_documents(monkeypatch):
    def no_pad(tables):
        raise tbatch.BatchUnsupported("no zero-class byte to pad with")

    monkeypatch.setattr(tbatch, "_pad_byte", no_pad)
    sc, host = _scanners(rb"(er+)or", threshold=1 << 12)
    docs = _docs(random.Random(15), b"erox ", b"errror", SIZES)
    assert sc.count_many(docs) == [host.count(d) for d in docs]
    assert sc.stats().api == "count"
    assert sc.scan_many(docs) == [host.scan(d) for d in docs]
    assert sc.stats().api == "scan"
    assert sc.find_many(docs) == [host.find(d) for d in docs]
    assert sc.stats().api == "find"
    assert sc.prepare_many(docs) is None


def test_the_lazy_machine_and_the_host_loop_over_the_documents():
    sc, host = _scanners(rb"a.{13}b")
    assert sc.dfa is None
    docs = [b"xyz" * 2000 + b"a" + b"q" * 13 + b"b", b"", b"ab" * 3000]
    assert sc.count_many(docs) == [host.count(d) for d in docs]
    assert sc.stats().api == "count"
    assert sc.prepare_many(docs) is None
    hs = compile_pattern(rb"(er+)or", device=None)
    docs = _docs(random.Random(21), b"eorx ", b"errror", SIZES)
    want = jax_compile(rb"(er+)or", use_device=False)
    assert hs.count_many(docs) == [want.count(d) for d in docs]
    assert hs.stats().tier == "native"
