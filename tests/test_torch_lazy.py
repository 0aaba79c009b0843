"""The lazy machine in the port's Scanner: patterns past the eager DFA
budget (a.{13}b, x[^y]{300}y) against the JAX package.

Results: count/scan/match/find of the port's Scanner on device=None
(the lazy host walkers) and on device="cpu" with DEVICE_THRESHOLD
lowered (the legacy core over the lazy machine, LazyCoreTables, on the
plain kernels) equal the JAX package's host Scanner (tier "lazy"), the
port's own LazyDfa and the native Pike engine over the whole corpus.
Tables: the port's LazyCoreTables holds the JAX one's hot set, core
machine and inner table from the same sample, and its fold equals the
JAX fold (Pallas in interpret mode, as the JAX package's own tests run
it).  Inputs come from numpy's and random's seeded generators; every
quantity is an integer, so the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

import sregex_tpu
from sregex_tpu.dfa import LazyDfa as JaxLazy
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan

import sregex_tpu_torch
from sregex_tpu_torch import compile_regex, parse
from sregex_tpu_torch.convert import _flat_rows
from sregex_tpu_torch.dfa import DfaTooLarge, LazyDfa, build_dfa
from sregex_tpu_torch.native_pike import NativePikeCtx, NativeProgram
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
PATTERNS = [b"a.{13}b", b"x[^y]{300}y"]


@pytest.fixture
def jax_caps(monkeypatch):
    """The JAX package caps its wide tier at 4096 entries on the CPU;
    cores are held against the JAX package's at that cap."""
    monkeypatch.setattr(tscan.SpecTablesWide, "MAX_ENTRIES",
                        jscan.SpecTablesWide.MAX_ENTRIES)


def _sparse(n, seed, rare=b"a", rate=1e-3):
    """Text over "bcdfgz " with a rare byte planted at random spots: a
    small hot set, so a lazy core fits."""
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"bcdfgz ", np.uint8), n)
    for b in rare:
        text[rng.integers(0, n - 400, max(1, int(n * rate)))] = b
    return text.tobytes()


def _dense(n, seed, alpha=b"ab"):
    """Random text over ``alpha``: a.{13}b over "ab" (x[^y]{300}y over
    "xab") visits thousands of lazy states, so no core fits and the lazy
    host walkers serve."""
    rng = random.Random(seed)
    return bytes(rng.choice(alpha) for _ in range(n))


def _host_expect(pattern, data):
    """count / scan / find of the JAX package's host Scanner (tier lazy)."""
    js = sregex_tpu.compile_pattern(pattern)
    assert js.dfa is None
    want = (js.count(data), js.scan(data), js.match(data), js.find(data))
    assert js.stats().tier == "lazy"
    return want


def _port_native(pattern, data):
    """The same from the port's LazyDfa (native walkers) and the native
    Pike engine over the whole corpus."""
    ast, _ = parse(pattern)
    prog = compile_regex(ast)
    lz = LazyDfa(prog)
    c, st = lz.count(data, 0)
    c += lz.match_eof(st)
    ctx = NativePikeCtx(NativeProgram(prog), exact=True)
    rc, _ = ctx.exec(data, True)
    find = (rc, [int(v) for v in ctx.ovector]) if rc >= 0 else None
    return c, find


def test_past_the_budget_patterns_have_no_dense_machine():
    for p in PATTERNS:
        with pytest.raises(DfaTooLarge):
            build_dfa(compile_regex(parse(p)[0]))


@pytest.mark.parametrize("device", [None, "cpu"])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_lazy_scanner_equals_jax_and_native(pattern, device):
    """A sparse corpus with planted matches (the lazy core serves on
    device="cpu") and a dense one (no core fits: the lazy walkers)."""
    planted = b"x" + b"q" * 300 + b"y" if b"x" in pattern else \
        b"a" + b"q" * 13 + b"b"
    for data, cored in ((_sparse(120000, 3)[:90000] + planted
                         + _sparse(40000, 4), True),
                        (_dense(30000 if pattern[:1] == b"a" else 6000, 5,
                                pattern[:1] + b"ab"), False)):
        sc = sregex_tpu_torch.compile_pattern(pattern, device=device)
        assert sc.dfa is None and sc._spec is None
        sc.DEVICE_THRESHOLD = 1 << 12
        sc.CORE_SAMPLE = 8 << 10
        want = _host_expect(pattern, data)
        got = (sc.count(data), sc.scan(data), sc.match(data))
        tier = "LazyCoreTables" if device and cored else "lazy"
        assert sc.stats().tier == tier
        # find on a device corpus tries the tagged hot core first, and
        # where it certifies, the core served; else the multi-pass path's
        # prefilter did
        got += (sc.find(data),)
        st = sc.stats()
        assert st.tier == ("TdfaCoreTables" if st.certified else tier)
        assert got == want
        c, find = _port_native(pattern, data)
        assert (got[0], got[3]) == (c, find)
        if device and not cored:
            assert sc._coret is False     # declined: the hot set is wide


def test_lazy_scanner_counts_the_reanchor_corpus():
    """300,000 bytes of random "ab" from random.Random(5): a.{13}b counts
    75,264 on the JAX Scanner, the port's LazyDfa and the port's
    Scanner."""
    rng = random.Random(5)
    data = bytes(rng.choice(b"ab") for _ in range(300000))
    sc = sregex_tpu_torch.compile_pattern(b"a.{13}b", device=None)
    assert sc.count(data) == 75264 == _port_native(b"a.{13}b", data)[0]
    assert sc.stats().tier == "lazy"


def test_lazy_scanner_with_prepared_corpus_and_eof():
    """prepared= on the lazy core, and a match ending at EOF."""
    data = _sparse(60000, 8) + b"a" + b"z" * 13 + b"b"
    sc = sregex_tpu_torch.compile_pattern(b"a.{13}b", device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 14
    sc.CORE_SAMPLE = 8 << 10
    prep = sc.prepare(data, chunk_len=512)
    want = _host_expect(b"a.{13}b", data)
    assert sc.count(data, prepared=prep) == want[0]
    assert sc.stats().tier == "LazyCoreTables"
    assert sc.scan(data, prepared=prep) == want[1]
    assert want[1][1] == len(data) or want[0] > 1


def test_sregex_core_0_keeps_the_lazy_core_out(monkeypatch):
    monkeypatch.setenv("SREGEX_CORE", "0")
    data = _sparse(60000, 9)
    sc = sregex_tpu_torch.compile_pattern(b"a.{13}b", device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 14
    assert sc.count(data) == _host_expect(b"a.{13}b", data)[0]
    assert sc.stats().tier == "lazy" and sc._coret is False


@pytest.mark.parametrize("pattern", PATTERNS)
def test_lazy_core_tables_equal_the_jax_lazy_core(jax_caps, pattern):
    """The same sample gives the same hot set (H, hot2full), the same
    core machine and the same inner table in both packages."""
    prog_t = compile_regex(parse(pattern)[0])
    prog_j = sregex_tpu.compile_regex(sregex_tpu.parse(pattern)[0])
    sample = _sparse(24000, 11, rare=pattern[:1],
                     rate=1e-3 if pattern[:1] == b"a" else 1e-4)
    tct = tcore.LazyCoreTables(LazyDfa(prog_t), sample, device=CPU)
    jct = jcore.LazyCoreTables(JaxLazy(prog_j), sample)
    assert tct.H == jct.H > 1
    assert np.array_equal(tct.hot2full, jct.hot2full)
    assert tct.full2core == jct.full2core
    assert tct.core.nstates == jct.core.nstates
    assert np.array_equal(tct.core.trans, jct.core.trans)
    ti, ji = tct.inner, jct.inner
    assert type(ti).__name__ == type(ji).__name__
    for k in ("ncls", "bits", "cpw", "warmup"):
        assert getattr(ti, k) == getattr(ji, k), k
    rows = getattr(ji, "fused_rows", None)
    assert np.array_equal(ti.fused.numpy(), _flat_rows(np.asarray(
        ji.fused_vec if rows is None else rows)))
    assert tct.esc_premult == jct.esc_premult


def test_lazy_core_fold_equals_the_jax_fold(jax_caps):
    """core_count_bytes / core_scan_bytes over LazyCoreTables: the port's
    plain kernels and fold equal the JAX package's (interpret mode), its
    last_repair included, and the lazy machine's own walk, with escapes
    re-scanned on the lazy machine."""
    pattern = b"a.{13}b"
    prog_t = compile_regex(parse(pattern)[0])
    prog_j = sregex_tpu.compile_regex(sregex_tpu.parse(pattern)[0])
    sample = _sparse(16000, 12, rate=2e-4)
    tct = tcore.LazyCoreTables(LazyDfa(prog_t), sample, device=CPU)
    jct = jcore.LazyCoreTables(JaxLazy(prog_j), sample)
    data = _sparse(20000, 13, rate=3e-3)
    lz = tct.lazy          # lazy state ids are the machine's own
    got = tcore.core_count_bytes(tct, data, chunk_len=256)
    assert got == jcore.core_count_bytes(jct, data, chunk_len=256)
    assert got == lz.count(data, 0)[::-1]
    assert tct.last_repair == jct.last_repair and tct.last_repair[0] > 0
    got = tcore.core_scan_bytes(tct, data, chunk_len=256)
    assert got == jcore.core_scan_bytes(jct, data, chunk_len=256)
    assert got == lz.scan_first(data, 0)[::-1]
