"""The port's hot-core tagged tables (ops/tdfa_scan.TdfaCoreTables) and
find's one-pass branch over them, against the JAX package's (its
ops/tdfa_scan.py, the Pallas kernel in interpret mode on the CPU mesh,
as tests/test_tdfa_core.py runs it).

Tables: from the same sample both packages choose the same hot set
(hot2full, H, esc_k), code width, rows, seed and dead states, and pack
the same planes bit for bit, the ESC row block included, for a 4-bit
code machine, a byte-code one and one of 8-bit class words; they
decline the same samples.  Kernel: one launch on core tables through
the plain version gives the JAX kernel's planes and summary.  Fold:
tdfa_spec_find on core tables equals the JAX one and Python re
(certified no-match, a match between the sample windows, a match-dense
tail whose chunks meet in ESC, an escape-heavy corpus that falls back,
two regexes), with the host walks of the repair fold counted on both
sides.  Scanner.find on device="cpu" takes the hot core past the dense
budget and equals the JAX Scanner and re.  Every quantity
is an integer: the tolerance is exact equality.
"""

import random
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import sregex_tpu
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops import tdfa_scan as jtdfa
from sregex_tpu.tdfa import TdfaTooLarge as JaxTdfaTooLarge

import sregex_tpu_torch
from sregex_tpu_torch.ops import tdfa_scan as ttdfa
from sregex_tpu_torch.ops.layout import GROUPS
from sregex_tpu_torch.ops.prep import prepare_auto
from sregex_tpu_torch.tdfa import TdfaTooLarge

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")

# past the 512-entry CPU dense budget, a two-state hot set on text
# without a's (tests/test_tdfa_core.py)
PAT = rb"(a{150,300})b"
EIGHT_BIT_PAT = rb"(money|parted|fool|kilo|victor|zebra)x([0-9]+)"
BYTECODE_PAT = rb"(\d+)-(\d+)-(\d+)T(\d+):(\d+):(\d+)\.(\d+)"

FIELDS = ("H", "esc_k", "nstates", "nregs", "ntags", "ncls", "code_bits",
          "rows", "bits", "cpw", "warmup", "seed_premult", "dead_premult",
          "tags", "hot2full", "is_core")


def _corpus(n, plant_at=None, seed=3):
    rng = random.Random(seed)
    data = bytearray(rng.choice(b"xyz mnpq") for _ in range(n))
    if plant_at is not None:
        data[plant_at:plant_at + 201] = b"a" * 200 + b"b"
    return bytes(data)


def _alpha_sample(alpha, seed, stamp):
    rng = random.Random(seed)
    return bytes(rng.choice(alpha) for _ in range(4000)) + stamp


# name -> (pattern, SREGEX_TDFA_MAX or None, sample): the samples of
# tests/test_tdfa_core.py and tests/test_tdfa_device.py
CORE_CASES = {
    "code4": (PAT, None, lambda: _corpus(1 << 16)),
    "bytecode": (BYTECODE_PAT, None, lambda: _alpha_sample(
        b"abc 0123456789-:.T", 42, b" 2026-08-19T12:34:56.789 " * 2)),
    "8bit-classes": (EIGHT_BIT_PAT, 4096, lambda: _alpha_sample(
        b"abcdefghijklmnopqrstuvwxyz0123456789 ", 32, b"zebrax77 " * 3)),
}


def _programs(pat):
    return (sregex_tpu.compile_pattern(pat).program,
            sregex_tpu_torch.compile_pattern(pat, device=None).program)


def _flat(a):
    """A JAX plane [rows, 8, 128] or stack [P, rows, 8, 128] -> the
    port's [rows*128] / [P, rows*128] (every row is sublane-broadcast)."""
    a = np.asarray(a)
    assert (a == a[..., :1, :]).all()
    return a[..., 0, :].reshape(a.shape[:-3] + (-1,))


def _both(pat, sample):
    jprog, tprog = _programs(pat)
    return (jtdfa.TdfaCoreTables(jprog, sample),
            ttdfa.TdfaCoreTables(tprog, sample, CPU))


@pytest.mark.parametrize("name", sorted(CORE_CASES))
def test_core_tables_equal_the_jax_core_tables(name, monkeypatch):
    pat, tmax, sample = CORE_CASES[name]
    if tmax:
        monkeypatch.setenv("SREGEX_TDFA_MAX", str(tmax))
    jprog, tprog = _programs(pat)
    # the dense tables decline (past the budget) in both packages or in
    # neither (the 8-bit class words fit at 4096 entries)
    try:
        jtdfa.TdfaSpecTables(jprog)
    except JaxTdfaTooLarge:
        with pytest.raises(TdfaTooLarge):
            ttdfa.TdfaSpecTables(tprog, CPU)
    else:
        ttdfa.TdfaSpecTables(tprog, CPU)
    jt, tt = _both(pat, sample())
    for f in FIELDS:
        assert getattr(tt, f) == getattr(jt, f), f
    assert tt.full2core == jt.full2core
    assert np.array_equal(tt.class_map, jt.class_map)
    for k in ("t_next", "t_regsrc", "t_csrc", "t_cmeta"):
        assert np.array_equal(getattr(tt, k).numpy(),
                              _flat(getattr(jt, k))), k
    # the ESC sink: its row block loops on itself, rebuilds UNSET, commits
    # nothing; off-core ids map to None
    ncls, esc = tt.ncls, tt.esc_k
    blk = slice(esc * ncls, (esc + 1) * ncls)
    assert (tt.t_next[blk] == esc * ncls).all()
    assert (tt.t_cmeta[blk] == 0).all()
    unset = ttdfa._specials(tt.code_bits)[0]
    spp = 32 // tt.code_bits
    codes = [(tt.t_regsrc[k // spp, blk] >> (tt.code_bits * (k % spp)))
             & ((1 << tt.code_bits) - 1) for k in range(tt.nregs)]
    assert all((c == unset).all() for c in codes)
    assert tt.from_kernel_premult(esc * ncls) is None
    off = next(s for s in range(tt.tdfa.nstates) if s not in tt.full2core)
    assert tt.to_kernel_premult(off) is None
    assert tt.to_kernel_premult(tt.hot2full[-1]) == (tt.H - 1) * ncls


def test_core_tables_decline_as_the_jax_package(monkeypatch):
    """An empty sample, a sample whose hot states need more than 48
    registers (a long a-run at a budget that holds its states) and one
    whose visit mass leaves the budget all raise in both packages."""
    jprog, tprog = _programs(PAT)
    cases = [(b"", None), (b"xy" * 100 + b"a" * 290 + b"b", "4096"),
             (_corpus(1 << 16, plant_at=1000), None)]
    for sample, tmax in cases:
        if tmax:
            monkeypatch.setenv("SREGEX_TDFA_MAX", tmax)
        with pytest.raises(JaxTdfaTooLarge) as je:
            jtdfa.TdfaCoreTables(jprog, sample)
        with pytest.raises(TdfaTooLarge) as te:
            ttdfa.TdfaCoreTables(tprog, sample, CPU)
        assert str(te.value) == str(je.value)
        monkeypatch.delenv("SREGEX_TDFA_MAX", raising=False)


def test_core_planes_and_summary_equal_the_jax_kernel():
    """One launch over core tables (ESC rows, UNSET rebuilds) on a corpus
    whose a-runs leave the core: the plain version gives the JAX
    kernel's planes and summary, on the same packed words."""
    jt, tt = _both(PAT, _corpus(1 << 16))
    data = bytearray(_corpus(96 << 10, seed=8))
    for at in (5000, 40000, 70000):
        data[at:at + 201] = b"a" * 200 + b"b"
    data[90000:90100] = b"a" * 100          # an escape with no match
    data = bytes(data)
    jd, C, K, J, B = jscan._prepare(jt, data, 256)
    td, tC, tK, _, tB = prepare_auto(tt, data, 256)
    assert (C, K, B) == (tC, tK, tB)
    assert np.array_equal(np.asarray(jd), td.numpy())
    W = tt.warmup
    state0 = np.full((B, GROUPS, 8, 128), tt.seed_premult, np.int32)
    j0 = np.zeros_like(state0)
    j0[0, 0, 0, 0] = W
    full_C = C if C * K <= len(data) else C - 1
    jout = jtdfa._tdfa_scan(
        jd, jnp.asarray(state0), jnp.asarray(j0), jt.t_next, jt.t_regsrc,
        jt.t_csrc, jt.t_cmeta, jnp.int32(full_C),
        jnp.int32(jt.dead_premult), J=J, W=W, CPW=jt.cpw, BITS=jt.bits,
        CODE=jt.code_bits, R=jt.nregs, T=jt.ntags, ROWS=jt.rows)
    before = ttdfa.tdfa_scan_launches
    tout = ttdfa._tdfa_scan(tt, td, torch.from_numpy(state0),
                            torch.from_numpy(j0), full_C)
    assert ttdfa.tdfa_scan_launches == before      # the plain version ran
    for j, g, what in zip(jout, tout, ("summary", "phi", "swarm", "bank",
                                       "regs")):
        assert np.array_equal(np.asarray(j), g.numpy()), what
    # chunks ended in ESC, and two neighbours met there
    phi = tout[1].numpy()[:full_C]
    esc = tt.esc_k * tt.ncls
    assert (phi == esc).sum() >= 3
    assert (tout[2].numpy()[1:full_C][phi[:-1] == esc] == esc).any()


def _match_dense_tail(n):
    """Text without a's whose last 5000 bytes repeat a full match: every
    chunk there escapes the core, and the chunks' warmups escape too, so
    neighbouring chunks meet in ESC and the device chain validates."""
    data = bytearray(_corpus(n, seed=5))
    run = b"a" * 200 + b"b"
    data[n - 5000:] = (run * (5000 // len(run) + 1))[:5000]
    return bytes(data)


def _escape_heavy(n, step):
    """An a-run of 100, no match, every ``step`` bytes, and one full
    match near the end: every chunk escapes the core, past the repair
    budget (1/16 of the chunks), so the one-pass result falls back."""
    data = bytearray(_corpus(n, seed=11))
    for at in range(0, n - 1000, step):
        data[at:at + 100] = b"a" * 100
    data[n - 600:n - 399] = b"a" * 200 + b"b"
    return bytes(data)


def _two_regexes(n, at):
    """Text of "ab cd ef" with one match of the second regex at ``at``."""
    rng = random.Random(5)
    data = bytearray(rng.choice(b"ab cd ef") for _ in range(n))
    data[at:at + 81] = b"q" * 80 + b"r"
    return bytes(data)


TWO = [rb"(x{60,200})y", rb"(q{60,200})r"]
N = 256 << 10        # tdfa_spec_find's corpora, 512 chunks of 512 bytes

# name -> (patterns, corpus): PAT's cases over its core sampled from
# clean text, the two regexes' over the head of their corpus
FIND_CASES = {
    "no-match": (PAT, lambda: _corpus(N)),
    "planted": (PAT, lambda: _corpus(N, plant_at=150_000)),
    "meet-in-esc": (PAT, lambda: _match_dense_tail(N)),
    "fallback": (PAT, lambda: _escape_heavy(N, 400)),
    "two-regexes": (TWO, lambda: _two_regexes(N, N // 2)),
}


@pytest.fixture
def jax_walks(monkeypatch):
    """Counts the JAX repair fold's host chunk walks (its _walk_chunk),
    the count the port keeps in last_repair."""
    calls = [0]
    walk = jtdfa._walk_chunk

    def counted(*a):
        calls[0] += 1
        return walk(*a)
    monkeypatch.setattr(jtdfa, "_walk_chunk", counted)
    return calls


def _oracle(pat, data):
    """(regex id, [start, end, group 1 start, end]) of the first match by
    Python re (the second regex's for TWO, whose first never matches)."""
    rid = 1 if pat is TWO else 0
    m = re.search(pat[1] if pat is TWO else pat, data)
    return None if m is None else (rid, [m.start(), m.end(), m.start(1),
                                         m.end(1)])


@pytest.mark.parametrize("name", sorted(FIND_CASES))
def test_tdfa_spec_find_on_core_tables_equals_jax(name, jax_walks):
    pat, corpus = FIND_CASES[name]
    data = corpus()
    jt, tt = _both(pat, data[:1 << 16] if pat is TWO
                   else _corpus(1 << 16))
    want = jtdfa.tdfa_spec_find(jt, data, chunk_len=512)
    got = ttdfa.tdfa_spec_find(tt, data, chunk_len=512)
    if want not in (None, "fallback"):
        want = (want[0], [int(v) for v in want[1]])
    assert got == want
    # the walk that would pass the budget is counted, not made
    walks = jax_walks[0] + (got == "fallback")
    assert tt.last_repair == (walks, N // 512)
    if name == "fallback":
        assert got == "fallback"
        return
    # exact against Python re (the bank holds every regex's slots)
    want = _oracle(pat, data)
    if want is not None:
        ofs = tt.tdfa.slice_ofs[got[0]]
        got = (got[0], got[1][ofs:ofs + 4])
    assert got == want
    if name == "meet-in-esc":
        assert got is not None and tt.last_repair[0] > 0


def test_scanner_find_takes_the_hot_core_and_equals_jax():
    """Scanner.find past the dense budget on device="cpu": the hot core
    sampled from the corpus certifies in one pass (tier TdfaCoreTables)
    and equals the JAX Scanner (its host engines; its device path is
    held against the port's in the tests above) and Python re, for a match
    between the sample windows ({0, n/3, 2n/3, n - 256 KB}, 256 KB
    each) of one regex and of two."""
    n = 1 << 20
    for pat, data in ((PAT, _corpus(n, plant_at=620_000)),
                      (TWO, _two_regexes(n, 620_000))):
        sc = sregex_tpu_torch.compile_pattern(pat, device="cpu")
        sc.DEVICE_THRESHOLD = 1 << 16
        assert sc._tdfa_spec is None
        got = sc.find(data)
        assert got == sregex_tpu.compile_pattern(pat).find(data)
        assert got[:1] + (got[1][:4],) == _oracle(pat, data)
        assert isinstance(sc._tdfa_coret, ttdfa.TdfaCoreTables)
        st = sc.stats()
        assert (st.tier, st.certified, st.chunks) == (
            "TdfaCoreTables", True, n // 2048)


def test_hot_core_declines_and_raises_as_the_jax_package(monkeypatch):
    """A sample no core covers is declined once (False, cached) and find
    takes the multi-pass path; an error other than a decline raises."""
    sc = sregex_tpu_torch.compile_pattern(PAT, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 16
    sc.CORE_SAMPLE = 16 << 10
    data = bytearray(_corpus(1 << 17))
    for at in range(0, len(data) - 300, 4096):   # a-runs in every slice
        data[at:at + 250] = b"a" * 250
    data = bytes(data)
    assert sc.find(data) == _oracle(PAT, data)
    assert sc._tdfa_coret is False and sc.stats().certified is None
    sc2 = sregex_tpu_torch.compile_pattern(PAT, device="cpu")
    sc2.DEVICE_THRESHOLD = 1 << 16

    def broken(*a, **k):
        raise RuntimeError("build failed")
    monkeypatch.setattr(sregex_tpu_torch.stream, "TdfaCoreTables", broken)
    with pytest.raises(RuntimeError):
        sc2.find(_corpus(1 << 17))
