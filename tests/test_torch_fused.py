"""The port's fused two-phase core tier (ops/core.py) against the JAX
package's (ops/pallas_core.py, its Pallas kernels in interpret mode on
the CPU mesh, as tests/test_fused_count.py runs them) and the native
engine, at chunk_len 512 on corpora of at most 600 KB.

_fused_count: the 11-int summary, the merged planes (full premultiplied
space) and the phase-1 core planes equal the JAX ones on every live
chunk slot, for escapes below the cap, a chunk-0 escape, an overflow
past a lowered cap, a phase-2 speculation miss, big full tables and
small corpora (the last four in tests/test_torch_fused_cases.py).  core_count_fused / core_scan_fused: results,
last_repair and last_fused_cause equal the JAX package's, and the
results the native engine's.  Scanner: wide and big machines stay on
their static tiers (the card's band); SREGEX_FUSED=1 puts them on the
fused tier, SREGEX_CORE=0 keeps it out again; an overflowing fused
count hands the machine back to the static tier, and repeated "miss"
repairs climb the warmup ladder on both machines in lockstep.  Every
quantity is an integer, so the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex, parse
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.pallas_big import SpecTablesBig as JaxBig
from test_fused_count import _corpus, _multi_machine
from test_torch_core import assert_same_core, jax_caps  # noqa: F401

from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.ops import big as tbig
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, TILE
from sregex_tpu_torch.ops.pair import SpecTablesPair
from sregex_tpu_torch.ops.prep import prepare_auto

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
K = 512


def _dense_full(dfa):
    """The full machine's narrow or wide tables in both packages."""
    try:
        return jscan.SpecTables(dfa), tscan.SpecTables(dfa, CPU)
    except ValueError:
        return jscan.SpecTablesWide(dfa), tscan.SpecTablesWide(dfa, CPU)


def _long_runs(head_len, n, seed):
    """Short a-runs for head_len bytes (every window converges), then
    250-450-byte runs that outlast a 32-byte warmup."""
    rng = random.Random(seed)
    head = bytearray()
    while len(head) < head_len:
        head += b"a" * rng.randrange(5, 40) + b" "
    body = bytearray(head[:head_len])
    while len(body) < n:
        body += (b"a" * rng.randrange(250, 450) + rng.choice([b"b", b" "])
                 + b"a" * rng.randrange(5, 40) + b" ")
    return bytes(body[:n])


def _case_escapes():
    dfa, words = _multi_machine()
    data = _corpus(words, 400_000, seed=3, plant_every=8192)
    return dfa, _dense_full(dfa), data, data[:64 << 10], {}


def _case_chunk0():
    # keywords only inside chunk 0, a core sampled where there are none
    dfa, words = _multi_machine()
    data = bytearray(_corpus(words, 200_000, seed=7, plant_every=1 << 30))
    w = words[0]
    data[40:40 + len(w) + 2] = b" " + w + b" "
    data[200:200 + len(w) + 2] = b" " + w + b" "
    data = bytes(data)
    return dfa, _dense_full(dfa), data, data[8 << 10:72 << 10], {
        "no_pair": True}


def _case_overflow():
    # a keyword in every 128-byte chunk of 600 KB, a core sampled where
    # there are none: 4688 escaped chunks, past the smallest cap (one
    # phase-2 block row, GROUPS*1024 = 4096 slots at 4 groups)
    dfa, words = _multi_machine(nwords=8, wordlen=4, seed=11)
    data = bytearray(_corpus(words, 600_000, seed=3, plant_every=1 << 30))
    for pos in range(40, len(data) - 16, 128):
        w = words[pos % len(words)]
        data[pos:pos + len(w) + 2] = b" " + w + b" "
    sample = _corpus(words, 64 << 10, seed=4, plant_every=1 << 30)
    return dfa, _dense_full(dfa), bytes(data), sample, {"no_pair": True}


def _case_miss():
    # the escaped long runs cannot converge in the full machine's
    # 32-byte warmup: phase 2's chain breaks and the host walks it
    ast, _ = parse(b"a{200,400}b")
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    data = _long_runs(64 << 10, 300_000, seed=7)
    return dfa, (jscan.SpecTablesWide(dfa), tscan.SpecTablesWide(dfa, CPU)), \
        data, data[:64 << 10], {"no_pair": True}


def _case_big():
    # phase 2 on the big kernel
    ast, _ = parse(rb"(?:ab?c){60,140}z")
    dfa = build_dfa(compile_regex(ast), max_states=65536)
    rng = random.Random(23)
    data = bytearray()
    while len(data) < 400_000:
        data += bytes(rng.choice(b"xyzw .")
                      for _ in range(rng.randrange(200, 900)))
        data += b"abc" * rng.randrange(1, 30)
    data = bytes(data[:400_000])
    # a core sampled from the filler alone: every excursion escapes
    sample = bytes(rng.choice(b"xyzw .") for _ in range(64 << 10))
    return dfa, (JaxBig(dfa), tbig.SpecTablesBig(dfa, CPU)), data, \
        sample, {"no_pair": True}


CASES = {"escapes": _case_escapes, "chunk0": _case_chunk0,
         "overflow": _case_overflow, "miss": _case_miss, "big": _case_big}
# the chunk length of each case
CHUNK = {"overflow": 128}
# Each case compiles its own interpret-mode JAX program (its machine and
# core differ); these cases, and the small corpora's, run in
# tests/test_torch_fused_cases.py to balance the test workers.
CASES_FILE_CASES = ("overflow", "miss", "big")
HERE = [c for c in CASES if c not in CASES_FILE_CASES]


@pytest.fixture
def case(request, jax_caps, monkeypatch):  # noqa: F811
    """(JAX core, port core, JAX full tables, port full tables, data);
    the overflow case lowers both packages' FUSED_CAP to one phase-2
    block row."""
    name = request.param
    if name == "overflow":
        monkeypatch.setattr(jcore, "FUSED_CAP", GROUPS * TILE)
        monkeypatch.setattr(tcore, "FUSED_CAP", GROUPS * TILE)
    dfa, (jfull, tfull), data, sample, kw = CASES[name]()
    jct = jcore.CoreTables(dfa, sample, require_fast=False, **kw)
    tct = tcore.CoreTables(dfa, sample, require_fast=False, device=CPU,
                           **kw)
    assert_same_core(tct, jct)
    assert np.array_equal(tfull.fused.numpy(), _flat(jfull))
    return name, jct, tct, jfull, tfull, data, CHUNK.get(name, 512)


def _flat(jt):
    from sregex_tpu_torch.convert import _flat_rows
    v = getattr(jt, "fused_rows", None)
    return _flat_rows(np.asarray(jt.fused_vec if v is None else v))


def _same_dispatch(jct, tct, jfull, tfull, data, k=512):
    """Both packages' _fused_dispatch on one corpus at chunk length k:
    the chunking, the summary, and the merged and core planes on the
    live slots agree.  Returns the port's summary."""
    jd = jcore._fused_dispatch(jct, jfull, data, k, 0, None, None)
    td = tcore._fused_dispatch(tct, tfull, data, k, 0, None, None)
    for key in ("C", "Cfull", "K", "n", "B1"):
        assert jd[key] == td[key], key
    if jd["summ"] is None:
        assert td["summ"] is None
        return None
    assert np.array_equal(jd["summ"], td["summ"]), (jd["summ"], td["summ"])
    live = td["Cfull"]
    for key in ("merged", "packed_core"):
        want = np.asarray(jd[key]).reshape(3, -1)[:, :live]
        got = td[key].reshape(3, -1)[:, :live].numpy()
        assert np.array_equal(want, got), key
    return td["summ"]


@pytest.mark.parametrize("case", HERE, indirect=True)
def test_fused_count_summary_and_planes_equal_jax(case):
    fused_count_summary_and_planes_equal_jax(case)


def fused_count_summary_and_planes_equal_jax(case):
    """_fused_dispatch of both packages on the case's corpus: summary and
    planes equal; escapes, overflow and the phase-2 miss as the case
    plants them."""
    name, jct, tct, jfull, tfull, data, k = case
    summ = _same_dispatch(jct, tct, jfull, tfull, data, k)
    n_esc, overflow = int(summ[8]), bool(summ[7])
    assert n_esc > 0
    assert overflow == (name == "overflow")
    if name == "overflow":
        assert n_esc > GROUPS * TILE
    if name == "chunk0":
        # the redo of chunk 0 survived the merge (the dump slot)
        assert bool(summ[0])
    if name == "miss":
        assert not bool(summ[0]) and not overflow


@pytest.mark.parametrize("case", HERE, indirect=True)
def test_fused_results_equal_jax_and_native(case):
    fused_results_equal_jax_and_native(case)


def fused_results_equal_jax_and_native(case):
    """core_count_fused / core_scan_fused: results, last_repair and
    last_fused_cause equal the JAX package's, the results the native
    engine's."""
    name, jct, tct, jfull, tfull, data, k = case
    native = NativeDfa(tct.dfa)
    exp_c, exp_st = native.count(data, 0)
    got = tcore.core_count_fused(tct, tfull, data, chunk_len=k)
    assert got == jcore.core_count_fused(jct, jfull, data, chunk_len=k)
    assert got == (exp_st, exp_c)
    assert tct.last_repair == jct.last_repair
    assert tct.last_fused_cause == jct.last_fused_cause
    if name in ("overflow", "miss"):
        assert tct.last_fused_cause == name
    exp_f, exp_fst = native.scan_first(data, 0)
    got = tcore.core_scan_fused(tct, tfull, data, chunk_len=k)
    assert got == jcore.core_scan_fused(jct, jfull, data, chunk_len=k)
    assert got == (exp_fst, exp_f)
    assert tct.last_repair == jct.last_repair
    assert tct.last_fused_cause == jct.last_fused_cause


@pytest.mark.parametrize("case", ["escapes"], indirect=True)
def test_fused_phase2_reads_escaped_chunks_of_the_full_prep(case):
    fused_phase2_reads_escaped_chunks_of_the_full_prep(case)


def fused_phase2_reads_escaped_chunks_of_the_full_prep(case):
    """The merged planes of every escaped chunk (phase 2 through the slot
    map, the windows read in place in the full machine's prep) equal the
    full machine's own scan of that chunk entered at state 0, the plain
    version over the whole prep."""
    name, jct, tct, jfull, tfull, data, k = case
    td = tcore._fused_dispatch(tct, tfull, data, k, 0, None, None)
    full_data = prepare_auto(tfull, data, td["K"])[0]
    z = torch.zeros((full_data.shape[0], GROUPS, 8, 128), dtype=torch.int32)
    want = torch.stack([p.reshape(-1) for p in tscan.spec_scan_ref(
        full_data, z, z, tfull.fused, W=tfull.warmup, CPW=tfull.cpw,
        BITS=tfull.bits, COUNT=True)])
    live = torch.arange(td["packed_core"].shape[1]) < td["Cfull"]
    esc = (td["packed_core"][0] == tct.esc_premult) & live
    assert int(esc.sum()) > 10, name
    assert torch.equal(td["merged"][:, esc], want[:, :esc.numel()][:, esc])


def test_fused_chunk_aligns_both_preps():
    """The two preps agree on one chunk length: the dense tiers' maximum
    does not depend on the warmup, so it is the default 2048 for a
    narrow or wide core over wide or big full tables."""
    dfa, _ = _multi_machine()
    sample = _corpus(_multi_machine()[1], 64 << 10, seed=1)
    tct = tcore.CoreTables(dfa, sample, no_pair=True, device=CPU)
    _, tfull = _dense_full(dfa)
    assert tcore.fused_chunk(tct.inner, tfull) == 2048
    big = tbig.SpecTablesBig(dfa, CPU)
    assert tcore.fused_chunk(tct.inner, big) == 2048
    assert tcore.fused_chunk(tct.inner, tfull, 512) == 512


# ---------------------------------------------------------------------
# Scanner routing (device "cpu", a lowered DEVICE_THRESHOLD)
# ---------------------------------------------------------------------

BIG_PATTERN = "a.{11}b"       # past the wide cap: the big tier


def _big_corpus(n, seed):
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"bcdxyz ", np.uint8), n)
    text[rng.integers(0, n - 16, n // 4000)] = ord("a")
    return text.tobytes()


def _expect(sc, data):
    c, st = sc._native.count(data, 0)
    return c + int(sc.dfa.match_eof[st])


def _scanner(pattern):
    sc = tstream.compile_pattern(pattern, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 14
    return sc


def test_scanner_serves_a_big_tier_machine_with_the_fused_tier(monkeypatch):
    """With SREGEX_FUSED=1 the fused tier serves a big-tier machine."""
    monkeypatch.setenv("SREGEX_FUSED", "1")
    sc = _scanner(BIG_PATTERN)
    assert isinstance(sc._spec, tbig.SpecTablesBig)
    assert tstream._core_band(sc._spec) == "static"
    # 16 KB sample slices at 0, 100, 200 and 284 KB; a's between them
    # leave the sampled core and are redone in phase 2
    sc.CORE_SAMPLE = 16 << 10
    text = bytearray(_big_corpus(300_000, 1))
    for pos in np.random.default_rng(6).integers(20_000, 90_000, 60):
        text[pos] = ord("a")
    data = bytes(text)
    exp = _expect(sc, data)
    assert sc.count(data) == exp
    fct = sc._fusedct
    assert isinstance(fct, tcore.CoreTables)
    assert not isinstance(fct.inner, SpecTablesPair)
    st = sc.stats()
    assert st.tier == "CoreTables" and st.chunks > 0
    assert fct.last_escapes[0] > 0           # the a's leave the core
    first, state = sc._native.scan_first(data, 0)
    assert sc.scan(data) == (sc.dfa.id_at(state, data[first]), first)
    assert sc.stats().tier == "CoreTables"
    # a prepared corpus keys its preps on (tables, chunk length)
    prep = sc.prepare(data)
    assert sc.count(data, prepared=prep) == exp
    assert sc.count(data, prepared=prep) == exp
    ck = tcore.fused_chunk(fct.inner, sc._spec)
    assert {(id(fct.inner), ck), (id(sc._spec), ck)} <= set(prep._by_tables)


@pytest.mark.parametrize("fused", [None, "1"])
def test_scanner_keeps_wide_machines_on_the_static_tier(monkeypatch, fused):
    """The card's band without the first-scan A/B: a wide machine,
    long chain or not, stays on its static tier, and no legacy core is
    built; SREGEX_FUSED=1 puts a long-chain one on the fused tier, the
    TPU's route for it.  This 7-row machine is in the "ab" band, whose
    A/B (tests/test_torch_tier_ab.py) SREGEX_TIER_AB=0 turns off."""
    monkeypatch.setenv("SREGEX_TIER_AB", "0")
    if fused:
        monkeypatch.setenv("SREGEX_FUSED", fused)
    dfa, words = _multi_machine()
    from sregex_tpu_torch.parser import parse_multi
    from sregex_tpu_torch.compiler import compile_regex as tcompile
    ast, _ = parse_multi(words)
    sc = tstream.Scanner(tcompile(ast), device="cpu", ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 14
    assert isinstance(sc._spec, tscan.SpecTablesWide) and sc._spec.rows > 4
    assert tstream._core_band(sc._spec) == "ab"
    data = _corpus(words, 200_000, seed=31)
    assert sc.count(data) == _expect(sc, data)
    assert not sc._coret
    if fused:
        assert isinstance(sc._fusedct, tcore.CoreTables)
        assert sc.stats().tier == "CoreTables"
    else:
        assert sc._fusedct is False
        assert sc.stats().tier == "SpecTablesWide"


@pytest.mark.parametrize("fused", [None, "0"])
def test_big_machines_stay_on_the_static_big_tier(monkeypatch, fused):
    """The card's band: without SREGEX_FUSED=1 a big-tier machine is
    served by the static big tier, and no core is built."""
    if fused:
        monkeypatch.setenv("SREGEX_FUSED", fused)
    sc = _scanner(BIG_PATTERN)
    data = _big_corpus(200_000, 2)
    assert sc.count(data) == _expect(sc, data)
    assert sc._fusedct is False and sc._coret is False
    assert sc.stats().tier == "SpecTablesBig"


def test_sregex_core_0_keeps_every_core_tier_out(monkeypatch):
    monkeypatch.setenv("SREGEX_CORE", "0")
    monkeypatch.setenv("SREGEX_FUSED", "1")
    sc = _scanner(BIG_PATTERN)
    data = _big_corpus(200_000, 3)
    assert sc.count(data) == _expect(sc, data)
    assert sc._fusedct is False and sc._coret is False
    assert sc.stats().tier == "SpecTablesBig"


def test_fused_overflow_hands_the_machine_to_the_static_tier(monkeypatch):
    """A fused count past the device cap (one phase-2 block row)
    repairs its escapes on the host and is exact; it declines the fused
    tier, and the static big tier serves the next count and scan."""
    monkeypatch.setenv("SREGEX_FUSED", "1")
    monkeypatch.setattr(tcore, "FUSED_CAP", GROUPS * TILE)
    sc = _scanner(BIG_PATTERN)
    sc.CORE_SAMPLE = 16 << 10
    # the 16 KB sample slices at 0, 3, 6 and 9 MB - 16 KB hold no a;
    # elsewhere an a every 1500 bytes leaves the core in every
    # 2048-byte chunk: ~4300 escapes
    n = 9_000_000
    text = bytearray(_big_corpus(n, 4).replace(b"a", b"b"))
    for lo in (20_000, 3_020_000, 6_020_000):
        for pos in range(lo, lo + 2_940_000, 1500):
            text[pos] = ord("a")
    data = bytes(text)
    want = _expect(sc, data)
    assert sc.count(data) == want
    st = sc.stats()
    assert st.tier == "CoreTables" and st.repaired > GROUPS * TILE
    assert sc._fusedct is False
    assert sc.count(data) == want
    assert sc.stats().tier == "SpecTablesBig"
    first, state = sc._native.scan_first(data, 0)
    assert sc.scan(data) == (sc.dfa.id_at(state, data[first]), first)
    assert sc.stats().tier == "SpecTablesBig"


def test_fused_phase2_warmup_ladder_escalation(monkeypatch):
    """tests/test_fused_count.py's ladder test on the port, over a
    big-tier machine (the card's fused band): escaped long runs cannot
    certify in phase 2 at the 32-byte warmup, so two repair-heavy
    "miss" scans in a row climb the ladder on the static tables and the
    core's inner tables together, until the corpus scans with (near)
    zero host repairs; every answer is exact at every rung."""
    monkeypatch.setenv("SREGEX_AFFINE", "0")
    monkeypatch.setenv("SREGEX_FUSED", "1")
    sc = tstream.compile_pattern("a{200,400}b|c.{10}d", device="cpu")
    assert isinstance(sc._spec, tbig.SpecTablesBig)
    assert sc._spec.warmup == 32
    sc.DEVICE_THRESHOLD = 1 << 12
    data = _long_runs(sc.CORE_SAMPLE, 500_000, seed=7)
    exp = _expect(sc, data)
    reps = []
    for _ in range(6):
        assert sc.count(data) == exp
        st = sc.stats()
        assert st.tier == "CoreTables", st
        fct = sc._fusedct
        reps.append((sc._spec.warmup, fct.inner.warmup,
                     fct.last_fused_cause, st.repaired, st.chunks))
        if sc._spec.warmup >= 512 and st.repaired <= 1:
            break
    assert isinstance(sc._fusedct, tcore.CoreTables), reps
    assert reps[0][2] == "miss" and reps[0][3] > reps[0][4] * 0.25, reps
    assert sc._spec.warmup >= 512, reps
    assert all(w2 == w1 for w1, w2, *_ in reps), reps     # lockstep
    assert reps[-1][3] <= 1, reps
    assert sc.stats().warm_events >= 2
