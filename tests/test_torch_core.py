"""The port's legacy hot-core tier (ops/core.py) against the JAX
package's (ops/pallas_core.py, its Pallas kernels in interpret mode on
the CPU mesh, as its own tests run them) and the native engine.

Tables: CoreTables picks the same hot set, core machine, inner tier and
table as the JAX one from the same sample, with the defaults,
require_fast, and the fused tier's prefer_small + no_pair +
FUSED_ESCAPE_FRAC, and declines where it declines.  Summary: the ESC
check of _summarize equals the JAX one on random planes.  Results:
core_count_bytes / core_scan_bytes against the JAX package's and the
native engine's are in tests/test_torch_core_legacy.py.  The gated
phase-2 kernel's
plain version equals the JAX gated launch on the active block rows for
narrow, wide and big tables.  Routing: a machine no static tier accepts
goes to the legacy core, or to the native engine where no core fits,
and a drifted core is rebuilt.  Every quantity is an integer, so the
tolerance is exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.dfa import build_dfa
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.pallas_big import SpecTablesBig as JaxBig

from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.convert import _flat_rows
from sregex_tpu_torch.ops import big as tbig
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, TILE

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")


@pytest.fixture
def jax_caps(monkeypatch):
    """The JAX package caps its wide tier at 4096 entries on the CPU
    (16384 on the TPU); the port's cap is 16384.  Core choices are held
    against the JAX package's at its CPU cap."""
    monkeypatch.setattr(tscan.SpecTablesWide, "MAX_ENTRIES",
                        jscan.SpecTablesWide.MAX_ENTRIES)


def _full(pattern, max_states=65536):
    if isinstance(pattern, list):
        ast, _ = parse_multi(pattern, [0] * len(pattern))
    else:
        ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast), max_states=max_states)


def _jax_fused(jt):
    v = getattr(jt, "fused_rows", None)
    return _flat_rows(np.asarray(jt.fused_vec if v is None else v))


def assert_same_core(tct, jct):
    """The port's CoreTables holds the JAX one's core, bit for bit."""
    assert tct.H == jct.H
    assert np.array_equal(tct.hot2full, jct.hot2full)
    assert np.array_equal(tct.full2core, jct.full2core)
    assert tct.core.nstates == jct.core.nstates
    ti, ji = tct.inner, jct.inner
    assert type(ti).__name__ == type(ji).__name__
    for k in ("ncls", "bits", "cpw", "warmup"):
        assert getattr(ti, k) == getattr(ji, k), k
    assert ti.rows == getattr(ji, "rows", 1)
    assert np.array_equal(ti.fused.numpy(), _jax_fused(ji))
    assert tct.esc_premult == jct.esc_premult


# tests/test_pallas_core.py's machines:
# (pattern, benign alphabet, adversarial alphabet, planted match)
PATTERNS = [
    (b"a{60,120}b", b"ab xx", b"a", b"c" + b"a" * 80 + b"b"),
    (b"word (?:[a-zA-Z0-9]+ ){0,10}otherword",
     b"word other abc12 ", b"abc12 ", b"word abc de3 otherword"),
    (b"(x|y|z[QW]){1,5}(longish|loquatious)",
     b"xyzQW longish loquatious", b"xyzQW", b"zQxylongish"),
]
WIDE_ALPHA = [bytes([c]) + b"zz" for c in range(ord("a"), ord("a") + 18)]
MULTI = [b"abcd", b"bdca", b"cadb", b"dbac", b"acbd", b"mnkl", b"klmn",
         b"lnkm", b"nmlk", b"ikjn"]

# (name, pattern, sample alphabet, CoreTables keywords)
CORE_CASES = [
    ("counted-default", PATTERNS[0][0], PATTERNS[0][1], {}),
    ("word-default", PATTERNS[1][0], PATTERNS[1][1], {}),
    ("alt-default", PATTERNS[2][0], PATTERNS[2][1], {}),
    ("counted-fast", PATTERNS[0][0], b"xy z", {"require_fast": True}),
    ("wide-alpha-default", WIDE_ALPHA, b"abcdefghijklmnopqrz ", {}),
    ("multi-fused", MULTI, b"abcdklmn ", {
        "prefer_small": True, "no_pair": True,
        "max_escape_frac": tcore.FUSED_ESCAPE_FRAC}),
    ("counted-fused", PATTERNS[0][0], PATTERNS[0][1], {
        "prefer_small": True, "no_pair": True,
        "max_escape_frac": tcore.FUSED_ESCAPE_FRAC}),
]


@pytest.mark.parametrize("name,pattern,alpha,kw", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_core_tables_equal_the_jax_core(jax_caps, name, pattern, alpha, kw):
    dfa = _full(pattern)
    rng = random.Random(len(name))
    sample = bytes(rng.choice(alpha) for _ in range(20000))
    jct = jcore.CoreTables(dfa, sample, **kw)
    tct = tcore.CoreTables(dfa, sample, device=CPU, **kw)
    assert_same_core(tct, jct)
    assert tct.H < dfa.nstates + 1
    if kw.get("require_fast"):
        assert type(tct.inner).__name__ != "SpecTablesWide"
    if kw.get("no_pair"):
        assert type(tct.inner).__name__ != "SpecTablesPair"


def test_core_tables_decline_what_the_jax_core_declines(jax_caps):
    """No pair/narrow core covers the 18-literal machine's hot rows
    (require_fast), and an empty sample has no core: both packages
    raise ValueError."""
    dfa = _full(WIDE_ALPHA)
    rng = random.Random(11)
    sample = bytes(rng.choice(b"abcdefghijklmnopqrz ") for _ in range(20000))
    with pytest.raises(ValueError):
        jcore.CoreTables(dfa, sample, require_fast=True)
    with pytest.raises(ValueError):
        tcore.CoreTables(dfa, sample, require_fast=True, device=CPU)
    for make in (lambda: jcore.CoreTables(dfa, b""),
                 lambda: tcore.CoreTables(dfa, b"", device=CPU)):
        with pytest.raises(ValueError, match="empty"):
            make()


@pytest.mark.parametrize("count", [True, False])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_summarize_esc_check_equals_jax(count, seed):
    """_summarize with ESC on random planes whose chains hold in runs,
    with escaped exits spread over them: the summary and the narrow
    repair planes equal the JAX package's exactly."""
    rng = np.random.default_rng(seed * 2 + count)
    Cp = GROUPS * TILE
    shape = (1, GROUPS, 8, 128)
    ESC = 37 * 5
    phi = rng.integers(0, 37, Cp).astype(np.int32) * 5
    swarm = np.concatenate([[0], phi[:-1]]).astype(np.int32)
    broke = rng.random(Cp) < 0.01
    swarm[broke] = (swarm[broke] + 5) % (37 * 5)
    phi[rng.random(Cp) < 0.004 * seed] = ESC
    fm = np.where(rng.random(Cp) < 0.02, rng.integers(1, 700, Cp), 0) \
        .astype(np.int32)
    state0 = np.zeros(shape, np.int32)
    C = Cp - 100 * seed
    bad_tail = C - 1 if seed == 2 else -1
    for esc in (None, ESC):
        jsum, jpacked = jscan._summarize(
            jnp.asarray(phi.reshape(shape)), jnp.asarray(fm.reshape(shape)),
            jnp.asarray(swarm.reshape(shape)), jnp.asarray(state0), C,
            bad_tail, count, ESC=esc)
        tsum, tpacked = tscan._summarize(
            *(torch.from_numpy(a.reshape(shape).copy())
              for a in (phi, fm, swarm, state0)), C, bad_tail, count,
            ESC=esc)
        assert np.array_equal(np.asarray(jsum), tsum.numpy()), esc
        assert np.array_equal(np.asarray(jpacked), tpacked.numpy())
    assert not bool(tsum[0])


# (name, pattern, JAX tables class, port tables class, big)
GATED = [
    ("narrow", "(?:a|b)aa(?:aa|bb)cc(?:a|b)", jscan.SpecTables,
     tscan.SpecTables, False),
    ("wide", "a{60}b", jscan.SpecTablesWide, tscan.SpecTablesWide, False),
    ("big", "a{60,120}b", JaxBig, tbig.SpecTablesBig, True),
]


@pytest.mark.parametrize("name,pattern,jcls,tcls,big", GATED,
                         ids=[g[0] for g in GATED])
def test_gated_plain_version_equals_the_jax_gated_launch(name, pattern, jcls,
                                                         tcls, big):
    """_dispatch_kernel_gated (interpret mode, both block rows let
    through: one launch, as a row's result does not depend on the gate)
    and gated_scan_ref on the same windows: the rows the gate lets
    through agree for escape counts of 1, one block and one block plus
    one, and the plain version leaves zeros in the rows gated off."""
    dfa = _full(pattern)
    jt, tt = jcls(dfa), tcls(dfa, CPU)
    kind, W, CPW, BITS, R = jcore._tier_statics(jt)
    assert tcore._tier_statics(tt) == (kind, W, CPW, BITS, R)
    K, B2 = 256, 2
    Jw = (W + K) // CPW
    rng = np.random.default_rng(len(name))
    shape = (B2, Jw, GROUPS, 8, 128)
    cls = rng.integers(0, tt.ncls, shape + (CPW,), dtype=np.int64)
    words = np.zeros(shape, np.int64)
    for k in range(CPW):
        words |= cls[..., k] << (BITS * k)
    data = words.astype(np.uint32).view(np.int32)
    planes = (B2, GROUPS, 8, 128)
    s0 = (rng.integers(0, tt.nstates, planes) * tt.ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, planes).astype(np.int32)
    kernel = jcore._mk_kernel(kind, W + K, W, CPW, BITS, R)
    fused = jt.fused_vec if kind == "narrow" else jt.fused_rows
    targs = [torch.from_numpy(a.copy()) for a in (data, s0, j0)] \
        + [tt.fused]
    want = jcore._dispatch_kernel_gated(
        kernel, jnp.asarray(data), jnp.asarray(s0), jnp.asarray(j0),
        fused, jnp.ones(B2, jnp.int32))
    for n_esc in (1, GROUPS * TILE, GROUPS * TILE + 1, 0):
        nblk = -(-n_esc // (GROUPS * TILE))
        ne = torch.tensor([n_esc], dtype=torch.int32)
        got = tcore.gated_scan_ref(*targs, ne, W=W, CPW=CPW, BITS=BITS)
        launched = tcore.gated_scan_launches
        got2 = tcore.gated_scan(*targs, ne, W=W, CPW=CPW, BITS=BITS,
                                big=big)
        assert tcore.gated_scan_launches == launched    # no CPU launch
        for g, g2, w in zip(got, got2, want):
            assert torch.equal(g, g2)
            assert np.array_equal(g[:nblk].numpy(), np.asarray(w)[:nblk])
            assert not g[nblk:].any()


def test_gated_wrapper_keeps_gated_rows_of_given_planes():
    """With ``out`` planes, the CPU wrapper writes the active rows only,
    as the kernel does."""
    dfa = _full("a{60}b")
    tt = tscan.SpecTablesWide(dfa, CPU)
    K = 128
    Jw = (tt.warmup + K) // tt.cpw
    data = torch.zeros((2, Jw, GROUPS, 8, 128), dtype=torch.int32)
    z = torch.zeros((2, GROUPS, 8, 128), dtype=torch.int32)
    out = tuple(torch.full_like(z, -7) for _ in range(3))
    got = tcore.gated_scan(data, z, z, tt.fused,
                           torch.tensor([5], dtype=torch.int32),
                           W=tt.warmup, CPW=tt.cpw, BITS=tt.bits, out=out)
    for g, o in zip(got, out):
        assert g is o
        assert bool((g[1:] == -7).all()) and not bool((g[0] == -7).any())
    with pytest.raises(ValueError, match="one int32"):
        tcore.gated_scan(data, z, z, tt.fused,
                         torch.zeros(2, dtype=torch.int32), W=tt.warmup,
                         CPW=tt.cpw, BITS=tt.bits)


def _mapped_case(n_esc, seed, B2=4, Bc=6):
    """A corpus of Bc block rows of a{60}b's wide prep words (random class
    codes), zero entry planes for B2 rows and an ascending random slot
    map of n_esc chunks, padding slots on chunk 0 (_compact_escapes'
    layout)."""
    tt = tscan.SpecTablesWide(_full("a{60}b"), CPU)
    rng = np.random.default_rng(seed)
    Jw = (tt.warmup + 128) // tt.cpw
    cls = rng.integers(0, tt.ncls, (Bc, Jw, GROUPS, 8, 128, tt.cpw),
                       dtype=np.int64)
    words = np.zeros(cls.shape[:-1], np.int64)
    for k in range(tt.cpw):
        words |= cls[..., k] << (tt.bits * k)
    corpus = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    cap, chunks = B2 * GROUPS * TILE, Bc * GROUPS * TILE
    sel = np.zeros(cap, np.int64)
    sel[:n_esc] = np.sort(rng.choice(chunks, min(n_esc, cap), replace=False))
    z = torch.zeros((B2, GROUPS, 8, 128), dtype=torch.int32)
    return tt, corpus, torch.from_numpy(sel.astype(np.int32)), z


@pytest.mark.parametrize("n_esc", [0, 1, GROUPS * TILE, GROUPS * TILE + 1,
                                   4 * GROUPS * TILE])
def test_gated_slot_map_equals_gathered_windows(n_esc):
    """gated_scan over the corpus through a slot map (the card's phase 2,
    windows read in place) equals _gather_windows + gated_scan_ref, and
    each active slot equals the plain scan of its chunk's words picked
    out by numpy; padding slots redo chunk 0."""
    tt, corpus, sel, z = _mapped_case(n_esc, seed=n_esc)
    kw = dict(W=tt.warmup, CPW=tt.cpw, BITS=tt.bits)
    ne = torch.tensor([n_esc], dtype=torch.int32)
    got = tcore.gated_scan(corpus, z, z, tt.fused, ne, sel=sel, **kw)
    blk = tcore._gather_windows(corpus, sel, sel.numel())
    want = tcore.gated_scan_ref(blk, z, z, tt.fused, ne, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the windows again, gathered by numpy: slot i -> chunk sel[i]
    Bc, Jw = corpus.shape[:2]
    flat = corpus.numpy().reshape(Bc, Jw, -1)
    c = sel.numpy().astype(np.int64)
    slot_words = flat[c // (GROUPS * TILE), :, c % (GROUPS * TILE)]
    windows = torch.from_numpy(np.ascontiguousarray(
        slot_words.reshape(z.shape[0], GROUPS * TILE, Jw)
        .transpose(0, 2, 1)).reshape(z.shape[0], Jw, GROUPS, 8, 128))
    ref = tscan.spec_scan_ref(windows, z, z, tt.fused, COUNT=True, **kw)
    nblk = min(z.shape[0], -(-n_esc // (GROUPS * TILE)))
    for g, r in zip(got, ref):
        assert torch.equal(g[:nblk], r[:nblk])
        assert not g[nblk:].any()
    if n_esc < nblk * GROUPS * TILE:      # an active padding slot
        c0 = tscan.spec_scan_ref(corpus[:1], z[:1], z[:1], tt.fused,
                                 COUNT=True, **kw)
        for g, c in zip(got, c0):
            assert int(g.reshape(-1)[n_esc]) == int(c.reshape(-1)[0])


def test_gated_wrapper_checks_its_slot_map():
    """A map of the wrong length, dtype or device raises before any
    launch; t16 without ``big`` raises."""
    tt, corpus, sel, z = _mapped_case(5, seed=1)
    kw = dict(W=tt.warmup, CPW=tt.cpw, BITS=tt.bits)
    ne = torch.tensor([5], dtype=torch.int32)
    with pytest.raises(ValueError, match="sel must be int32"):
        tcore.gated_scan(corpus, z, z, tt.fused, ne, sel=sel[:-1], **kw)
    with pytest.raises(TypeError, match="int32"):
        tcore.gated_scan(corpus, z, z, tt.fused, ne, sel=sel.long(), **kw)
    with pytest.raises(ValueError, match="different devices"):
        tcore.gated_scan(corpus, z, z, tt.fused, ne,
                         sel=torch.empty_like(sel, device="meta"), **kw)
    with pytest.raises(ValueError, match="big tables only"):
        tcore.gated_scan(corpus, z, z, tt.fused, ne, sel=sel, t16=object(),
                         **kw)


# a machine past the big tier's 2**17 entries that is not piecewise affine
NO_TIER = "a.{10}b|cdefghijklmnopqrstuvwxyz"


@pytest.fixture(scope="module")
def no_tier_prog():
    ast, _ = parse(NO_TIER)
    return compile_regex(ast)


def _expect(sc, data):
    c, st = sc._native.count(data, 0)
    return c + int(sc.dfa.match_eof[st])


def test_scanner_serves_a_no_static_tier_machine_with_the_legacy_core(
        no_tier_prog):
    sc = tstream.Scanner(no_tier_prog, device="cpu")
    assert sc._spec is None
    sc.DEVICE_THRESHOLD = 1 << 14
    rng = random.Random(3)
    data = bytearray(rng.choice(b"bcdxyz ") for _ in range(200_000))
    for pos in (70_001, 150_003):
        data[pos:pos + 12] = b"a0123456789b"
    data = bytes(data)
    assert sc.count(data) == _expect(sc, data) >= 2
    assert isinstance(sc._coret, tcore.CoreTables)
    assert sc._fusedct is False            # no static tier for phase 2
    st = sc.stats()
    assert st.tier == "CoreTables" and st.chunks > 0
    assert st.repaired >= 1                # the planted matches escape
    first, state = sc._native.scan_first(data, 0)
    assert sc.scan(data) == (sc.dfa.id_at(state, data[first]), first)
    assert sc.stats().tier == "CoreTables"
    assert sc.match(data)


def test_scanner_falls_back_to_native_where_no_core_fits(no_tier_prog):
    """A sample that visits thousands of states evenly (the window of
    a's times the literal's first steps): no wide core covers it within
    the escape budget, CoreTables declines, the native engine serves,
    and stats() says so."""
    sc = tstream.Scanner(no_tier_prog, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 14
    rng = random.Random(4)
    data = bytes(rng.choice(b"abcd") for _ in range(100_000))
    assert sc.count(data) == _expect(sc, data)
    assert sc._coret is False
    assert sc.stats().tier == "native"
    assert sc.scan(data) is not None and sc.stats().tier == "native"


def test_sregex_core_0_keeps_the_legacy_core_out(monkeypatch, no_tier_prog):
    monkeypatch.setenv("SREGEX_CORE", "0")
    sc = tstream.Scanner(no_tier_prog, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 14
    data = bytes(random.Random(5).choice(b"bcdxyz ")
                 for _ in range(50_000))
    assert sc.count(data) == _expect(sc, data)
    assert sc._coret is False and sc._fusedct is False
    assert sc.stats().tier == "native"


def test_scanner_recores_on_corpus_drift(no_tier_prog):
    """tests/test_pallas_core.py's drift test on the port: two drifted
    scans in a row rebuild the legacy core from the current corpus, the
    re-core shows in stats(), and every answer stays exact.  On this
    machine a rebuilt core stays repair-heavy (a chunk's speculative
    start in mid-run passes through window states that the sample's
    walk never visits, so it escapes; the JAX package's core does the
    same), so past MAX_RECORE rebuilds the tier declines for good and
    the native engine serves."""
    sc = tstream.Scanner(no_tier_prog, device="cpu")
    sc.DEVICE_THRESHOLD = 1 << 12
    rng = random.Random(41)

    def check(data):
        assert sc.count(data) == _expect(sc, data)

    benign = bytes(rng.choice(b"xy z") for _ in range(40000))
    check(benign)
    core_a = sc._coret
    assert isinstance(core_a, tcore.CoreTables)
    assert sc.stats().recore_events == 0
    drift = b"".join(b"a" * rng.randrange(3, 12) + b"x"
                     for _ in range(6000))
    check(drift)                  # strike 1 (exact via repair)
    assert sc._coret is core_a
    check(drift)                  # strike 2 -> rebuild scheduled
    assert sc._coret is None and sc._core_rebuilds == 1
    assert sc.stats().recore_events == 1
    check(drift)                  # rebuilt from the drifted corpus
    core_b = sc._coret
    assert isinstance(core_b, tcore.CoreTables) and core_b is not core_a
    assert core_b.H > core_a.H
    assert sc._core_strikes == 1
    for rebuilt in range(2, sc.MAX_RECORE + 2):
        check(drift)              # strike 2 -> the next rebuild
        assert sc._core_rebuilds == rebuilt
        assert sc.stats().recore_events == rebuilt
        check(drift)              # served by the next core, or native
    assert sc._coret is False
    assert sc.stats().tier == "native"
