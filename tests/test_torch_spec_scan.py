"""The port's scan against the JAX package's Pallas scan (interpret mode
on the CPU mesh, as the JAX package's own tests run it).

Planes: on identical packed inputs and entry planes, the port's plain
kernel (spec_scan_ref, which the wrapper takes for CPU tensors) and the
two-code kernel's walk over its host-built table (spec_pair_ref) give
the JAX kernel's phi/fm/swarm, and the torch summary and repair planes
equal JAX's _summarize output.  The two-code walk equals spec_scan_ref
on random tables and the edge families (classes past ncls, j0 inside a
code pair, odd word counts, entry states that are not table values);
pair_table declines exactly what it cannot hold.  Results:
spec_scan_bytes and spec_count_bytes equal the JAX package's and the
native C++ engine.

Inputs come from numpy's seeded generator; the tolerance is exact
equality (every quantity is an integer).  JAX compiles are shared
across cases through module-scoped fixtures: B=1 and K=256 everywhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.pallas_pair import SpecTablesPair as JaxPair

from sregex_tpu_torch.convert import spec_tables_from_jax
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, SMEM_BYTES, TILE
from sregex_tpu_torch.ops.pair import SpecTablesPair

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")
HEADLINE = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"
WORDS4 = [b"abcd", b"efgh", b"ijkl", b"mnop"]   # 17 classes: 8-bit, R=3
CHUNK = 256


def _dfa(pattern):
    if isinstance(pattern, list):
        ast, _ = parse_multi(pattern)
    else:
        ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast))


@pytest.fixture(scope="module")
def tiers():
    """name -> (jax tables, port tables, dfa)."""
    out = {}
    d = _dfa(HEADLINE)
    out["narrow"] = (jscan.SpecTables(d), tscan.SpecTables(d, CPU), d)
    d = _dfa(WORDS4)
    jw, tw = jscan.SpecTablesWide(d), tscan.SpecTablesWide(d, CPU)
    assert (tw.bits, tw.rows) == (8, 3) and jw.rows == 3
    out["wide"] = (jw, tw, d)
    d = _dfa("abc")
    jp, tp = JaxPair(d, narrow_only=True), SpecTablesPair(d, CPU,
                                                          narrow_only=True)
    assert tp.rows == 1 and not tp.wide
    out["pair"] = (jp, tp, d)
    return out


def _random_inputs(rng, tables, W_units):
    """Packed words of random classes in [0, 2**BITS) (past ncls too,
    so out-of-table indices are exercised), valid premultiplied entry
    states and random warmup freezes j0 in [0, W]."""
    bits, cpw = tables.bits, tables.cpw
    Jw = (W_units + CHUNK // getattr(tables, "bpu", 1)) // cpw
    shape = (1, Jw, GROUPS, 8, 128)
    cls = rng.integers(0, 1 << bits, shape + (cpw,), dtype=np.int64)
    words = np.zeros(shape, np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    data = words.astype(np.uint32).view(np.int32)
    planes = (1, GROUPS, 8, 128)
    state0 = (rng.integers(0, tables.nstates, planes)
              * tables.ncls).astype(np.int32)
    j0 = rng.integers(0, W_units + 1, planes).astype(np.int32)
    return data, state0, j0


# (tier, COUNT, warmup in bytes); W=128 runs the narrow kernel with a
# warmup four times the default
PLANE_CASES = [("narrow", True, 32), ("narrow", False, 32),
               ("narrow", False, 128), ("wide", True, 16),
               ("wide", False, 16), ("pair", True, 64),
               ("pair", False, 64)]


@pytest.mark.parametrize("tier,count,W", PLANE_CASES)
def test_planes_and_summary_match_jax(tiers, tier, count, W):
    jt, tt, _ = tiers[tier]
    bpu = getattr(tt, "bpu", 1)
    rng = np.random.default_rng(W + 7 * count + len(tier))
    data, state0, j0_units = _random_inputs(rng, tt, W // bpu)
    j0 = j0_units * bpu                        # _scan takes bytes
    Cp = GROUPS * TILE
    C, bad_tail = Cp - 37, 1234
    J = W + CHUNK
    j_sum, j_packed = jt._scan(jnp.asarray(data), jnp.asarray(state0),
                               jnp.asarray(j0), jnp.int32(C),
                               jnp.int32(bad_tail), J, W, COUNT=count)
    t = [torch.from_numpy(a.copy()) for a in (data, state0, j0)]
    t_sum, t_packed = tt._scan(t[0], t[1], t[2], C, bad_tail, W,
                               COUNT=count)
    assert t_sum.dtype == torch.int32
    assert np.array_equal(np.asarray(j_sum), t_sum.numpy())
    assert t_packed.dtype == (torch.int32 if tt.wide else torch.uint8)
    assert np.array_equal(np.asarray(j_packed), t_packed.numpy())

    # the raw planes of the plain kernel against the JAX kernel's
    phi, fm, swarm = tscan.spec_scan_ref(
        t[0], t[1], t[2] // bpu, tt.fused, W=W // bpu, CPW=tt.cpw,
        BITS=tt.bits, COUNT=count)
    jphi, jfm, jswarm = jscan._unpack(j_packed, Cp)
    assert np.array_equal(phi.reshape(-1).numpy(), jphi)
    assert np.array_equal(fm.reshape(-1).numpy(), jfm)
    assert np.array_equal(swarm.reshape(-1).numpy(), jswarm)
    # the two-code kernel's walk, where its tier takes it
    assert (tt.pair is not None) == (tier != "wide")
    if tt.pair is not None:
        planes = tscan.spec_pair_ref(
            t[0], t[1], t[2] // bpu, tt.fused, tt.pair, W=W // bpu,
            CPW=tt.cpw, BITS=tt.bits, COUNT=count)
        for got, want in zip(planes, (jphi, jfm, jswarm)):
            assert np.array_equal(got.reshape(-1).numpy(), want)
    # the random freezes reach both ends: some streams never move in
    # the warmup, some move in all of it
    assert (j0_units == 0).any() and (j0_units >= W // bpu).any()


def _pair_case(rng, bits, ncls, W, count, j0_odd=False, odd_entry=False,
               raw_table=False, words=12):
    """Random words of classes up to 2**bits (past ncls), a random
    narrow table over S = 128 // ncls states with match fields 0-2,
    valid entry states and freezes j0 in [0, W].  ``j0_odd``: every
    freeze odd (inside a code pair); ``odd_entry``: a third of the
    entry states arbitrary (negative, past the table, not multiples of
    ncls), half of those frozen through the whole warmup; ``raw_table``:
    next fields that are not multiples of ncls."""
    cpw = tscan._CPW[bits]
    S = 128 // ncls
    Jw = W // cpw + words
    shape = (1, Jw, GROUPS, 8, 128)
    data = rng.integers(0, 1 << 32, shape, dtype=np.uint64) \
        .astype(np.uint32).view(np.int32)
    nxt = rng.integers(0, 1 << 9, 128) if raw_table \
        else rng.integers(0, S, 128) * ncls
    table = (nxt | rng.integers(0, 3, 128) << 20).astype(np.int32)
    planes = (1, GROUPS, 8, 128)
    s0 = (rng.integers(0, S, planes) * ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, planes).astype(np.int32)
    if j0_odd:
        j0 = (j0 | 1).astype(np.int32)
    if odd_entry:
        pick = rng.random(planes) < 1 / 3
        s0[pick] = rng.integers(-300, 3000, int(pick.sum()))
        j0[pick & (rng.random(planes) < 0.5)] = W
    args = [torch.from_numpy(a) for a in (data, s0, j0, table)]
    pt = tscan.pair_table(table, ncls, S, bits, CPU)
    return args, pt, dict(W=W, CPW=cpw, BITS=bits, COUNT=count)


# name -> (bits, ncls, W units, COUNT, _pair_case options)
PAIR_CASES = {
    "4bit-count": (4, 16, 32, True, {}),
    "4bit-scan": (4, 4, 32, False, {}),
    "3bit-count": (3, 8, 40, True, {}),
    "3bit-scan-wrap": (3, 5, 40, False, {}),
    "4bit-j0-in-a-pair": (4, 9, 32, True, dict(j0_odd=True)),
    "3bit-j0-in-a-pair": (3, 6, 40, False, dict(j0_odd=True)),
    "4bit-one-warm-word": (4, 11, 8, False, dict(words=6)),
    "3bit-three-warm-words": (3, 7, 30, True, dict(words=2)),
    "4bit-no-warmup": (4, 16, 0, True, {}),
    "4bit-odd-entries": (4, 3, 32, True, dict(odd_entry=True)),
    "3bit-odd-entries": (3, 8, 40, False, dict(odd_entry=True)),
    "4bit-raw-next": (4, 5, 32, False, dict(raw_table=True,
                                            odd_entry=True)),
}


@pytest.mark.parametrize("name", sorted(PAIR_CASES))
def test_pair_walk_equals_plain_version(name):
    """spec_pair_ref over pair_table's table gives spec_scan_ref's
    planes: random tables, classes past ncls, freezes inside a code
    pair, odd numbers of warm words, no warmup, entry states that are
    neither table values nor rows (negative, past the table), some
    frozen through the whole warmup, next fields off the ncls grid."""
    bits, ncls, W, count, opts = PAIR_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    args, pt, kw = _pair_case(rng, bits, ncls, W, count, **opts)
    assert pt is not None
    got = tscan.spec_pair_ref(*args, pt, **kw)
    want = tscan.spec_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    # a row for every produced state and every multiple of ncls below S
    stride = (1 << 2 * bits) + 1
    assert pt.table.numel() == pt.rows * stride
    rows = pt.table.view(pt.rows, stride)[:, -1]
    S = 128 // ncls
    want_rows = np.union1d(args[3].numpy() & ((1 << 20) - 1),
                           np.arange(S) * ncls)
    assert np.array_equal(rows.numpy(), want_rows)


def test_pair_table_declines_exactly_what_it_cannot_hold():
    base = (np.arange(128) % 8 * 4).astype(np.int32)     # S 8, ncls 4
    for bits in (3, 4):
        assert tscan.pair_table(base, 4, 8, bits, CPU).rows == 8
    assert tscan.pair_table(base, 4, 8, 8, CPU) is None    # 8-bit codes
    # the match fields: [0, 7] (their sum rides 4 bits)
    assert tscan.pair_table(base | 7 << 20, 4, 8, 4, CPU) is not None
    assert tscan.pair_table(base | 8 << 20, 4, 8, 4, CPU) is None
    assert tscan.pair_table(base | -1 << 20, 4, 8, 4, CPU) is None
    # row states below 2**16
    edge = base.copy()
    edge[5] = (1 << 16) - 1
    assert tscan.pair_table(edge, 4, 8, 4, CPU) is not None
    edge[5] = 1 << 16
    assert tscan.pair_table(edge, 4, 8, 4, CPU) is None
    # both tables in one block's shared memory: 225 rows of 257 entries
    # beside a 256-entry table fit, 226 do not
    assert (256 + 225 * 257) * 4 <= SMEM_BYTES < (256 + 226 * 257) * 4
    for rows, fits in ((225, True), (226, False)):
        f = np.zeros(256, np.int32)
        f[:rows] = np.arange(rows)
        assert (tscan.pair_table(f, 1, 0, 4, CPU) is not None) == fits


def test_tiers_take_the_two_code_table_where_it_holds(tiers, monkeypatch):
    """The narrow tier at 4 and 3 bits and the pair tier at 4 bits build
    the two-code table (the headline: 11 rows); the wide tier, and
    tables from the JAX package through spec_tables_from_jax, as the
    port's own."""
    _, tt, d = tiers["narrow"]
    assert tt.pair.rows == 11 and tt.pair.table.numel() == 11 * 257
    assert tiers["wide"][1].pair is None and tiers["pair"][1].pair.rows
    monkeypatch.setenv("SREGEX_PACK_BITS", "3")
    t3 = tscan.SpecTables(d, CPU)
    assert t3.bits == 3 and t3.pair.table.numel() == 11 * 65
    for name in ("narrow", "pair", "wide"):
        jt, own, _ = tiers[name]
        arrays = {k: getattr(jt, k) for k in ("cpw", "bits", "warmup",
                                              "rows", "byte_ncls")
                  if hasattr(jt, k)}
        arrays["kind"] = type(jt).__name__
        for k in ("fused_vec", "fused_rows"):
            if getattr(jt, k, None) is not None:
                arrays[k] = np.asarray(getattr(jt, k)).copy()
        got = spec_tables_from_jax(arrays, own.dfa, CPU)
        if own.pair is None:
            assert got.pair is None
        else:
            assert torch.equal(got.pair.table, own.pair.table)
            assert torch.equal(got.pair.rowmap, own.pair.rowmap)


def test_summary_all_ok_reports_first_bad_zero(tiers):
    """All chunks valid: first_bad is 0 (the reference's argmin of an
    all-true mask), the prefix count covers all C chunks."""
    _, tt, _ = tiers["narrow"]
    shape = (1, GROUPS, 8, 128)
    phi = torch.full(shape, 4, dtype=torch.int32)
    swarm = phi.clone()
    state0 = phi.clone()
    fm = torch.ones(shape, dtype=torch.int32)
    summ, _ = tscan._summarize(phi, fm, swarm, state0, 100, -1, True)
    jsumm, _ = jscan._summarize(*(jnp.asarray(x.numpy()) for x in
                                  (phi, fm, swarm, state0)),
                                jnp.int32(100), jnp.int32(-1), True)
    assert np.array_equal(np.asarray(jsumm), summ.numpy())
    assert summ[0] == 1 and summ[1] == 0 and summ[7] == 100


def _plant(rng, n, alphabet, word, at):
    pool = np.frombuffer(alphabet, np.uint8)
    buf = bytearray(rng.choice(pool, n).tobytes())
    if word is not None:
        buf[at:at + len(word)] = word
    return bytes(buf)


# (tier or pattern, alphabet, planted word, position, corpus length)
RESULT_CASES = {
    "headline-planted": ("narrow", b"abc", b"xaaabbccb", 40000, 70000),
    "headline-none": ("narrow", b"abc", None, 0, 70000),
    "anchored-A": (r"\Aab", b"abc", b"ab", 0, 9000),
    "anchored-A-late": (r"\Aab", b"abc", b"ab", 3000, 9000),
    "miss-x-then-z": ("x[^y]*z", b"ab", b"x", 100, 6000),
    "straddle": ("abcdef", b"xyz", b"abcdef", 3 * CHUNK - 3, 5000),
    "empty": ("narrow", b"abc", None, 0, 0),
    "wide-planted": ("wide", b"aeimxy ", b"efgh", 4000, 9000),
    "pair-planted": ("pair", b"abx", b"abc", 5000, 9000),
}


@pytest.mark.parametrize("case", sorted(RESULT_CASES))
def test_results_match_jax_and_native(tiers, case):
    what, alphabet, word, at, n = RESULT_CASES[case]
    if what in tiers:
        jt, tt, dfa = tiers[what]
    else:
        dfa = _dfa(what)
        jt, tt = jscan.SpecTables(dfa), tscan.SpecTables(dfa, CPU)
    data = _plant(np.random.default_rng(n + at), n, alphabet, word, at)
    if case == "miss-x-then-z":
        data = data[:n - 50] + b"z" + data[n - 49:]
    native = NativeDfa(dfa)
    exp_first, exp_state = native.scan_first(data, 0)
    exp_count, exp_cstate = native.count(data, 0)

    got = tscan.spec_scan_bytes(tt, data, chunk_len=CHUNK)
    assert got == jscan.spec_scan_bytes(jt, data, chunk_len=CHUNK)
    assert got == (exp_state, exp_first)
    assert tt.last_repair == jt.last_repair
    got = tscan.spec_count_bytes(tt, data, chunk_len=CHUNK)
    assert got == jscan.spec_count_bytes(jt, data, chunk_len=CHUNK)
    assert got == (exp_cstate, exp_count)
    assert tt.last_repair == jt.last_repair
    if case == "miss-x-then-z":
        assert tt.last_repair[0] > 1      # speculation really missed
    if case.endswith("planted") or case == "straddle":
        assert exp_first >= 0
