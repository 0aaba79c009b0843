"""The port's scan against the JAX package's Pallas scan (interpret mode
on the CPU mesh, as the JAX package's own tests run it).

The planes and summaries against the JAX kernel, and the results of
spec_scan_bytes and spec_count_bytes against the JAX package's and the
native C++ engine, are in tests/test_torch_spec_scan_planes.py.  Here:
the two-code walk (spec_pair_ref) equals spec_scan_ref on random tables
and the edge families (classes past ncls, j0 inside a code pair, odd
word counts, entry states that are not table values); pair_table
declines exactly what it cannot hold; the tiers carry the two-code
table where it holds; the summary of an all-valid chain equals JAX's.

Inputs come from numpy's seeded generator; the tolerance is exact
equality (every quantity is an integer).  The tables are module-scoped
fixtures: B=1 and K=256 everywhere.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.dfa import build_dfa
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.pallas_pair import SpecTablesPair as JaxPair

from sregex_tpu_torch.convert import spec_tables_from_jax
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, SMEM_BYTES
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


