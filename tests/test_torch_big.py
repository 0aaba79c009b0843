"""The port's big tier (ops/big.py) against the JAX package's
(ops/pallas_big.py in interpret mode on the CPU mesh, as its own tests
run it), and the tier chain against the JAX chain.

Planes: on identical seeded inputs, big_scan_ref (which the wrapper
takes for CPU tensors) gives the JAX kernel's phi/fm/swarm, and the
summary and repair planes equal JAX's.  The JAX row loop reads
undefined rows for an index past the table, so the inputs there keep
every index in range (classes below ncls, valid entry states).
The 16-bit kernel's walk over its host-built table (big16_ref) gives
the same planes, and equals big_scan_ref on random tables and the edge
families (classes past ncls, the wrap; entry states that are not rows);
big16_table declines exactly what it cannot hold.  Results:
spec_scan_bytes / spec_count_bytes equal the JAX package's and the
native engine.  The planes against the JAX kernel and the results are
in tests/test_torch_big_planes.py.  B = 1 and K = 256 throughout; every
quantity is an integer, so the tolerance is exact equality.
"""

import functools
import inspect

import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu import stream as jstream
from sregex_tpu.dfa import build_dfa
from sregex_tpu.ops import pallas_big as jbig
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.pallas_big import SpecTablesBig as JaxBig

from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.convert import spec_tables_from_jax
from sregex_tpu_torch.ops import big as tbig
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, SMEM_BYTES

from chip_smoke import dictionary

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")
CHUNK = 256

# tests/test_pallas_big.py CASES: (pattern, alphabet, planted)
CASES = {
    "word": (b"word (?:[a-zA-Z0-9]+ ){0,10}otherword",
             b"word other abc12 ", b"word abc de3 otherword"),
    "counted": (b"a{60,120}b", b"aab", b"x" + b"a" * 80 + b"b"),
    "branch": (b"(x|y|z[QW]){1,5}(longish|loquatious)",
               b"xyzQWlongishloquatious", b"zQxylongish"),
    "anchored": (b"^.{9}abc.*\n", b"abc\nxyzw", b"123456789abczz\n"),
    # 27 classes: 8-bit packing
    "dict20-8bit": (None, b"abcdefghijklmnopqrstuvwxyz ", None),
}


DICT20 = dictionary(20, 5)


def _dfa(pattern):
    if pattern is None:
        ast, _ = parse_multi(DICT20)
    else:
        ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast), max_states=65536)


# JaxBig._scan as _one_kernel copies it: if the JAX method changes, the
# copy no longer stands for it and _one_kernel fails.
_JAX_BIG_SCAN = """\
    def _scan(self, data, state0, j0, C, bad_tail, J, W, COUNT=False,
              mesh=None, axis=None, esc=None):
        return _spec_scan_big_call(
            data, state0, j0, self.fused_rows, C, bad_tail, J=J, W=W,
            CPW=self.cpw, BITS=self.bits, COUNT=COUNT, R=self.rows,
            kernel_fn=functools.partial(_kernel_big, FAST=self.fast),
            mesh=mesh, axis=axis, ESC=esc)
"""


def _one_kernel(jt):
    """The JAX tables with one kernel for their life.

    JaxBig._scan hands jit a new functools.partial of its kernel as a
    static argument on every call.  Partials compare by identity, so
    jit's cache never finds the compiled program again and each call
    compiles it anew.  This routes the call through one partial: the
    same sregex_tpu function on the same arguments, so a machine's
    scans of one shape share one program and compute what they did.
    The method's source is pinned to _JAX_BIG_SCAN."""
    assert inspect.getsource(JaxBig._scan) == _JAX_BIG_SCAN
    assert jbig._spec_scan_big_call is jscan._spec_scan_big_call
    kernel = functools.partial(jbig._kernel_big, FAST=jt.fast)

    def scan(data, state0, j0, C, bad_tail, J, W, COUNT=False, mesh=None,
             axis=None, esc=None):
        return jscan._spec_scan_big_call(
            data, state0, j0, jt.fused_rows, C, bad_tail, J=J, W=W,
            CPW=jt.cpw, BITS=jt.bits, COUNT=COUNT, R=jt.rows,
            kernel_fn=kernel, mesh=mesh, axis=axis, ESC=esc)

    jt._scan = scan
    return jt


@pytest.fixture(scope="module")
def tiers():
    """name -> (jax tables, port tables, dfa)."""
    out = {}
    for name, (pattern, _, _) in CASES.items():
        d = _dfa(pattern)
        out[name] = (_one_kernel(JaxBig(d)), tbig.SpecTablesBig(d, CPU), d)
    return out


def test_tables_equal_the_jax_tables(tiers):
    for name, (jt, tt, d) in tiers.items():
        assert (tt.bits, tt.cpw, tt.warmup, tt.rows, tt.wide) == \
            (jt.bits, jt.cpw, jt.warmup, jt.rows, True), name
        rows = np.asarray(jt.fused_rows)[:, 0].reshape(-1)
        assert np.array_equal(tt.fused.numpy(), rows), name
        assert d.nstates * d.nclasses > 128
    assert tiers["dict20-8bit"][1].bits == 8
    assert tiers["word"][1].bits == 4


def test_big_rejects_oversize():
    class FakeDfa:
        nstates = tbig.MAX_ENTRIES
        nclasses = 2
    with pytest.raises(ValueError):
        tbig.SpecTablesBig(FakeDfa(), CPU)


def test_wrapper_takes_the_big_table_and_counts_no_cpu_launch():
    rng = np.random.default_rng(4)
    n = 600 * 128                     # past the shared-memory cap
    assert n > tscan.SMEM_TABLE_MAX
    table = torch.from_numpy((rng.integers(0, n // 16, n) * 16)
                             .astype(np.int32))
    data = torch.zeros((1, 36, 1, 8, 128), dtype=torch.int32)
    s0 = torch.zeros((1, 1, 8, 128), dtype=torch.int32)
    kw = dict(W=32, CPW=8, BITS=4, COUNT=True)
    with pytest.raises(ValueError, match="table"):
        tscan.spec_scan(data, s0, s0, table, **kw)
    before = (tbig.big_scan_launches, tbig.big_smem_launches)
    got = tbig.big_scan(data, s0, s0, table, **kw)
    assert (tbig.big_scan_launches, tbig.big_smem_launches) == before
    # the 16-bit table changes nothing on the CPU: no launch either
    t16 = tbig.big16_table(table.numpy(), 16, n // 16, 4, CPU)
    assert t16 is not None
    for g, w in zip(tbig.big_scan(data, s0, s0, table, t16=t16, **kw), got):
        assert torch.equal(g, w)
    assert (tbig.big_scan_launches, tbig.big_smem_launches) == before
    for g, w in zip(got, tscan.spec_scan_ref(data, s0, s0, table, **kw)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="4 or 8"):
        tbig.big_scan(torch.zeros((1, 30, 1, 8, 128), dtype=torch.int32),
                      s0, s0, table, W=40, CPW=10, BITS=3, COUNT=True)
    meta = [t.to("meta") for t in (data, s0, s0, table)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tbig.big_scan(*meta, **kw)


def test_tier_choice_matches_the_jax_chain_past_the_wide_cap():
    """A 100-word dictionary is past the port's wide cap (16384) and the
    JAX package's CPU wide cap (4096): both chains pick the big tier."""
    ast, _ = parse_multi(dictionary(100, 3))
    dfa = build_dfa(compile_regex(ast))
    assert dfa.nstates * dfa.nclasses > tscan.SpecTablesWide.MAX_ENTRIES
    jt = jstream._build_spec_tables(dfa)
    tt = tstream._build_spec_tables(dfa, CPU)
    assert type(jt).__name__ == type(tt).__name__ == "SpecTablesBig"
    assert tt.rows == jt.rows and tt.bits == jt.bits == 8


def _big16_case(rng, bits, rows, ncls, W, count, in_range=False,
                odd_entry=False, frozen=False):
    """Random words (classes below ncls with ``in_range``, else up to
    2**bits: past ncls and past the table), a random table of rows*128
    entries over S = rows*128 // ncls states with match fields 0-2,
    valid entry states and freezes j0 in [0, W].  ``odd_entry``: a third
    of the entry states arbitrary (negative, past the rows, not
    multiples of ncls); ``frozen``: half the streams frozen through the
    whole warmup."""
    cpw = tscan._CPW[bits]
    S = rows * 128 // ncls
    shape = (1, W // cpw + 8, GROUPS, 8, 128)
    cls = rng.integers(0, ncls if in_range else 1 << bits, shape + (cpw,))
    words = np.zeros(shape, np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 3, rows * 128) << 20).astype(np.int32)
    planes = (1, GROUPS, 8, 128)
    s0 = (rng.integers(0, S, planes) * ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, planes).astype(np.int32)
    if odd_entry:
        pick = rng.random(planes) < 1 / 3
        s0[pick] = rng.integers(-300, S * ncls + 3000, int(pick.sum()))
    if frozen:
        j0[rng.random(planes) < 0.5] = W
    args = [torch.from_numpy(a) for a in
            (words.astype(np.uint32).view(np.int32), s0, j0, table)]
    t16 = tbig.big16_table(table, ncls, S, bits, CPU)
    return args, t16, dict(W=W, CPW=cpw, BITS=bits, COUNT=count)


# name -> (bits, rows, ncls, W, COUNT, _big16_case options)
BIG16_CASES = {
    "4bit-count-in-range": (4, 600, 16, 32, True, dict(in_range=True)),
    "4bit-scan-wrap": (4, 300, 9, 32, False, {}),
    "8bit-count-dictionary-size": (8, 821, 27, 32, True, {}),
    "8bit-scan-wrap": (8, 200, 200, 16, False, {}),
    "8bit-near-the-cap": (8, 906, 128, 16, True, dict(in_range=True)),
    "4bit-odd-entries": (4, 40, 5, 32, True, dict(odd_entry=True)),
    "8bit-odd-entries-frozen": (8, 64, 27, 32, False,
                                dict(odd_entry=True, frozen=True)),
    "8bit-no-warmup": (8, 100, 27, 0, True, dict(odd_entry=True)),
}


@pytest.mark.parametrize("name", sorted(BIG16_CASES))
def test_big16_walk_equals_plain_version(name):
    """big16_ref over big16_table's table gives big_scan_ref's planes:
    classes past ncls (entries past the fused table: the wrap padding),
    a table near the shared-memory cap, entry states that are not rows,
    some frozen through the whole warmup, no warmup."""
    bits, rows, ncls, W, count, opts = BIG16_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    args, t16, kw = _big16_case(rng, bits, rows, ncls, W, count, **opts)
    assert t16 is not None and t16.table.dtype == torch.int16
    got = tbig.big16_ref(*args, t16, **kw)
    want = tbig.big_scan_ref(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    S = rows * 128 // ncls
    assert t16.rows == S and t16.table.numel() % 8 == 0
    assert t16.table.numel() >= (S - 1) * ncls + (1 << bits)


def test_big16_table_declines_exactly_what_it_cannot_hold():
    def table(S, ncls, match=0, step=None):
        nxt = np.arange(S * ncls) % S * (step or ncls)
        rows = -(-(S * ncls) // 128)
        f = np.zeros(rows * 128, np.int64)
        f[:S * ncls] = nxt | match << 20
        return f.astype(np.int32)

    # shared memory: 907 states of 128 classes at 8 bits fill it exactly
    # ((906 * 128 + 256) * 2 bytes); 908 do not
    assert (906 * 128 + 256) * 2 == SMEM_BYTES
    assert tbig.big16_table(table(907, 128), 128, 907, 8, CPU).rows == 907
    assert tbig.big16_table(table(908, 128), 128, 908, 8, CPU) is None
    # 2**14 state ids at most
    assert tbig.big16_table(table(1 << 14, 2), 2, 1 << 14, 4,
                            CPU).rows == 1 << 14
    assert tbig.big16_table(table((1 << 14) + 1, 2), 2, (1 << 14) + 1, 4,
                            CPU) is None
    # match fields in [0, 3]; next states on the ncls grid
    assert tbig.big16_table(table(64, 9, 3), 9, 64, 4, CPU) is not None
    assert tbig.big16_table(table(64, 9, 4), 9, 64, 4, CPU) is None
    assert tbig.big16_table(table(64, 9, step=1), 9, 64, 4, CPU) is None
    neg = table(64, 9)
    neg[3] = -1
    assert tbig.big16_table(neg, 9, 64, 4, CPU) is None


def test_big_tiers_hold_the_16bit_table(tiers):
    """Every big machine of CASES builds the 16-bit table, and tables
    from the JAX package through spec_tables_from_jax build the same."""
    for name, (jt, tt, d) in tiers.items():
        assert tt.t16 is not None and tt.t16.ncls == d.nclasses, name
        assert tt.t16.rows == d.nstates, name
        arrays = {k: getattr(jt, k) for k in ("cpw", "bits", "warmup",
                                              "rows")}
        arrays["kind"] = type(jt).__name__
        arrays["fused_rows"] = np.asarray(jt.fused_rows).copy()
        got = spec_tables_from_jax(arrays, d, CPU)
        assert torch.equal(got.t16.table, tt.t16.table), name
        assert got.t16.rows == tt.t16.rows, name
