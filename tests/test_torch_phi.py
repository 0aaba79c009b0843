"""The port's exact transfer-composition tier (ops/phi.py) against the
JAX package's (ops/pallas_phi.py, its Pallas kernels in interpret mode
on the CPU mesh, as its own tests run them) and the native engine.

Tables and prep: the port's fused tables and packed corpora equal the
JAX ones bit for bit, from host bytes and from a uint8 tensor.  Planes:
the plain versions (which the kernel wrappers take for CPU tensors)
give, for every chunk and every entry state, the native engine's exit
state and count or first match; the plain models of both kernels'
k-gram walks (phi_stride_ref, phi_big_stride_ref) equal the plain
versions, and the lane-packed one equals the JAX kernel's planes.
The summaries of _phi_dispatch and the results of phi_count_bytes /
phi_scan_bytes against the JAX package's are in
tests/test_torch_phi_dispatch.py.  The Scanner switches to the phi tier
when the warmup ladder runs out.
Small corpora and chunk_len=512 keep the interpret-mode compiles few
(one per machine, mode and block count); every quantity is an integer,
so the tolerance is exact equality.
"""

import functools
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_phi as jphi

from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.ops import phi as tphi

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")
CHUNK = 512

# tests/test_pallas_phi.py's machines: (pattern, alphabet)
CASES = [
    (rb"\A(?:aa)*b", b"ab"),
    (rb"b(?:aa)*b", b"aab"),
    (rb"a{60,120}b", b"ab x"),
    (rb"(?:cat|dog)", b"catdog x"),
    (rb"\bw\d+\b", b"w12 xy"),
]
BIG_CASES = [
    (rb"b(?:a{137})*b", b"a" * 12 + b"ab"),
    (rb"x(?:a{300})*y", b"a" * 12 + b"axy"),
]
# test_phi_8bit_wide_alphabet's machine: 17 two-byte literals and the
# parity machine, 19 classes
WIDE = [bytes([c]) + b"q" for c in b"abcdefghijklmnopr"] + [rb"b(?:aa)*b"]
WIDE_ALPHA = b"abcdefghijklmnopqr x"


def _dfa(pattern):
    if isinstance(pattern, list):
        ast, _ = parse_multi(pattern)
    else:
        ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast), max_states=65536)


def _pair(pattern):
    """(JAX tables, port tables, dfa) of the layout the machine takes."""
    d = _dfa(pattern)
    if d.nstates > 128:
        return jphi.PhiTablesBig(d), tphi.PhiTablesBig(d, CPU), d
    return jphi.PhiTables(d), tphi.PhiTables(d, CPU), d


def _corpus(alpha, n, seed):
    rng = random.Random(seed)
    return bytes(rng.choice(alpha) for _ in range(n))


def _one_block(tt):
    """The most bytes whose full chunks fit one block at CHUNK: every
    corpus up to it shares one interpret-mode compile."""
    K = CHUNK
    per_blk = (tphi.GROUPS * tt.CPT if isinstance(tt, tphi.PhiTablesBig)
               else tphi.GROUPS * 8 * tt.nseg)
    return per_blk * K


MACHINES = {"lane-parity": rb"b(?:aa)*b", "lane-s3": rb"ab",
            "lane-8bit": WIDE, "big-137": rb"b(?:a{137})*b",
            "big-300": rb"x(?:a{300})*y"}


@pytest.mark.parametrize("name", sorted(MACHINES))
def test_tables_equal_the_jax_tables(name):
    jt, tt, _ = _pair(MACHINES[name])
    assert type(tt).__name__ == type(jt).__name__
    for k in ("nstates", "ncls", "rows", "bits", "cpw", "nseg", "SB",
              "CPT"):
        assert getattr(tt, k, None) == getattr(jt, k, None), k
    rows = np.asarray(jt.fused_rows)[:, 0].reshape(-1)
    assert np.array_equal(tt.fused.numpy(), rows)
    assert np.array_equal(tt.class_map, jt.class_map)
    assert tt.bits == (8 if name == "lane-8bit" else 4)


def test_tables_decline_what_the_jax_tables_decline(monkeypatch):
    big = _dfa(rb"b(?:a{137})*b")          # 4 rows
    for cls in (jphi.PhiTables, tphi.PhiTables):
        with pytest.raises(ValueError):
            cls(big) if cls is jphi.PhiTables else cls(big, CPU)
    small = _dfa(rb"b(?:aa)*b")
    for cls in (jphi.PhiTablesBig, tphi.PhiTablesBig):
        with pytest.raises(ValueError):
            cls(small) if cls is jphi.PhiTablesBig else cls(small, CPU)
    monkeypatch.setenv("SREGEX_PHI_MAX_ROWS", "3")
    with pytest.raises(ValueError, match="row"):
        jphi.PhiTablesBig(big)
    with pytest.raises(ValueError, match="row"):
        tphi.PhiTablesBig(big, CPU)
    monkeypatch.delenv("SREGEX_PHI_MAX_ROWS")
    # the CPU's cap of 32 rows, as in interpret mode (52 rows here)
    wide_big = _dfa([rb"x(?:a{300})*y"]
                    + [bytes([c]) + b"q" for c in b"bcdefghijklmnop"])
    assert 32 < -(-wide_big.nstates * wide_big.nclasses // 128) <= 64
    with pytest.raises(ValueError):
        jphi.PhiTablesBig(wide_big)
    with pytest.raises(ValueError):
        tphi.PhiTablesBig(wide_big, CPU)


PREP_CASES = [(name, n) for name in sorted(MACHINES)
              for n in (0, 100, 5000, 33_000)]


@pytest.mark.parametrize("name,n", PREP_CASES)
def test_prep_is_bit_identical_to_the_jax_prep(name, n):
    jt, tt, _ = _pair(MACHINES[name])
    alpha = WIDE_ALPHA if name == "lane-8bit" else b"aabxy q"
    data = _corpus(alpha, n, n)
    for chunk_len in (CHUNK, 2048 + 77):
        want = jphi.phi_prepare(jt, data, chunk_len)
        for src in (data, torch.from_numpy(
                np.frombuffer(data, np.uint8).copy())):
            got = tphi.phi_prepare(tt, src, chunk_len)
            assert tuple(got[1:]) == tuple(want[1:])
            assert got[0].dtype == torch.int32
            assert np.array_equal(got[0].numpy(), np.asarray(want[0]))


def _planes(tt, prepared, count):
    data, _, K, WL, _, _ = prepared
    kw = dict(Kw=K // tt.cpw, CPW=tt.cpw, BITS=tt.bits, S=tt.nstates,
              NCLS=tt.ncls, COUNT=count)
    if isinstance(tt, tphi.PhiTablesBig):
        return tphi.phi_big_scan_ref(data, tt.fused, SB=tt.SB, **kw)
    return tphi.phi_scan_ref(data, tt.fused, WL=WL, NSEG=tt.nseg, **kw)


@pytest.mark.parametrize("name,C", [("lane-parity", 40), ("lane-s3", 45),
                                    ("lane-8bit", 12), ("big-137", 6)])
def test_plain_transfers_equal_native_from_every_entry(name, C):
    _, tt, d = _pair(MACHINES[name])
    native = NativeDfa(d)
    alpha = WIDE_ALPHA if name == "lane-8bit" else b"aaaabx"
    data = _corpus(alpha, C * CHUNK + 100, C)
    # chunk 1 fires from no entry state
    data = data[:CHUNK] + b"x" * CHUNK + data[2 * CHUNK:]
    prepared = tphi.phi_prepare(tt, data, CHUNK)
    assert prepared[1] == C
    phi, cnt = (tphi.chunk_slots(tt, x)
                for x in _planes(tt, prepared, True))
    _, first = (tphi.chunk_slots(tt, x)
                for x in _planes(tt, prepared, False))
    fires = 0
    for c in range(C):
        chunk = data[c * CHUNK:(c + 1) * CHUNK]
        for s in range(tt.nstates):
            k, st = native.count(chunk, s)
            assert int(phi[c, s]) == st * tt.ncls, (c, s)
            assert int(cnt[c, s]) == k, (c, s)
            f, _ = native.scan_first(chunk, s)
            assert int(first[c, s]) == (f if f >= 0 else tphi._SENT)
            fires += f >= 0
    assert 0 < fires < C * tt.nstates


def test_prepared_reuse_and_a_corpus_of_no_full_chunk():
    _, tt, d = _pair(rb"\A(?:aa)*b")
    native = NativeDfa(d)
    data = _corpus(b"ab", 100_000, 9)
    prep = tphi.phi_prepare(tt, data, CHUNK)
    for _ in range(2):
        assert tphi.phi_count_bytes(tt, data, chunk_len=CHUNK,
                                    prepared=prep) == native.count(data)[::-1]
    assert tt.last_repair == (0, 100_000 // CHUNK)
    short = data[:CHUNK - 1]
    assert tphi.phi_count_bytes(tt, short, chunk_len=CHUNK) \
        == native.count(short)[::-1]
    f, st = native.scan_first(short, 0)
    assert tphi.phi_scan_bytes(tt, short, chunk_len=CHUNK) == (st, f)
    assert tt.last_repair == ((0, 0) if f < 0 else None)


def _runs(n, lo, hi, seed):
    """a-runs of lo..hi-1 bytes, each closed by a b."""
    rng = random.Random(seed)
    data = bytearray()
    while len(data) < n:
        data += b"a" * rng.randrange(lo, hi) + b"b"
    return bytes(data[:n])


@pytest.mark.parametrize("pat,lo,hi,tier", [
    (rb"b(?:aa)*b", 60, 300, "PhiTables"),
    (rb"b(?:a{137})*b", 4096, 16384, "PhiTablesBig")])
def test_scanner_switches_to_phi_when_the_ladder_runs_out(pat, lo, hi,
                                                          tier):
    """Run parity and a residue mod 137 defeat every warmup window on
    long runs: strike pairs climb the ladder (the pair tier cannot
    climb at all) and then switch to the phi tier, which serves count,
    scan and match with no repair, equal to the host engine."""
    ast, _ = parse(pat)
    prog = compile_regex(ast)
    sc = tstream.Scanner(prog, device="cpu", ast=ast)
    host = tstream.Scanner(prog, device=None, ast=ast)
    sc.DEVICE_THRESHOLD = 1 << 12
    data = _runs(200_000, lo, hi, 3)
    exp = host.count(data)
    seen = []
    for _ in range(9):
        assert sc.count(data) == exp
        seen.append(sc.stats().tier)
        if sc._phi_active:
            break
    assert sc._phi_active, seen
    assert seen[-1] != tier and tier not in seen
    assert sc.count(data) == exp
    st = sc.stats()
    assert (st.tier, st.repaired, st.chunks) == (tier, 0, len(data) // 2048)
    # every rung climbed and the switch count as warmup events
    assert st.warm_events == len(seen) // 2
    assert sc.scan(data) == host.scan(data)
    assert sc.stats().tier == tier and sc.stats().repaired == 0
    prepared = sc.prepare(data)
    assert sc.count(data, prepared=prepared) == exp
    assert sc.match(data, prepared=prepared) == host.match(data)
    # an odd run closes without a match: plant a matching run at the end
    run = 2 if tier == "PhiTables" else 137 * 2
    planted = data[:-run - 600] + b"b" + b"a" * run + b"b" + b"x" * 598
    assert sc.scan(planted) == host.scan(planted)
    assert sc.stats().tier == tier


def test_wrappers_check_and_count_no_cpu_launch():
    _, tt, _ = _pair(rb"b(?:aa)*b")
    data, _, K, WL, _, _ = tphi.phi_prepare(tt, b"ab" * 5000, CHUNK)
    kw = dict(Kw=K // 8, WL=WL, CPW=8, BITS=4, S=4, NSEG=32, NCLS=3,
              COUNT=True, stride=tt.stride(True))
    before = tphi.phi_scan_launches
    tphi.phi_scan(data, tt.fused, **kw)
    assert tphi.phi_scan_launches == before
    with pytest.raises(ValueError, match="lane-packed"):
        tphi.phi_scan(data, tt.fused, **dict(kw, NSEG=16))
    with pytest.raises(ValueError, match="Kw"):
        tphi.phi_scan(data, tt.fused, **dict(kw, Kw=10_000))
    with pytest.raises(TypeError):
        tphi.phi_scan(data.long(), tt.fused, **kw)
    with pytest.raises(ValueError, match="4 or 8"):
        tphi.phi_scan(data, tt.fused, **dict(kw, BITS=3, CPW=10))
    meta = [x.to("meta") for x in (data, tt.fused)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        tphi.phi_scan(*meta, **kw)
    with pytest.raises(TypeError, match="stride"):
        tphi.phi_scan(data, tt.fused, **{k: v for k, v in kw.items()
                                         if k != "stride"})
    bkw = dict(Kw=K // 8, CPW=8, BITS=4, S=139, SB=2, NCLS=3, COUNT=False,
               stride=(1, torch.from_numpy(tphi.stride_table(
                   tt.fused.numpy(), tt.nstates, tt.ncls, 1, False))))
    with pytest.raises(ValueError, match="SB"):
        tphi.phi_big_scan(data, tt.fused, **dict(bkw, SB=3))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tphi.phi_big_scan(*meta, **bkw)
    with pytest.raises(TypeError, match="stride"):
        tphi.phi_big_scan(data, tt.fused, **{k: v for k, v in bkw.items()
                                             if k != "stride"})
    before = tphi.phi_big_scan_launches
    tphi.phi_big_scan(data, tt.fused, **bkw)
    assert tphi.phi_big_scan_launches == before


def _stride_case(rng, S, bits, ncls, words, B=1, G=2, K=512):
    """Random sublane-group words (``words``: "in" every class below
    ncls, "mixed" one word in ten with a class code past ncls, "any"
    classes up to 2**bits), a random fused table of valid premultiplied
    states, and the kernel's keywords."""
    cpw = 32 // bits
    Kw = K // cpw
    rows = -(-(S * ncls) // 128)
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 2, rows * 128) << 20).astype(np.int32)
    SB = 1 << (-(-S // 128) - 1).bit_length()
    P = -(-Kw // 128)
    cls = rng.integers(0, ncls if words != "any" else 1 << bits,
                       (B, P, G, 8, 128, cpw))
    if words == "mixed":
        bad = rng.random(cls.shape[:-1]) < 0.1
        cls[..., 0] = np.where(bad, rng.integers(ncls, 1 << bits, bad.shape),
                               cls[..., 0])
    w = np.zeros(cls.shape[:-1], np.int64)
    for j in range(cpw):
        w |= cls[..., j] << (bits * j)
    data = torch.from_numpy(w.astype(np.uint32).view(np.int32))
    return data, torch.from_numpy(table), dict(Kw=Kw, CPW=cpw, BITS=bits,
                                               S=S, SB=SB, NCLS=ncls)


@pytest.mark.parametrize("S,bits,ncls", [(139, 4, 3), (501, 4, 3),
                                         (1000, 4, 2), (139, 8, 5)])
@pytest.mark.parametrize("words", ["in", "mixed", "any"])
def test_stride_walk_equals_the_plain_version(S, bits, ncls, words):
    """The plain model of the sublane-group kernel's k-gram walk equals
    phi_big_scan_ref (held against the JAX kernel above) for every k in
    (1, 2, 4) that divides the word and fits shared memory, COUNT and
    scan, on the valid slots."""
    rng = np.random.default_rng(S * 7 + bits + len(words))
    data, table, kw = _stride_case(rng, S, bits, ncls, words)
    valid = ((torch.arange(8)[:, None] % kw["SB"]) * 128
             + torch.arange(128) < S)
    ks = [k for k in (1, 2, 4) if kw["CPW"] % k == 0
          and S * ncls ** k + table.numel() + 256
          <= tphi.STRIDE_SMEM_ENTRIES]
    assert len(ks) >= 2
    for count in (True, False):
        want = tphi.phi_big_scan_ref(data, table, COUNT=count, **kw)
        for k in ks:
            st = torch.from_numpy(tphi.stride_table(table.numpy(), S, ncls,
                                                    k, count))
            got = tphi.phi_big_stride_ref(data, table, (k, st), COUNT=count,
                                          **kw)
            for g, w in zip(got, want):
                assert torch.equal(g[..., valid], w[..., valid]), (k, count)


def test_stride_table_entries_and_choice():
    """The chip's phi_big machine, b(?:a{499})*b (S = 501, 3 classes,
    4-bit words): k = 4 fits (40,581 entries); each entry is the
    composition of k single steps; PhiTablesBig caches one table per
    (k, mode); a table entry past S*ncls, or not premultiplied, is
    refused."""
    d = _dfa(rb"b(?:a{499})*b")
    t = tphi.PhiTablesBig(d, CPU)
    assert (t.nstates, t.ncls, t.cpw) == (501, 3, 8)
    assert tphi.stride_k(t.nstates, t.ncls, t.cpw, t.fused.numel()) == 4
    k, st = t.stride(True)
    assert k == 4 and st.numel() == 501 * 81
    assert t.stride(True)[1] is st and t.stride(False)[1] is not st
    f = t.fused.numpy().astype(np.int64)
    rng = np.random.default_rng(3)
    for q, g in zip(rng.integers(0, 501, 50), rng.integers(0, 81, 50)):
        s, cnt = q * 3, 0
        for j in range(4):
            e = f[s + (g // 3 ** j) % 3]
            cnt += e >> 20
            s = e & ((1 << 20) - 1)
        e = int(st[q * 81 + g]) & 0xFFFFFFFF
        assert (e >> 14, e & 0x3FFF) == (s // 3 * 81 * 4, cnt)
    bad = t.fused.numpy().copy()
    bad[5] = 501 * 3
    with pytest.raises(ValueError):
        tphi.stride_table(bad, 501, 3, 2, True)
    bad[5] = 4
    with pytest.raises(ValueError):
        tphi.stride_table(bad, 501, 3, 2, True)


def _lane_case(rng, S, bits, ncls, words, B=1, G=1, K=128):
    """Random lane-packed words (``words`` as _stride_case's), a random
    fused table of valid premultiplied states, and the kernel's
    keywords."""
    cpw = 32 // bits
    Kw = K // cpw
    rows = -(-(S * ncls) // 128)
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 2, rows * 128) << 20).astype(np.int32)
    nseg = max(1, 128 // S)
    WL = 128 // nseg
    P = -(-Kw // WL)
    cls = rng.integers(0, ncls if words != "any" else 1 << bits,
                       (B, P, G, 8, 128, cpw))
    if words == "mixed" and ncls < 1 << bits:
        bad = rng.random(cls.shape[:-1]) < 0.1
        cls[..., 0] = np.where(bad, rng.integers(ncls, 1 << bits, bad.shape),
                               cls[..., 0])
    w = np.zeros(cls.shape[:-1], np.int64)
    for j in range(cpw):
        w |= cls[..., j] << (bits * j)
    data = torch.from_numpy(w.astype(np.uint32).view(np.int32))
    return data, torch.from_numpy(table), dict(
        Kw=Kw, WL=WL, CPW=cpw, BITS=bits, S=S, NSEG=nseg, NCLS=ncls)


@pytest.mark.parametrize("S,bits,ncls", [(1, 4, 2), (4, 4, 3), (5, 4, 5),
                                         (9, 4, 4), (128, 4, 8),
                                         (2, 4, 20), (50, 8, 20),
                                         (3, 8, 256)])
@pytest.mark.parametrize("words", ["in", "mixed", "any"])
def test_lane_stride_walk_equals_the_plain_version(S, bits, ncls, words):
    """The plain model of the lane-packed kernel's k-gram walk equals
    phi_scan_ref on the valid slots for every k in (8, 4, 2, 1) that
    divides the word and fits shared memory (every k stride_k can
    choose), 1 to 128 states, class codes past ncls, COUNT and scan."""
    rng = np.random.default_rng(S * 11 + bits + len(words))
    data, table, kw = _lane_case(rng, S, bits, ncls, words)
    valid = torch.arange(128) < kw["NSEG"] * S
    ks = [k for k in (8, 4, 2, 1) if kw["CPW"] % k == 0
          and S * ncls ** k + table.numel() + 256
          <= tphi.STRIDE_SMEM_ENTRIES]
    assert tphi.stride_k(S, ncls, kw["CPW"], table.numel(),
                         (8, 4, 2)) == ks[0]
    for count in (True, False):
        want = tphi.phi_scan_ref(data, table, COUNT=count, **kw)
        for k in ks:
            st = torch.from_numpy(tphi.stride_table(table.numpy(), S, ncls,
                                                    k, count))
            got = tphi.phi_stride_ref(data, table, (k, st), COUNT=count,
                                      **kw)
            for g, w in zip(got, want):
                assert torch.equal(g[..., valid], w[..., valid]), (k, count)


def _jax_lane_planes(jt, data, kw, count):
    """The JAX package's lane-packed kernel (pallas_phi._phi_kernel) in
    interpret mode on ``data``: its (phi, acc) planes as numpy."""
    B, P, G = data.shape[:3]
    rows = jt.fused_rows.shape[0]
    kernel = functools.partial(jphi._phi_kernel, ROWS=rows, COUNT=count,
                               **kw)
    spec = pl.BlockSpec((1, G, 8, 128), lambda i: (i, 0, 0, 0))
    out = pl.pallas_call(
        kernel, grid=(B,),
        in_specs=[pl.BlockSpec((1, P, G, 8, 128), lambda i: (i, 0, 0, 0, 0)),
                  pl.BlockSpec(tuple(jt.fused_rows.shape),
                               lambda i: (0, 0, 0))],
        out_specs=[spec, spec],
        out_shape=[jax.ShapeDtypeStruct((B, G, 8, 128), jnp.int32)] * 2,
        interpret=True)(jnp.asarray(data), jt.fused_rows)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("count", [True, False])
def test_lane_stride_walk_equals_the_jax_kernel(count):
    """b(?:aa)*b's tables (S = 4, ncls = 3): the lane-packed k-gram walk
    at the k its tables choose (8) gives the JAX kernel's planes on the
    same random words, class codes past ncls among them."""
    jt, tt, _ = _pair(rb"b(?:aa)*b")
    rng = np.random.default_rng(21)
    P, G = 8, tphi.GROUPS
    words = rng.integers(0, 1 << 32, (1, P, G, 8, 128), dtype=np.uint64)
    data = words.astype(np.uint32).view(np.int32)
    kw = dict(Kw=P * 4, WL=4, CPW=8, BITS=4, S=4, NSEG=32, NCLS=3)
    want = _jax_lane_planes(jt, data, kw, count)
    stride = tt.stride(count)
    assert stride[0] == 8
    got = tphi.phi_stride_ref(torch.from_numpy(data), tt.fused, stride,
                              COUNT=count, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_lane_tables_stride_choice():
    """PhiTables takes k = 8 where it fits (b(?:aa)*b: 4 * 3**8 = 26,244
    entries), caches one table per (k, mode), and steps down to 4, 2
    and 1 as ncls grows; PhiTablesBig keeps (4, 2)."""
    t = tphi.PhiTables(_dfa(rb"b(?:aa)*b"), CPU)
    k, st = t.stride(True)
    assert (k, st.numel()) == (8, 4 * 3 ** 8)
    assert t.stride(True)[1] is st and t.stride(False)[1] is not st
    assert t.stride(True, 2)[1].numel() == 4 * 9
    assert tphi.stride_k(4, 5, 8, 128, (8, 4, 2)) == 4
    assert tphi.stride_k(50, 20, 4, 1024, (8, 4, 2)) == 2
    assert tphi.stride_k(3, 256, 4, 768, (8, 4, 2)) == 1
    assert tphi.stride_k(4, 3, 8, 128) == 4
