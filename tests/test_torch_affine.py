"""The port's piecewise-affine tier (ops/affine.py) against the JAX
package's (ops/pallas_affine.py in interpret mode on the CPU mesh, as
its own tests run it); the warmup ladder, and the chained and digit
machines' plane and result cases, are in tests/test_torch_affine_ladder.py.

Planes: on identical seeded inputs, affine_scan_ref (which the wrapper
takes for CPU tensors) and affine_relaid_ref (the plain model of the
card's walk over the re-laid table) give the JAX kernel's phi/fm/swarm,
and the summary and repair planes equal JAX's.  Classes run past the
table, so the out-of-table rule (entry index & 127) is exercised; the
model also equals affine_scan_ref on random tables of 1 to 48 pieces,
states out of range and int32 wrap.  Results:
spec_scan_bytes / spec_count_bytes equal the JAX package's and the
native engine, a renumbered (perm) machine included.  B = 1 and
K = 256 in the plane and result tests; every quantity is an integer,
so the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sregex_tpu import compile_regex, parse
from sregex_tpu import stream as jstream
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_affine as jaff
from sregex_tpu.ops import pallas_scan as jscan

from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.ops import affine as taff
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, TILE

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")
CHUNK = 256

# tests/test_pallas_affine.py patterns: (pattern, alphabet, plant)
CASES = {
    "counted": (rb"a{400,499}b", b"ab x", b"x" + b"a" * 450 + b"b"),
    "class-run": (rb"[a-c]{450}x", b"abcx ", b"." + b"abc" * 150 + b"x"),
    "chained": (rb"a{499}b{499}c{499}", b"abc",
                b"a" * 499 + b"b" * 499 + b"c" * 499),
    "digit": (rb"\dA{300,400}z", b"7Az x", b"3" + b"A" * 350 + b"z"),
    "perm": (rb"(?:ab?c){60,140}z", b"abcz .", b"." + b"abc" * 100 + b"z"),
}


def _dfa(pattern):
    ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast), max_states=65536)


def make_tiers(names):
    """name -> (jax tables, port tables, dfa) for CASES[name]."""
    out = {}
    for name in names:
        d = _dfa(CASES[name][0])
        out[name] = (jaff.SpecTablesAffine(d), taff.SpecTablesAffine(d, CPU),
                     d)
    return out


@pytest.fixture(scope="module")
def tiers():
    return make_tiers(CASES)


def test_tables_equal_the_jax_tables(tiers):
    for name, (jt, tt, _) in tiers.items():
        for k in ("pieces", "bp_premult", "off", "rows", "bits", "cpw",
                  "warmup"):
            assert getattr(tt, k) == getattr(jt, k), (name, k)
        rows = np.asarray(jt.fused_rows)[:, 0].reshape(-1)
        assert np.array_equal(tt.fused.numpy(), rows), name
        assert tt.bp.tolist() == list(jt.bp_premult)
        assert (tt.perm is None) == (jt.perm is None), name
        if tt.perm is not None:
            assert np.array_equal(tt.perm, jt.perm)
            for s in (0, 7, tt.nstates - 1):
                assert tt.to_premult(s) == jt.to_premult(s)
                p = tt.to_premult(s)
                assert tt.from_premult(p) == jt.from_premult(p) == s
            v = np.arange(0, tt.off, tt.ncls)
            assert np.array_equal(tt.from_premult_vec(v),
                                  jt.from_premult_vec(v))
    assert tiers["perm"][1].perm is not None
    assert tiers["counted"][1].wide


def test_detect_pieces_and_periodic_perm_equal_the_jax_ones(tiers):
    for name, (_, _, d) in tiers.items():
        try:
            want = jaff.detect_pieces(d)
        except ValueError:
            with pytest.raises(ValueError):
                taff.detect_pieces(d)
            want = None
        if want is not None:
            got = taff.detect_pieces(d)
            assert got[0] == want[0]
            for g, w in zip(got[1:], want[1:]):
                assert np.array_equal(g, w)
        jp, tp = jaff.periodic_perm(d), taff.periodic_perm(d)
        assert (jp is None) == (tp is None), name
        if jp is not None:
            assert np.array_equal(jp, tp)
    d = _dfa(rb"(x|y|z[QW]){1,5}(longish|loquatious)")
    with pytest.raises(ValueError):
        taff.SpecTablesAffine(d, CPU, max_pieces=6)


def _random_inputs(rng, tables, W):
    """Packed words of random classes in [0, 2**BITS) (past the table
    too), valid premultiplied entry states and warmup freezes."""
    bits, cpw = tables.bits, tables.cpw
    Jw = (W + CHUNK) // cpw
    shape = (1, Jw, GROUPS, 8, 128)
    cls = rng.integers(0, 1 << bits, shape + (cpw,), dtype=np.int64)
    words = np.zeros(shape, np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    data = words.astype(np.uint32).view(np.int32)
    planes = (1, GROUPS, 8, 128)
    state0 = (rng.integers(0, tables.nstates, planes)
              * tables.ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, planes).astype(np.int32)
    return data, state0, j0


PLANE_CASES = [("counted", True), ("counted", False), ("perm", True),
               ("perm", False), ("chained", True), ("digit", False)]
# Each machine's plane and result cases share its interpret-mode JAX
# programs (one per COUNT mode); the chained and digit machines' cases
# run in tests/test_torch_affine_ladder.py, beside the ladder, to
# balance the test workers.
LADDER_FILE_MACHINES = ("chained", "digit")


@pytest.mark.parametrize("name,count", [
    c for c in PLANE_CASES if c[0] not in LADDER_FILE_MACHINES])
def test_planes_and_summary_match_jax(tiers, name, count):
    planes_and_summary_match_jax(tiers, name, count)


def planes_and_summary_match_jax(tiers, name, count):
    """The JAX kernel and the port's plain version and re-laid model on
    identical seeded inputs: the summary and the planes equal."""
    jt, tt, _ = tiers[name]
    W = tt.warmup
    rng = np.random.default_rng(len(name) + 13 * count)
    data, state0, j0 = _random_inputs(rng, tt, W)
    Cp = GROUPS * TILE
    C, bad_tail = Cp - 5, 99
    j_sum, j_packed = jt._scan(jnp.asarray(data), jnp.asarray(state0),
                               jnp.asarray(j0), jnp.int32(C),
                               jnp.int32(bad_tail), W + CHUNK, W,
                               COUNT=count)
    t = [torch.from_numpy(a.copy()) for a in (data, state0, j0)]
    t_sum, t_packed = tt._scan(t[0], t[1], t[2], C, bad_tail, W,
                               COUNT=count)
    assert np.array_equal(np.asarray(j_sum), t_sum.numpy())
    assert t_packed.dtype == torch.int32
    assert np.array_equal(np.asarray(j_packed), t_packed.numpy())

    phi, fm, swarm = taff.affine_scan_ref(
        t[0], t[1], t[2], tt.fused, tt.bp, W=W, CPW=tt.cpw, BITS=tt.bits,
        NCLS=tt.ncls, OFF=tt.off, COUNT=count)
    jphi, jfm, jswarm = jscan._unpack(j_packed, Cp)
    model = taff.affine_relaid_ref(t[0], t[1], t[2], tt.relaid, W=W,
                                   CPW=tt.cpw, BITS=tt.bits, COUNT=count)
    for got in ((phi, fm, swarm), model):
        assert np.array_equal(got[0].reshape(-1).numpy(), jphi)
        assert np.array_equal(got[1].reshape(-1).numpy(), jfm)
        assert np.array_equal(got[2].reshape(-1).numpy(), jswarm)
    assert (j0 == 0).any() and (j0 >= W).any()
    if count:
        assert jfm.max() > 1         # counts, not a 0/1 flag


@pytest.mark.parametrize("name", sorted(set(CASES)
                                        - set(LADDER_FILE_MACHINES)))
def test_results_match_jax_and_native(tiers, name):
    results_match_jax_and_native(tiers, name)


def results_match_jax_and_native(tiers, name):
    """spec_scan_bytes / spec_count_bytes over two seeded corpora (one
    with the machine's plant) equal the JAX package's and the native
    engine's, last_repair too."""
    jt, tt, dfa = tiers[name]
    _, alphabet, plant = CASES[name]
    native = NativeDfa(dfa)
    rng = random.Random(len(name))
    for trial in range(2):
        n = rng.choice([6000, 9001])
        data = bytearray(rng.choice(alphabet) for _ in range(n))
        if trial == 0:
            at = rng.randrange(0, n - len(plant) - 1)
            data[at:at + len(plant)] = plant
        data = bytes(data)
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
        if trial == 0:
            assert exp_first >= 0


def test_tier_choice_matches_the_jax_chain_for_a_counted_rep():
    dfa = _dfa(rb"[A-Za-z0-9+/]{400,499}=")
    jt = jstream._build_spec_tables(dfa)
    tt = tstream._build_spec_tables(dfa, CPU)
    assert type(jt).__name__ == type(tt).__name__ == "SpecTablesAffine"
    assert (tt.pieces, tt.bits) == (jt.pieces, jt.bits) == (3, 4)


def test_with_warmup_matches_the_jax_eligibility(tiers):
    _, tt, _ = tiers["counted"]
    jt = tiers["counted"][0]
    for W in (16, 36, 128, 512, 2048, 4096):
        j2, t2 = jscan.with_warmup(jt, W), tscan.with_warmup(tt, W)
        assert (j2 is None) == (t2 is None), W
        if t2 is not None:
            assert t2.warmup == j2.warmup == W
            assert t2.fused is tt.fused and t2.last_repair is None
    assert tt.warmup == 32
    # byte-unit tiers only: the pair tier's tables never escalate
    from sregex_tpu_torch.ops.pair import SpecTablesPair
    pair = SpecTablesPair(_dfa(rb"abc"), CPU, narrow_only=True)
    assert tscan.with_warmup(pair, 128) is None


def test_wrapper_checks_and_counts_no_cpu_launch(tiers):
    _, tt, _ = tiers["counted"]
    data = torch.zeros((1, (32 + CHUNK) // 8, 1, 8, 128), dtype=torch.int32)
    s0 = torch.zeros((1, 1, 8, 128), dtype=torch.int32)
    kw = dict(W=32, CPW=8, BITS=4, NCLS=tt.ncls, OFF=tt.off, COUNT=True,
              relaid=tt.relaid)
    before = taff.affine_scan_launches
    taff.affine_scan(data, s0, s0, tt.fused, tt.bp, **kw)
    assert taff.affine_scan_launches == before
    with pytest.raises(ValueError, match="bp"):
        taff.affine_scan(data, s0, s0, tt.fused,
                         torch.zeros(48, dtype=torch.int32), **kw)
    with pytest.raises(TypeError):
        taff.affine_scan(data, s0, s0, tt.fused, tt.bp.long(), **kw)
    meta = [x.to("meta") for x in (data, s0, s0, tt.fused, tt.bp)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        taff.affine_scan(*meta, **kw)


def test_relaid_table_holds_the_plain_versions_entries(tiers):
    """relay_table: piece pid's row at byte pid << (bits + 3), swizzled
    by sw(pid) = pid * (ncls rounded up to a power of two) mod 16; the
    entry of (pid, code) at byte (code << 3) ^ offsets[pid] is the
    (add, y) of fused[pid * ncls + code], or of entry (index & 127) past
    the table; SpecTablesAffine carries its own; unsorted breakpoints
    are refused."""
    for name, (_, tt, _) in tiers.items():
        rel = tt.relaid
        assert rel.bp == tt.bp_premult
        assert list(rel.host) == list(rel.bp + rel.offsets) \
            == rel.pieces.tolist()
        blk = 1 << (tt.ncls - 1).bit_length()
        for pid, o in enumerate(rel.offsets):
            sw = (pid * blk) % 16 if blk < 16 else 0
            assert o == pid << (tt.bits + 3) | sw << 3
        tab = rel.table.numpy().view(np.uint32).reshape(-1, 2)
        assert len(tab) == tt.pieces << tt.bits
        f = tt.fused.numpy().view(np.uint32)
        for pid in range(tt.pieces):
            for code in (0, tt.ncls - 1, tt.ncls, (1 << tt.bits) - 1):
                idx = pid * tt.ncls + code
                e = int(f[idx if idx < len(f) else idx & 127])
                val, rel_bit = e & taff._VAL_MASK, (e >> 28) & 1
                add = (val - tt.off if rel_bit else val) & 0xFFFFFFFF
                y = rel_bit << 31 | (e >> 30) & 1
                at = (code << 3 ^ rel.offsets[pid]) >> 3
                assert tuple(tab[at]) == (add, y), (name, pid, code)
    with pytest.raises(ValueError, match="sorted"):
        taff.relay_table(tt.fused.numpy(), (6, 3), tt.ncls, tt.bits,
                         tt.off, CPU)


def _affine_random(rng, pieces, bits, wrap, B=1, G=1, K=32):
    """Random affine inputs of P pieces (the cuda tests' families):
    class codes up to 2**bits; with ``wrap`` arbitrary int32 entries and
    entry states (out of range, the breakpoints' neighbours, the int32
    extremes), else valid ones."""
    cpw = {4: 8, 8: 4}[bits]
    W = 2 * cpw
    ncls = int(rng.integers(2, (1 << bits) + 1))
    S = pieces * int(rng.integers(3, 40))
    off = S * ncls
    Jw = (W + K) // cpw
    words = rng.integers(0, 1 << 32, (B, Jw, G, 8, 128), dtype=np.uint64)
    bp = np.sort(rng.choice(np.arange(1, S), pieces - 1, replace=False)
                 * ncls)
    rows = -(-(pieces * ncls) // 128)
    if wrap:
        table = rng.integers(-2 ** 31, 2 ** 31, rows * 128)
        s0 = rng.integers(-2 ** 31, 2 ** 31, (B, G, 8, 128))
        near = [-2 ** 31, 2 ** 31 - 1, -1, 0, off]
        for b in bp.tolist():
            near += [b - 1, b]
        s0.reshape(-1)[:len(near)] = near
    else:
        table = (rng.integers(0, 2 * off, rows * 128)
                 | rng.integers(0, 2, rows * 128) << 28
                 | rng.integers(0, 2, rows * 128) << 30)
        s0 = rng.integers(0, S, (B, G, 8, 128)) * ncls
    j0 = rng.integers(0, W + 1, (B, G, 8, 128))
    arrays = (words.astype(np.uint32).view(np.int32), s0.astype(np.int32),
              j0.astype(np.int32), table.astype(np.int32),
              bp.astype(np.int32))
    return ([torch.from_numpy(a) for a in arrays],
            dict(W=W, CPW=cpw, BITS=bits, NCLS=ncls, OFF=off))


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("wrap", [False, True])
def test_relaid_walk_equals_the_plain_version(bits, wrap):
    """The plain model of the kernel's walk (affine_relaid_ref over
    relay_table) equals affine_scan_ref for P from 1 to 48, the
    templated kernel's range and past it, COUNT and scan."""
    rng = np.random.default_rng(bits * 2 + wrap)
    for pieces in (*range(1, 10), 12, 16, 23, 31, 40, 47, 48):
        args, kw = _affine_random(rng, pieces, bits, wrap)
        rel = taff.relay_table(args[3].numpy(), args[4].tolist(), kw["NCLS"],
                               bits, kw["OFF"], CPU)
        for count in (True, False):
            want = taff.affine_scan_ref(*args, COUNT=count, **kw)
            got = taff.affine_relaid_ref(*args[:3], rel, W=kw["W"],
                                         CPW=kw["CPW"], BITS=bits,
                                         COUNT=count)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (pieces, count)
