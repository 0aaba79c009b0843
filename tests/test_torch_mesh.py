"""The port's multi-device layer (ops/mesh.py, the ops' ``mesh=``,
Scanner(mesh=), ops/scan.py, parallel/sharded_scan.py) against the JAX
package on its 8-device virtual CPU mesh (tests/conftest.py; Pallas in
interpret mode) and the native engine.

The port's mesh here is eight CPU shards (make_mesh([cpu] * 8)), a
virtual mesh that takes the route of distinct devices (each shard's
blocks and planes its own tensors).  Planes, summaries, per-shard
summaries, offsets and results are integers: the tolerance is exact
equality.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.dfa import build_dfa
from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops import scan as jops
from sregex_tpu.ops.prep import prepare_auto as jprepare
from sregex_tpu.parallel import make_mesh as jmake_mesh
from sregex_tpu.parallel import sharded_scan_bytes as jsharded
from sregex_tpu.stream import compile_pattern as jcompile
from test_fused_count import _corpus, _multi_machine
from test_torch_core import assert_same_core, jax_caps  # noqa: F401

from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import scan as tops
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, TILE
from sregex_tpu_torch.ops.mesh import Mesh, make_mesh
from sregex_tpu_torch.ops.prep import prepare_auto, prepare_shards
from sregex_tpu_torch.parallel import sharded_scan_bytes

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)

CPU = torch.device("cpu")
HEADLINE = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8
    return jmake_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh([CPU] * 8)


@pytest.fixture
def shard_calls(monkeypatch):
    """Records, for each scan the ops run, the mesh it was given."""
    calls = []
    orig = tscan.shard_planes

    def spy(tables, data, state0, j0, mesh, launch):
        calls.append(mesh)
        return orig(tables, data, state0, j0, mesh, launch)

    monkeypatch.setattr(tscan, "shard_planes", spy)
    return calls


def _dfa(pattern):
    if isinstance(pattern, list):
        ast, _ = parse_multi(pattern)
    else:
        ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast), max_states=65536)


def _headline_data(n, seed):
    rng = random.Random(seed)
    data = bytearray(rng.choice(b"abccc x") for _ in range(n))
    at = n * 3 // 4
    data[at:at + 9] = b"xaaabbccb"
    return bytes(data)


# ---------------------------------------------------------------------
# the sharded dispatch of the static tiers
# ---------------------------------------------------------------------

def test_static_dispatch_equals_jax_mesh_and_one_device(jmesh, tmesh,
                                                        monkeypatch):
    """The narrow tier at chunk_len 256 over 8 shards: the prep, the
    summary and the packed planes equal the JAX dispatch shard_mapped
    over its 8 devices and the port on one device, from the mesh's prep
    and from one tensor cut over the mesh; each shard ran one launch
    over its block rows."""
    dfa = _dfa(HEADLINE)
    jt, tt = jscan.SpecTables(dfa), tscan.SpecTables(dfa, CPU)
    data = _headline_data(150_000, 3)
    jp = jprepare(jt, data, 256, b_multiple=8)
    tp = prepare_auto(tt, data, 256, mesh=tmesh)
    d = torch.cat(tp[0].parts)
    assert np.array_equal(np.asarray(jp[0]), d.numpy())
    _, C, K, J, B = tp
    assert B == 8 and (C, K) == jp[1:3]
    W = tt.warmup
    bad_tail = (C - 1) if C * K > len(data) else -1
    s0, j0 = tscan._entry_planes(0, W, B, CPU)
    js, jpk = jt._scan(jnp.asarray(jp[0]), jnp.asarray(s0.numpy()),
                       jnp.asarray(j0.numpy()), jnp.int32(C),
                       jnp.int32(bad_tail), J, W, COUNT=True, mesh=jmesh,
                       axis="data")
    rows = []
    orig = tscan.SpecTables._kernel

    def counted(self, data, *a, **k):
        rows.append(data.shape[0])
        return orig(self, data, *a, **k)

    monkeypatch.setattr(tscan.SpecTables, "_kernel", counted)
    ts, tpk = tt._scan(tp[0], s0, j0, C, bad_tail, W, COUNT=True,
                       mesh=tmesh)
    assert rows == [1] * 8
    assert np.array_equal(np.asarray(js), ts.numpy())
    assert np.array_equal(np.asarray(jpk), tpk.numpy())
    one = tt._scan(d, s0, j0, C, bad_tail, W, COUNT=True)
    cut = tt._scan(d, s0, j0, C, bad_tail, W, COUNT=True, mesh=tmesh)
    for got in (one, cut):
        assert torch.equal(got[0], ts) and torch.equal(got[1], tpk)


@pytest.mark.parametrize("shards", [8, 4])
def test_static_entry_points_on_a_mesh_equal_native(tmesh, shards,
                                                    shard_calls):
    """spec_scan_bytes / spec_count_bytes / spec_scan_last_bytes /
    spec_chunk_map over meshes of 8 and 4 shards equal the native engine
    and one device; a caller's prep whose block count does not divide
    over the mesh is made again."""
    mesh = tmesh if shards == 8 else Mesh([CPU] * shards)
    dfa = _dfa(r"\bw\d+\b")
    tt = tscan.SpecTables(dfa, CPU)
    rng = random.Random(9)
    data = bytes(rng.choice(b"a w12 b") for _ in range(1_200_000))
    nat = NativeDfa(dfa)
    f, st = nat.scan_first(data, 0)
    k, kst = nat.count(data, 0)
    lone = prepare_auto(tt, data, 256)
    assert lone[4] == 2
    assert tscan.spec_scan_bytes(tt, data, 256, mesh=mesh,
                                 prepared=lone) == (st, f)
    assert tscan.spec_count_bytes(tt, data, 256, mesh=mesh) == (kst, k)
    assert tscan.spec_scan_last_bytes(tt, data, 256, mesh=mesh) == \
        tscan.spec_scan_last_bytes(tt, data, 256)
    for got, want in zip(tscan.spec_chunk_map(tt, data, 256, mesh=mesh),
                         tscan.spec_chunk_map(tt, data, 256)):
        assert np.array_equal(got, want)
    assert shard_calls.count(mesh) == 4 and shard_calls.count(None) == 2


@pytest.mark.parametrize("pattern,bpu", [(HEADLINE, 1), ("abc", 2)])
def test_mesh_prep_equals_the_whole_prep_cut(pattern, bpu):
    """prepare_shards' parts equal block rows of the whole corpus's
    prep, bit for bit, with a warmup tail and a corpus ending inside
    shard 1 (shards 2 and 3 all padding); byte and pair units."""
    from sregex_tpu_torch.ops.pair import SpecTablesPair
    dfa = _dfa(pattern)
    tt = SpecTablesPair(dfa, CPU, narrow_only=True) if bpu == 2 \
        else tscan.SpecTables(dfa, CPU)
    mesh = Mesh([CPU] * 4)
    data = _headline_data(GROUPS * TILE * 64 + 5001, 4)
    tail = np.arange(tt.warmup, dtype=np.uint8) % tt.byte_ncls \
        if bpu == 2 else np.arange(tt.warmup, dtype=np.uint8) % tt.ncls
    whole = prepare_auto(tt, data, 64, b_multiple=4, prev_tail_cls=tail)
    parts = prepare_shards(tt, data, 64, mesh, prev_tail_cls=tail)
    assert parts[1:] == whole[1:] and whole[4] == 4
    via_auto = prepare_auto(tt, data, 64, prev_tail_cls=tail, mesh=mesh)
    assert via_auto[1:] == whole[1:]
    for i, p in enumerate(parts[0].parts):
        assert torch.equal(p, whole[0][i:i + 1])
        assert torch.equal(via_auto[0].parts[i], p)


# ---------------------------------------------------------------------
# the fused two-phase tier on a mesh
# ---------------------------------------------------------------------

def _stitch_case():
    """a{200,400}b over a-runs shorter than the 32-byte warmup (every
    speculation converges), 128-byte chunks (4096 a shard at 4 groups),
    and one 250-byte run that starts at chunk 4095: chunk 4096,
    the first of shard 1, speculates 32 a's where 128 came before it, so
    the merged chain breaks exactly at the stitch (a stitch that ignored
    the previous shard's exit would trust it and miss the match)."""
    dfa = _dfa("a{200,400}b")
    rng = random.Random(8)
    data = bytearray()
    while len(data) < 600_000:
        data += b"a" * rng.randrange(5, 30) + b" "
    at = 4095 * 128
    data[at - 1:at + 251] = b" " + b"a" * 250 + b"b"
    return dfa, bytes(data[:600_000])


def test_fused_mesh_shard_summaries_equal_jax(  # noqa: F811
        jmesh, tmesh, jax_caps, monkeypatch):
    """The [8, 11] per-shard summaries, the combined summary and the
    merged and core planes of the live chunks equal JAX's
    _fused_count_mesh on the stitch case; core_count_fused over the
    mesh (and over a mesh of 2 shards) equals the native engine and one
    device."""
    dfa, data = _stitch_case()
    jfull, tfull = jscan.SpecTablesWide(dfa), tscan.SpecTablesWide(dfa, CPU)
    sample = data[:64 << 10]
    jct = jcore.CoreTables(dfa, sample, require_fast=False, no_pair=True)
    tct = tcore.CoreTables(dfa, sample, require_fast=False, no_pair=True,
                           device=CPU)
    assert_same_core(tct, jct)
    seen = {}
    orig = jcore._combine_fused_summaries

    def spy(S, C, Cp_l):
        seen["S"] = np.asarray(S).astype(np.int64)
        return orig(S, C, Cp_l)

    monkeypatch.setattr(jcore, "_combine_fused_summaries", spy)
    jd = jcore._fused_dispatch(jct, jfull, data, 128, 0, None, None,
                               mesh=jmesh)
    td = tcore._fused_dispatch(tct, tfull, data, 128, 0, None, None,
                               mesh=tmesh)
    assert td["shard_summ"].shape == (8, 11)
    assert np.array_equal(seen["S"], td["shard_summ"])
    assert np.array_equal(jd["summ"], td["summ"])
    # the chain breaks at the stitch: shard 0 validated, shard 1 not, at
    # its first chunk
    assert td["shard_summ"][0, 0] == 1 and td["shard_summ"][1, 0] == 0
    assert td["summ"][1] == GROUPS * TILE
    live = td["Cfull"]
    for key in ("merged", "packed_core"):
        want = np.asarray(jd[key]).reshape(3, -1)[:, :live]
        assert np.array_equal(want, td[key][:, :live].numpy()), key
    exp_c, exp_st = NativeDfa(dfa).count(data, 0)
    got = tcore.core_count_fused(tct, tfull, data, chunk_len=128, mesh=tmesh)
    assert got == (exp_st, exp_c)
    assert tct.last_fused_cause == "miss"
    assert got == tcore.core_count_fused(tct, tfull, data, chunk_len=128)
    assert tcore.core_count_fused(tct, tfull, data, chunk_len=128,
                                  mesh=make_mesh([CPU] * 2)) == got


@pytest.mark.parametrize("seed", range(6))
def test_combine_fused_summaries_equals_jax(seed):
    """The port's _combine_fused_summaries equals JAX's on seeded random
    per-shard summaries (all-ok shards, breaks, fires before and after
    the first break, overflow, chunk C-1 in any shard)."""
    rng = np.random.default_rng(seed)
    ndev, Cp_l = int(rng.integers(1, 9)), 4096
    S = rng.integers(-1, 5000, (ndev, 11))
    S[:, 0] = rng.random(ndev) < 0.7
    S[:, 7] = rng.random(ndev) < 0.2
    S[:, 9] = np.where(rng.random(ndev) < 0.5, -1, S[:, 9])
    C = int(rng.integers(1, ndev * Cp_l + 1))
    assert np.array_equal(tcore._combine_fused_summaries(S, C, Cp_l),
                          jcore._combine_fused_summaries(S, C, Cp_l))


def test_fused_mesh_per_shard_overflow_stays_exact(monkeypatch):
    """A keyword in every 128-byte chunk of 2 MB over 2 shards of two
    block rows each, the cap at one phase-2 block row: both shards
    overflow, and the legacy fold over the global core planes is exact."""
    monkeypatch.setattr(tcore, "FUSED_CAP", GROUPS * TILE)
    dfa, words = _multi_machine(nwords=8, wordlen=4, seed=11)
    data = bytearray(_corpus(words, 2 << 20, seed=3, plant_every=1 << 30))
    for pos in range(40, len(data) - 16, 128):
        w = words[pos % len(words)]
        data[pos:pos + len(w) + 2] = b" " + w + b" "
    data = bytes(data)
    full = tscan.SpecTablesWide(dfa, CPU)
    ct = tcore.CoreTables(dfa, _corpus(words, 64 << 10, seed=4,
                                       plant_every=1 << 30),
                          require_fast=False, no_pair=True, device=CPU)
    mesh = make_mesh([CPU] * 2)
    d = tcore._fused_dispatch(ct, full, data, 128, 0, None, None, mesh=mesh)
    assert d["B1"] == 4 and d["shard_summ"][:, 7].all()
    exp_c, exp_st = NativeDfa(dfa).count(data, 0)
    assert tcore.core_count_fused(ct, full, data, chunk_len=128,
                                  mesh=mesh) == (exp_st, exp_c)
    assert ct.last_fused_cause == "overflow"


# ---------------------------------------------------------------------
# ops/scan and the sharded enumerative scan
# ---------------------------------------------------------------------

def test_ops_scan_equals_jax():
    """chunk_transfer, compose and reduce_summaries equal JAX's at C=8,
    K=128 (a ragged last chunk; random byte data; a two-pattern set)."""
    dfa = _dfa([b"abcd", b"bc", b"zz"])
    jt = jops.dfa_device_tables(dfa)
    tt = tops.dfa_device_tables(dfa, CPU)
    assert np.array_equal(np.asarray(jt["fused_bm"]), tt["fused_bm"].numpy())
    rng = np.random.default_rng(5)
    data = rng.choice(np.frombuffer(b"abcdz x", np.uint8), (8, 128))
    valid = np.full(8, 128, np.int32)
    valid[-1] = 77
    jo = jops.chunk_transfer(jt["fused_bm"], jnp.asarray(data),
                             jnp.asarray(valid), chunk_len=128)
    to = tops.chunk_transfer(tt["fused_bm"], torch.from_numpy(data),
                             torch.from_numpy(valid), chunk_len=128)
    for j, t in zip(jo, to):
        assert np.array_equal(np.asarray(j), t.numpy())
    with jax.enable_x64():
        jr = jops.reduce_summaries(*jo, jnp.asarray(valid))
        a = tuple(np.asarray(x) for x in jr)
        # compose two block summaries, the second shifted by 1000 bytes
        b = (a[0][::-1].copy(), np.where(a[1] >= jops._NO_MATCH_ABS,
                                         a[1], a[1] + 1000), a[2])
        jc = jops.compose(tuple(jnp.asarray(x) for x in a),
                          tuple(jnp.asarray(x) for x in b))
        jc = tuple(np.asarray(x) for x in jc)
    tr = tops.reduce_summaries(*to, torch.from_numpy(valid))
    for j, t in zip(jr, tr):
        assert np.array_equal(np.asarray(j), t.numpy())
    tc = tops.compose(tuple(torch.from_numpy(x) for x in a),
                      tuple(torch.from_numpy(x) for x in b))
    for j, t in zip(jc, tc):
        assert np.array_equal(j, t.numpy())


@pytest.mark.parametrize("pattern,data", [
    ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"abccc" * 2000 + b"aaabbccb"),
    ("xyz", b"abc" * 5000),
    ("needle", b"hay " * 3000 + b"needle" + b" hay" * 1000),
    (r"\bw\d+\b", b"a w12 b" * 997),
    ("^line", b"text\nline two\n" * 500),
], ids=["headline", "xyz", "needle", "word", "line"])
def test_sharded_scan_bytes_equals_jax(pattern, data, jmesh, tmesh):
    """tests/test_sharded_scan.py's cases: the port's sharded scan over 8
    shards equals JAX's over its 8 devices, the port's one-device scan
    and the native engine's first match."""
    dfa = _dfa(pattern)
    jt = jops.dfa_device_tables(dfa)
    tt = tops.dfa_device_tables(dfa, CPU)
    want = jsharded(jt, data, mesh=jmesh, chunk_len=256)
    assert sharded_scan_bytes(tt, data, mesh=tmesh, chunk_len=256) == want
    assert tops.scan_bytes(tt, data, chunk_len=256) == want
    assert want[1] == NativeDfa(dfa).scan_first(data, 0)[0]


# ---------------------------------------------------------------------
# Scanner(mesh=)
# ---------------------------------------------------------------------

def _scanner_case(name):
    rng = random.Random(len(name))
    if name == "headline":
        return HEADLINE, _headline_data(60_000, 5)
    if name == "keywords":
        data = bytearray(rng.choice(b"abcdgirt xy") for _ in range(60_000))
        data[41_000:41_006] = b" bird "
        return [b"cat", b"dog", b"bird"], bytes(data)
    data = bytes(rng.choice(b"ab xx") for _ in range(40_000))
    return "a{60,120}b", data[:30_000] + b"c" + b"a" * 90 + b"b" + \
        data[30_000:]


@pytest.mark.parametrize("name", ["headline", "keywords", "counted"])
def test_scanner_on_a_mesh_equals_jax_and_native(name, jmesh, tmesh,
                                                 shard_calls):
    """count, scan, match, count_many and count_stream of Scanner(mesh=)
    equal the native engine and the JAX Scanner(mesh=): on all five for
    the headline, on count and scan for the keywords, on count for the
    counted repetition (each JAX program costs seconds of interpret-mode
    compile); every device scan went through the mesh.  A three-keyword
    set (regex ids) and a counted repetition (the affine tier here)
    beside the headline."""
    pattern, data = _scanner_case(name)
    tsc = tstream.compile_pattern(pattern, device="cpu", mesh=tmesh)
    jsc = jcompile(pattern, use_device=True, mesh=jmesh)
    for sc in (tsc, jsc):
        sc.DEVICE_THRESHOLD = 1 << 12
        sc.CORE_SAMPLE = 1 << 12
    nat = NativeDfa(tsc.dfa)

    def count(d):
        k, st = nat.count(d, 0)
        return k + int(tsc.dfa.match_eof[st])

    f, fst = nat.scan_first(data, 0)
    want_scan = (tsc.dfa.id_at(fst, data[f]), f) if f >= 0 else None
    docs = [data[i:i + 9000] for i in range(0, len(data), 9000)]
    segs = [data[i:i + 13_000] for i in range(0, len(data), 13_000)]
    got = (tsc.count(data), tsc.scan(data),
           tsc.count_many(docs, chunk_len=256),
           tsc.count_stream(segs, chunk_len=256), tsc.match(data))
    assert got == (count(data), want_scan, [count(d) for d in docs],
                   count(data), want_scan is not None)
    assert want_scan is not None and tsc.stats().tier != "native"
    assert shard_calls and all(m is tmesh for m in shard_calls)
    jgot = (jsc.count(data),)
    if name != "counted":
        jgot += (jsc.scan(data),)
    if name == "headline":
        jgot += (jsc.count_many(docs, chunk_len=256),
                 jsc.count_stream(segs, chunk_len=256), jsc.match(data))
    assert got[:len(jgot)] == jgot


def test_fused_batch_declines_on_a_mesh_scanner(monkeypatch, tmesh):
    """SREGEX_FUSED=1 serves a long-chain wide machine's batch on the
    fused tier on one device; a mesh Scanner declines it (as the JAX
    package does) and serves the batch on the sharded static tier."""
    monkeypatch.setenv("SREGEX_FUSED", "1")
    rng = random.Random(2)
    words = list({("".join(rng.choice("abcdefghijklmn")
                           for _ in range(4))).encode() for _ in range(14)})
    docs = [_corpus(words, 40_000, seed=s) for s in range(4)]
    want = None
    for mesh in (None, tmesh):
        sc = tstream.compile_pattern(words, device="cpu", mesh=mesh)
        sc.DEVICE_THRESHOLD = 1 << 12
        assert isinstance(sc._spec, tscan.SpecTablesWide) and sc._spec.rows > 4
        got = sc.count_many(docs)
        fused = sc._batch_fused_core(docs)
        assert (fused is None) == (mesh is not None)
        assert sc.stats().tier == ("SpecTablesWide" if mesh else "CoreTables")
        want = got if want is None else want
        assert got == want


def test_mesh_and_device_checks(tmesh):
    """make_mesh wants a card or devices=; Mesh refuses unknown devices
    and CUDA devices torch cannot see; a Scanner whose device= disagrees
    with its mesh raises; block rows must divide over the mesh."""
    from sregex_tpu_torch.ops.mesh import shard_rows
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
        with pytest.raises(RuntimeError, match="cuda"):
            Mesh([torch.device("cuda")])
    with pytest.raises(ValueError, match="unsupported"):
        Mesh([torch.device("meta")])
    prog = tstream.compile_pattern("abc", device=None).program
    for device in ("cuda", None):
        with pytest.raises(ValueError, match="disagrees"):
            tstream.Scanner(prog, device=device, mesh=tmesh)
    sc = tstream.Scanner(prog, device="cpu", mesh=tmesh)
    assert sc.device == CPU and sc.mesh is tmesh
    with pytest.raises(ValueError, match="do not divide"):
        shard_rows(12, tmesh)
