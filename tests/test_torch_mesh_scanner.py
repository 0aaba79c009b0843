"""The port's fused tier and Scanner(mesh=) on the 8-shard CPU mesh
against the JAX package on its 8-device virtual CPU mesh (Pallas in
interpret mode) and the native engine: the fused count's per-shard
summaries at a stitch, and count, scan, match, count_many and
count_stream of Scanner(mesh=).  Each compiles interpret-mode programs
that tests/test_torch_mesh.py's cases do not, so they run in a file of
their own, scheduled beside the longest JAX files.  Summaries, planes
and results are integers: the tolerance is exact equality.
"""

import random

import numpy as np
import pytest
import torch

from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.stream import compile_pattern as jcompile
from test_torch_core import assert_same_core, jax_caps  # noqa: F401
from test_torch_mesh import (CPU, HEADLINE, _dfa, _headline_data,  # noqa: F401
                             jmesh, shard_calls, tmesh)

from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, TILE
from sregex_tpu_torch.ops.mesh import make_mesh

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


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
