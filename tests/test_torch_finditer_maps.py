"""The index's forward fire maps against the JAX package's (Pallas in
interpret mode on the CPU mesh) and a native walk chunk by chunk:
spec_chunk_map on a narrow and a wide machine, core_chunk_map on the
legacy core, core_chunk_map_fused on the fused tier and past its device
cap.  Each compiles interpret-mode programs that
tests/test_torch_finditer.py's cases do not, so they run in a file of
their own, scheduled beside the longest JAX files.  Entries, counts and
exit states are integers: the tolerance is exact equality.
"""

import random

import numpy as np
import torch

from sregex_tpu import compile_regex as jax_compile_regex
from sregex_tpu import parse as jax_parse
from sregex_tpu.dfa import build_dfa as jax_build_dfa
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan
from test_fused_count import _corpus, _multi_machine
from test_torch_finditer import CPU, K, _brute_map

from sregex_tpu_torch import compile_regex, parse
from sregex_tpu_torch.dfa import build_dfa
from sregex_tpu_torch.native import NativeDfa
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


def _same_map(got, jax_got, want):
    for g, j, w in zip(got[:2], jax_got[:2], want[:2]):
        assert np.array_equal(g, j) and np.array_equal(g, w)
    assert int(got[2]) == int(jax_got[2]) == int(want[2])


def _long_runs(n, seed):
    """a-runs of 5-40 bytes, and in every other chunk a run of 200-600
    bytes, past the 32-byte warmup: speculation misses."""
    rng = random.Random(seed)
    out = bytearray()
    while len(out) < n:
        out += b"a" * rng.randrange(5, 40) + b" "
        if len(out) // K % 2:
            out += b"a" * rng.randrange(200, 600) + rng.choice([b"b", b" "])
    return bytes(out[:n])


def test_spec_chunk_map_equals_jax_and_native():
    """A narrow and a wide machine, from state 0 and from a non-zero
    entry, with speculation misses, a ragged tail and counts of several
    hundred a chunk."""
    repaired = []
    for pattern, data, jcls, tcls, entry in (
            (rb"[^a]a{34,38}b", _long_runs(31 * K + 100, 1), jscan.SpecTables,
             tscan.SpecTables, 0),
            (rb"(?:cat|dog|[^a]a{3,70}b)", _long_runs(30 * K, 2),
             jscan.SpecTablesWide, tscan.SpecTablesWide, 5),
            (rb"a", b"ab" * (8 * K), jscan.SpecTables, tscan.SpecTables,
             0)):
        jdfa = jax_build_dfa(jax_compile_regex(jax_parse(pattern)[0]))
        tdfa_ = build_dfa(compile_regex(parse(pattern)[0]))
        jt, tt = jcls(jdfa), tcls(tdfa_, CPU)
        got = tscan.spec_chunk_map(tt, data, K, entry_state=entry)
        jgot = jscan.spec_chunk_map(jt, data, K, entry_state=entry)
        _same_map(got, jgot, _brute_map(NativeDfa(tdfa_), data, K, entry))
        repaired.append(tt.last_repair[0])
    # misses in the first two, a clean chain (but its ragged tail) in
    # the last
    assert repaired[0] > 1 and repaired[1] > 1 and repaired[2] == 0


def test_core_chunk_map_equals_jax_and_native(monkeypatch):
    """The legacy core with escapes (its 12-keyword core sampled from
    filler), a non-zero entry state in the core."""
    monkeypatch.setattr(tscan.SpecTablesWide, "MAX_ENTRIES",
                        jscan.SpecTablesWide.MAX_ENTRIES)
    dfa, words = _multi_machine()
    data = _corpus(words, 30 * K, seed=5, plant_every=1500)
    sample = _corpus(words, 64 << 10, seed=6, plant_every=1 << 30)
    jct = jcore.CoreTables(dfa, sample)
    tct = tcore.CoreTables(dfa, sample, device=CPU)
    entry = next(s for s in range(1, dfa.nstates)
                 if tct.to_core_premult(s) >= 0)
    got = tcore.core_chunk_map(tct, data, K, entry_state=entry)
    jgot = jcore.core_chunk_map(jct, data, K, entry_state=entry)
    _same_map(got, jgot, _brute_map(NativeDfa(dfa), data, K, entry))
    assert tct.last_repair == jct.last_repair and tct.last_repair[0] > 0


def test_core_chunk_map_fused_equals_jax_and_native(monkeypatch):
    """The fused tier's map at 32 chunks: the long runs escape the core
    and are redone in phase 2, where they outlast the full machine's
    warmup, so the chain breaks and the merged planes' vectorised walk
    repairs it."""
    monkeypatch.setattr(tscan.SpecTablesWide, "MAX_ENTRIES",
                        jscan.SpecTablesWide.MAX_ENTRIES)
    pat = rb"a{200,400}b"
    dfa = jax_build_dfa(jax_compile_regex(jax_parse(pat)[0]))
    head = _long_runs(8 * K, 9).replace(b"b", b" ")
    rng = random.Random(3)
    body = bytearray(head)
    while len(body) < 32 * K:
        body += b"a" * rng.randrange(250, 450) + b"b"
    data, sample = bytes(body[:32 * K]), head
    jfull, tfull = jscan.SpecTablesWide(dfa), tscan.SpecTablesWide(dfa, CPU)
    kw = dict(require_fast=False, no_pair=True)
    jct = jcore.CoreTables(dfa, sample, **kw)
    tct = tcore.CoreTables(dfa, sample, device=CPU, **kw)
    got = tcore.core_chunk_map_fused(tct, tfull, data, K)
    jgot = jcore.core_chunk_map_fused(jct, jfull, data, K)
    _same_map(got, jgot, _brute_map(NativeDfa(dfa), data, K))
    assert tct.last_repair == jct.last_repair
    assert tct.last_fused_cause == jct.last_fused_cause == "miss"
    assert tct.last_escapes[0] > 0


def test_core_chunk_map_fused_overflow_equals_native(monkeypatch):
    """More escapes than the device cap (one phase-2 block row): the
    legacy core-plane fold maps the full-chunk region."""
    monkeypatch.setattr(tcore, "FUSED_CAP", 1)
    dfa, words = _multi_machine(nwords=8, wordlen=4, seed=11)
    data = bytearray(_corpus(words, 4200 * 128 + 50, seed=3,
                             plant_every=1 << 30))
    for pos in range(40, len(data) - 16, 128):
        w = words[pos % len(words)]
        data[pos:pos + len(w) + 2] = b" " + w + b" "
    data = bytes(data)
    sample = _corpus(words, 64 << 10, seed=4, plant_every=1 << 30)
    tct = tcore.CoreTables(dfa, sample, require_fast=False, no_pair=True,
                           device=CPU)
    tfull = tscan.SpecTablesWide(dfa, CPU)
    got = tcore.core_chunk_map_fused(tct, tfull, data, 128)
    want = _brute_map(NativeDfa(dfa), data, 128)
    assert tct.last_fused_cause == "overflow"
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
