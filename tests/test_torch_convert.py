"""spec_tables_from_jax / prepared_from_jax: the JAX package's tables
and prepared corpus, handed over as numpy, give the port's own tables
and a corpus the port scans to the JAX result (exact equality)."""

import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.dfa import build_dfa
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.pallas_affine import SpecTablesAffine as JaxAffine
from sregex_tpu.ops.pallas_big import SpecTablesBig as JaxBig
from sregex_tpu.ops.pallas_pair import SpecTablesPair as JaxPair

from sregex_tpu.ops import pallas_phi as jphi

from sregex_tpu_torch.convert import (phi_tables_from_jax, prepared_from_jax,
                                      spec_tables_from_jax)
from sregex_tpu_torch.ops import phi as tphi
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.affine import SpecTablesAffine
from sregex_tpu_torch.ops.big import SpecTablesBig
from sregex_tpu_torch.ops.pair import SpecTablesPair

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")


def _dfa(pattern):
    if isinstance(pattern, list):
        ast, _ = parse_multi(pattern)
    else:
        ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast))


def _arrays(jt):
    """What a caller hands over: the JAX class name, the scalars, and
    every array as a writable numpy copy."""
    out = {k: getattr(jt, k) for k in ("cpw", "bits", "warmup", "rows",
                                       "bpu", "byte_ncls", "pieces",
                                       "bp_premult", "off", "perm")
           if hasattr(jt, k)}
    out["kind"] = type(jt).__name__
    for k in ("fused_vec", "fused_rows"):
        v = getattr(jt, k, None)
        if v is not None:
            out[k] = np.asarray(v).copy()
    return out


CASES = {
    "narrow": ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", jscan.SpecTables,
               tscan.SpecTables),
    "wide-4bit": ("a{60}b", jscan.SpecTablesWide, tscan.SpecTablesWide),
    "wide-8bit": ([b"abcd", b"efgh", b"ijkl", b"mnop"],
                  jscan.SpecTablesWide, tscan.SpecTablesWide),
    "pair-narrow": ("abc", JaxPair, SpecTablesPair),
    "pair-wide": ("abcde", JaxPair, SpecTablesPair),
    "big": ("a{60,120}b", JaxBig, SpecTablesBig),
    "affine": ("a{400,499}b", JaxAffine, SpecTablesAffine),
    "affine-perm": ("(?:ab?c){60,140}z", JaxAffine, SpecTablesAffine),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_from_jax_equal_the_ports_own(case):
    pattern, jcls, tcls = CASES[case]
    dfa = _dfa(pattern)
    jt = jcls(dfa)
    own = tcls(dfa, CPU)
    got = spec_tables_from_jax(_arrays(jt), dfa, CPU)
    assert type(got) is type(own)
    assert torch.equal(got.fused, own.fused)
    for k in ("nstates", "ncls", "cpw", "bits", "warmup", "rows",
              "max_chunk", "wide"):
        assert getattr(got, k) == getattr(own, k), k
    for k in ("bpu", "byte_ncls"):
        assert getattr(got, k, None) == getattr(own, k, None), k
    assert np.array_equal(got.class_map, own.class_map)
    if case == "pair-wide":
        assert own.wide and own.rows > 1
    if isinstance(own, SpecTablesAffine):
        for k in ("pieces", "bp_premult", "off"):
            assert getattr(got, k) == getattr(own, k), k
        assert torch.equal(got.bp, own.bp)
        assert (got.perm is None) == (own.perm is None)
        if own.perm is not None:
            assert np.array_equal(got.perm, own.perm)
            assert np.array_equal(got.inv, own.inv)


def test_big_tables_from_jax_stay_big():
    """A JAX SpecTablesBig has row tiles like a wide table; it becomes
    the port's big tier, never a wide table past the shared-memory
    cap."""
    dfa = _dfa("a.{11}b")
    jt = JaxBig(dfa)
    assert jt.rows * 128 > tscan.SpecTablesWide.MAX_ENTRIES
    got = spec_tables_from_jax(_arrays(jt), dfa, CPU)
    assert type(got) is SpecTablesBig and got.warmup == 32
    rng = np.random.default_rng(2)
    data = rng.choice(np.frombuffer(b"abab.", np.uint8), 9000).tobytes()
    want = jscan.spec_count_bytes(jt, data, chunk_len=256)
    assert tscan.spec_count_bytes(got, data, chunk_len=256) == want


def test_affine_tables_from_jax_keep_perm_and_scan_alike():
    dfa = _dfa("(?:ab?c){60,140}z")
    jt = JaxAffine(dfa)
    got = spec_tables_from_jax(_arrays(jt), dfa, CPU)
    assert got.perm is not None
    data = (b"." + b"abc" * 100 + b"z" + b"ab.c") * 20
    want = jscan.spec_count_bytes(jt, data, chunk_len=256)
    assert tscan.spec_count_bytes(got, data, chunk_len=256) == want
    assert want[1] > 0


def test_tables_from_jax_need_a_known_class():
    dfa = _dfa("abc")
    arrays = _arrays(jscan.SpecTables(dfa))
    arrays["kind"] = "CoreTables"
    with pytest.raises(ValueError, match="CoreTables"):
        spec_tables_from_jax(arrays, dfa, CPU)


def test_tables_from_jax_rejects_rows_that_are_not_broadcast():
    dfa = _dfa("abc")
    arrays = _arrays(jscan.SpecTables(dfa))
    arrays["fused_vec"][3, 5] += 1
    with pytest.raises(ValueError, match="broadcast"):
        spec_tables_from_jax(arrays, dfa, CPU)


def test_prepared_from_jax_scans_to_the_jax_result():
    dfa = _dfa("ab")
    jt = jscan.SpecTables(dfa)
    tt = spec_tables_from_jax(_arrays(jt), dfa, CPU)
    rng = np.random.default_rng(9)
    data = rng.choice(np.frombuffer(b"aabbc", np.uint8), 5000).tobytes()
    jp = jscan._prepare(jt, data, 240)
    prepared = prepared_from_jax(np.asarray(jp[0]).copy(), *jp[1:],
                                 device=CPU)
    got = tscan.spec_count_bytes(tt, data, chunk_len=240,
                                 prepared=prepared)
    assert got == jscan.spec_count_bytes(jt, data, chunk_len=240,
                                         prepared=jp)
    assert got[1] == data.count(b"ab")


@pytest.mark.parametrize("pattern,kind", [("b(?:aa)*b", "PhiTables"),
                                          ("b(?:a{137})*b", "PhiTablesBig")])
def test_phi_tables_from_jax_count_as_jax_does(pattern, kind):
    dfa = _dfa(pattern)
    jt = getattr(jphi, kind)(dfa)
    arrays = {k: getattr(jt, k) for k in ("nstates", "ncls", "rows", "bits",
                                          "nseg", "SB") if hasattr(jt, k)}
    arrays["kind"] = kind
    arrays["fused_rows"] = np.asarray(jt.fused_rows).copy()
    got = phi_tables_from_jax(arrays, dfa, CPU)
    assert type(got) is getattr(tphi, kind)
    assert torch.equal(got.fused, getattr(tphi, kind)(dfa, CPU).fused)
    rng = np.random.default_rng(4)
    data = rng.choice(np.frombuffer(b"aaaaab", np.uint8), 7000).tobytes()
    want = jphi.phi_count_bytes(jt, data, chunk_len=512)
    assert tphi.phi_count_bytes(got, data, chunk_len=512) == want
    assert want[1] > 0
    bad = dict(arrays, rows=arrays["rows"] + 1)
    with pytest.raises(ValueError, match="rows"):
        phi_tables_from_jax(bad, dfa, CPU)
    with pytest.raises(ValueError, match="SpecTables"):
        phi_tables_from_jax(dict(arrays, kind="SpecTables"), dfa, CPU)


def test_core_tables_from_jax_hold_the_jax_core_and_count_alike():
    """core_tables_from_jax carries a JAX CoreTables across: the same
    hot set, core machine, inner tables and ESC id, and the legacy
    core's count and first-match scan (with their repairs) equal the
    JAX package's and the native engine's on a corpus that escapes."""
    import random
    from sregex_tpu.native import NativeDfa
    from sregex_tpu.ops import pallas_core as jcore
    from test_torch_core import assert_same_core
    from sregex_tpu_torch.convert import core_tables_from_jax
    from sregex_tpu_torch.ops import core as tcore
    dfa = build_dfa(compile_regex(parse(b"a{60,120}b")[0]),
                    max_states=65536)
    rng = random.Random(5)
    sample = bytes(rng.choice(b"ab xx") for _ in range(20000))
    jct = jcore.CoreTables(dfa, sample)
    tct = core_tables_from_jax(jct, CPU)
    assert_same_core(tct, jct)
    assert isinstance(tct, tcore.CoreTables) and tct.device == CPU
    data = sample[:5000] + b"c" + b"a" * 90 + b"b" + sample[5000:9000]
    native = NativeDfa(dfa)
    got = tcore.core_count_bytes(tct, data, chunk_len=256)
    assert got == jcore.core_count_bytes(jct, data, chunk_len=256)
    assert got == native.count(data, 0)[::-1]
    assert tct.last_repair == jct.last_repair and tct.last_repair[0] > 0
    got = tcore.core_scan_bytes(tct, data, chunk_len=256)
    assert got == jcore.core_scan_bytes(jct, data, chunk_len=256)
    assert got == native.scan_first(data, 0)[::-1]
