"""The port's corpus prep (host and torch device paths) is bit-identical
to the JAX package's host prep and device prep: the scan kernels of
either package cannot tell which path packed their input.

Inputs come from numpy's seeded generator; the tolerance is exact
equality (every word is an integer)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.dfa import build_dfa
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops import prep as jprep
from sregex_tpu.ops.pallas_pair import SpecTablesPair as JaxPair

from sregex_tpu_torch.ops import prep as tprep
from sregex_tpu_torch.ops.layout import effective_chunk
from sregex_tpu_torch.ops.pair import SpecTablesPair
from sregex_tpu_torch.ops.spec_scan import SpecTables, SpecTablesWide

import bench

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")
HEADLINE = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"
CHUNK = 256


def _dfa(pattern):
    if isinstance(pattern, list):
        ast, _ = parse_multi(pattern)
    else:
        ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast))


def _namespace(class_map, bits):
    """Prep reads only these attributes, so a namespace goes through
    both packages' prep (the JAX wide tier refuses 8-bit machines of
    this size on the CPU)."""
    cpw = {3: 10, 4: 8, 8: 4}[bits]
    return SimpleNamespace(class_map=np.asarray(class_map, np.uint8),
                           cpw=cpw, bits=bits, warmup=4 * cpw,
                           max_chunk=1 << 15, device=CPU)


def _case(name, monkeypatch):
    """(jax tables, port tables, byte alphabet for the corpus)."""
    if name == "4bit":
        dfa = _dfa(HEADLINE)
        return jscan.SpecTables(dfa), SpecTables(dfa, CPU), b"abcx"
    if name == "3bit":
        monkeypatch.setenv("SREGEX_PACK_BITS", "3")
        dfa = _dfa(HEADLINE)
        jt, tt = jscan.SpecTables(dfa), SpecTables(dfa, CPU)
        assert jt.bits == tt.bits == 3 and tt.cpw == 10
        return jt, tt, b"abcx"
    if name == "8bit-multi":
        dfa = _dfa([w.encode() for w in bench.MULTI_WORDS])
        tt = SpecTablesWide(dfa, CPU)
        assert (tt.bits, tt.cpw, tt.rows) == (8, 4, 98)
        return _namespace(dfa.class_map, 8), tt, b"errorwarning proxy!"
    if name == "8bit-cmap255":
        perm = np.random.default_rng(255).permutation(256)
        ns = _namespace(perm, 8)
        assert ns.class_map.max() == 255
        return ns, ns, None
    if name == "pair4":
        dfa = _dfa("abc")
        jt, tt = JaxPair(dfa), SpecTablesPair(dfa, CPU)
        assert jt.bits == tt.bits == 4
        return jt, tt, b"abcx"
    if name == "pair8":
        dfa = _dfa(r"a[bc]d?e")
        jt, tt = JaxPair(dfa), SpecTablesPair(dfa, CPU)
        assert jt.bits == tt.bits == 8
        return jt, tt, b"abcdex"
    raise KeyError(name)


CASES = ["4bit", "3bit", "8bit-multi", "8bit-cmap255", "pair4", "pair8"]


def _corpus(rng, n, alphabet):
    if alphabet is None:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    pool = np.frombuffer(alphabet, np.uint8)
    return rng.choice(pool, n).tobytes()


def _assert_same(jax_out, port_out):
    assert tuple(jax_out[1:]) == tuple(port_out[1:])
    assert port_out[0].dtype == torch.int32
    assert np.array_equal(np.asarray(jax_out[0]), port_out[0].numpy())


def _check_all(jt, tt, data, **kw):
    """Port host prep, port device prep (from bytes and from a uint8
    tensor) against JAX host prep and JAX device prep."""
    jh = jscan._prepare(jt, data, CHUNK, **kw)
    jd = jprep.prepare_on_device(jt, data, CHUNK, **kw)
    assert tuple(jh[1:]) == tuple(jd[1:])
    assert np.array_equal(np.asarray(jh[0]), np.asarray(jd[0]))
    _assert_same(jh, tprep._prepare(tt, data, CHUNK, **kw))
    _assert_same(jh, tprep.prepare_on_device(tt, data, CHUNK, **kw))
    as_tensor = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    _assert_same(jh, tprep.prepare_on_device(tt, as_tensor, CHUNK, **kw))
    return jh


@pytest.mark.parametrize("case", CASES)
def test_prep_ragged_sizes(case, monkeypatch):
    jt, tt, alphabet = _case(case, monkeypatch)
    rng = np.random.default_rng(1)
    for n in (1, 255, 4096, 70001):
        _check_all(jt, tt, _corpus(rng, n, alphabet))


@pytest.mark.parametrize("case", CASES)
def test_prep_exact_multiple_of_chunk(case, monkeypatch):
    jt, tt, alphabet = _case(case, monkeypatch)
    K = effective_chunk(tt, CHUNK)
    assert K == jscan.effective_chunk(jt, CHUNK)
    data = _corpus(np.random.default_rng(2), 3 * K, alphabet)
    _, C, K2, _, _ = _check_all(jt, tt, data)
    assert (C, K2) == (3, K)


@pytest.mark.parametrize("case", CASES)
def test_prep_prev_tail_cls(case, monkeypatch):
    jt, tt, alphabet = _case(case, monkeypatch)
    rng = np.random.default_rng(3)
    ncls = (256 if case == "8bit-cmap255"
            else int(np.asarray(tt.class_map).max()) + 1)
    tail = rng.integers(1, ncls, tt.warmup).astype(np.uint8)
    data = _corpus(rng, 5000, alphabet)
    with_tail = _check_all(jt, tt, data, prev_tail_cls=tail)
    plain = jscan._prepare(jt, data, CHUNK)
    # the tail really reaches chunk 0's warmup window
    assert not np.array_equal(np.asarray(with_tail[0]),
                              np.asarray(plain[0]))


@pytest.mark.parametrize("case", CASES)
def test_prep_b_multiple(case, monkeypatch):
    jt, tt, alphabet = _case(case, monkeypatch)
    data = _corpus(np.random.default_rng(4), 9000, alphabet)
    out = _check_all(jt, tt, data, b_multiple=2)
    assert out[4] == 2


def test_prepare_auto_routes_tensor_input_to_device_prep(monkeypatch):
    monkeypatch.setenv("SREGEX_DEVICE_PREP", "0")
    dfa = _dfa(HEADLINE)
    tt = SpecTables(dfa, CPU)
    data = (b"abccc" * 4000)[:17000]
    calls = []
    real = tprep.prepare_on_device
    monkeypatch.setattr(tprep, "prepare_on_device",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tprep.prepare_auto(
        tt, torch.from_numpy(np.frombuffer(data, np.uint8).copy()), 512)
    assert calls
    _assert_same(jscan._prepare(jscan.SpecTables(dfa), data, 512), got)
