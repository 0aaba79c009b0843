"""The port's own frontend (parser, compiler, DFA builder, native engine)
against the JAX package's: the same patterns give the same automaton,
table for table, and the native engines count alike.  Exact equality."""

import numpy as np
import pytest

import sregex_tpu
from sregex_tpu import dfa as jdfa
from sregex_tpu import native as jnative

import sregex_tpu_torch
from sregex_tpu_torch import dfa as tdfa
from sregex_tpu_torch import native as tnative

import bench
from chip_smoke import MULTI_WORDS, dictionary


PATTERNS = {
    "headline": "(?:a|b)aa(?:aa|bb)cc(?:a|b)",
    "multi90": [w.encode() for w in bench.MULTI_WORDS],
    "counted": "a{400,499}b",
    "base64": "[A-Za-z0-9+/]{400,499}=",
    "branching-rep": "(?:ab?c){60,140}z",
    "dict100": dictionary(100, 3),
    # tests/test_pallas_big.py CASES
    "big-word": b"word (?:[a-zA-Z0-9]+ ){0,10}otherword",
    "big-counted": b"a{60,120}b",
    "big-branch": b"(x|y|z[QW]){1,5}(longish|loquatious)",
    "big-anchored": b"^.{9}abc.*\n",
}


def _build(pkg, dfa_mod, pattern):
    if isinstance(pattern, list):
        ast, _ = pkg.parse_multi(pattern)
    else:
        ast, _ = pkg.parse(pattern)
    return dfa_mod.build_dfa(pkg.compile_regex(ast), max_states=65536)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_port_frontend_builds_the_same_dfa(name):
    pattern = PATTERNS[name]
    jd = _build(sregex_tpu, jdfa, pattern)
    td = _build(sregex_tpu_torch, tdfa, pattern)
    assert type(td).__module__ == "sregex_tpu_torch.dfa"
    assert (td.nstates, td.nclasses) == (jd.nstates, jd.nclasses)
    for k in ("trans", "match", "match_eof", "match_eof_id", "class_map"):
        assert np.array_equal(np.asarray(getattr(td, k)),
                              np.asarray(getattr(jd, k))), k

    rng = np.random.default_rng(len(name))
    alphabet = np.frombuffer(b"abcxyz =AZaz09+/\n", np.uint8)
    data = rng.choice(alphabet, 20000).tobytes()
    tn, jn = tnative.NativeDfa(td), jnative.NativeDfa(jd)
    assert tn.lib is not None
    assert tn.count(data, 0) == jn.count(data, 0)
    assert tn.scan_first(data, 0) == jn.scan_first(data, 0)


def test_native_library_builds_into_the_build_directory():
    assert tnative.get_lib() is not None
    assert tnative._SO.replace("\\", "/").endswith(
        "build/sregex_tpu_torch/libsrehost.so")
    assert tnative._CSRC.replace("\\", "/").endswith(
        "sregex_tpu_torch/csrc/sre_host.cpp")


def test_chip_smoke_carries_the_benchmark_word_list():
    assert MULTI_WORDS == bench.MULTI_WORDS
