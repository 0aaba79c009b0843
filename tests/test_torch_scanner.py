"""The port's main path as a whole on device="cpu" (the plain torch
versions): Scanner.count/scan/match for the headline pattern and the
90-keyword set equal the native C++ engine and the JAX package's
host-engine Scanner.  Inputs come from numpy's seeded generator; the
tolerance is exact equality."""

import numpy as np
import pytest
import torch

import sregex_tpu
from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.native import NativeDfa

import sregex_tpu_torch
from sregex_tpu_torch import stream as tstream

import bench

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


HEADLINE = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"


def _headline_corpus(n, plant_at):
    body = (b"abccc" * (n // 5 + 1))[:n]
    return body[:plant_at] + b"xaaabbccb" + body[plant_at + 9:]


def _multi_corpus(n, seed):
    """bench_multi's corpus shape at a small size: filler words from a
    disjoint vocabulary with dictionary words planted every 4 KB."""
    rng = np.random.default_rng(seed)
    filler = (b"alpha bravo delta golf hotel juliet kilo lima mike "
              b"november oscar papa quebec romeo sierra tango").split()
    words = [w.encode() for w in bench.MULTI_WORDS]
    piece = b" ".join(filler[i] for i in rng.integers(0, len(filler),
                                                      512)) + b" "
    out = bytearray((piece * (n // len(piece) + 1))[:n])
    for pos in range(4096, n - 64, 4096):
        w = words[rng.integers(len(words))]
        out[pos:pos + len(w) + 2] = b" " + w + b" "
    return bytes(out)


def _programs(kind):
    if kind == "headline":
        ast, _ = parse(HEADLINE)
    else:
        ast, _ = parse_multi([w.encode() for w in bench.MULTI_WORDS])
    return ast, compile_regex(ast)


def _expected(sc, data):
    """count / first match end / match from the native engine alone."""
    native = NativeDfa(sc.dfa)
    k, st = native.count(data, 0)
    first, fst = native.scan_first(data, 0)
    return (k + int(sc.dfa.match_eof[st]), first,
            first >= 0 or bool(sc.dfa.match_eof[fst]))


CORPORA = {
    "headline-planted": ("headline", lambda: _headline_corpus(60000, 41002)),
    "headline-tail": ("headline", lambda: _headline_corpus(60000, 59990)),
    "multi": ("multi", lambda: _multi_corpus(70000, 5)),
    "multi-ragged": ("multi", lambda: _multi_corpus(33333, 6)),
}


@pytest.mark.parametrize("case", sorted(CORPORA))
@pytest.mark.parametrize("use_prepared", [False, True])
def test_scanner_matches_native_and_reference(case, use_prepared):
    kind, make = CORPORA[case]
    data = make()
    ast, prog = _programs(kind)
    sc = tstream.Scanner(prog, device="cpu", ast=ast)
    sc.DEVICE_THRESHOLD = 1
    ref = sregex_tpu.Scanner(prog, use_device=False, ast=ast)
    exp_count, exp_first, exp_match = _expected(sc, data)
    prep = sc.prepare(data) if use_prepared else None

    assert sc.count(data, prepared=prep) == exp_count == ref.count(data)
    st = sc.stats()
    assert st.api == "count" and st.nbytes == len(data)
    assert st.tier == ("SpecTables" if kind == "headline"
                       else "SpecTablesWide")
    assert st.chunks == -(-len(data) // 2048)
    got = sc.scan(data, prepared=prep)
    assert got == ref.scan(data)
    assert (got[1] if got else -1) == exp_first
    assert sc.stats().api == "scan"
    assert sc.match(data, prepared=prep) == exp_match == ref.match(data)


def test_multi_set_is_served_by_the_wide_tier():
    ast, prog = _programs("multi")
    sc = tstream.Scanner(prog, device="cpu", ast=ast)
    assert type(sc._spec).__name__ == "SpecTablesWide"
    assert (sc.dfa.nstates, sc.dfa.nclasses) == (461, 27)
    assert (sc._spec.rows, sc._spec.bits) == (98, 8)


def test_pair_tier_serves_small_machines():
    sc = sregex_tpu_torch.compile_pattern("abc", device="cpu")
    sc.DEVICE_THRESHOLD = 1
    data = (b"xxabcab" * 3000)[:20001]
    assert sc.count(data) == data.count(b"abc")
    assert sc.stats().tier == "SpecTablesPair"
    assert sc.scan(data) == (0, 5)      # end boundary: after the "c"


def test_device_prep_path_through_prepared_corpus(monkeypatch):
    monkeypatch.setenv("SREGEX_DEVICE_PREP", "1")
    sc = sregex_tpu_torch.compile_pattern(HEADLINE, device="cpu")
    sc.DEVICE_THRESHOLD = 1
    data = _headline_corpus(50000, 20000)
    prep = sc.prepare(data)
    assert sc.count(data, prepared=prep) == _expected(sc, data)[0]
    assert isinstance(prep._raw_dev, torch.Tensor)


def test_small_corpus_and_host_scanner_use_native():
    sc = sregex_tpu_torch.compile_pattern(HEADLINE, device="cpu")
    data = _headline_corpus(5000, 100)
    assert sc.count(data) == 1 and sc.stats().tier == "native"
    host = sregex_tpu_torch.compile_pattern(HEADLINE, device=None)
    host.DEVICE_THRESHOLD = 1
    assert host.device is None and host._spec is None
    assert host.scan(data) == (0, 109) and host.stats().tier == "native"


def test_past_the_wide_cap_raises_on_a_device_path():
    """Past the wide cap the big tier serves; a machine past the big cap
    that is not piecewise affine has no static tier and constructs (the
    core tiers or the native engine serve it, tests/test_torch_core.py);
    a pattern past the eager DFA budget no longer raises: it constructs
    with no dense machine, and on a device path past DEVICE_THRESHOLD
    the legacy core over the lazy machine (LazyCoreTables) serves it
    (tests/test_torch_lazy.py).  The name predates that."""
    ast, _ = parse("a.{11}b")
    prog = compile_regex(ast)
    sc = tstream.Scanner(prog, device="cpu")
    assert sc.dfa.nstates * sc.dfa.nclasses > 16384
    assert type(sc._spec).__name__ == "SpecTablesBig"
    ast, _ = parse("a.{10}b|cdefghijklmnopqrstuvwxyz")
    prog = compile_regex(ast)
    sc = tstream.Scanner(prog, device="cpu")
    assert sc.dfa.nstates * sc.dfa.nclasses > (1 << 17)
    assert sc._spec is None
    ast, _ = parse("a.{13}b")
    sc = tstream.Scanner(compile_regex(ast), device="cpu")
    assert sc.dfa is None and sc._spec is None
    data = b"xyz" * 2000 + b"a" + b"q" * 13 + b"b" + b"xyz" * 2000
    sc.DEVICE_THRESHOLD = 1 << 12
    assert sc.count(data) == 1
    assert sc.stats().tier == "LazyCoreTables"
    assert sc.scan(data) == (0, 6015)
    assert sc.stats().tier == "LazyCoreTables"
    assert type(sc._coret).__name__ == "LazyCoreTables"


def test_no_find_on_the_port():
    """find is ported (tests/test_torch_find.py); finditer, find_many,
    sub and split are not yet."""
    sc = sregex_tpu_torch.compile_pattern("abc", device="cpu")
    assert callable(sc.find)
    for name in ("finditer", "find_many", "sub", "split"):
        assert not hasattr(sc, name), name
