"""The port's streaming surface against the JAX package's: StreamScanner,
the Thompson VM, the CLI and serialize, and the public names.

StreamScanner: the port on the host engine (device=None) and on the
device path's plain versions (device="cpu", DEVICE_THRESHOLD lowered to
a few KB so chunks take the static tier or the legacy core from the
stream's carried state) against the JAX StreamScanner(use_device=False)
on random chunkings (empty chunks, byte at a time), a multi-regex set
and the post-match SRE_ERROR contract.  ThompsonCtx: the same programs
and chunkings through both packages.  CLI: both mains on the argv and
stdin cases of tests/test_cli.py, stdout, stderr and rc equal.
serialize: a round trip, and a file written by either package loaded by
the other.  Every quantity is an integer or bytes, so the tolerance is
exact equality.  Inputs are made from seeds.
"""

import io
import random

import numpy as np
import pytest
import torch

import sregex_tpu
from sregex_tpu import cli as jcli
from sregex_tpu import serialize as jser
from sregex_tpu.stream import StreamScanner as JaxStreamScanner
from sregex_tpu.stream import compile_pattern as jax_compile
from sregex_tpu.thompson_vm import ThompsonCtx as JaxThompson

import sregex_tpu_torch
from sregex_tpu_torch import cli as tcli
from sregex_tpu_torch import serialize as tser
from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.consts import SRE_AGAIN, SRE_ERROR, SRE_OK
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.thompson_vm import ThompsonCtx

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)



def _dictionary(n, seed):
    """n distinct keywords of 6-12 lowercase letters."""
    rng = np.random.default_rng(seed)
    words = set()
    while len(words) < n:
        words.add(bytes(rng.integers(97, 123, int(rng.integers(6, 13)))
                        .astype(np.uint8)))
    return sorted(words)


# 816 states x 27 classes: past the wide tier, the big tier's 16-bit table
DICT100 = _dictionary(100, 5)
# the base64-blob detector (402 states x 3 classes): the affine tier
BASE64 = rb"[A-Za-z0-9+/]{400,499}="

STREAM_CASES = [
    ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", b"abc x", b"aaabbccb"),
    (r"\bword\b", b"word abc ", b" word "),
    ("a[^b]{0,40}b", b"a xyz", b"a  b"),
    ([b"cat", b"dog(s)?", b"bird"], b"catdogsbird x", b"dogs"),
    (BASE64, b"Ab9+/ ", b" " + b"Q" * 450 + b"="),
    (DICT100, b"abcdefghijklmnopqrstuvwxyz ", b" " + DICT100[37] + b" "),
]
NO_TIER = "a.{10}b|cdefghijklmnopqrstuvwxyz"


def _chunkings(data, rng, n=3):
    """The whole buffer, then random cuts with empty chunks sprinkled."""
    yield [data]
    for _ in range(n):
        cuts = sorted(rng.randrange(len(data) + 1)
                      for _ in range(rng.randrange(1, 8)))
        pieces, prev = [], 0
        for c in cuts:
            pieces.append(data[prev:c])
            prev = c
        pieces.append(data[prev:])
        for _ in range(rng.randrange(0, 3)):
            pieces.insert(rng.randrange(len(pieces) + 1), b"")
        yield pieces


def _feed(ss, pieces):
    """(rc, offset, matched_regex) of a stream, and the SRE_ERROR of one
    more exec after it finished."""
    for i, p in enumerate(pieces):
        rc, off = ss.exec(p, eof=i == len(pieces) - 1)
        if rc != SRE_AGAIN:
            break
    after = ss.exec(b"x", eof=True)
    return (rc, off, ss.matched_regex), after


def _corpus(alpha, plant, n, seed, at=None):
    rng = random.Random(seed)
    data = bytearray(rng.choice(alpha) for _ in range(n))
    if at is not None:
        data[at:at + len(plant)] = plant
    return bytes(data)


@pytest.mark.parametrize("idx", range(len(STREAM_CASES)))
def test_stream_scanner_equals_jax(idx):
    pattern, alpha, plant = STREAM_CASES[idx]
    jsc = jax_compile(pattern)
    tsc = sregex_tpu_torch.compile_pattern(pattern, device=None)
    rng = random.Random(idx)
    datas = [_corpus(alpha, plant, 6000, idx),
             _corpus(b"xyz ", plant, 24000, idx + 1, at=17001)]
    for data in datas:
        for pieces in _chunkings(data, rng):
            want = _feed(JaxStreamScanner(jsc.dfa), pieces)
            assert _feed(tstream.StreamScanner(tsc.dfa, device=None),
                         pieces) == want
            dev = tstream.StreamScanner(tsc.dfa, device="cpu")
            dev.DEVICE_THRESHOLD = 4096
            assert _feed(dev, pieces) == want
    # byte at a time through the first 600 bytes, then the rest at once
    data = datas[0]
    pieces = [data[i:i + 1] for i in range(600)] + [data[600:]]
    want = _feed(JaxStreamScanner(jsc.dfa), pieces)
    assert _feed(tstream.StreamScanner(tsc.dfa, device=None),
                 pieces) == want
    assert want[1] == (SRE_ERROR, -1)


def test_stream_scanner_device_chunks_take_the_static_tier():
    """A planted match past a chunk boundary: the 4 KB+ chunks run the
    static tier's plain version from the carried state, and the result
    is the native engine's."""
    tsc = sregex_tpu_torch.compile_pattern(STREAM_CASES[0][0], device=None)
    body = b"abccc" * 6000
    data = body[:20477] + b"aaabbccb" + body[20485:]
    want = tsc._native.scan_first(data, 0)[0]
    ss = tstream.StreamScanner(tsc.dfa, device="cpu")
    ss.DEVICE_THRESHOLD = 4096
    before = tscan.pair_scan_launches + tscan.spec_scan_launches
    r = _feed(ss, [data[i:i + 5120] for i in range(0, len(data), 5120)])
    assert r[0] == (SRE_OK, want, 0)
    assert isinstance(ss._tables, tscan.SpecTables) and ss._coret is False
    # the plain versions ran: no CUDA launch is counted
    assert tscan.pair_scan_launches + tscan.spec_scan_launches == before
    assert r == _feed(JaxStreamScanner(
        jax_compile(STREAM_CASES[0][0]).dfa),
        [data[i:i + 5120] for i in range(0, len(data), 5120)])


@pytest.mark.parametrize("tier,pattern,alpha,plant", [
    ("SpecTablesAffine", BASE64, b"Ab9+/ ", b" " + b"Q" * 450 + b"="),
    ("SpecTablesBig", DICT100, b"abcdefgh ", b" " + DICT100[37] + b" ")],
    ids=["affine", "big"])
def test_stream_scanner_static_tiers_from_carried_states(tier, pattern,
                                                         alpha, plant):
    """The affine and big tiers entered in non-zero carried states: the
    device chunks run the tier's plain version from them, and the
    result is the native engine's and the JAX host StreamScanner's."""
    tsc = sregex_tpu_torch.compile_pattern(pattern, device=None)
    data = _corpus(alpha, plant, 30000, 6, at=26001)
    want = tsc._native.scan_first(data, 0)
    pieces = [data[i:i + 4500] for i in range(0, len(data), 4500)]
    ss = tstream.StreamScanner(tsc.dfa, device="cpu")
    ss.DEVICE_THRESHOLD = 4096
    states = []
    orig = tstream.spec_scan_bytes

    def spy(tables, chunk, **kw):
        states.append(kw["entry_state"])
        return orig(tables, chunk, **kw)

    tstream.spec_scan_bytes = spy
    try:
        r = _feed(ss, pieces)
    finally:
        tstream.spec_scan_bytes = orig
    assert type(ss._tables).__name__ == tier
    assert r[0] == (SRE_OK, want[0], tsc.dfa.id_at(want[1],
                                                    data[want[0]]))
    assert len(states) >= 5 and sum(s != 0 for s in states) >= 3
    assert r == _feed(JaxStreamScanner(jax_compile(pattern).dfa), pieces)


def test_stream_scanner_legacy_core_with_carried_states():
    """A machine with no static tier: chunks go through the legacy core,
    entered in non-zero carried states (or natively where the state is
    not in the core), exactly as the native engine and the JAX host
    StreamScanner."""
    tsc = sregex_tpu_torch.compile_pattern(NO_TIER, device=None)
    assert tstream._build_spec_tables(tsc.dfa, "cpu") is None
    rng = random.Random(5)
    data = bytearray(rng.choice(b"acdxyz ") for _ in range(60000))
    data[51190:51214] = b"cdefghijklmnopqrstuvwxyz"
    data = bytes(data)
    want = tsc._native.scan_first(data, 0)[0]
    assert want == 51214        # the boundary after the last byte
    pieces = [data[i:i + 8192] for i in range(0, len(data), 8192)]
    ss = tstream.StreamScanner(tsc.dfa, device="cpu")
    ss.DEVICE_THRESHOLD = 4096
    states = []
    orig = tcore.core_scan_bytes

    def spy(ct, chunk, **kw):
        states.append(kw["entry_state"])
        return orig(ct, chunk, **kw)

    tstream.core_scan_bytes = spy
    try:
        r = _feed(ss, pieces)
    finally:
        tstream.core_scan_bytes = orig
    assert r[0] == (SRE_OK, want, 0)
    assert isinstance(ss._coret, tcore.CoreTables)
    assert len(states) >= 3 and any(s != 0 for s in states)
    assert r == _feed(JaxStreamScanner(jax_compile(NO_TIER).dfa), pieces)


def test_stream_scanner_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    dfa = sregex_tpu_torch.compile_pattern("ab", device=None).dfa
    with pytest.raises(RuntimeError, match="cuda"):
        tstream.StreamScanner(dfa)


THOMPSON_CASES = ["a|(ab)", r"\bfoo\b", "^line$", "a{2,4}[b-d]+\\z",
                  "(?:x|y)*z"]


@pytest.mark.parametrize("pattern", THOMPSON_CASES)
def test_thompson_ctx_equals_jax(pattern):
    jprog = sregex_tpu.compile_regex(sregex_tpu.parse(pattern)[0])
    tprog = sregex_tpu_torch.compile_regex(
        sregex_tpu_torch.parse(pattern)[0])
    rng = random.Random(pattern)
    for _ in range(6):
        data = bytes(rng.choice(b"abcdfoxyz\n line") for _ in
                     range(rng.randrange(0, 40)))
        for pieces in _chunkings(data, rng, n=2):
            jctx, tctx = JaxThompson(jprog), ThompsonCtx(tprog)
            for i, p in enumerate(pieces):
                eof = i == len(pieces) - 1
                assert tctx.exec(p, eof) == jctx.exec(p, eof)


def _run(main, argv, stdin=b""):
    out, err = io.BytesIO(), io.BytesIO()
    rc = main([b"sregex-cli"] + argv, io.BytesIO(stdin), out, err)
    return out.getvalue(), err.getvalue(), rc


CLI_CASES = [
    ([], b""),
    ([b"abc"], b""),
    ([b"--flags", b"z", b"abc", b"x"], b""),
    ([b"(ab", b"x"], b""),
    ([b"-n", b"2", b"ok", b"(bad", b"x"], b""),
    ([b"--stdin", b"a|(ab)"], b"3\nbah4\nabab0\n2\nab"),
    ([b"ab", b"zab", b"nope"], b""),
    ([b"-n", b"2", b"--flags", b"i ", b"AB", b"c(d)", b"xabcd", b"cd"],
     b""),
    ([b"--stdin", b"(a+)(b)?"], b"5\naabab 3\nxyz"),
    ([b"--bogus", b"a"], b""),
]


@pytest.mark.parametrize("argv,stdin", CLI_CASES)
def test_cli_equals_jax(argv, stdin):
    assert _run(tcli.main, argv, stdin) == _run(jcli.main, argv, stdin)


def test_cli_native_pike_engine_equals_jax(monkeypatch):
    monkeypatch.setenv("SREGEX_PIKE_ENGINE", "native")
    argv, stdin = [b"--stdin", b"(a+)(b)?|c"], b"6\naabcab2\ncc"
    assert _run(tcli.main, argv, stdin) == _run(jcli.main, argv, stdin)


def _roundtrip(save, load, sc, **kw):
    buf = io.BytesIO()
    save(buf, sc)
    buf.seek(0)
    return load(buf, **kw)


@pytest.mark.parametrize("pattern", [rb"(\w+)@(\w+)",
                                     [b"cat", b"dog(s)?", b"bird"],
                                     rb"a{2,4}[b-d]+\z"])
def test_serialize_round_trip_and_across_packages(pattern):
    tsc = sregex_tpu_torch.compile_pattern(pattern, device=None)
    jsc = jax_compile(pattern)
    loaded = [_roundtrip(tser.save_compiled, tser.load_compiled, tsc,
                         device=None),
              _roundtrip(jser.save_compiled, tser.load_compiled, jsc,
                         device=None),
              _roundtrip(tser.save_compiled, jser.load_compiled, tsc)]
    rng = random.Random(7)
    for lo in loaded:
        for k in ("trans", "match_id", "match_eof_id", "class_map"):
            assert np.array_equal(getattr(lo.dfa, k), getattr(tsc.dfa, k))
        assert lo.ast is None
    for _ in range(4):
        data = bytes(rng.choice(b"ab@cd_x dogsbird") for _ in range(400))
        want = (jsc.scan(data), jsc.count(data), jsc.find(data),
                list(jsc.finditer(data)))
        for lo in loaded:
            assert (lo.scan(data), lo.count(data), lo.find(data),
                    list(lo.finditer(data))) == want


def test_serialize_loads_on_the_device_path():
    tsc = sregex_tpu_torch.compile_pattern(rb"ab+c", device=None)
    lo = _roundtrip(tser.save_compiled, tser.load_compiled, tsc,
                    device="cpu")
    lo.DEVICE_THRESHOLD = 4096
    data = b"xabbbc" * 2000
    assert lo.count(data) == 2000
    assert lo.stats().tier != "native"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            _roundtrip(tser.save_compiled, tser.load_compiled, tsc)


def test_port_exports_every_public_name_of_the_jax_package():
    assert set(sregex_tpu.__all__) <= set(sregex_tpu_torch.__all__)
    for name in sregex_tpu_torch.__all__:
        assert getattr(sregex_tpu_torch, name) is not None
    for name in ("SRE_OK", "SRE_ERROR", "SRE_AGAIN", "SRE_BUSY", "SRE_DONE",
                 "SRE_DECLINED", "SRE_REGEX_CASELESS", "SRE_REGEX_NEWLINE"):
        assert getattr(sregex_tpu_torch, name) == getattr(sregex_tpu, name)
    prog = sregex_tpu_torch.compile_regex(sregex_tpu_torch.parse("a(b)")[0])
    jprog = sregex_tpu.compile_regex(sregex_tpu.parse("a(b)")[0])
    assert sregex_tpu_torch.dump_program(prog) == \
        sregex_tpu.dump_program(jprog)
    assert sregex_tpu_torch.dump_ast(sregex_tpu_torch.parse("a(b)")[0]) \
        == sregex_tpu.dump_ast(sregex_tpu.parse("a(b)")[0])
    ctx = sregex_tpu_torch.thompson_create_ctx(prog)
    assert ctx.exec(b"xab", True) == \
        sregex_tpu.thompson_create_ctx(jprog).exec(b"xab", True)
