"""The port's legacy hot-core tier's results (ops/core.py,
core_count_bytes / core_scan_bytes) against the JAX package's
(ops/pallas_core.py in interpret mode on the CPU mesh, as its own tests
run them) and the native engine, on tests/test_pallas_core.py's
machines, escapes at chunk edges included, and from a nonzero entry
state.  They compile interpret-mode programs that
tests/test_torch_core.py's cases do not, so they run in a file of their
own, scheduled beside the longest JAX files.  Every quantity is an
integer, so the tolerance is exact equality.
"""

import random

import pytest
import torch

from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_core as jcore
from test_torch_core import (CPU, PATTERNS, WIDE_ALPHA, _full,  # noqa: F401
                             assert_same_core, jax_caps)

from sregex_tpu_torch.ops import core as tcore

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


def _datasets(rng, benign, adv, planted):
    d = bytes(rng.choice(benign) for _ in range(3000))
    return [
        d,
        d[:1500] + planted + d[1500:],
        bytes(rng.choice(adv) for _ in range(2000)),
        (bytes(rng.choice(adv) for _ in range(97))
         + bytes(rng.choice(benign) for _ in range(61))) * 12 + b"tail",
        planted,
        b"",
    ]


@pytest.mark.parametrize("idx", range(len(PATTERNS)))
def test_legacy_results_equal_jax_and_native(jax_caps, idx):
    pattern, benign, adv, planted = PATTERNS[idx]
    dfa = _full(pattern)
    native = NativeDfa(dfa)
    rng = random.Random(len(pattern))
    sample = bytes(rng.choice(benign) for _ in range(20000))
    jct = jcore.CoreTables(dfa, sample)
    tct = tcore.CoreTables(dfa, sample, device=CPU)
    assert_same_core(tct, jct)
    for data in _datasets(rng, benign, adv, planted):
        exp_first, exp_state = native.scan_first(data, 0)
        got = tcore.core_scan_bytes(tct, data, chunk_len=256)
        assert got == jcore.core_scan_bytes(jct, data, chunk_len=256)
        assert got == (exp_state, exp_first), len(data)
        assert tct.last_repair == jct.last_repair
        exp_cnt, exp_st = native.count(data, 0)
        got = tcore.core_count_bytes(tct, data, chunk_len=256)
        assert got == jcore.core_count_bytes(jct, data, chunk_len=256)
        assert got == (exp_st, exp_cnt), len(data)
        assert tct.last_repair == jct.last_repair


def test_legacy_escapes_at_chunk_edges_equal_jax_and_native(jax_caps):
    """tests/test_pallas_core.py's chunk-edge fuzz: 64-byte chunks and
    escapes at any byte, the chunk-final byte included (an escaped
    chunk with clean counts that only its ESC exit betrays)."""
    dfa = _full(b"a{60,120}b")
    native = NativeDfa(dfa)
    rng = random.Random(99)
    sample = bytes(rng.choice(b"ab xx") for _ in range(20000))
    jct = jcore.CoreTables(dfa, sample)
    tct = tcore.CoreTables(dfa, sample, device=CPU)
    repaired = 0
    for trial in range(8):
        parts = []
        for _ in range(rng.randrange(2, 30)):
            parts.append(b"x" * rng.randrange(0, 70))
            parts.append(b"a" * rng.randrange(0, 130))
            if rng.random() < 0.3:
                parts.append(b"b")
        data = b"".join(parts)
        exp_first, exp_state = native.scan_first(data, 0)
        got = tcore.core_scan_bytes(tct, data, chunk_len=64)
        assert got == jcore.core_scan_bytes(jct, data, chunk_len=64)
        assert got == (exp_state, exp_first), trial
        assert tct.last_repair == jct.last_repair
        exp_cnt, exp_st = native.count(data, 0)
        got = tcore.core_count_bytes(tct, data, chunk_len=64)
        assert got == jcore.core_count_bytes(jct, data, chunk_len=64)
        assert got == (exp_st, exp_cnt), trial
        assert tct.last_repair == jct.last_repair
        repaired += tct.last_repair[0]
    assert repaired > 0


def test_legacy_entry_state_and_wide_inner():
    """A nonzero full entry state in the core, and the 8-bit wide inner
    of the 18-literal machine: exact against the native engine."""
    dfa = _full(WIDE_ALPHA)
    native = NativeDfa(dfa)
    rng = random.Random(11)
    sample = bytes(rng.choice(b"abcdefghijklmnopqrz ") for _ in range(20000))
    tct = tcore.CoreTables(dfa, sample, device=CPU)
    assert tct.inner.bits == 8
    data = sample[:9000] + b"fzz" + sample[9000:15000] + b"qzz" \
        + sample[15000:]
    _, entry = native.count(b"qz", 0)
    assert tct.to_core_premult(entry) >= 0
    for e in (0, entry):
        exp_c, exp_st = native.count(data, e)
        assert tcore.core_count_bytes(tct, data, chunk_len=256,
                                      entry_state=e) == (exp_st, exp_c)
        exp_f, exp_s = native.scan_first(data, e)
        assert tcore.core_scan_bytes(tct, data, chunk_len=256,
                                     entry_state=e) == (exp_s, exp_f)
