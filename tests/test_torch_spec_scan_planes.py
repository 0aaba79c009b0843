"""The port's scan against the JAX package's Pallas scan (interpret mode
on the CPU mesh, as the JAX package's own tests run it), on
tests/test_torch_spec_scan.py's narrow, wide and pair tables.

Planes: on identical packed inputs and entry planes, the port's plain
kernel (spec_scan_ref, which the wrapper takes for CPU tensors) and the
two-code kernel's walk over its host-built table (spec_pair_ref) give
the JAX kernel's phi/fm/swarm, and the torch summary and repair planes
equal JAX's _summarize output.  Results: spec_scan_bytes and
spec_count_bytes equal the JAX package's and the native C++ engine.
The results reuse the planes' interpret-mode programs (B=1 and K=256
everywhere); none of them is compiled by tests/test_torch_spec_scan.py,
so they run in a file of their own, scheduled beside the longest JAX
files.  Inputs come from numpy's seeded generator; the tolerance is
exact equality (every quantity is an integer).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_scan as jscan
from test_torch_spec_scan import CHUNK, CPU, _dfa, tiers  # noqa: F401

from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, TILE

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


def _random_inputs(rng, tables, W_units):
    """Packed words of random classes in [0, 2**BITS) (past ncls too,
    so out-of-table indices are exercised), valid premultiplied entry
    states and random warmup freezes j0 in [0, W]."""
    bits, cpw = tables.bits, tables.cpw
    Jw = (W_units + CHUNK // getattr(tables, "bpu", 1)) // cpw
    shape = (1, Jw, GROUPS, 8, 128)
    cls = rng.integers(0, 1 << bits, shape + (cpw,), dtype=np.int64)
    words = np.zeros(shape, np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    data = words.astype(np.uint32).view(np.int32)
    planes = (1, GROUPS, 8, 128)
    state0 = (rng.integers(0, tables.nstates, planes)
              * tables.ncls).astype(np.int32)
    j0 = rng.integers(0, W_units + 1, planes).astype(np.int32)
    return data, state0, j0


# (tier, COUNT, warmup in bytes); W=128 runs the narrow kernel with a
# warmup four times the default
PLANE_CASES = [("narrow", True, 32), ("narrow", False, 32),
               ("narrow", False, 128), ("wide", True, 16),
               ("wide", False, 16), ("pair", True, 64),
               ("pair", False, 64)]


@pytest.mark.parametrize("tier,count,W", PLANE_CASES)
def test_planes_and_summary_match_jax(tiers, tier, count, W):
    jt, tt, _ = tiers[tier]
    bpu = getattr(tt, "bpu", 1)
    rng = np.random.default_rng(W + 7 * count + len(tier))
    data, state0, j0_units = _random_inputs(rng, tt, W // bpu)
    j0 = j0_units * bpu                        # _scan takes bytes
    Cp = GROUPS * TILE
    C, bad_tail = Cp - 37, 1234
    J = W + CHUNK
    j_sum, j_packed = jt._scan(jnp.asarray(data), jnp.asarray(state0),
                               jnp.asarray(j0), jnp.int32(C),
                               jnp.int32(bad_tail), J, W, COUNT=count)
    t = [torch.from_numpy(a.copy()) for a in (data, state0, j0)]
    t_sum, t_packed = tt._scan(t[0], t[1], t[2], C, bad_tail, W,
                               COUNT=count)
    assert t_sum.dtype == torch.int32
    assert np.array_equal(np.asarray(j_sum), t_sum.numpy())
    assert t_packed.dtype == (torch.int32 if tt.wide else torch.uint8)
    assert np.array_equal(np.asarray(j_packed), t_packed.numpy())

    # the raw planes of the plain kernel against the JAX kernel's
    phi, fm, swarm = tscan.spec_scan_ref(
        t[0], t[1], t[2] // bpu, tt.fused, W=W // bpu, CPW=tt.cpw,
        BITS=tt.bits, COUNT=count)
    jphi, jfm, jswarm = jscan._unpack(j_packed, Cp)
    assert np.array_equal(phi.reshape(-1).numpy(), jphi)
    assert np.array_equal(fm.reshape(-1).numpy(), jfm)
    assert np.array_equal(swarm.reshape(-1).numpy(), jswarm)
    # the two-code kernel's walk, where its tier takes it
    assert (tt.pair is not None) == (tier != "wide")
    if tt.pair is not None:
        planes = tscan.spec_pair_ref(
            t[0], t[1], t[2] // bpu, tt.fused, tt.pair, W=W // bpu,
            CPW=tt.cpw, BITS=tt.bits, COUNT=count)
        for got, want in zip(planes, (jphi, jfm, jswarm)):
            assert np.array_equal(got.reshape(-1).numpy(), want)
    # the random freezes reach both ends: some streams never move in
    # the warmup, some move in all of it
    assert (j0_units == 0).any() and (j0_units >= W // bpu).any()


def _plant(rng, n, alphabet, word, at):
    pool = np.frombuffer(alphabet, np.uint8)
    buf = bytearray(rng.choice(pool, n).tobytes())
    if word is not None:
        buf[at:at + len(word)] = word
    return bytes(buf)


# (tier or pattern, alphabet, planted word, position, corpus length)
RESULT_CASES = {
    "headline-planted": ("narrow", b"abc", b"xaaabbccb", 40000, 70000),
    "headline-none": ("narrow", b"abc", None, 0, 70000),
    "anchored-A": (r"\Aab", b"abc", b"ab", 0, 9000),
    "anchored-A-late": (r"\Aab", b"abc", b"ab", 3000, 9000),
    "miss-x-then-z": ("x[^y]*z", b"ab", b"x", 100, 6000),
    "straddle": ("abcdef", b"xyz", b"abcdef", 3 * CHUNK - 3, 5000),
    "empty": ("narrow", b"abc", None, 0, 0),
    "wide-planted": ("wide", b"aeimxy ", b"efgh", 4000, 9000),
    "pair-planted": ("pair", b"abx", b"abc", 5000, 9000),
}


@pytest.mark.parametrize("case", sorted(RESULT_CASES))
def test_results_match_jax_and_native(tiers, case):
    what, alphabet, word, at, n = RESULT_CASES[case]
    if what in tiers:
        jt, tt, dfa = tiers[what]
    else:
        dfa = _dfa(what)
        jt, tt = jscan.SpecTables(dfa), tscan.SpecTables(dfa, CPU)
    data = _plant(np.random.default_rng(n + at), n, alphabet, word, at)
    if case == "miss-x-then-z":
        data = data[:n - 50] + b"z" + data[n - 49:]
    native = NativeDfa(dfa)
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
    if case == "miss-x-then-z":
        assert tt.last_repair[0] > 1      # speculation really missed
    if case.endswith("planted") or case == "straddle":
        assert exp_first >= 0
