"""The port's big tier (ops/big.py) against the JAX package's
(ops/pallas_big.py in interpret mode on the CPU mesh, as its own tests
run it) on tests/test_torch_big.py's machines: the planes and summary
of the kernel's plain version and of the 16-bit walk's model
(big16_ref), and spec_scan_bytes / spec_count_bytes against the JAX
package's and the native engine.  Each machine's scans share its two
interpret-mode programs (COUNT and scan), which no case of
tests/test_torch_big.py compiles, so they run in a file of their own,
scheduled beside the longest JAX files.  B = 1 and K = 256 throughout;
every quantity is an integer, so the tolerance is exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_scan as jscan
from test_torch_big import CASES, CHUNK, DICT20, tiers  # noqa: F401

from sregex_tpu_torch.ops import big as tbig
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.layout import GROUPS, TILE

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


def _in_range_inputs(rng, tables, W):
    """Packed words of classes below ncls, valid premultiplied entry
    states and random warmup freezes j0 in [0, W]."""
    bits, cpw = tables.bits, tables.cpw
    Jw = (W + CHUNK) // cpw
    shape = (1, Jw, GROUPS, 8, 128)
    cls = rng.integers(0, tables.ncls, shape + (cpw,), dtype=np.int64)
    words = np.zeros(shape, np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    data = words.astype(np.uint32).view(np.int32)
    planes = (1, GROUPS, 8, 128)
    state0 = (rng.integers(0, tables.nstates, planes)
              * tables.ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, planes).astype(np.int32)
    return data, state0, j0


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("count", [True, False])
def test_planes_and_summary_match_jax(tiers, name, count):
    jt, tt, _ = tiers[name]
    W = tt.warmup
    rng = np.random.default_rng(len(name) + 11 * count)
    data, state0, j0 = _in_range_inputs(rng, tt, W)
    Cp = GROUPS * TILE
    C, bad_tail = Cp - 21, 777
    j_sum, j_packed = jt._scan(jnp.asarray(data), jnp.asarray(state0),
                               jnp.asarray(j0), jnp.int32(C),
                               jnp.int32(bad_tail), W + CHUNK, W,
                               COUNT=count)
    t = [torch.from_numpy(a.copy()) for a in (data, state0, j0)]
    t_sum, t_packed = tt._scan(t[0], t[1], t[2], C, bad_tail, W,
                               COUNT=count)
    assert np.array_equal(np.asarray(j_sum), t_sum.numpy())
    assert t_packed.dtype == torch.int32
    assert np.array_equal(np.asarray(j_packed), t_packed.numpy())

    phi, fm, swarm = tbig.big_scan_ref(t[0], t[1], t[2], tt.fused, W=W,
                                       CPW=tt.cpw, BITS=tt.bits,
                                       COUNT=count)
    jphi, jfm, jswarm = jscan._unpack(j_packed, Cp)
    assert np.array_equal(phi.reshape(-1).numpy(), jphi)
    assert np.array_equal(fm.reshape(-1).numpy(), jfm)
    assert np.array_equal(swarm.reshape(-1).numpy(), jswarm)
    assert (j0 == 0).any() and (j0 >= W).any()
    # the 16-bit kernel's walk
    planes = tbig.big16_ref(t[0], t[1], t[2], tt.fused, tt.t16, W=W,
                            CPW=tt.cpw, BITS=tt.bits, COUNT=count)
    for got, want in zip(planes, (jphi, jfm, jswarm)):
        assert np.array_equal(got.reshape(-1).numpy(), want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_results_match_jax_and_native(tiers, name):
    jt, tt, dfa = tiers[name]
    _, alphabet, planted = CASES[name]
    planted = planted or b" " + DICT20[7] + b" "
    native = NativeDfa(dfa)
    rng = random.Random(len(name))
    for trial in range(2):
        n = rng.choice([900, 2500])
        data = bytes(rng.choice(alphabet) for _ in range(n))
        if trial == 0:
            data = data[:n // 2] + planted + data[n // 2:]
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
