"""The port's exact transfer-composition tier (ops/phi.py) against the
JAX package's (ops/pallas_phi.py, its Pallas kernels in interpret mode
on the CPU mesh, as its own tests run them) and the native engine:
_phi_dispatch's summaries for COUNT and scan on both layouts, 4- and
8-bit words, and phi_count_bytes / phi_scan_bytes on
tests/test_pallas_phi.py's machines (tests/test_torch_phi.py's CASES and
BIG_CASES).  These are the interpret-mode programs of the tier's tests;
they run in a file of their own, scheduled beside the longest JAX
files.  Small corpora and chunk_len=512 keep the compiles few (one per
machine, mode and block count); every quantity is an integer, so the
tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_phi as jphi
from test_torch_phi import (BIG_CASES, CASES, CHUNK, MACHINES, WIDE_ALPHA,
                            _corpus, _one_block, _pair)

from sregex_tpu_torch.ops import phi as tphi

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


SUMMARY_CASES = [(name, count) for name in ("lane-parity", "lane-8bit",
                                            "big-137")
                 for count in (True, False)]


@pytest.mark.parametrize("name,count", SUMMARY_CASES)
def test_summaries_equal_the_jax_dispatch(name, count):
    jt, tt, _ = _pair(MACHINES[name])
    alpha = WIDE_ALPHA if name == "lane-8bit" else b"aaaaaaab"
    n = _one_block(tt) - 300             # a ragged tail: C*K < n
    data = _corpus(alpha, n, 5)
    jp = jphi.phi_prepare(jt, data, CHUNK)
    tp = tphi.phi_prepare(tt, data, CHUNK)
    C = tp[1]
    assert C * CHUNK < n
    for c in (C, C - 3, 1):
        for entry in (0, 1, tt.nstates - 1):
            want = np.asarray(jphi._phi_dispatch(jt, jp, c, entry, count))
            got = tphi._phi_dispatch(tt, tp, c, entry, count)
            assert got.dtype == np.int64
            assert np.array_equal(got, want.astype(np.int64)), (c, entry)


@pytest.mark.parametrize("pat,alpha", CASES + BIG_CASES,
                         ids=[repr(p) for p, _ in CASES + BIG_CASES])
def test_results_equal_jax_and_native(pat, alpha):
    jt, tt, d = _pair(pat)
    native = NativeDfa(d)
    top = min(20_000, _one_block(tt))
    for n, entry in [(top, 0), (4096, 2), (63, 0), (0, 0), (2049, 1),
                     (top - 1, 77)]:
        entry = entry % tt.nstates
        data = _corpus(alpha, n, n + entry)
        want = native.count(data, entry)[::-1]
        got = tphi.phi_count_bytes(tt, data, chunk_len=CHUNK,
                                   entry_state=entry)
        assert got == want, (n, entry)
        assert got == jphi.phi_count_bytes(jt, data, chunk_len=CHUNK,
                                           entry_state=entry)
        assert tt.last_repair == jt.last_repair
        f, st = native.scan_first(data, entry)
        got = tphi.phi_scan_bytes(tt, data, chunk_len=CHUNK,
                                  entry_state=entry)
        assert got == (st, f), (n, entry)
        assert got == jphi.phi_scan_bytes(jt, data, chunk_len=CHUNK,
                                          entry_state=entry)
        assert tt.last_repair == jt.last_repair
