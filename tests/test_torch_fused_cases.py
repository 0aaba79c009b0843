"""The port's fused two-phase core tier against the JAX package's
(ops/pallas_core.py in interpret mode on the CPU mesh): the overflow,
miss and big cases of tests/test_torch_fused.py's CASES, and the small
corpora and tail edges.  Each compiles its own interpret-mode JAX
program, so they run in a file of their own to balance the test
workers.  Every quantity is an integer, so the tolerance is exact
equality.
"""

import pytest
import torch

from sregex_tpu.native import NativeDfa
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan
from test_fused_count import _corpus, _multi_machine
from test_torch_core import assert_same_core, jax_caps  # noqa: F401
from test_torch_fused import (CASES_FILE_CASES, CPU, K, _dense_full,
                              _same_dispatch, case,  # noqa: F401
                              fused_count_summary_and_planes_equal_jax,
                              fused_phase2_reads_escaped_chunks_of_the_full_prep,
                              fused_results_equal_jax_and_native)

from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


@pytest.mark.parametrize("case", CASES_FILE_CASES, indirect=True)
def test_fused_count_summary_and_planes_equal_jax(case):
    fused_count_summary_and_planes_equal_jax(case)


@pytest.mark.parametrize("case", CASES_FILE_CASES, indirect=True)
def test_fused_results_equal_jax_and_native(case):
    fused_results_equal_jax_and_native(case)


@pytest.mark.parametrize("case", ["big"], indirect=True)
def test_fused_phase2_reads_escaped_chunks_of_the_full_prep(case):
    fused_phase2_reads_escaped_chunks_of_the_full_prep(case)


@pytest.fixture(scope="module")
def small_pair():
    dfa, words = _multi_machine(nwords=6, wordlen=4, seed=21)
    jfull, tfull = _dense_full(dfa)
    sample = _corpus(words, 32 << 10, seed=1)
    mp = pytest.MonkeyPatch()
    mp.setattr(tscan.SpecTablesWide, "MAX_ENTRIES",
               jscan.SpecTablesWide.MAX_ENTRIES)
    jct = jcore.CoreTables(dfa, sample, require_fast=False)
    tct = tcore.CoreTables(dfa, sample, require_fast=False, device=CPU)
    mp.undo()
    assert_same_core(tct, jct)
    return dfa, words, jct, tct, jfull, tfull


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 5000])
def test_fused_small_and_tail_edges_equal_jax_and_native(small_pair, n):
    dfa, words, jct, tct, jfull, tfull = small_pair
    native = NativeDfa(dfa)
    data = _corpus(words, n, seed=n + 1) if n else b""
    summ = _same_dispatch(jct, tct, jfull, tfull, data)
    assert (summ is None) == (n < K)
    got = tcore.core_count_fused(tct, tfull, data, chunk_len=K)
    assert got == jcore.core_count_fused(jct, jfull, data, chunk_len=K)
    exp_c, exp_st = native.count(data, 0)
    assert got == (exp_st, exp_c)
    got = tcore.core_scan_fused(tct, tfull, data, chunk_len=K)
    assert got == jcore.core_scan_fused(jct, jfull, data, chunk_len=K)
    exp_f, exp_fst = native.scan_first(data, 0)
    assert got == (exp_fst, exp_f)
