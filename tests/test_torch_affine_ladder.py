"""The port's piecewise-affine tier against the JAX package's
(ops/pallas_affine.py in interpret mode on the CPU mesh, as its own
tests run it): the warmup ladder of the port's Scanner against the JAX
Scanner's, and the plane and result cases of the chained and digit
machines of tests/test_torch_affine.py's CASES.  They share no
interpret-mode JAX program with that file's machines, so they run here
to balance the test workers.  Every quantity is an integer, so the
tolerance is exact equality.
"""

import random

import pytest
import torch

from sregex_tpu import compile_regex, parse
from sregex_tpu import stream as jstream
from sregex_tpu.native import NativeDfa
from test_torch_affine import (LADDER_FILE_MACHINES, PLANE_CASES, make_tiers,
                               planes_and_summary_match_jax,
                               results_match_jax_and_native)

from sregex_tpu_torch import stream as tstream

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiers():
    return make_tiers(LADDER_FILE_MACHINES)


@pytest.mark.parametrize("name,count", [
    c for c in PLANE_CASES if c[0] in LADDER_FILE_MACHINES])
def test_planes_and_summary_match_jax(tiers, name, count):
    planes_and_summary_match_jax(tiers, name, count)


@pytest.mark.parametrize("name", sorted(LADDER_FILE_MACHINES))
def test_results_match_jax_and_native(tiers, name):
    results_match_jax_and_native(tiers, name)


def _long_runs(n, seed):
    """tests/test_pallas_affine.py::test_affine_warmup_escalation_window's
    corpus: runs of 300-519 a's, each closed by a b."""
    rng = random.Random(seed)
    data = bytearray()
    while len(data) < n:
        data += b"a" * rng.randrange(300, 520) + b"b"
    return bytes(data[:n])


def test_ladder_escalates_as_the_jax_scanner_does():
    ast, _ = parse(rb"a{400,499}b")
    prog = compile_regex(ast)
    data = _long_runs(150_000, 9)
    jsc = jstream.Scanner(prog, use_device=True, ast=ast)
    tsc = tstream.Scanner(prog, device="cpu", ast=ast)
    jsc.DEVICE_THRESHOLD = tsc.DEVICE_THRESHOLD = 1 << 12
    native = NativeDfa(tsc.dfa)
    k, st = native.count(data, 0)
    exp = k + int(tsc.dfa.match_eof[st])
    seen = []
    for _ in range(5):
        assert tsc.count(data) == jsc.count(data) == exp
        ts, js = tsc.stats(), jsc.stats()
        assert (ts.tier, ts.chunks, ts.repaired, ts.warm_events) == \
            (js.tier, js.chunks, js.repaired, js.warm_events)
        assert tsc._spec.warmup == jsc._spec.warmup
        seen.append(tsc._spec.warmup)
    assert seen == [32, 128, 128, 512, 512]
    assert ts.tier == "SpecTablesAffine"
    assert ts.repaired <= 1 and ts.warm_events == 2
    # scan and match ride the escalated tables
    assert tsc.scan(data) == jsc.scan(data)
    assert tsc.stats().repaired == 0 and tsc.stats().warm_events == 2


def test_ladder_stops_at_its_last_rung():
    sc = tstream.Scanner(compile_regex(parse(rb"a{400,499}b")[0]),
                         device="cpu")
    for w in (128, 512, 2048):
        assert sc._escalate_warmup() and sc._spec.warmup == w
    assert not sc._escalate_warmup()
    assert sc._warm_escalations == 3 and sc._spec.warmup == 2048
