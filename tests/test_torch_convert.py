"""spec_tables_from_jax / prepared_from_jax: the JAX package's tables
and prepared corpus, handed over as numpy, give the port's own tables
and a corpus the port scans to the JAX result (exact equality)."""

import numpy as np
import pytest
import torch

from sregex_tpu import compile_regex, parse, parse_multi
from sregex_tpu.dfa import build_dfa
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.pallas_pair import SpecTablesPair as JaxPair

from sregex_tpu_torch.convert import prepared_from_jax, spec_tables_from_jax
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.pair import SpecTablesPair

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


CPU = torch.device("cpu")


def _dfa(pattern):
    if isinstance(pattern, list):
        ast, _ = parse_multi(pattern)
    else:
        ast, _ = parse(pattern)
    return build_dfa(compile_regex(ast))


def _arrays(jt):
    """What a caller hands over: every array as a writable numpy copy."""
    out = {k: getattr(jt, k) for k in ("cpw", "bits", "warmup", "rows",
                                       "bpu", "byte_ncls")
           if hasattr(jt, k)}
    for k in ("fused_vec", "fused_rows"):
        v = getattr(jt, k, None)
        if v is not None:
            out[k] = np.asarray(v).copy()
    return out


CASES = {
    "narrow": ("(?:a|b)aa(?:aa|bb)cc(?:a|b)", jscan.SpecTables,
               tscan.SpecTables),
    "wide-4bit": ("a{60}b", jscan.SpecTablesWide, tscan.SpecTablesWide),
    "wide-8bit": ([b"abcd", b"efgh", b"ijkl", b"mnop"],
                  jscan.SpecTablesWide, tscan.SpecTablesWide),
    "pair-narrow": ("abc", JaxPair, SpecTablesPair),
    "pair-wide": ("abcde", JaxPair, SpecTablesPair),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_from_jax_equal_the_ports_own(case):
    pattern, jcls, tcls = CASES[case]
    dfa = _dfa(pattern)
    jt = jcls(dfa)
    own = tcls(dfa, CPU)
    got = spec_tables_from_jax(_arrays(jt), dfa, CPU)
    assert type(got) is type(own)
    assert torch.equal(got.fused, own.fused)
    for k in ("nstates", "ncls", "cpw", "bits", "warmup", "rows",
              "max_chunk", "wide"):
        assert getattr(got, k) == getattr(own, k), k
    for k in ("bpu", "byte_ncls"):
        assert getattr(got, k, None) == getattr(own, k, None), k
    assert np.array_equal(got.class_map, own.class_map)
    if case == "pair-wide":
        assert own.wide and own.rows > 1


def test_tables_from_jax_rejects_rows_that_are_not_broadcast():
    dfa = _dfa("abc")
    arrays = _arrays(jscan.SpecTables(dfa))
    arrays["fused_vec"][3, 5] += 1
    with pytest.raises(ValueError, match="broadcast"):
        spec_tables_from_jax(arrays, dfa, CPU)


def test_prepared_from_jax_scans_to_the_jax_result():
    dfa = _dfa("ab")
    jt = jscan.SpecTables(dfa)
    tt = spec_tables_from_jax(_arrays(jt), dfa, CPU)
    rng = np.random.default_rng(9)
    data = rng.choice(np.frombuffer(b"aabbc", np.uint8), 5000).tobytes()
    jp = jscan._prepare(jt, data, 240)
    prepared = prepared_from_jax(np.asarray(jp[0]).copy(), *jp[1:],
                                 device=CPU)
    got = tscan.spec_count_bytes(tt, data, chunk_len=240,
                                 prepared=prepared)
    assert got == jscan.spec_count_bytes(jt, data, chunk_len=240,
                                         prepared=jp)
    assert got[1] == data.count(b"ab")
