"""The port's batched dispatch against the JAX package's three
interpret-mode programs of tests/test_torch_batch.py's surface: the
narrow _batch_dispatch planes, _fused_batch on the 14-keyword set (the
JAX inputs carried across, escapes in document-start chunks) and
tdfa_find_many.  They run in a file of their own, scheduled beside the
longest JAX files.  Every quantity is an integer or bytes, so the
tolerance is exact equality; inputs come from seeded generators.
"""

import random

import numpy as np
import torch

from sregex_tpu import compile_regex as jax_compile_regex
from sregex_tpu import parse as jax_parse
from sregex_tpu.ops import batch as jbatch
from sregex_tpu.ops import pallas_core as jcore
from sregex_tpu.ops import pallas_scan as jscan
from sregex_tpu.ops.tdfa_scan import TdfaSpecTables as JaxTdfa
from sregex_tpu.ops.tdfa_scan import tdfa_find_many as jax_find_many
from test_torch_batch import (CPU, SIZES, _abutting, _docs, _kw_docs,
                              _kw_scanners, _machines)

from sregex_tpu_torch import compile_regex, parse
from sregex_tpu_torch.convert import core_tables_from_jax, prepared_from_jax
from sregex_tpu_torch.ops import batch as tbatch
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import spec_scan as tscan
from sregex_tpu_torch.ops.tdfa_scan import TdfaSpecTables, tdfa_find_many

# The tier-1 run puts several test workers on the machine's cores; torch's
# own intra-op threads would spin against them and make these small ops
# many times slower.
torch.set_num_threads(1)


def test_batch_planes_equal_jax():
    pattern = rb"(?:a|b)aa(?:aa|bb)cc(?:a|b)"
    tdfa, jdfa = _machines(pattern)
    tt, jt = tscan.SpecTables(tdfa, CPU), jscan.SpecTables(jdfa)
    docs = _docs(random.Random(11), b"abc x", b"baaaaccb", SIZES)
    tK, tspans, *tplanes = tbatch._batch_dispatch(tt, docs, 256, True)
    jK, jspans, *jplanes = jbatch._batch_dispatch(jt, docs, 256, True)
    assert (tK, tspans) == (jK, jspans)
    for got, want in zip(tplanes, jplanes):
        assert np.array_equal(got, np.asarray(want))


def test_fused_batch_equals_jax(monkeypatch):
    """_fused_batch on the JAX inputs (carried across) gives the JAX
    outputs, and _fused_batch_dispatch the JAX per-document summary."""
    sc, host, jsc, words = _kw_scanners()
    docs = _abutting(_kw_docs(words, n_docs=8, doc0_plant=True), words)
    jct = jsc._batch_fused_core(docs)
    assert jct is not None
    jfull = jsc._spec
    tct = core_tables_from_jax(jct, CPU)
    tfull = tscan.SpecTablesWide(jfull.dfa, CPU)
    seen = {}
    real = jcore._fused_batch

    def keep(*args, **kw):
        out = real(*args, **kw)
        seen["args"], seen["kw"], seen["out"] = args, kw, out
        return out

    monkeypatch.setattr(jcore, "_fused_batch", keep)
    jd = jbatch._fused_batch_dispatch(jct, jfull, docs, 512, None, None)
    assert jd is not None and jd["n_esc"] > 0
    (core_data, full_data, s01, j01, p2_j0, _cf, _ff, _h2f, C, doc_id,
     fullv, startv, last_full) = seen["args"]
    kw = seen["kw"]
    K, B1 = kw["K"], core_data.shape[0]

    def t(a):
        return torch.from_numpy(np.array(a))

    tcore_data = prepared_from_jax(np.array(core_data), int(C), K, 0, B1,
                                   CPU)[0]
    tfull_data = prepared_from_jax(np.array(full_data), int(C), K, 0, B1,
                                   CPU)[0]
    h2f = np.full(tct.H + 1, -1, dtype=np.int32)
    h2f[:tct.H] = tct.hot2full[:tct.H]
    got = tcore._fused_batch(
        tcore_data, tfull_data, t(s01), t(j01), t(p2_j0), tct.inner, tfull,
        torch.from_numpy(h2f), int(C), t(doc_id), t(fullv), t(startv),
        t(last_full), CAP=kw["CAP"], ESC=kw["ESC"], NDOCS=kw["NDOCS"])
    for g, w in zip(got, seen["out"]):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # the port's own dispatch over its own preps: the same summary
    td = tbatch._fused_batch_dispatch(tct, tfull, docs, 512, None, None)
    for key in ("K", "spans", "C", "all_ok", "n_esc", "overflow"):
        assert td[key] == jd[key], key
    assert np.array_equal(td["dcounts"], np.asarray(jd["dcounts"]))
    assert np.array_equal(td["dfinals"], np.asarray(jd["dfinals"]))
    # and the document-start escapes were redone on the device from the
    # seed: every chain validated, and every document's count is the
    # native count of its full chunks
    phi1 = td["packed_core"][0].numpy()
    assert all(phi1[td["spans"][i][0]] == tct.esc_premult for i in (3, 7))
    assert td["all_ok"]
    for i, (c0, cd, nd) in enumerate(td["spans"]):
        fcd = cd - 1 if cd * td["K"] > nd else cd
        if fcd:
            k, st = tct.native.count(docs[i][:fcd * td["K"]], 0)
            assert int(td["dcounts"][i]) == k
            assert int(td["dfinals"][i]) // tfull.ncls == st


def test_tdfa_find_many_equals_jax():
    pattern = rb"(\w+)@(\w+)"
    tt = TdfaSpecTables(compile_regex(parse(pattern)[0]), CPU)
    jt = JaxTdfa(jax_compile_regex(jax_parse(pattern)[0]))
    docs = _docs(random.Random(18), b"abc@12 .,", b"user@host", SIZES)
    docs += [b"a" * 300 + b"@" + b"b" * 700]    # a match across chunks
    got = tdfa_find_many(tt, docs, 256)
    want = jax_find_many(jt, docs, 256)
    assert got == [w if w in (None, "fallback") else (w[0], list(w[1]))
                   for w in want]
    assert any(g not in (None, "fallback") for g in got)
