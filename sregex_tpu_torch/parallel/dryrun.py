"""A quick check of the multi-device layer on tiny corpora.

dryrun_multichip(n, devices=None) builds a mesh of n devices and runs
five sharded scans, each against the native engine: the enumerative
scan (parallel/sharded_scan.py), the speculative static scan, the batched
count, the fused two-phase count and the piecewise-affine count.  These
are the checks and corpora of the JAX package's
__graft_entry__.dryrun_multichip.  ``devices`` lists the mesh's devices
(one device listed n times makes a virtual mesh); without it the mesh is
the first n CUDA devices, and fewer raise.
"""

import random

import torch

from ..compiler import compile_regex
from ..dfa import build_dfa
from ..native import NativeDfa
from ..ops.affine import SpecTablesAffine
from ..ops.batch import spec_count_many
from ..ops.core import CoreTables, core_count_fused
from ..ops.mesh import Mesh
from ..ops.scan import dfa_device_tables
from ..ops.spec_scan import (SpecTables, SpecTablesWide, spec_count_bytes,
                             spec_scan_bytes)
from ..parser import parse, parse_multi
from .sharded_scan import sharded_scan_bytes

HEADLINE = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"


def _check(name, got, want):
    if got != want:
        raise AssertionError("%s diverged: %r != %r" % (name, got, want))


def dryrun_multichip(n_devices, devices=None):
    """Run the five sharded checks over a mesh of ``n_devices``.  Returns
    {check: what was compared}; raises AssertionError on a divergence."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError("need %d devices, have %d CUDA devices (list "
                               "devices= for a virtual mesh)"
                               % (n_devices, have))
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError("%d devices listed for a mesh of %d"
                         % (len(devices), n_devices))
    mesh = Mesh(devices)
    dev = mesh.lead
    out = {}

    dfa = build_dfa(compile_regex(parse(HEADLINE)[0]))
    native = NativeDfa(dfa)
    corpus = (b"abccc" * 64 + b"aaabbccb") * n_devices
    state, end, rid = sharded_scan_bytes(dfa_device_tables(dfa, dev), corpus,
                                         mesh=mesh, chunk_len=64)
    if end < 0 or rid != 0:
        raise AssertionError("sharded scan: end %d, regex id %d" % (end, rid))
    _check("sharded scan", end, native.scan_first(corpus, 0)[0])
    out["sharded_scan"] = (state, end, rid)

    spec = SpecTables(dfa, dev)
    got = spec_scan_bytes(spec, corpus, chunk_len=64, mesh=mesh)
    _check("sharded spec scan", got, native.scan_first(corpus, 0)[::-1])
    out["spec_scan"] = got

    docs = [b"abccc" * 40 + b"aaabbccb", b"", b"abccc" * 7,
            b"aaabbccb" * 30]
    counts, finals, _, _ = spec_count_many(spec, docs, chunk_len=64,
                                           mesh=mesh)
    _check("batched count", list(zip(counts, finals)),
           [native.count(d, 0) for d in docs])
    out["count_many"] = counts

    rng = random.Random(2)
    words = sorted({("".join(rng.choice("abcdefghijklmn")
                             for _ in range(4))).encode()
                    for _ in range(14)})
    mdfa = build_dfa(compile_regex(parse_multi(words)[0]))
    try:
        mfull = SpecTables(mdfa, dev)
    except ValueError:
        mfull = SpecTablesWide(mdfa, dev)
    filler = [("".join(rng.choice("nopqrstuv") for _ in range(5))).encode()
              for _ in range(12)]
    piece = b" ".join(rng.choice(filler) for _ in range(64)) + b" "
    nbytes = 256 * 1024
    mcorp = bytearray((piece * (nbytes // len(piece) + 1))[:nbytes])
    for pos in range(4096, nbytes - 16, 4096):
        w = words[rng.randrange(len(words))]
        mcorp[pos:pos + len(w) + 2] = b" " + w + b" "
    mcorp = bytes(mcorp)
    mct = CoreTables(mdfa, mcorp[:64 << 10], require_fast=False,
                     no_pair=True, device=dev)
    got = core_count_fused(mct, mfull, mcorp, chunk_len=512, mesh=mesh)
    if got is None:
        raise AssertionError("the fused mesh count declined")
    _check("fused mesh count", got, NativeDfa(mdfa).count(mcorp, 0)[::-1])
    out["fused_count"] = got

    adfa = build_dfa(compile_regex(parse("a{60,120}b")[0]), max_states=65536)
    at = SpecTablesAffine(adfa, dev)
    arng = random.Random(3)
    acorp = bytearray()
    while len(acorp) < 64 * 1024:
        acorp += b"a" * arng.randrange(20, 140) \
            + arng.choice([b"b", b"x", b" "])
    acorp = bytes(acorp[:64 * 1024])
    got = spec_count_bytes(at, acorp, chunk_len=512, mesh=mesh)
    _check("affine mesh count", got, NativeDfa(adfa).count(acorp, 0)[::-1])
    out["affine_count"] = got
    return out
