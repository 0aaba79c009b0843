"""Smoke run of sregex_tpu_torch on one CUDA card (run: python3 chip_smoke.py).

Builds the CUDA scan kernel from this checkout, holds it against its
plain torch version, then drives the port's main path at full size:
the headline scan (bench.py's 1920 MB corpus and pattern) and the
90-keyword Scanner.count (bench.py's bench_multi corpus), each checked
against the native C++ engine.  Every phase prints one line; any
failure raises, so the script exits non-zero without the final line.

Output, in order: one line per phase, the card's name and power limit
as nvidia-smi reports them, a JSON line {"kernels": [...]} with each
kernel's launches on the main path, its largest difference from the
plain version, and its time beside the plain version's at the main
path's shapes, and last {"ok": true, "device": {...}}.

SREGEX_BENCH_MB and SREGEX_BENCH_MULTI_MB size the two corpora
(default 1920 each, as in bench.py).
"""

import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

import sregex_tpu_torch
from bench import MULTI_WORDS
from sregex_tpu_torch import Scanner, build_dfa, compile_regex, parse
from sregex_tpu_torch.ops import _build
from sregex_tpu_torch.ops import spec_scan as scan
from sregex_tpu_torch.ops.layout import GROUPS
from sregex_tpu_torch.ops.pair import SpecTablesPair
from sregex_tpu_torch.ops.prep import prepare_on_device
from sregex_tpu_torch.ops.spec_scan import spec_scan_ref

HEADLINE = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"
KERNEL_SRC = "sregex_tpu_torch/csrc/spec_scan.cu"
REPS = 5


def say(phase, **fields):
    print("%s: %s" % (phase, json.dumps(fields)), flush=True)


def max_abs_err(got, want):
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def compare(args, kw):
    """Kernel vs plain version on the same inputs: bit-exact planes."""
    got = scan.spec_scan(*args, **kw)
    torch.cuda.synchronize()
    want = spec_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError("kernel differs from plain version by %d "
                             "(%r)" % (err, kw))
    return err


def random_case(rng, dev, *, bits, rows, W, count, B=2, G=8, K=512):
    """Random packed words (classes up to 2**bits, past the table too),
    a random table of rows*128 valid entries, valid entry states and
    random warmup freezes."""
    cpw = {3: 10, 4: 8, 8: 4}[bits]
    K = K // (2 * cpw) * (2 * cpw)      # whole loop iterations
    Jw = (W + K) // cpw
    words = rng.integers(0, 1 << 32, (B, Jw, G, 8, 128), dtype=np.uint64)
    data = words.astype(np.uint32).view(np.int32)
    ncls = min(1 << bits, 16)
    S = rows * 128 // ncls
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 3, rows * 128) << 20).astype(np.int32)
    s0 = (rng.integers(0, S, (B, G, 8, 128)) * ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (data, s0, j0, table)]
    return args, dict(W=W, CPW=cpw, BITS=bits, COUNT=count)


def time_gpu(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def min_rep_seconds(fn, check):
    """min over REPS of host time around a call that reads its value
    back, with a device synchronise inside the timed region."""
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        check(got)
    return min(times)


def headline_corpus(mb):
    body = b"abccc" * (1024 * 1024 * (mb // 5))
    ofs = (len(body) * 255 // 256) // 5 * 5 + 2
    return body[:ofs] + b"xaaabbccb" + body[ofs + 9:]


def multi_corpus(mb, words):
    """bench.py bench_multi's corpus: disjoint filler, a dictionary word
    planted every 64 KB."""
    rng = random.Random(1234)
    filler = [w.encode() for w in
              ("alpha bravo delta golf hotel juliet kilo lima mike "
               "november oscar papa quebec romeo sierra tango uniform "
               "victor whiskey xray yankee zulu").split()]
    piece = b" ".join(rng.choice(filler) for _ in range(512)) + b" "
    body = piece * (mb * (1 << 20) // len(piece) + 1)
    out = bytearray(body[:mb << 20])
    step = 64 << 10
    for pos in range(step, len(out) - 64, step):
        w = words[rng.randrange(len(words))]
        out[pos:pos + len(w) + 2] = b" " + w + b" "
    return bytes(out)


def main():
    t_start = time.perf_counter()
    # --- 1. environment -------------------------------------------------
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA card: "
                           "torch.cuda.is_available() is False")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=kind,
        count=torch.cuda.device_count())

    # --- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    kernel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the native engine is the oracle and the repair path; without it
    # NativeDfa walks the corpus in Python, far past the time limit
    if sregex_tpu_torch.compile_pattern("a")._native.lib is None:
        raise RuntimeError("the native host engine (csrc/sre_host.cpp) "
                           "did not build: g++ is needed")
    say("build", seconds=kernel_s, compiled=_build.build_seconds is not None,
        native_seconds=time.perf_counter() - t0)
    if _build.build_log:
        print(_build.build_log.strip(), flush=True)

    # --- 3. kernel vs plain on the card -----------------------------------
    rng = np.random.default_rng(2026)
    errs = {"narrow": 0, "wide": 0}
    cases = [("narrow", dict(bits=4, rows=1, W=32, count=True)),
             ("narrow", dict(bits=4, rows=1, W=128, count=False)),
             ("narrow", dict(bits=3, rows=1, W=40, count=False)),
             ("narrow", dict(bits=8, rows=1, W=16, count=True)),
             ("wide", dict(bits=8, rows=3, W=16, count=False)),
             ("wide", dict(bits=8, rows=98, W=16, count=True)),
             ("wide", dict(bits=8, rows=98, W=128, count=False))]
    for tier, case in cases:
        args, kw = random_case(rng, dev, **case)
        errs[tier] = max(errs[tier], compare(args, kw))
    # the pair tier's own tables on a pair-packed corpus, COUNT and OR
    ast, _ = parse("abc")
    pt = SpecTablesPair(build_dfa(compile_regex(ast)), dev,
                        narrow_only=True)
    corpus = rng.choice(np.frombuffer(b"abcx", np.uint8),
                        3 << 20).tobytes()
    packed, _, _, _, B = prepare_on_device(pt, corpus, 2048)
    s0, j0 = scan._entry_planes(0, pt.warmup // 2, B, dev)
    for count in (True, False):
        errs["narrow"] = max(errs["narrow"], compare(
            [packed, s0, j0, pt.fused],
            dict(W=pt.warmup // 2, CPW=pt.cpw, BITS=pt.bits,
                 COUNT=count)))
    say("kernel_vs_plain", cases=len(cases) + 2, groups=GROUPS,
        max_abs_err=max(errs.values()))
    del packed, s0, j0

    # --- 4. headline: the main path, launches counted from here -----------
    mb = int(os.environ.get("SREGEX_BENCH_MB", "1920"))
    corpus = headline_corpus(mb)
    n = len(corpus)
    ast, _ = parse(HEADLINE)
    prog = compile_regex(ast)
    dfa = build_dfa(prog)
    sc = Scanner(prog, device=dev, ast=ast)
    t0 = time.perf_counter()
    exp_first, _ = sc._native.scan_first(corpus, 0)
    k, st = sc._native.count(corpus, 0)
    exp_count = k + int(dfa.match_eof[st])
    native_s = time.perf_counter() - t0
    assert exp_first > 0
    tables = scan.SpecTables(dfa, dev)
    assert type(sc._spec) is scan.SpecTables

    torch.cuda.reset_peak_memory_stats()
    scan.spec_scan_launches = 0
    t0 = time.perf_counter()
    prepared = prepare_on_device(tables, corpus, 2048)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0

    def check_first(r):
        if r[1] != exp_first:
            raise AssertionError("offset %r != native %r" % (r[1],
                                                           exp_first))

    def check_total(got):
        if got != exp_count:
            raise AssertionError("count %r != native %r" % (got,
                                                          exp_count))

    def check_count(r):
        check_total(r[1] + int(dfa.match_eof[r[0]]))

    check_first(scan.spec_scan_bytes(tables, corpus, prepared=prepared))
    check_count(scan.spec_count_bytes(tables, corpus, prepared=prepared))
    repaired, chunks = tables.last_repair
    dt = min_rep_seconds(lambda: scan.spec_scan_bytes(
        tables, corpus, prepared=prepared), check_first)
    sc_prep = sc.prepare(corpus)
    check_total(sc.count(corpus, prepared=sc_prep))
    st = sc.stats()
    if sc.scan(corpus, prepared=sc_prep)[1] != exp_first:
        raise AssertionError("Scanner.scan != native")
    if not sc.match(corpus, prepared=sc_prep):
        raise AssertionError("Scanner.match missed the planted match")
    sc_dt = min_rep_seconds(lambda: sc.count(corpus, prepared=sc_prep),
                            check_total)
    narrow_launches = scan.spec_scan_launches
    say("headline", mb=mb, bytes=n, offset=exp_first, count=exp_count,
        dfa_scan_gbps=n / dt / 1e9, scanner_count_gbps=n / sc_dt / 1e9,
        tier=st.tier, repaired=repaired, chunks=chunks,
        launches=narrow_launches, prep_s=prep_s, native_s=native_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    del sc_prep, sc

    # --- 5. multi: 90 keywords through Scanner.count ----------------------
    mmb = int(os.environ.get("SREGEX_BENCH_MULTI_MB", "1920"))
    pats = [w.encode() for w in MULTI_WORDS]
    msc = sregex_tpu_torch.compile_pattern(pats, device=dev)
    if type(msc._spec).__name__ != "SpecTablesWide":
        raise AssertionError("multi set served by %s"
                             % type(msc._spec).__name__)
    mcorpus = multi_corpus(mmb, pats)
    mn = len(mcorpus)
    t0 = time.perf_counter()
    k, st_ = msc._native.count(mcorpus, 0)
    mexp = k + int(msc.dfa.match_eof[st_])
    mnative_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    mprep = msc.prepare(mcorpus)
    t0 = time.perf_counter()
    if msc.count(mcorpus, prepared=mprep) != mexp:
        raise AssertionError("multi count != native %d" % mexp)
    first_s = time.perf_counter() - t0

    def check_multi(c):
        if c != mexp:
            raise AssertionError("multi rep %r != native %r" % (c, mexp))

    mdt = min_rep_seconds(lambda: msc.count(mcorpus, prepared=mprep),
                          check_multi)
    mst = msc.stats()
    total_launches = scan.spec_scan_launches
    wide_launches = total_launches - narrow_launches
    say("multi", mb=mmb, bytes=mn, count=mexp,
        multi_dfa_scan_gbps=mn / mdt / 1e9, tier=mst.tier,
        states=msc.dfa.nstates, classes=msc.dfa.nclasses,
        rows=msc._spec.rows, repaired=mst.repaired, chunks=mst.chunks,
        launches=wide_launches, first_call_s=first_s,
        native_s=mnative_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    if narrow_launches <= 0 or wide_launches <= 0:
        raise AssertionError("main path skipped the kernel: %d narrow, "
                             "%d wide launches"
                             % (narrow_launches, wide_launches))

    # --- 6. kernel vs plain time at the main path's shapes ----------------
    timings = {}
    shapes = [("narrow", tables, prepared[0], False),
              ("wide", msc._spec, mprep.for_tables(msc._spec)[0], True)]
    for tier, t, data, count in shapes:
        B = data.shape[0]
        s0, j0 = scan._entry_planes(0, t.warmup, B, dev)
        args = [data, s0, j0, t.fused]
        kw = dict(W=t.warmup, CPW=t.cpw, BITS=t.bits, COUNT=count)
        errs[tier] = max(errs[tier], compare(args, kw))
        ms = time_gpu(lambda: scan.spec_scan(*args, **kw), 20)
        plain_ms = time_gpu(lambda: scan.spec_scan_ref(*args, **kw), 2)
        timings[tier] = (ms, plain_ms, tuple(data.shape))
        say("kernel_time", tier=tier, shape=list(data.shape),
            count=count, ms=ms, plain_ms=plain_ms,
            kernel_gbps=(n if tier == "narrow" else mn) / ms / 1e6)
    say("done", seconds=time.perf_counter() - t_start)

    print(smi, flush=True)
    kernels = []
    for tier, line, launches in (("narrow", 267, narrow_launches),
                                 ("wide", 334, wide_launches)):
        ms, plain_ms, shape = timings[tier]
        kernels.append({
            "name": "spec_scan (%s table, shape %s)" % (tier, list(shape)),
            "route": "cuda", "source": KERNEL_SRC,
            "replaces": "sregex_tpu/ops/pallas_scan.py:%d" % line,
            "launches": launches, "max_abs_err": errs[tier],
            "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
