"""Smoke run of sregex_tpu_torch on one CUDA card (run: python3 chip_smoke.py).

Builds the CUDA kernels from this checkout, holds each against its
plain torch version, then drives the port's main paths at full size
through compile_pattern / Scanner, each checked against the native C++
engine:

  - headline: a first-match scan of one pattern over 1920 MB (the
    narrow tier, on the two-code kernel);
  - multi: Scanner.count of 90 keywords over a 1920 MB text corpus
    (the wide tier); beside it the same count by a Scanner with
    SREGEX_FUSED=1, the fused two-phase core tier, the TPU's route for
    this set (phase 2 on the gated kernel with the table in shared
    memory, the escaped chunks read in place), and that phase 2 timed;
  - lazy: Scanner.count of a.{13}b, past the eager DFA budget, over the
    multi corpus: the legacy core over the lazy machine (LazyCoreTables,
    escapes re-scanned on the lazy machine's native walkers), checked
    against the lazy machine's own count;
  - affine: Scanner.count and Scanner.scan of a base64-blob detector,
    [A-Za-z0-9+/]{400,499}=, over 1920 MB of log-like text with base64
    runs, after the warmup ladder has settled (the affine tier);
  - big: Scanner.count of a 500-keyword dictionary over the multi
    corpus with dictionary words planted (the static big tier, where the
    card's band keeps it, on the 16-bit shared-memory kernel);
  - core: Scanner.count and Scanner.scan of the same dictionary over the
    same corpus by a Scanner with SREGEX_FUSED=1, served by the fused
    two-phase core tier (phase 1 on a sampled core, phase 2 on the gated
    kernel's 16-bit route, the escaped chunks read in place), with its
    phase split; then the same with the device cap under the corpus's
    escapes, where the first count overflows and
    hands the machine to the static big tier; then Scanner.count of a
    machine with no static tier, a.{10}b|cdefghijklmnopqrstuvwxyz, over
    the same corpus (the legacy core, or the native engine where no
    core fits);
  - find: Scanner.find of a log-field extractor with two capture
    groups over 1920 MB of log lines full of near misses, one full
    match planted near the end (the tagged-DFA kernel, certified in one
    pass); then a 16 MB corpus whose one match spans 1.5 MB, past the
    chunk window and the chunk-repair budget, which the multi-pass path
    serves (the scan kernel forward, spec_scan_last_bytes on the
    reversed corpus, the Pike engine over the match);
  - phi: Scanner.count and Scanner.scan of the run-parity machine
    b(?:aa)*b over 1920 MB of a-runs, after two repair-heavy scans of a
    64 MB corpus have switched it from the pair tier to the exact
    transfer-composition tier (the lane-packed phi kernel);
  - phi_big: the same for b(?:a{499})*b, a residue mod 499 (501 states),
    after eight scans have climbed the warmup ladder 32 -> 128 -> 512 ->
    2048 and switched it from the affine tier (the sublane-group phi
    kernel).

Every phase prints one line; any failure raises, so the script exits
non-zero without the final line.  The kernel launch counts are set to
0 just before each path is driven and read just after it.

Output, in order: one line per phase, the card's name and power limit
as nvidia-smi reports them, a JSON line {"kernels": [...]} with each
kernel's launches on its main path, its largest difference from the
plain version, its time beside the plain version's and its bound at
the main path's shapes, and last {"ok": true, "device": {...}}.

SREGEX_BENCH_MB, SREGEX_BENCH_MULTI_MB, SREGEX_BENCH_AFFINE_MB,
SREGEX_BENCH_BIG_MB (the big and core phases), SREGEX_BENCH_FIND_MB,
SREGEX_BENCH_PHI_MB and SREGEX_BENCH_PHI_BIG_MB size the seven corpora
(default 1920 each).
"""

import contextlib
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

import sregex_tpu_torch
from sregex_tpu_torch import Scanner, build_dfa, compile_regex, parse
from sregex_tpu_torch.consts import sre_isword
from sregex_tpu_torch.dfa import LazyDfa
from sregex_tpu_torch.native_pike import NativePikeCtx
from sregex_tpu_torch.ops import _build
from sregex_tpu_torch.ops import affine as aff
from sregex_tpu_torch.ops import big
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import phi as tphi
from sregex_tpu_torch.ops import spec_scan as scan
from sregex_tpu_torch.ops import tdfa_scan as tdfa
from sregex_tpu_torch.ops.layout import GROUPS
from sregex_tpu_torch.ops.pair import SpecTablesPair
from sregex_tpu_torch.ops.prep import prepare_on_device
from sregex_tpu_torch.ops.spec_scan import spec_scan_ref

HEADLINE = "(?:a|b)aa(?:aa|bb)cc(?:a|b)"
BASE64_BLOB = "[A-Za-z0-9+/]{400,499}="
# 90 distinct keywords: the dictionary-matching shape of log scanning
MULTI_WORDS = """error warning failure timeout retry connect disconnect login
logout session token refresh expired invalid denied granted access request
response header payload buffer overflow underflow socket stream packet frame
segment router gateway proxy cache miss hit evict flush commit rollback begin
transaction deadlock conflict replica shard leader follower election heartbeat
snapshot compact merge split index query plan execute fetch cursor batch queue
topic partition offset consumer producer broker cluster node zone region
latency throughput quota limit throttle backoff jitter circuit breaker
fallback primary secondary standby failover recover restore backup archive
purge""".split()
# a log-field extractor: the status code and the user of a log line
FIND_PATTERN = rb"status=([0-9]+) user=([a-z_]+)"
# log lines, each with a near miss of FIND_PATTERN ("status=" not
# followed by digits, " user=" and a letter) and ending in a newline, so
# no line and no suffix of one completes a match
FIND_LINES = [b"2026-10-16T14:05:28Z INFO api status= user=x id=4127\n",
              b"2026-10-16T14:05:29Z WARN status=503 usr=bob retry=3\n",
              b"2026-10-16T14:05:30Z INFO status=200 user= cache=ok\n",
              b"2026-10-16T14:05:31Z DEBUG user=alice status= token\n",
              b"2026-10-16T14:05:32Z INFO status=5 user=9 q=GET\n"]
FIND_PLANT = b"2026-10-16T14:05:33Z ERROR status=404 user=bob_x path=/a\n"
# never-converging machines: the parity of an a-run, a residue mod 499
PHI_PATTERN = rb"b(?:aa)*b"
PHI_BIG_PATTERN = rb"b(?:a{499})*b"
PHI_BIG_PLAIN_MB = 64         # the big-phi plain version's slice
# past the big tier's 2**17 entries and not piecewise affine: no static
# tier accepts it
NO_TIER_PATTERN = "a.{10}b|cdefghijklmnopqrstuvwxyz"
# past the eager DFA budget: no dense machine, the lazy one serves
LAZY_PATTERN = rb"a.{13}b"
REPS = 5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
SCALAR_OPS_PER_S = 67e12      # H100 SXM, non-tensor 32-bit rate


def say(phase, **fields):
    print("%s: %s" % (phase, json.dumps(fields)), flush=True)


def mb_env(name):
    return int(os.environ.get(name, "1920"))


@contextlib.contextmanager
def env(name, value):
    """The environment variable ``name`` set to ``value`` inside the
    block, as it was after it."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def drop_preps(prepared, *tables):
    """Free a prepared corpus's preps for ``tables``, at every chunk
    length."""
    ids = {id(t) for t in tables}
    for key in [k for k in prepared._by_tables if k[0] in ids]:
        del prepared._by_tables[key]


def reset_launches():
    scan.spec_scan_launches = 0
    scan.pair_scan_launches = 0
    big.big_scan_launches = 0
    big.big_smem_launches = 0
    aff.affine_scan_launches = 0
    tdfa.tdfa_scan_launches = 0
    tphi.phi_scan_launches = 0
    tphi.phi_big_scan_launches = 0
    tcore.gated_scan_launches = 0
    for route in tcore.gated_route_launches:
        tcore.gated_route_launches[route] = 0


def max_abs_err(got, want):
    return max(int((g.long() - w.long()).abs().max()) for g, w in
               zip(got, want))


def compare(kernel, plain, args, kw, tables=None):
    """Kernel vs plain version on the same inputs: bit-exact planes.
    ``tables``: the kernel's own tables (pair=, t16=), which the plain
    version does not take."""
    got = kernel(*args, **kw, **(tables or {}))
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError("%s differs from its plain version by %d (%r)"
                             % (kernel.__name__, err, kw))
    return err


def random_words(rng, shape, bits, hi):
    """int32 words of CPW classes, each class drawn from [0, hi)."""
    cpw = {3: 10, 4: 8, 8: 4}[bits]
    cls = rng.integers(0, hi, shape + (cpw,), dtype=np.int64)
    words = np.zeros(shape, np.int64)
    for k in range(cpw):
        words |= cls[..., k] << (bits * k)
    return words.astype(np.uint32).view(np.int32)


def random_case(rng, dev, *, bits, rows, W, count, B=2, G=8, K=512,
                ncls=None, in_range=False, odd_entry=False, frozen=False,
                j0_odd=False):
    """Random packed words, a random table of rows*128 valid entries,
    valid entry states and random warmup freezes.  Classes run up to
    2**bits (past the table too) unless ``in_range``, which keeps them
    below ncls, so every index stays inside the table.  ``odd_entry``:
    a third of the entry states arbitrary (negative, past the table, off
    the ncls grid); ``frozen``: half the streams frozen through the
    whole warmup; ``j0_odd``: every freeze odd (inside a code pair)."""
    cpw = {3: 10, 4: 8, 8: 4}[bits]
    K = K // (2 * cpw) * (2 * cpw)      # whole loop iterations
    Jw = (W + K) // cpw
    ncls = ncls or min(1 << bits, 16)
    data = random_words(rng, (B, Jw, G, 8, 128), bits,
                        ncls if in_range else 1 << bits)
    S = rows * 128 // ncls
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 3, rows * 128) << 20).astype(np.int32)
    s0 = (rng.integers(0, S, (B, G, 8, 128)) * ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32)
    if odd_entry:
        pick = rng.random(s0.shape) < 1 / 3
        s0[pick] = rng.integers(-300, S * ncls + 3000, int(pick.sum()))
    if frozen:
        j0[rng.random(j0.shape) < 0.5] = W
    if j0_odd:
        j0 |= 1
    args = [torch.from_numpy(a).to(dev) for a in (data, s0, j0, table)]
    return args, dict(W=W, CPW=cpw, BITS=bits, COUNT=count)


def compare_gated(args, kw, n_esc, big_, t16=None, sel=None):
    """The gated kernel vs its plain version: bit-exact planes in the
    active block rows, and the rows gated off still hold the sentinel
    the output planes were filled with.  ``sel``: the slots read the
    corpus args[0] through this map (in place)."""
    ne = torch.tensor([n_esc], dtype=torch.int32, device=args[0].device)
    out = tuple(torch.full_like(args[1], -7) for _ in range(3))
    got = tcore.gated_scan(*args, ne, big=big_, t16=t16, sel=sel, out=out,
                           **kw)
    torch.cuda.synchronize()
    want = tcore.gated_scan_ref(*args, ne, sel=sel, **kw)
    torch.cuda.synchronize()
    nblk = tcore._active_rows(ne, args[1])
    err = max_abs_err([g[:nblk] for g in got],
                      [w[:nblk] for w in want]) if nblk else 0
    if err or not all(bool((g[nblk:] == -7).all()) for g in got):
        raise AssertionError("the gated kernel differs from its plain "
                             "version by %d or wrote a gated row (n_esc %d, "
                             "t16 %s, sel %s, %r)" % (
                                 err, n_esc, t16 is not None,
                                 sel is not None, kw))
    return err


def slot_map(rng, chunks, n_esc, cap, dev):
    """An ascending random slot -> chunk map of n_esc chunks among
    ``chunks``, padding slots on chunk 0 (_compact_escapes' layout)."""
    sel = np.zeros(cap, np.int64)
    n = min(n_esc, cap)
    sel[:n] = np.sort(rng.choice(chunks, n, replace=False))
    return torch.from_numpy(sel.astype(np.int32)).to(dev)


def random_affine_case(rng, dev, *, pieces, bits, W, count, B=2, G=8,
                       K=512, wrap=False):
    """Random affine tables of P pieces: sorted premultiplied
    breakpoints, entries with random values, modes and match bits; with
    ``wrap`` arbitrary int32 entries and entry states instead (states
    out of range, relative steps that wrap), the breakpoints'
    neighbours and the int32 extremes among the states."""
    cpw = {4: 8, 8: 4}[bits]
    ncls = int(rng.integers(2, (1 << bits) + 1))
    S = pieces * int(rng.integers(3, 40))
    off = S * ncls
    Jw = (W + K // (2 * cpw) * (2 * cpw)) // cpw
    data = random_words(rng, (B, Jw, G, 8, 128), bits, 1 << bits)
    bp = np.sort(rng.choice(np.arange(1, S), pieces - 1, replace=False)
                 * ncls).astype(np.int32)
    rows = -(-(pieces * ncls) // 128)
    if wrap:
        table = rng.integers(-2 ** 31, 2 ** 31, rows * 128).astype(np.int32)
        s0 = rng.integers(-2 ** 31, 2 ** 31, (B, G, 8, 128))
        near = [-2 ** 31, 2 ** 31 - 1, -1, 0, off, off - 1]
        for b in bp.tolist():
            near += [b - 1, b, b + 1]
        s0.reshape(-1)[:len(near)] = near
        s0 = s0.astype(np.int32)
    else:
        val = rng.integers(0, 2 * off, rows * 128)
        table = (val | rng.integers(0, 2, rows * 128) << 28
                 | rng.integers(0, 2, rows * 128) << 30).astype(np.int32)
        s0 = (rng.integers(0, S, (B, G, 8, 128)) * ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (data, s0, j0, table, bp)]
    return args, dict(W=W, CPW=cpw, BITS=bits, NCLS=ncls, OFF=off,
                      COUNT=count)


def compare_affine(args, kw, relaid=None, generic=False):
    """The affine kernel (templated, or ``generic``) vs its plain version
    on the same inputs: bit-exact planes.  ``relaid`` defaults to the
    re-laid table of args' table and breakpoints."""
    if relaid is None:
        relaid = aff.relay_table(args[3].cpu().numpy(), args[4].tolist(),
                                 kw["NCLS"], kw["BITS"], kw["OFF"],
                                 args[0].device)
    got = aff.affine_scan(*args, relaid=relaid, generic=generic, **kw)
    torch.cuda.synchronize()
    want = aff.affine_scan_ref(*args, **kw)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError("the affine kernel differs from its plain "
                             "version by %d (generic %r, %r)"
                             % (err, generic, kw))
    return err


def random_tdfa_case(rng, dev, *, bits, rows, code, R, T, B=2, G=8, K=256,
                     identity=False):
    """Random words (classes past the table too), valid premultiplied
    next and entry states, commits on about a third of the entries, and
    code slots that are register ids (up to two past R) or UNSET, CUR
    and NEXT; with ``identity`` every register-source slot k holds k
    (the registers carry over, only commits read them)."""
    cpw = 32 // bits
    W = 4 * cpw
    Jw = (W + K) // cpw
    n = rows * 128
    ncls = 16 if bits == 4 else 40
    S = max(1, n // ncls)
    spp = 32 // code
    top = (1 << code) - 1
    data = random_words(rng, (B, Jw, G, 8, 128), bits, 1 << bits)
    t_next = (rng.integers(0, S, n) * ncls).astype(np.int32)
    t_cmeta = np.where(rng.random(n) < 0.3, 1 | (rng.integers(0, 128, n) << 1),
                       rng.integers(0, 1 << 20, n) << 1).astype(np.int32)

    def planes(k, ident=False):
        P = max(1, -(-k // spp))
        if ident:
            slots = np.broadcast_to(np.arange(P * spp).reshape(P, spp, 1),
                                    (P, spp, n))
        else:
            slots = np.where(rng.random((P, spp, n)) < 0.5,
                             rng.integers(0, k + 2, (P, spp, n)),
                             top - rng.integers(0, 3, (P, spp, n)))
        out = np.zeros((P, n), np.uint64)
        for sl in range(spp):
            out |= slots[:, sl].astype(np.uint64) << np.uint64(code * sl)
        return out.astype(np.uint32).view(np.int32)

    s0 = (rng.integers(0, S, (B, G, 8, 128)) * ncls).astype(np.int32)
    j0 = rng.integers(0, W + 1, (B, G, 8, 128)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in
            (data, s0, j0, t_next, planes(R, identity), planes(T), t_cmeta)]
    return args, dict(W=W, CPW=cpw, BITS=bits, CODE=code, R=R, T=T)


def random_phi_case(rng, dev, *, S, bits, ncls, big, B=2, G=8, K=512,
                    in_range=False):
    """Random words (classes up to 2**bits, past the table too, or with
    ``in_range`` below ncls, so every word takes the big kernel's k-gram
    path), a random fused table of ceil(S*ncls/128) rows with valid next
    states, and the kernel's keywords (COUNT excepted)."""
    cpw = 32 // bits
    Kw = K // cpw
    rows = -(-(S * ncls) // 128)
    table = (rng.integers(0, S, rows * 128) * ncls
             | rng.integers(0, 2, rows * 128) << 20).astype(np.int32)
    kw = dict(Kw=Kw, CPW=cpw, BITS=bits, S=S, NCLS=ncls)
    if big:
        kw["SB"] = 1 << (-(-S // 128) - 1).bit_length()
        P = -(-Kw // 128)
    else:
        kw["NSEG"] = max(1, 128 // S)
        kw["WL"] = 128 // kw["NSEG"]
        P = -(-Kw // kw["WL"])
    data = random_words(rng, (B, P, G, 8, 128), bits,
                        ncls if in_range else 1 << bits)
    return [torch.from_numpy(a).to(dev) for a in (data, table)], kw


def phi_valid(kw, dev):
    """[8, 128] bool: the slots that hold a chunk's entry state (the
    rest are padding, which the comparisons leave out)."""
    sub = torch.arange(8, device=dev)[:, None]
    lane = torch.arange(128, device=dev)[None, :]
    if "SB" in kw:
        return ((sub % kw["SB"]) * 128 + lane < kw["S"]).expand(8, 128)
    return (lane < kw["NSEG"] * kw["S"]).expand(8, 128)


def compare_phi(kernel, plain, args, kw, stride):
    """A phi kernel vs its plain version on the same inputs: bit-exact
    planes on the valid slots.  ``stride`` (k, table) goes to the kernel
    alone."""
    got = kernel(*args, stride=stride, **kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    valid = phi_valid(kw, args[0].device)
    err = max_abs_err([g[..., valid] for g in got],
                      [w[..., valid] for w in want])
    if err:
        raise AssertionError("%s differs from its plain version by %d (%r)"
                             % (kernel.__name__, err, kw))
    return err


def phi_kw(t, prepared, count):
    """The phi kernel's keywords for tables t over a prepared corpus."""
    _, _, K, WL, _, _ = prepared
    kw = dict(Kw=K // t.cpw, CPW=t.cpw, BITS=t.bits, S=t.nstates,
              NCLS=t.ncls, COUNT=count)
    if isinstance(t, tphi.PhiTablesBig):
        kw["SB"] = t.SB
    else:
        kw.update(WL=WL, NSEG=t.nseg)
    return kw


def run_corpus(mb, lo, hi, seed, odd=False, avoid=None, plant=None):
    """mb MB of a-runs of lo..hi-1 bytes, each closed by "b" (the
    JAX package's bench/ab_phi.py corpus), built with numpy.  ``odd``
    makes every run odd, ``avoid`` lengthens runs that are a multiple
    of it by one; ``plant`` = (back, length) sets the first run that
    starts at or after n - back to ``length``."""
    rng = np.random.default_rng(seed)
    n = mb << 20
    runs = rng.integers(lo, hi, n // lo + 2)
    if odd:
        runs |= 1
    if avoid:
        runs += runs % avoid == 0
    if plant is not None:
        starts = np.cumsum(runs + 1) - (runs + 1)
        runs[np.searchsorted(starts, n - plant[0])] = plant[1]
    ends = np.cumsum(runs + 1) - 1
    out = np.full(n, ord("a"), np.uint8)
    out[ends[ends < n]] = ord("b")
    return out.tobytes()


def activate_phi(sc, corpus, max_scans):
    """Count ``corpus`` until the Scanner switches to its phi tier,
    each count checked against the native engine.  Returns the ladder:
    [warmup, repaired, chunks, tier] per scan."""
    exp = native_count(sc, corpus)
    ladder = []
    for _ in range(max_scans):
        if sc.count(corpus) != exp:
            raise AssertionError("activation count != native %d" % exp)
        st = sc.stats()
        ladder.append([sc._spec.warmup, st.repaired, st.chunks, st.tier])
        if sc._phi_active:
            return ladder
    raise AssertionError("the phi tier never switched on: %r" % ladder)


def time_phi(sc, api, corpus, prep, want):
    """Scanner.count (api "count": the count) or Scanner.scan ("scan":
    the first match end) over a prepared corpus on the phi tier: a first
    call, then the min of REPS reps, each equal to the native engine's
    ``want`` and served by the phi tables with no repair.  Returns
    (min seconds, first call seconds, the last ScanStats)."""
    tier = type(sc._phi).__name__

    def call():
        r = getattr(sc, api)(corpus, prepared=prep)
        return r if api == "count" or r is None else r[1]

    def check(r):
        if r != want:
            raise AssertionError("%s %s %r != native %r"
                                 % (tier, api, r, want))
        # a scan that matched records no chunk count, in every tier
        st = sc.stats()
        if (st.tier, st.repaired) != (tier, 0) \
                or (api == "count" and st.chunks <= 0) \
                or tier not in ("PhiTables", "PhiTablesBig"):
            raise AssertionError("%s not served by the phi tier: %r"
                                 % (api, st))

    t0 = time.perf_counter()
    check(call())
    first_s = time.perf_counter() - t0
    return min_rep_seconds(call, check), first_s, sc.stats()


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


def bound_ms(args, steps):
    """The least time the card could take for one launch: the larger of
    the bytes it must move (every input read once, the three output
    planes written once) over the HBM rate, and its operations, counted
    as one 32-bit operation per transition step (a lower bound on the
    work), over the scalar peak."""
    moved = sum(a.numel() * a.element_size() for a in args)
    moved += 3 * args[1].numel() * 4
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = steps / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def affine_times(asc, aprep, acorpus, timings, errs, dev):
    """The affine kernel at the affine phase's shape, COUNT: the
    templated kernel (the main path's) and the generic one, each checked
    against the plain version; the templated one in scan mode; the plain
    version; and as a yardstick the wide kernel on the base64 machine's
    own wide table (SpecTablesWide) over the same corpus at its own
    warmup.  Records timings["affine"] and returns the kernel_time
    line's fields."""
    t = asc._spec
    data = aprep.for_tables(t)[0]
    s0, j0 = scan._entry_planes(0, t.warmup, data.shape[0], dev)
    args = [data, s0, j0, t.fused, t.bp]
    kw = dict(W=t.warmup, CPW=t.cpw, BITS=t.bits, NCLS=t.ncls, OFF=t.off,
              COUNT=True)
    ms = {}
    for generic in (False, True):
        errs["affine"] = max(errs["affine"], compare_affine(
            args, kw, t.relaid, generic))
        ms[generic] = time_gpu(lambda: aff.affine_scan(
            *args, relaid=t.relaid, generic=generic, **kw), 20)
    kw_scan = dict(kw, COUNT=False)
    errs["affine"] = max(errs["affine"], compare_affine(
        args, kw_scan, t.relaid))
    scan_ms = time_gpu(lambda: aff.affine_scan(*args, relaid=t.relaid,
                                               **kw_scan), 5)
    plain_ms = time_gpu(lambda: aff.affine_scan_ref(*args, **kw), 2)
    bms, by = bound_ms(args, s0.numel() * data.shape[1] * t.cpw)
    timings["affine"] = (ms[False], plain_ms, bms, by, list(data.shape))
    wt = scan.SpecTablesWide(asc.dfa, dev)
    wdata = prepare_on_device(wt, acorpus, 2048)[0]
    ws0, wj0 = scan._entry_planes(0, wt.warmup, wdata.shape[0], dev)
    wide_ms = time_gpu(lambda: scan.spec_scan(
        wdata, ws0, wj0, wt.fused, W=wt.warmup, CPW=wt.cpw, BITS=wt.bits,
        COUNT=True), 20)
    wide_units = wdata.shape[1] * wt.cpw - wt.warmup
    del wdata
    return dict(
        tier="affine", shape=list(data.shape), count=True, ms=ms[False],
        generic_ms=ms[True], scan_ms=scan_ms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, pieces=t.pieces, offsets=t.relaid.offsets,
        corpus_gbps=s0.numel() * (data.shape[1] * t.cpw - t.warmup)
        / ms[False] / 1e6,
        wide_ms=wide_ms, wide_entries=wt.nstates * wt.ncls,
        wide_corpus_gbps=ws0.numel() * wide_units / wide_ms / 1e6)


def gated_times(prep, fct, full, n, dev, errs):
    """The fused tier's phase split on a prepared corpus, by CUDA events:
    phase 1, the gated kernel on the route of the full machine's tables,
    reading the escaped chunks in place (``ms``; ``windows_ms`` on the
    same windows gathered first, ``one_row_ms`` with one escape: one
    active row, the chain alone), the window gather the card no longer
    makes (``gather_ms``), the plain version and one whole
    _fused_count (``fused_device_ms``).  Holds the kernel against its
    plain version at both addressings.  ``sectors_per_word``: the
    distinct 32-byte sectors holding one word of each active slot's
    chunk, ``sector_mb`` those sectors over every word.  Returns the
    kernel_time line's fields and the kernels line's timing tuple."""
    inner = fct.inner
    ck = tcore.fused_chunk(inner, full)
    cdata, C, K, _, B1 = prep.for_tables(inner, ck)
    fdata = prep.for_tables(full, ck)[0]
    Cfull = C - 1 if C * K > n and n - (C - 1) * K != K else C
    cap = tcore._fused_cap(B1)
    Cp = B1 * GROUPS * 1024
    s01, j01 = scan._entry_planes(fct.to_core_premult(0), inner.warmup, B1,
                                  dev)

    def phase1():
        return scan.spec_scan(cdata, s01, j01, inner.fused, W=inner.warmup,
                              CPW=inner.cpw, BITS=inner.bits, COUNT=True)

    p1_ms = time_gpu(phase1, 20)
    live = torch.arange(Cp, device=dev) < Cfull
    n_esc, _, sel_g, _ = tcore._compact_escapes(
        phase1()[0].reshape(Cp), live, fct.esc_premult, cap)
    nesc = int(n_esc)
    big_ = isinstance(full, big.SpecTablesBig)
    t16 = full.t16 if big_ else None
    route = "big16" if t16 is not None else "global" if big_ else "smem"
    z2 = torch.zeros((cap // (GROUPS * 1024), GROUPS, 8, 128),
                     dtype=torch.int32, device=dev)
    gargs = [fdata, z2, z2, full.fused]
    gkw = dict(W=full.warmup, CPW=full.cpw, BITS=full.bits, big=big_,
               t16=t16)
    pkw = dict(W=full.warmup, CPW=full.cpw, BITS=full.bits)
    gblk = tcore._gather_windows(fdata, sel_g, cap)
    errs["gated"] = max(errs["gated"], compare_gated(
        gargs, pkw, nesc, big_, t16=t16, sel=sel_g), compare_gated(
        [gblk, z2, z2, full.fused], pkw, nesc, big_, t16=t16))
    ne = n_esc.reshape(1)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    g_ms = time_gpu(lambda: tcore.gated_scan(*gargs, ne, sel=sel_g, **gkw),
                    20)
    one_ms = time_gpu(lambda: tcore.gated_scan(*gargs, one, sel=sel_g,
                                               **gkw), 20)
    win_ms = time_gpu(lambda: tcore.gated_scan(gblk, z2, z2, full.fused, ne,
                                               **gkw), 20)
    gather_ms = time_gpu(lambda: tcore._gather_windows(fdata, sel_g, cap),
                         20)
    g_plain_ms = time_gpu(lambda: tcore.gated_scan_ref(
        *gargs, ne, sel=sel_g, **pkw), 2)
    fused_ms = time_gpu(lambda: tcore._fused_count(
        cdata, fdata, inner, full, fct._h2f_dev, Cfull,
        fct.to_core_premult(0), 0, CAP=cap, ESC=fct.esc_premult), 5)
    # bytes: each distinct chunk an active slot reads, all its words; the
    # table the route stages or reads; the active slots' map entries,
    # entry planes and three output planes.  Operations: one a step of
    # each escaped chunk
    nblk = tcore._active_rows(ne, z2)
    slots = nblk * GROUPS * 1024
    active = sel_g[:slots]
    chunks = int(torch.unique(active).numel())
    sectors = int(torch.unique(active // 8).numel())
    table_bytes = (t16.table.numel() * 2 if t16 is not None
                   else full.fused.numel() * 4)
    t_bytes = ((chunks * fdata.shape[1] + 6 * slots) * 4 + table_bytes) \
        / HBM_BYTES_PER_S * 1e3
    t_ops = min(nesc, cap) * (full.warmup + K) / SCALAR_OPS_PER_S * 1e3
    bms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                           "operations")
    shape = [cap // (GROUPS * 1024)] + list(fdata.shape[1:])
    line = dict(route=route, shape=shape, corpus_shape=list(fdata.shape),
                n_esc=nesc, active_rows=nblk, ms=g_ms, one_row_ms=one_ms,
                windows_ms=win_ms, gather_ms=gather_ms, plain_ms=g_plain_ms,
                bound_ms=bms, bound_by=by, sectors_per_word=sectors,
                sector_mb=sectors * 32 * fdata.shape[1] / 1e6,
                phase1_ms=p1_ms, phase1_shape=list(cdata.shape),
                fused_device_ms=fused_ms, K=ck, cap=cap)
    return line, (g_ms, g_plain_ms, bms, by, shape, route)


def native_count(sc, corpus):
    k, st = sc._native.count(corpus, 0)
    return k + int(sc.dfa.match_eof[st])


def lazy_phase(corpus, mb, dev):
    """Scanner.count of LAZY_PATTERN over ``corpus`` on the legacy core
    over the lazy machine: a first call (the sample, the core, the prep),
    then the min of REPS reps, each equal to the lazy machine's own
    count; a scan checked against its first match.  Fails unless the
    LazyCoreTables tier served and its inner kernel launched.  Returns
    the phase's fields."""
    lsc = sregex_tpu_torch.compile_pattern(LAZY_PATTERN)
    if lsc.dfa is not None or lsc._spec is not None:
        raise AssertionError("%r has a dense machine" % LAZY_PATTERN)
    n = len(corpus)
    t0 = time.perf_counter()
    lz = LazyDfa(lsc.program)
    k, st = lz.count(corpus, 0)
    lexp = k + int(lz.match_eof(st))
    lexp_first, _ = lz.scan_first(corpus, 0)
    lazy_s = time.perf_counter() - t0

    def check(c):
        if c != lexp:
            raise AssertionError("lazy count %r != LazyDfa %r" % (c, lexp))

    reset_launches()
    prep = lsc.prepare(corpus)
    t0 = time.perf_counter()
    check(lsc.count(corpus, prepared=prep))
    first_s = time.perf_counter() - t0
    dt = min_rep_seconds(lambda: lsc.count(corpus, prepared=prep), check)
    st_ = lsc.stats()
    got = lsc.scan(corpus, prepared=prep)
    launched = scan.spec_scan_launches + scan.pair_scan_launches
    ct = lsc._coret
    if st_.tier != "LazyCoreTables" or not isinstance(
            ct, tcore.LazyCoreTables) or launched <= 0:
        raise AssertionError("the lazy machine's core did not serve: %r, "
                             "%d launches" % (st_, launched))
    if got is None or got[1] != lexp_first:
        raise AssertionError("lazy scan %r != LazyDfa end %r"
                             % (got, lexp_first))
    # the chunks whose core scan escaped (exit ESC), from one more launch
    inner = ct.inner
    data, C, _, _, B = prep.for_tables(inner)
    s0, j0 = scan._entry_planes(ct.to_core_premult(0), inner.warmup, B, dev)
    phi = scan.spec_scan(data, s0, j0, inner.fused, W=inner.warmup,
                         CPW=inner.cpw, BITS=inner.bits, COUNT=True)[0]
    escaped = int((phi.reshape(-1)[:C] == ct.esc_premult).sum())
    return dict(mb=mb, bytes=n, pattern=LAZY_PATTERN.decode(), count=lexp,
                first_end=lexp_first, count_gbps=n / dt / 1e9,
                tier=st_.tier, H=ct.H, lazy_states=lsc._lazy.nstates,
                inner=type(inner).__name__, inner_ncls=inner.ncls,
                inner_rows=inner.rows, escaped=escaped,
                repaired=st_.repaired, chunks=st_.chunks,
                recore_events=st_.recore_events, launches=launched,
                first_count_s=first_s, lazy_dfa_s=lazy_s,
                peak_mem_bytes=torch.cuda.max_memory_allocated())


def tdfa_step_shares(t, corpus, nbytes=1 << 20):
    """Over the first ``nbytes`` of ``corpus``, walked from the seed state
    through the tagged tables ``t``: the share of steps whose
    register-source word is the identity (every register from itself),
    whose entry commits, and whose rebuild takes another register (the
    tagged kernel's slow branch)."""
    spp = 32 // t.code_bits
    mask = (1 << t.code_bits) - 1
    R = t.nregs
    nxt = t.t_next.cpu().numpy()
    cm = t.t_cmeta.cpu().numpy()
    codes = np.zeros((nxt.size, max(R, 1)), np.int64)
    rs = t.t_regsrc.cpu().numpy().astype(np.int64) & 0xFFFFFFFF
    for k in range(R):
        codes[:, k] = (rs[k // spp] >> (t.code_bits * (k % spp))) & mask
    own = np.arange(max(R, 1))
    ident = (codes[:, :R] == own[:R]).all(1)
    gather = ((codes[:, :R] < R) & (codes[:, :R] != own[:R])).any(1)
    cls = t.class_map[np.frombuffer(bytes(corpus[:nbytes]), np.uint8)]
    s = t.seed_premult
    hits = np.zeros(3, np.int64)
    for c in cls.tolist():
        i = s + c
        hits += (ident[i], cm[i] & 1, gather[i])
        s = int(nxt[i])
    return dict(zip(("identity_share", "commit_share", "gather_share"),
                    (hits / len(cls)).tolist()))


def headline_corpus(mb):
    body = b"abccc" * (1024 * 1024 * (mb // 5))
    ofs = (len(body) * 255 // 256) // 5 * 5 + 2
    return body[:ofs] + b"xaaabbccb" + body[ofs + 9:]


def multi_corpus(mb, words):
    """Disjoint filler words with a dictionary word planted every 64 KB
    (the JAX package's bench_multi corpus)."""
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


# log text between base64 runs; each piece starts and ends outside the
# base64 alphabet, and two of them close the run before with "="
LOG_PIECES = [b"=\n2026-10-16T14:05:28Z INFO api upload id=4127 blob:",
              b" len=512\n2026-10-16T14:05:29Z WARN retry n=3 body:",
              b"\n2026-10-16T14:05:30Z INFO cache ok key ",
              b"==\n2026-10-16T14:05:31Z DEBUG session token "]
B64 = np.frombuffer(b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
                    b"0123456789+/", np.uint8)


def base64_corpus(mb, seed=11, block_mb=32):
    """Log-like text with base64 runs of 50-600 bytes, some ending in
    "=": one seeded block of block_mb MB, built with vectorised numpy,
    repeated to mb MB."""
    rng = np.random.default_rng(seed)
    n = min(mb, block_mb) << 20
    nseg = n // 300 + 16
    runs = rng.integers(50, 601, nseg)
    kinds = rng.integers(0, len(LOG_PIECES), nseg)
    plen = np.array([len(p) for p in LOG_PIECES])
    width = plen.max()
    pieces = np.zeros((len(LOG_PIECES), width), np.uint8)
    for i, p in enumerate(LOG_PIECES):
        pieces[i, :len(p)] = np.frombuffer(p, np.uint8)
    seg = np.empty(2 * nseg, np.int64)
    seg[0::2] = runs
    seg[1::2] = plen[kinds]
    sid = np.repeat(np.arange(2 * nseg, dtype=np.int32), seg)[:n]
    start = np.concatenate([[0], np.cumsum(seg)[:-1]])
    ofs = np.arange(n, dtype=np.int64) - start[sid]
    is_run = sid % 2 == 0
    block = np.where(is_run, B64[rng.integers(0, 64, n)],
                     pieces[kinds[sid // 2], np.minimum(ofs, width - 1)])
    block = block.astype(np.uint8).tobytes()
    reps = -(-(mb << 20) // len(block))
    return (block * reps)[:mb << 20]


def log_corpus(mb, seed=17, block_mb=32):
    """Log lines drawn from FIND_LINES: one seeded block of block_mb MB,
    repeated to mb MB."""
    rng = np.random.default_rng(seed)
    n = min(mb, block_mb) << 20
    mean = sum(map(len, FIND_LINES)) / len(FIND_LINES)
    idx = rng.integers(0, len(FIND_LINES), int(n / mean) + 64)
    block = b"".join(FIND_LINES[i] for i in idx)[:n]
    reps = -(-(mb << 20) // len(block))
    return bytearray((block * reps)[:mb << 20])


def plant_line(corpus, near, line):
    """Overwrite the corpus from the first line start at or after
    ``near`` with ``line``.  Returns that offset."""
    p = corpus.index(b"\n", near) + 1
    corpus[p:p + len(line)] = line
    return p


def find_oracle(corpus, p, user):
    """The planted match's ovector, from the generator: the line at p
    holds "status=404 user=<user>"."""
    s = p + FIND_PLANT.index(b"status=")
    u = s + len(b"status=404 user=")
    return (0, [s, u + len(user), s + 7, s + 10, u, u + len(user)])


def pike_window(prog, corpus, start):
    """The native Pike engine (exact mode) over corpus[start:], entered
    with the preceding byte's newline/word carry: (rid, ovector)."""
    ctx = NativePikeCtx(prog, exact=True)
    if start > 0:
        prev = corpus[start - 1]
        ctx.set_carry(start, prev == 10, sre_isword(prev))
    rc, _ = ctx.exec(bytes(corpus[start:]), True)
    return (rc, [int(v) for v in ctx.ovector]) if rc >= 0 else None


def dictionary(n, seed=7):
    """n distinct keywords of 6-12 lowercase letters (an IOC or DLP
    keyword list's shape)."""
    rng = np.random.default_rng(seed)
    words = set()
    while len(words) < n:
        words.add(bytes(rng.integers(97, 123, int(rng.integers(6, 13)))
                        .astype(np.uint8)))
    return sorted(words)


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
    if sregex_tpu_torch.compile_pattern("a", device=None)._native.lib \
            is None:
        raise RuntimeError("the native host engine (sregex_tpu_torch/"
                           "csrc/sre_host.cpp) did not build: g++ is "
                           "needed")
    say("build", seconds=kernel_s, compiled=_build.build_seconds is not None,
        native_seconds=time.perf_counter() - t0)
    if _build.build_log:
        print(_build.build_log.strip(), flush=True)

    # --- 3. kernel vs plain on the card -----------------------------------
    rng = np.random.default_rng(2026)
    errs = {"narrow": 0, "wide": 0, "big": 0, "affine": 0}
    spec = (scan.spec_scan, spec_scan_ref)
    cases = [("narrow", dict(bits=4, rows=1, W=32, count=True)),
             ("narrow", dict(bits=4, rows=1, W=128, count=False)),
             ("narrow", dict(bits=3, rows=1, W=40, count=False)),
             ("narrow", dict(bits=8, rows=1, W=16, count=True)),
             ("wide", dict(bits=8, rows=3, W=16, count=False)),
             ("wide", dict(bits=8, rows=98, W=16, count=True)),
             ("wide", dict(bits=8, rows=98, W=128, count=False))]
    for tier, case in cases:
        args, kw = random_case(rng, dev, **case)
        errs[tier] = max(errs[tier], compare(*spec, args, kw))
    # the pair tier's own tables on a pair-packed corpus, COUNT and OR
    ast, _ = parse("abc")
    pt = SpecTablesPair(build_dfa(compile_regex(ast)), dev,
                        narrow_only=True)
    corpus = rng.choice(np.frombuffer(b"abcx", np.uint8),
                        3 << 20).tobytes()
    packed, _, _, _, B = prepare_on_device(pt, corpus, 2048)
    s0, j0 = scan._entry_planes(0, pt.warmup // 2, B, dev)
    for count in (True, False):
        for pair in (None, pt.pair):
            errs["narrow"] = max(errs["narrow"], compare(
                *spec, [packed, s0, j0, pt.fused],
                dict(W=pt.warmup // 2, CPW=pt.cpw, BITS=pt.bits,
                     COUNT=count), dict(pair=pair)))
    # the two-code kernel on random narrow tables, 3- and 4-bit, COUNT and
    # scan: classes past ncls, freezes inside a code pair, one and no warm
    # word, entry states off the table's rows (some frozen through the
    # whole warmup)
    pair_cases = [dict(bits=4, W=32, count=True, ncls=16),
                  dict(bits=4, W=32, count=False, ncls=4, j0_odd=True),
                  dict(bits=4, W=8, count=True, ncls=9, odd_entry=True,
                       frozen=True),
                  dict(bits=4, W=0, count=False, ncls=16),
                  dict(bits=3, W=40, count=True, ncls=8),
                  dict(bits=3, W=10, count=False, ncls=5, odd_entry=True,
                       frozen=True),
                  dict(bits=3, W=40, count=True, ncls=6, j0_odd=True)]
    for case in pair_cases:
        args, kw = random_case(rng, dev, rows=1, **case)
        ncls = case["ncls"]
        pairs = scan.pair_table(args[3].cpu().numpy(), ncls, 128 // ncls,
                                case["bits"], dev)
        errs["narrow"] = max(errs["narrow"],
                             compare(*spec, args, kw, dict(pair=pairs)))
    # big: tables past the shared-memory cap at 32 bits, each through the
    # global-memory kernel and (where big16_table holds it) the 16-bit
    # one; classes in range, and past ncls (the wrap) with entry states
    # off the rows; 907 states of 128 classes fill shared memory at 16
    # bits, 908 do not (big16_table declines them)
    big_cases = [dict(bits=4, rows=600, W=32, count=True, ncls=16,
                      in_range=True),
                 dict(bits=4, rows=1024, W=32, count=False, ncls=16,
                      in_range=True),
                 dict(bits=8, rows=821, W=32, count=True, ncls=27,
                      in_range=True),
                 dict(bits=8, rows=1024, W=64, count=False, ncls=200,
                      in_range=True),
                 dict(bits=8, rows=821, W=32, count=False, ncls=27,
                      odd_entry=True, frozen=True),
                 dict(bits=4, rows=600, W=32, count=True, ncls=9,
                      odd_entry=True),
                 dict(bits=8, rows=907, W=16, count=True, ncls=128,
                      in_range=True),
                 dict(bits=8, rows=908, W=16, count=False, ncls=128,
                      in_range=True)]
    big16_held = []
    for case in big_cases:
        assert case["rows"] * 128 > scan.SMEM_TABLE_MAX
        args, kw = random_case(rng, dev, **case)
        ncls = case["ncls"]
        t16 = big.big16_table(args[3].cpu().numpy(), ncls,
                              case["rows"] * 128 // ncls, case["bits"], dev)
        big16_held.append(t16 is not None)
        for t16_ in (None, t16) if t16 is not None else (None,):
            errs["big"] = max(errs["big"], compare(
                big.big_scan, big.big_scan_ref, args, kw, dict(t16=t16_)))
    if big16_held[-2:] != [True, False]:
        raise AssertionError("big16_table's cap: %r" % big16_held)
    # affine: random tables of 1 to 48 pieces, each through the templated
    # kernel (P <= 8) and the generic one; valid states, and arbitrary
    # int32 entries and states (out of range, int32 wrap); then the tables
    # of a renumbered (perm) and a plain counted-repetition machine
    affine_cases = [dict(pieces=1, bits=4, W=32, count=True),
                    dict(pieces=3, bits=4, W=512, count=False),
                    dict(pieces=17, bits=8, W=16, count=True),
                    dict(pieces=48, bits=8, W=64, count=False),
                    dict(pieces=48, bits=4, W=32, count=True)]
    affine_cases += [dict(pieces=p, bits=bits, W=32 if bits == 4 else 16,
                          count=count, wrap=wrap, B=1)
                     for p in (2, 3, 6, 8, 9) for bits in (4, 8)
                     for count, wrap in ((True, True), (False, False))]
    for case in affine_cases:
        args, kw = random_affine_case(rng, dev, **case)
        for generic in (False, True):
            errs["affine"] = max(errs["affine"],
                                 compare_affine(args, kw, generic=generic))
    for pat, want_perm in (("(?:ab?c){60,140}z", True),
                           ("a{400,499}b", False)):
        at = aff.SpecTablesAffine(build_dfa(compile_regex(parse(pat)[0])),
                                  dev)
        assert (at.perm is not None) == want_perm
        text = (b"." + b"abc" * 100 + b"z" + b"a" * 450 + b"b") * 4000
        packed, _, _, _, B = prepare_on_device(at, text, 2048)
        s0, j0 = scan._entry_planes(0, at.warmup, B, dev)
        for count in (True, False):
            errs["affine"] = max(errs["affine"], compare_affine(
                [packed, s0, j0, at.fused, at.bp],
                dict(W=at.warmup, CPW=at.cpw, BITS=at.bits, NCLS=at.ncls,
                     OFF=at.off, COUNT=count), at.relaid))
    # tdfa: random code planes, CODE 4/8/16, one and several rows, 4- and
    # 8-bit words, R and T at the edges of each code width; the last
    # case's 50 planes of 2048 entries take the global-memory variant
    errs["tdfa"] = 0
    tdfa_cases = [dict(bits=4, rows=1, code=4, R=13, T=13),
                  dict(bits=8, rows=3, code=4, R=1, T=13),
                  dict(bits=4, rows=2, code=8, R=24, T=24),
                  dict(bits=8, rows=1, code=8, R=14, T=2),
                  dict(bits=4, rows=4, code=16, R=48, T=48),
                  dict(bits=8, rows=16, code=16, R=48, T=48)]
    # the register buckets' edges (R, T in {4, 5, 8, 9, 13}) for each code
    # width, and all-identity register words
    tdfa_cases += [dict(bits=4 if (R + T) % 2 else 8, rows=2, code=code,
                        R=R, T=T, B=1)
                   for code in (4, 8, 16)
                   for R, T in ((4, 4), (5, 6), (8, 8), (9, 4), (4, 9),
                                (13, 13), (5, 13))]
    tdfa_cases += [dict(bits=4, rows=2, code=4, R=5, T=6, B=1,
                        identity=True),
                   dict(bits=8, rows=2, code=8, R=13, T=2, B=1,
                        identity=True)]
    for case in tdfa_cases:
        args, kw = random_tdfa_case(rng, dev, **case)
        errs["tdfa"] = max(errs["tdfa"], compare(
            tdfa.tdfa_scan, tdfa.tdfa_scan_ref, args, kw))
    # phi: lane-packed S in {3, 4, 50, 128} and sublane-group S in {139,
    # 501, 1000} up to the card's 64 rows, 4- and 8-bit words, COUNT and
    # scan, each kernel at the k stride_k chooses; the padding slots are
    # left out
    errs["phi"] = errs["phi_big"] = 0
    phi_cases = [("phi", dict(S=3, bits=4, ncls=16), True),
                 ("phi", dict(S=4, bits=4, ncls=3), False),
                 ("phi", dict(S=50, bits=8, ncls=20), True),
                 ("phi", dict(S=128, bits=4, ncls=8), False),
                 ("phi", dict(S=3, bits=8, ncls=256), False),
                 ("phi", dict(S=128, bits=8, ncls=8), True),
                 ("phi_big", dict(S=139, bits=4, ncls=16), True),
                 ("phi_big", dict(S=501, bits=4, ncls=16), False),
                 ("phi_big", dict(S=1000, bits=4, ncls=8), True),
                 ("phi_big", dict(S=1000, bits=8, ncls=8), False),
                 ("phi_big", dict(S=139, bits=8, ncls=58), False)]
    for tier, case, count in phi_cases:
        big_ = tier == "phi_big"
        args, kw = random_phi_case(rng, dev, big=big_, **case)
        fns = ((tphi.phi_big_scan, tphi.phi_big_scan_ref) if big_
               else (tphi.phi_scan, tphi.phi_scan_ref))
        k = tphi.stride_k(case["S"], case["ncls"], kw["CPW"],
                          args[1].numel(), (4, 2) if big_ else (8, 4, 2))
        st = (k, torch.from_numpy(tphi.stride_table(
            args[1].cpu().numpy(), case["S"], case["ncls"], k,
            count)).to(dev))
        errs[tier] = max(errs[tier], compare_phi(
            *fns, args, dict(kw, COUNT=count), stride=st))
    # both kernels' k-gram walks at each k of (8, 4, 2, 1) that divides
    # the word and fits shared memory: every class below ncls, and (the
    # lane-packed kernel) classes up to 2**bits, past ncls
    kgram_cases = []
    for tier, S, bits, ncls, in_range in (
            ("phi_big", 139, 4, 3, True), ("phi_big", 501, 4, 3, True),
            ("phi_big", 1000, 4, 2, True), ("phi_big", 139, 8, 5, True),
            ("phi", 4, 4, 3, True), ("phi", 4, 4, 3, False),
            ("phi", 1, 4, 2, True), ("phi", 5, 4, 5, False),
            ("phi", 9, 4, 4, True), ("phi", 128, 4, 8, False),
            ("phi", 50, 8, 20, True), ("phi", 3, 8, 256, True)):
        big_ = tier == "phi_big"
        fns = ((tphi.phi_big_scan, tphi.phi_big_scan_ref) if big_
               else (tphi.phi_scan, tphi.phi_scan_ref))
        for count in (True, False):
            args, kw = random_phi_case(rng, dev, S=S, bits=bits, ncls=ncls,
                                       big=big_, K=2048, in_range=in_range,
                                       B=1)
            kw["COUNT"] = count
            for k in (8, 4, 2, 1):
                if kw["CPW"] % k or S * ncls ** k + args[1].numel() + 256 \
                        > tphi.STRIDE_SMEM_ENTRIES or (big_ and k == 8):
                    continue
                st = torch.from_numpy(tphi.stride_table(
                    args[1].cpu().numpy(), S, ncls, k, count)).to(dev)
                errs[tier] = max(errs[tier], compare_phi(
                    *fns, args, kw, stride=(k, st)))
                kgram_cases.append((tier, S, k, count))
    # gated: the phase-2 scan at CAP 32768 (4 block rows of G tiles) on
    # every route (narrow and wide tables in shared memory, a big table
    # by its 16-bit table and from global memory), over block-layout
    # windows and in place through a slot map into a corpus of two more
    # block rows, gated at the edges of a block row; the big table's
    # entry states a third off its rows
    errs["gated"] = 0
    cap_rows = 32768 // (GROUPS * 1024)
    gated_cases = []
    for bits, rows, ncls, route in ((4, 1, 16, "smem"), (8, 98, 27, "smem"),
                                    (8, 821, 27, "big16"),
                                    (8, 821, 27, "global")):
        args, kw = random_case(rng, dev, bits=bits, rows=rows, W=32,
                               count=True, B=cap_rows + 2, K=256, ncls=ncls,
                               in_range=True, odd_entry=rows > 98)
        kw.pop("COUNT")
        t16 = big.big16_table(args[3].cpu().numpy(), ncls, rows * 128 // ncls,
                              bits, dev) if route == "big16" else None
        if (t16 is None) == (route == "big16"):
            raise AssertionError("big16_table declined the %s case" % route)
        s0, j0 = (a[:cap_rows].contiguous() for a in args[1:3])
        chunks = args[0][:, 0].numel()
        for n_esc in (0, 1, GROUPS * 1024, GROUPS * 1024 + 1, 32768):
            for sel in (None, slot_map(rng, chunks, n_esc, 32768, dev)):
                data = args[0] if sel is not None else args[0][:cap_rows]
                errs["gated"] = max(errs["gated"], compare_gated(
                    [data, s0, j0, args[3]], kw, n_esc, route != "smem",
                    t16=t16, sel=sel))
                gated_cases.append((route, n_esc, sel is not None))
    say("kernel_vs_plain", groups=GROUPS, max_abs_err=max(errs.values()),
        cases=len(cases) + 4 + len(pair_cases) + len(big_cases)
        + sum(big16_held) + 2 * len(affine_cases) + 4
        + len(tdfa_cases) + len(phi_cases) + len(kgram_cases)
        + len(gated_cases))
    del packed, s0, j0

    launches = {}
    timings = {}
    # --- 4. headline: the main path, launches counted from here -----------
    mb = mb_env("SREGEX_BENCH_MB")
    corpus = headline_corpus(mb)
    n = len(corpus)
    ast, _ = parse(HEADLINE)
    prog = compile_regex(ast)
    dfa = build_dfa(prog)
    sc = Scanner(prog, ast=ast)
    t0 = time.perf_counter()
    exp_first, _ = sc._native.scan_first(corpus, 0)
    exp_count = native_count(sc, corpus)
    native_s = time.perf_counter() - t0
    assert exp_first > 0
    tables = scan.SpecTables(dfa, dev)
    assert type(sc._spec) is scan.SpecTables
    if tables.pair is None or sc._spec.pair is None:
        raise AssertionError("the headline's table has no two-code table")

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
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
    launches["narrow"] = scan.pair_scan_launches
    if scan.spec_scan_launches:
        raise AssertionError("the headline ran the one-lookup kernel %d "
                             "times" % scan.spec_scan_launches)
    say("headline", mb=mb, bytes=n, offset=exp_first, count=exp_count,
        dfa_scan_gbps=n / dt / 1e9, scanner_count_gbps=n / sc_dt / 1e9,
        tier=st.tier, repaired=repaired, chunks=chunks,
        launches=launches["narrow"], prep_s=prep_s, native_s=native_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    del sc_prep, sc

    # --- 5. multi: 90 keywords through Scanner.count ----------------------
    mmb = mb_env("SREGEX_BENCH_MULTI_MB")
    pats = [w.encode() for w in MULTI_WORDS]
    msc = sregex_tpu_torch.compile_pattern(pats)
    if type(msc._spec).__name__ != "SpecTablesWide":
        raise AssertionError("multi set served by %s"
                             % type(msc._spec).__name__)
    mcorpus = multi_corpus(mmb, pats)
    mn = len(mcorpus)
    t0 = time.perf_counter()
    mexp = native_count(msc, mcorpus)
    mnative_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
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
    launches["wide"] = scan.spec_scan_launches
    say("multi", mb=mmb, bytes=mn, count=mexp,
        multi_dfa_scan_gbps=mn / mdt / 1e9, tier=mst.tier,
        states=msc.dfa.nstates, classes=msc.dfa.nclasses,
        rows=msc._spec.rows, repaired=mst.repaired, chunks=mst.chunks,
        launches=launches["wide"], first_call_s=first_s,
        native_s=mnative_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    # the TPU's route for this set: the fused two-phase tier, which
    # SREGEX_FUSED=1 lets in over a long-chain wide tier
    with env("SREGEX_FUSED", "1"):
        fsc = sregex_tpu_torch.compile_pattern(pats)
        g0 = tcore.gated_scan_launches
        r0 = tcore.gated_route_launches["smem"]
        t0 = time.perf_counter()
        check_multi(fsc.count(mcorpus, prepared=mprep))
        ffirst_s = time.perf_counter() - t0
        fmdt = min_rep_seconds(lambda: fsc.count(mcorpus, prepared=mprep),
                               check_multi)
    mct, fmst = fsc._fusedct, fsc.stats()
    if fmst.tier != "CoreTables" or not isinstance(mct, tcore.CoreTables):
        raise AssertionError("the multi set is not on the fused tier: %r"
                             % fmst)
    if tcore.gated_route_launches["smem"] - r0 != \
            tcore.gated_scan_launches - g0 or tcore.gated_scan_launches == g0:
        raise AssertionError("multi phase 2 left the shared-memory route: "
                             "%r" % tcore.gated_route_launches)
    say("multi_fused", mb=mmb, count=mexp, fused_multi_gbps=mn / fmdt / 1e9,
        multi_dfa_scan_gbps=mn / mdt / 1e9,
        K=tcore.fused_chunk(mct.inner, fsc._spec),
        n_esc=mct.last_escapes[0], overflow=mct.last_escapes[1],
        cause=mct.last_fused_cause, repaired=fmst.repaired,
        chunks=fmst.chunks, H=mct.H, inner=type(mct.inner).__name__,
        inner_ncls=mct.inner.ncls, inner_rows=mct.inner.rows,
        gated_launches=tcore.gated_scan_launches - g0,
        first_call_s=ffirst_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    # the gated kernel's wide route at this arm's phase-2 shape and escapes
    say("kernel_time", tier="gated_wide", **gated_times(
        mprep, mct, fsc._spec, mn, dev, errs)[0])
    # mprep stays for the wide kernel's timing; the fused Scanner's preps
    # go
    drop_preps(mprep, mct.inner, fsc._spec)
    del mct, fsc

    # a pattern past the eager DFA budget on the same corpus
    torch.cuda.reset_peak_memory_stats()
    say("lazy", **lazy_phase(mcorpus, mmb, dev))
    del mcorpus

    # --- 6. affine: a base64-blob detector over log-like text ------------
    amb = mb_env("SREGEX_BENCH_AFFINE_MB")
    asc = sregex_tpu_torch.compile_pattern(BASE64_BLOB)
    if type(asc._spec).__name__ != "SpecTablesAffine":
        raise AssertionError("base64 detector served by %s"
                             % type(asc._spec).__name__)
    t0 = time.perf_counter()
    acorpus = base64_corpus(amb)
    gen_s = time.perf_counter() - t0
    an = len(acorpus)
    t0 = time.perf_counter()
    aexp = native_count(asc, acorpus)
    aexp_first, _ = asc._native.scan_first(acorpus, 0)
    anative_s = time.perf_counter() - t0

    def check_affine(c):
        if c != aexp:
            raise AssertionError("affine rep %r != native %r" % (c, aexp))

    def check_affine_scan(r):
        if r is None or r[1] != aexp_first:
            raise AssertionError("affine scan %r != native end %r"
                                 % (r, aexp_first))

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    # let the warmup ladder settle: scan until a scan needs no
    # escalation, each checked against the native engine
    ladder = []
    t0 = time.perf_counter()
    for _ in range(8):
        check_affine(asc.count(acorpus))
        ast_ = asc.stats()
        ladder.append([asc._spec.warmup, ast_.repaired, ast_.chunks,
                       ast_.warm_events])
        if ast_.repaired <= ast_.chunks * asc.CORE_DRIFT_FRAC \
                and asc._warm_strikes == 0:
            break
    settle_s = time.perf_counter() - t0
    aprep = asc.prepare(acorpus)
    check_affine(asc.count(acorpus, prepared=aprep))
    adt = min_rep_seconds(lambda: asc.count(acorpus, prepared=aprep),
                          check_affine)
    ast_ = asc.stats()
    ragged = int(an % 2048 != 0)
    if ast_.repaired > ragged:
        raise AssertionError("affine reps repaired %d chunks"
                             % ast_.repaired)
    check_affine_scan(asc.scan(acorpus, prepared=aprep))
    asdt = min_rep_seconds(lambda: asc.scan(acorpus, prepared=aprep),
                           check_affine_scan)
    if ast_.tier != "SpecTablesAffine":
        raise AssertionError("affine phase served by %s" % ast_.tier)
    launches["affine"] = aff.affine_scan_launches
    say("affine", mb=amb, bytes=an, pattern=BASE64_BLOB, count=aexp,
        first_end=aexp_first, count_gbps=an / adt / 1e9,
        scan_gbps=an / asdt / 1e9, tier=ast_.tier,
        states=asc.dfa.nstates, classes=asc.dfa.nclasses,
        pieces=asc._spec.pieces, warmup=asc._spec.warmup,
        ladder=ladder, warm_events=ast_.warm_events,
        repaired=ast_.repaired, chunks=ast_.chunks,
        launches=launches["affine"], corpus_s=gen_s, settle_s=settle_s,
        native_s=anative_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    # --- 7. big: a 500-keyword dictionary --------------------------------
    bmb = mb_env("SREGEX_BENCH_BIG_MB")
    words = dictionary(500)
    t0 = time.perf_counter()
    bsc = sregex_tpu_torch.compile_pattern(words)
    dfa_s = time.perf_counter() - t0
    if type(bsc._spec).__name__ != "SpecTablesBig":
        raise AssertionError("dictionary served by %s"
                             % type(bsc._spec).__name__)
    bcorpus = multi_corpus(bmb, words)
    bn = len(bcorpus)
    t0 = time.perf_counter()
    bexp = native_count(bsc, bcorpus)
    bexp_first, _ = bsc._native.scan_first(bcorpus, 0)
    bnative_s = time.perf_counter() - t0
    if bexp_first < 0:
        raise AssertionError("no dictionary word in the big corpus")

    def check_big(c):
        if c != bexp:
            raise AssertionError("big rep %r != native %r" % (c, bexp))

    def check_big_scan(r):
        if r is None or r[1] != bexp_first:
            raise AssertionError("big scan %r != native end %r"
                                 % (r, bexp_first))

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    bprep = bsc.prepare(bcorpus)
    check_big(bsc.count(bcorpus, prepared=bprep))
    bdt = min_rep_seconds(lambda: bsc.count(bcorpus, prepared=bprep),
                          check_big)
    bst = bsc.stats()
    # the card's band: no core tier is built over the big tier
    if bst.tier != "SpecTablesBig" or bsc._coret is not False \
            or bsc._fusedct is not False:
        raise AssertionError("big phase served by %s" % bst.tier)
    launches["big"] = big.big_smem_launches
    if big.big_scan_launches or bsc._spec.t16 is None:
        raise AssertionError("the big phase ran the global-memory kernel "
                             "%d times" % big.big_scan_launches)
    say("big", mb=bmb, bytes=bn, keywords=len(words), count=bexp,
        count_gbps=bn / bdt / 1e9, tier=bst.tier,
        states=bsc.dfa.nstates, classes=bsc.dfa.nclasses,
        entries=bsc.dfa.nstates * bsc.dfa.nclasses, rows=bsc._spec.rows,
        bits=bsc._spec.bits, warmup=bsc._spec.warmup,
        warm_events=bst.warm_events, repaired=bst.repaired,
        chunks=bst.chunks, launches=launches["big"], dfa_build_s=dfa_s,
        native_s=bnative_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    # --- 8. core: the dictionary on the fused two-phase core tier ---------
    # SREGEX_FUSED=1 lets the fused tier in over the big tier
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with env("SREGEX_FUSED", "1"):
        csc = sregex_tpu_torch.compile_pattern(words)
        cprep = csc.prepare(bcorpus)
        t0 = time.perf_counter()
        check_big(csc.count(bcorpus, prepared=cprep))
        cfirst_s = time.perf_counter() - t0
        cdt = min_rep_seconds(lambda: csc.count(bcorpus, prepared=cprep),
                              check_big)
        cst = csc.stats()
        fct = csc._fusedct
        if cst.tier != "CoreTables" \
                or not isinstance(fct, tcore.CoreTables):
            raise AssertionError("the dictionary is not on the fused "
                                 "tier: %r" % cst)
        cesc, ccause = fct.last_escapes, fct.last_fused_cause
        check_big_scan(csc.scan(bcorpus, prepared=cprep))
        csdt = min_rep_seconds(lambda: csc.scan(bcorpus, prepared=cprep),
                               check_big_scan)
        if csc.stats().tier != "CoreTables":
            raise AssertionError("core scan served by %s"
                                 % csc.stats().tier)
    launches["gated"] = tcore.gated_scan_launches
    claunch = dict(gated=launches["gated"],
                   gated_routes=dict(tcore.gated_route_launches),
                   spec=scan.spec_scan_launches,
                   pair=scan.pair_scan_launches, big=big.big_scan_launches,
                   big_smem=big.big_smem_launches)
    # the dictionary's table fits 16 bits: every phase 2 on that route
    if not launches["gated"] \
            or tcore.gated_route_launches["big16"] != launches["gated"]:
        raise AssertionError("core phase 2 routes: %r" % claunch)

    # the phase split by CUDA events, and the gated kernel at this
    # phase-2 shape with this corpus's escapes
    inner = fct.inner
    gline, timings["gated"] = gated_times(cprep, fct, csc._spec, bn, dev,
                                          errs)
    p1_ms, g_ms, fused_ms = (gline[k] for k in (
        "phase1_ms", "ms", "fused_device_ms"))
    nesc, ck, cap = gline["n_esc"], gline["K"], gline["cap"]
    say("kernel_time", tier="gated", **gline)

    # past the device cap (one phase-2 block row): the first count
    # repairs its escapes on the host and hands the machine to the
    # static big tier, which serves from then on
    ocap = GROUPS * 1024
    cap0, tcore.FUSED_CAP = tcore.FUSED_CAP, ocap
    try:
        with env("SREGEX_FUSED", "1"):
            osc = sregex_tpu_torch.compile_pattern(words)
            t0 = time.perf_counter()
            check_big(osc.count(bcorpus, prepared=cprep))
            o_first_s = time.perf_counter() - t0
    finally:
        tcore.FUSED_CAP = cap0
    ost = osc.stats()
    # a corpus cut below ~1 GB has fewer escapes than one block row
    overflows = cesc[0] > ocap
    if overflows and (ost.tier != "CoreTables"
                      or osc._fusedct is not False):
        raise AssertionError("the overflowing fused count did not hand "
                             "the machine back: %r" % ost)
    osdt = min_rep_seconds(lambda: osc.count(bcorpus, prepared=cprep),
                           check_big)
    overflow = dict(cap=ocap, overflows=overflows, first_tier=ost.tier,
                    first_repaired=ost.repaired, first_chunks=ost.chunks,
                    first_count_s=o_first_s,
                    settled_tier=osc.stats().tier,
                    settled_count_gbps=bn / osdt / 1e9)
    if overflow["settled_tier"] != ("SpecTablesBig" if overflows
                                    else "CoreTables"):
        raise AssertionError("after the overflow arm: %r" % overflow)
    del osc

    # a machine with no static tier: the legacy core, or the native
    # engine where CoreTables finds no core
    nsc = sregex_tpu_torch.compile_pattern(NO_TIER_PATTERN)
    if nsc._spec is not None:
        raise AssertionError("%s has a static tier" % NO_TIER_PATTERN)
    t0 = time.perf_counter()
    nexp = native_count(nsc, bcorpus)
    no_tier = dict(pattern=NO_TIER_PATTERN, count=nexp,
                   states=nsc.dfa.nstates, classes=nsc.dfa.nclasses,
                   native_s=time.perf_counter() - t0, scans=[])
    for _ in range(2):
        t0 = time.perf_counter()
        c_ = nsc.count(bcorpus, prepared=cprep)
        dt_ = time.perf_counter() - t0
        if c_ != nexp:
            raise AssertionError("no-tier count %r != native %r"
                                 % (c_, nexp))
        st_ = nsc.stats()
        no_tier["scans"].append(dict(
            tier=st_.tier, repaired=st_.repaired, chunks=st_.chunks,
            recore_events=st_.recore_events, count_gbps=bn / dt_ / 1e9))
    ct_ = nsc._coret
    if ct_:
        no_tier.update(H=ct_.H, inner=type(ct_.inner).__name__,
                       inner_ncls=ct_.inner.ncls)
    del nsc, ct_
    say("core", mb=bmb, bytes=bn, keywords=len(words), count=bexp,
        first_end=bexp_first, fused_count_gbps=bn / cdt / 1e9,
        fused_scan_gbps=bn / csdt / 1e9, static_big_count_gbps=bn / bdt / 1e9,
        tier=cst.tier, n_esc=cesc[0], overflow=cesc[1], cause=ccause,
        repaired=cst.repaired, chunks=cst.chunks,
        recore_events=cst.recore_events, H=fct.H,
        inner=type(inner).__name__, inner_ncls=inner.ncls,
        inner_rows=inner.rows, K=ck, cap=cap, rep_ms=cdt * 1e3,
        phase1_ms=p1_ms, phase2_ms=g_ms, fused_device_ms=fused_ms,
        host_timing=fct.last_timing, launches=claunch,
        overflow_arm=overflow, no_static_tier=no_tier,
        first_count_s=cfirst_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    del cprep, bcorpus, csc, fct

    # --- 9. find: a log-field extractor, certified in one pass -----------
    fmb = mb_env("SREGEX_BENCH_FIND_MB")
    fsc = sregex_tpu_torch.compile_pattern(FIND_PATTERN)
    ft = fsc._tdfa_spec
    if ft is None:
        raise AssertionError("no tagged tables for %r" % FIND_PATTERN)
    t0 = time.perf_counter()
    fcorpus = log_corpus(fmb)
    fp = plant_line(fcorpus, len(fcorpus) - 8192, FIND_PLANT)
    fcorpus = bytes(fcorpus)
    fgen_s = time.perf_counter() - t0
    fn = len(fcorpus)
    fexp = find_oracle(fcorpus, fp, b"bob_x")
    t0 = time.perf_counter()
    # independent checks of the generator's span: the native DFA's first
    # match end is the boundary after the user's first letter, and the
    # native Pike engine over a window that begins 64 KB before the line
    # agrees
    ffirst, _ = fsc._native.scan_first(fcorpus, 0)
    if ffirst != fexp[1][4] + 1:
        raise AssertionError("first match end %d, planted user at %d"
                             % (ffirst, fexp[1][4]))
    if pike_window(fsc.program, fcorpus, fp - 65536) != fexp:
        raise AssertionError("Pike window != the planted match %r" % (fexp,))
    foracle_s = time.perf_counter() - t0

    def check_find(r):
        if r != fexp:
            raise AssertionError("find %r != the planted match %r"
                                 % (r, fexp))
        st_ = fsc.stats()
        if (st_.tier, st_.certified, st_.repaired) != (
                "TdfaSpecTables", True, 0):
            raise AssertionError("find not certified in one pass: %r"
                                 % st_)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fprep = fsc.prepare(fcorpus)
    t0 = time.perf_counter()
    check_find(fsc.find(fcorpus, prepared=fprep))
    ffirst_s = time.perf_counter() - t0
    fdt = min_rep_seconds(lambda: fsc.find(fcorpus, prepared=fprep),
                          check_find)
    fst = fsc.stats()
    launches["tdfa"] = tdfa.tdfa_scan_launches
    say("find", mb=fmb, bytes=fn, pattern=FIND_PATTERN.decode(),
        match=fexp, find_gbps=fn / fdt / 1e9, tier=fst.tier,
        certified=fst.certified, repaired=fst.repaired, chunks=fst.chunks,
        S=ft.nstates, ncls=ft.ncls, R=ft.nregs, T=ft.ntags,
        CODE=ft.code_bits, rows=ft.rows, bits=ft.bits,
        launches=launches["tdfa"], first_call_s=ffirst_s,
        corpus_s=fgen_s, oracle_s=foracle_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    # a 16 MB corpus whose one match spans 1.5 MB: past the window and
    # the chunk-repair budget (1/16 of the chunks), so the one-pass
    # result falls back to the multi-pass path
    gcorpus = log_corpus(16)
    user = b"a" * (3 << 19)
    gp = plant_line(gcorpus, 8 << 20,
                    FIND_PLANT.replace(b"bob_x", user))
    gcorpus = bytes(gcorpus)
    gexp = find_oracle(gcorpus, gp, user)
    if pike_window(fsc.program, gcorpus, gp - 65536) != gexp:
        raise AssertionError("Pike window != the planted long match")
    gsc = sregex_tpu_torch.compile_pattern(FIND_PATTERN)
    reset_launches()
    t0 = time.perf_counter()
    got = gsc.find(gcorpus)
    fallback_s = time.perf_counter() - t0
    gst = gsc.stats()
    glaunch = dict(tdfa=tdfa.tdfa_scan_launches,
                   spec=scan.spec_scan_launches + scan.pair_scan_launches)
    if got != gexp:
        raise AssertionError("fallback find %r != the planted match"
                             % (got[:1],))
    if gst.certified is not False or glaunch["tdfa"] < 1 \
            or glaunch["spec"] < 2 or gsc._rev_spec is None:
        raise AssertionError("the long match did not take the multi-pass "
                             "path on the card: %r %r" % (gst, glaunch))
    say("find_fallback", mb=16, bytes=len(gcorpus), span=len(user) + 23,
        served_by="multi-pass", prefilter_tier=gst.tier,
        reverse_tier=type(gsc._rev_spec).__name__,
        certified=gst.certified, launches=glaunch, seconds=fallback_s)
    del gcorpus

    # --- 10. phi: the run-parity machine on the exact tier ----------------
    pmb = mb_env("SREGEX_BENCH_PHI_MB")
    psc = sregex_tpu_torch.compile_pattern(PHI_PATTERN)
    if type(psc._spec).__name__ != "SpecTablesPair":
        raise AssertionError("b(?:aa)*b served by %s"
                             % type(psc._spec).__name__)
    t0 = time.perf_counter()
    act = run_corpus(min(64, pmb), 60, 300, 0)
    pcorpus = run_corpus(pmb, 60, 300, 0)
    # every run odd but one, 8 KB before the end: one match, near the end
    scorpus = run_corpus(pmb, 60, 300, 1, odd=True, plant=(8192, 100))
    pgen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pexp = native_count(psc, pcorpus)
    pexp_first, _ = psc._native.scan_first(scorpus, 0)
    pnative_s = time.perf_counter() - t0
    if not len(scorpus) - 8192 <= pexp_first < len(scorpus):
        raise AssertionError("the planted run ends at %d" % pexp_first)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pladder = activate_phi(psc, act, 4)
    pact_s = time.perf_counter() - t0
    del act
    pt = psc._phi_tables()
    phi_stats = {}
    pprep = psc.prepare(pcorpus)
    pdt, pfirst_s, pst = time_phi(psc, "count", pcorpus, pprep, pexp)
    sprep = psc.prepare(scorpus)
    psdt, psfirst_s, _ = time_phi(psc, "scan", scorpus, sprep, pexp_first)
    del sprep, scorpus
    launches["phi"] = tphi.phi_scan_launches
    pn = len(pcorpus)
    say("phi", mb=pmb, bytes=pn, pattern=PHI_PATTERN.decode(), count=pexp,
        first_end=pexp_first, phi_count_gbps=pn / pdt / 1e9,
        phi_scan_gbps=pn / psdt / 1e9, tier=pst.tier,
        static_tier=type(psc._spec).__name__, states=pt.nstates,
        classes=pt.ncls, nseg=pt.nseg, bits=pt.bits, ladder=pladder,
        warm_events=pst.warm_events, repaired=pst.repaired,
        chunks=pst.chunks, launches=launches["phi"], activate_s=pact_s,
        first_count_s=pfirst_s, first_scan_s=psfirst_s, corpus_s=pgen_s,
        native_s=pnative_s, peak_mem_bytes=torch.cuda.max_memory_allocated())
    phi_stats["phi"] = (pt, pprep.for_tables(pt))
    del pcorpus

    # --- 11. phi_big: a residue mod 499 on the sublane-group tier ---------
    qmb = mb_env("SREGEX_BENCH_PHI_BIG_MB")
    qsc = sregex_tpu_torch.compile_pattern(PHI_BIG_PATTERN)
    if type(qsc._spec).__name__ != "SpecTablesAffine":
        raise AssertionError("b(?:a{499})*b served by %s"
                             % type(qsc._spec).__name__)
    t0 = time.perf_counter()
    # runs of 4096-16384: at the ladder's last window (2048) ~80% of the
    # chunks still miss, past the 25% strike threshold
    act = run_corpus(min(64, qmb), 4096, 16384, 2)
    qcorpus = run_corpus(qmb, 4096, 16384, 2)
    # no run a multiple of 499 but one of 4990, near the end
    scorpus = run_corpus(qmb, 4096, 16384, 3, avoid=499,
                         plant=(40000, 4990))
    qgen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    qexp = native_count(qsc, qcorpus)
    qexp_first, _ = qsc._native.scan_first(scorpus, 0)
    qnative_s = time.perf_counter() - t0
    if not len(scorpus) - 40000 <= qexp_first < len(scorpus):
        raise AssertionError("the planted run ends at %d" % qexp_first)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    qladder = activate_phi(qsc, act, 10)
    qact_s = time.perf_counter() - t0
    del act
    qt = qsc._phi_tables()
    qprep = qsc.prepare(qcorpus)
    qdt, qfirst_s, qst = time_phi(qsc, "count", qcorpus, qprep, qexp)
    sprep = qsc.prepare(scorpus)
    qsdt, qsfirst_s, _ = time_phi(qsc, "scan", scorpus, sprep, qexp_first)
    del sprep, scorpus
    launches["phi_big"] = tphi.phi_big_scan_launches
    qn = len(qcorpus)
    say("phi_big", mb=qmb, bytes=qn, pattern=PHI_BIG_PATTERN.decode(),
        count=qexp, first_end=qexp_first, phi_count_gbps=qn / qdt / 1e9,
        phi_scan_gbps=qn / qsdt / 1e9, tier=qst.tier,
        static_tier=type(qsc._spec).__name__, states=qt.nstates,
        classes=qt.ncls, rows=qt.rows, SB=qt.SB, CPT=qt.CPT, bits=qt.bits,
        ladder=qladder, warm_events=qst.warm_events, repaired=qst.repaired,
        chunks=qst.chunks, launches=launches["phi_big"], activate_s=qact_s,
        first_count_s=qfirst_s, first_scan_s=qsfirst_s, corpus_s=qgen_s,
        native_s=qnative_s, peak_mem_bytes=torch.cuda.max_memory_allocated())
    phi_stats["phi_big"] = (qt, qprep.for_tables(qt))
    del qcorpus

    if min(launches.values()) <= 0:
        raise AssertionError("a main path skipped its kernel: %r"
                             % launches)

    # --- 12. kernel vs plain time at the main path's shapes ---------------
    # narrow and big: the redesigned kernel the main path ran (the
    # two-code table, the 16-bit table) in the path's mode and the other
    # one, and the one-lookup kernel at the same shape
    shapes = [("narrow", spec, tables, prepared[0], False,
               dict(pair=tables.pair), "two-code"),
              ("wide", spec, msc._spec, mprep.for_tables(msc._spec)[0],
               True, {}, "one-lookup"),
              ("big", (big.big_scan, big.big_scan_ref), bsc._spec,
               bprep.for_tables(bsc._spec)[0], True,
               dict(t16=bsc._spec.t16), "16-bit")]
    for tier, fns, t, data, count, tab, variant in shapes:
        B = data.shape[0]
        s0, j0 = scan._entry_planes(0, t.warmup, B, dev)
        args = [data, s0, j0, t.fused]
        kw = dict(W=t.warmup, CPW=t.cpw, BITS=t.bits, COUNT=count)
        errs[tier] = max(errs[tier], compare(*fns, args, kw, tab))
        ms = time_gpu(lambda: fns[0](*args, **kw, **tab), 20)
        plain_ms = time_gpu(lambda: fns[1](*args, **kw), 2)
        steps = s0.numel() * data.shape[1] * t.cpw
        bms, by = bound_ms(args, steps)
        timings[tier] = (ms, plain_ms, bms, by, list(data.shape))
        more = {}
        if tab:
            other = dict(kw, COUNT=not count)
            errs[tier] = max(errs[tier], compare(*fns, args, other, tab))
            more = dict(other_mode_ms=time_gpu(
                lambda: fns[0](*args, **other, **tab), 20),
                one_lookup_ms=time_gpu(lambda: fns[0](*args, **kw), 20))
        say("kernel_time", tier=tier, shape=list(data.shape), count=count,
            variant=variant, ms=ms, plain_ms=plain_ms, bound_ms=bms,
            bound_by=by, corpus_gbps=s0.numel()
            * (data.shape[1] * t.cpw - t.warmup) / ms / 1e6, **more)
    say("kernel_time", **affine_times(asc, aprep, acorpus, timings, errs,
                                      dev))
    # the tagged kernel at the find phase's shape, entered as tdfa_spec_find
    # enters it (every stream at the seed, the true entry frozen below W)
    fdata = fprep.for_tables(ft)[0]
    s0 = torch.full((fdata.shape[0], GROUPS, 8, 128), ft.seed_premult,
                    dtype=torch.int32, device=dev)
    j0 = torch.zeros_like(s0)
    j0[0, 0, 0, 0] = ft.warmup
    tabs, kw = ft.planes()
    args = [fdata, s0, j0, *tabs]
    errs["tdfa"] = max(errs["tdfa"], compare(tdfa.tdfa_scan,
                                             tdfa.tdfa_scan_ref, args, kw))
    ms = time_gpu(lambda: tdfa.tdfa_scan(*args, **kw), 20)
    plain_ms = time_gpu(lambda: tdfa.tdfa_scan_ref(*args, **kw), 1)
    # bytes: the inputs once and the T+R+3 output planes once; operations:
    # one per byte step and one per register rebuilt at each step
    moved = sum(a.numel() * a.element_size() for a in args) \
        + (ft.ntags + ft.nregs + 3) * s0.numel() * 4
    steps = s0.numel() * fdata.shape[1] * ft.cpw * (1 + ft.nregs)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = steps / SCALAR_OPS_PER_S * 1e3
    bms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    timings["tdfa"] = (ms, plain_ms, bms, by, list(fdata.shape))
    say("kernel_time", tier="tdfa", shape=list(fdata.shape), ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        corpus_gbps=s0.numel() * (fdata.shape[1] * ft.cpw - ft.warmup)
        / ms / 1e6, R=ft.nregs, T=ft.ntags, CODE=ft.code_bits,
        steps_1mb=tdfa_step_shares(ft, fcorpus))
    # the phi kernels in COUNT mode at their main path's shapes; the big
    # one's plain version on the first PHI_BIG_PLAIN_MB MB of the corpus
    for tier, fns in (("phi", (tphi.phi_scan, tphi.phi_scan_ref)),
                      ("phi_big", (tphi.phi_big_scan,
                                   tphi.phi_big_scan_ref))):
        t, prep = phi_stats[tier]
        data, C, K = prep[0], prep[1], prep[2]
        kw = phi_kw(t, prep, True)
        pdata = data
        if tier == "phi_big":
            chunks_per_block = GROUPS * t.CPT
            plain_mb = min(PHI_BIG_PLAIN_MB, qmb)
            pdata = data[:-(-(plain_mb << 20) // K // chunks_per_block)]
        # each kernel takes its tables' cached k-gram table (the
        # Scanner's), each other k measured beside it, and the chosen k
        # once in scan mode
        st, st_scan = t.stride(True), t.stride(False)
        by_k = {}
        for k in (8, 4, 2, 1):
            if t.cpw % k or t.nstates * t.ncls ** k + t.fused.numel() \
                    + 256 > tphi.STRIDE_SMEM_ENTRIES \
                    or k not in (1, *t.STRIDE_KS):
                continue
            stk = t.stride(True, k)
            errs[tier] = max(errs[tier], compare_phi(
                *fns, [pdata, t.fused], kw, stk))
            by_k[k] = time_gpu(lambda: fns[0](data, t.fused, stride=stk,
                                              **kw), 5)
        errs[tier] = max(errs[tier], compare_phi(
            *fns, [pdata, t.fused], kw, st))
        ms = time_gpu(lambda: fns[0](data, t.fused, stride=st, **kw), 20)
        kw_scan = dict(kw, COUNT=False)
        errs[tier] = max(errs[tier], compare_phi(
            *fns, [pdata, t.fused], kw_scan, st_scan))
        scan_ms = time_gpu(lambda: fns[0](data, t.fused, stride=st_scan,
                                          **kw_scan), 5)
        plain_ms = time_gpu(lambda: fns[1](pdata, t.fused, **kw), 1)
        plain_kernel_ms = (ms if pdata is data else
                           time_gpu(lambda: fns[0](pdata, t.fused, stride=st,
                                                   **kw), 5))
        # bytes: the words and the table once, the two planes once;
        # operations: one table lookup for each live slot (C chunks, S
        # entry states) and each k bytes the kernel takes a lookup (every
        # word of these corpora is in range, so both kernels take k
        # classes on every lookup)
        moved = (data.numel() + t.fused.numel()
                 + 2 * data.shape[0] * GROUPS * 1024) * 4
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        k_run = st[0]
        t_ops = C * t.nstates * (K // k_run) / SCALAR_OPS_PER_S * 1e3
        bms, by = ((t_bytes, "bytes") if t_bytes >= t_ops
                   else (t_ops, "operations"))
        timings[tier] = (ms, plain_ms, bms, by, list(data.shape),
                         list(pdata.shape))
        say("kernel_time", tier=tier, shape=list(data.shape), count=True,
            ms=ms, plain_ms=plain_ms, plain_shape=list(pdata.shape),
            kernel_ms_at_plain_shape=plain_kernel_ms, bound_ms=bms,
            bound_by=by, corpus_gbps=C * K / ms / 1e6, k=k_run,
            ms_by_k=by_k, scan_ms=scan_ms)
    say("done", seconds=time.perf_counter() - t_start)

    print(smi, flush=True)
    kernels = []
    for tier, src, where in (
            ("narrow", "pair_scan.cu", "sregex_tpu/ops/pallas_scan.py:267"),
            ("wide", "spec_scan.cu", "sregex_tpu/ops/pallas_scan.py:334"),
            ("big", "big_scan.cu", "sregex_tpu/ops/pallas_big.py:169"),
            ("affine", "affine_scan.cu",
             "sregex_tpu/ops/pallas_affine.py:275"),
            ("tdfa", "tdfa_scan.cu", "sregex_tpu/ops/tdfa_scan.py:450"),
            ("phi", "phi_scan.cu", "sregex_tpu/ops/pallas_phi.py:410"),
            ("phi_big", "phi_scan.cu", "sregex_tpu/ops/pallas_phi.py:206"),
            ("gated", "gated_scan.cu",
             "sregex_tpu/ops/pallas_core.py:623")):
        ms, plain_ms, bms, by, shape = timings[tier][:5]
        if tier == "tdfa":
            name = "tagged-DFA scan (shape %s)" % shape
        elif tier == "phi":
            name = "lane-packed phi scan (shape %s)" % shape
        elif tier == "phi_big":
            name = ("sublane-group phi scan (shape %s; plain_ms at %s, the "
                    "first %d MB)" % (shape, timings[tier][5], plain_mb))
        elif tier == "gated":
            name = ("gated phase-2 scan (%s route, big table, windows read "
                    "in place, slots %s, %d escaped chunks)"
                    % (timings[tier][5], shape, nesc))
        elif tier == "narrow":
            name = "two-code spec scan (narrow table, shape %s)" % shape
        elif tier == "big":
            name = "16-bit spec scan (big table, shape %s)" % shape
        else:
            name = "%s scan (%s table, shape %s)" % (
                "affine" if tier == "affine" else "spec", tier, shape)
        kernels.append({
            "name": name,
            "route": "cuda", "source": "sregex_tpu_torch/csrc/" + src,
            "replaces": where, "launches": launches[tier],
            "max_abs_err": errs[tier], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
