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
  - find_core: find past the static tiers: Scanner.find of a log-field
    extractor whose tagged DFA is past the card's dense budget,
    user=([a-z_]{1,40}) id=([0-9]{4,12}), over SREGEX_BENCH_FIND_MB of
    log lines whose ids have 1-3 digits, one match planted near the end
    (the hot core, TdfaCoreTables: certified in one tagged launch, the
    host repair fold over every chunk), a certified no-match over the
    corpus without the plant, and beside them the multi-pass route of a
    Scanner whose tagged budget declines the core; find of
    a.{10}b|cdefghijklmnopqrstuvwxyz and of a.{13}b|cdefgh...xyz over
    INDEX_ROUTE_MB of filler with one match near the end, whose start
    locators run on the reverse machine's legacy core and on the lazy
    reverse core (core_scan_last_bytes), each beside the host walk it
    replaces; find of a.{13}b on its hot core; then precompile and a
    first count of the 90 keywords over the multi corpus on the static
    wide tier and (SREGEX_FUSED=1, a sample of its head) the fused tier,
    beside a first count without it, each exact against the native
    count;
  - phi: Scanner.count and Scanner.scan of the run-parity machine
    b(?:aa)*b over 1920 MB of a-runs, after two repair-heavy scans of a
    64 MB corpus have switched it from the pair tier to the exact
    transfer-composition tier (the lane-packed phi kernel);
  - phi_big: the same for b(?:a{499})*b, a residue mod 499 (501 states),
    after eight scans have climbed the warmup ladder 32 -> 128 -> 512 ->
    2048 and switched it from the affine tier (the sublane-group phi
    kernel);
  - stream: StreamScanner in 64 MB chunks over 1920 MB of the
    headline's text and of multi's filler, one match planted across the
    last chunk boundary (the narrow and wide tiers entered in the carried
    states), and the no-static-tier machine over 256 MB (the legacy
    core), each checked against the plant, the native engine and
    Scanner.scan of the whole corpus;
  - finditer: the log-field extractor over 1920 MB of log lines with one
    match planted every 1 MB: make_index (the reverse machine's COUNT
    pass over the corpus flipped on the card), finditer and sub through
    it, every ovector and the sub output held against the generator's,
    and the host TDFA walker over the same corpus;
  - pipeline: Scanner.count_stream, scan_stream and match_stream (the
    pipelined stream: each 64 MB segment staged in pinned memory and
    uploaded on a copy stream while the segment before it is scanned)
    over the stream phase's three corpora and 256 MB of the dictionary's
    (the static big tier), given as memoryviews over the host buffer as
    a file reader yields them, each count held against Scanner.count of
    the whole corpus and the native count, each scan against the plant;
    multi's count again from one refilled buffer at in_flight=3; then
    finditer_stream and sub_stream over the finditer corpus, held
    against finditer and sub through the index; and one segment's
    stages (the copy into pinned memory, the upload, beside it a
    pageable upload, the prep, the kernel, the fold) timed one after
    another, whose slower copy rate bounds the stream;
  - batch: the batched document surface (Scanner.count_many, scan_many,
    match_many, find_many, finditer_many, sub_many) over document sets
    cut from the corpora above (lengths log-uniform in 512 B - 4 MB,
    each below DEVICE_THRESHOLD, with empty and sub-chunk documents):
    the 90 keywords over BATCH_MB (the wide tier; a keyword across every
    tenth document boundary, which must not count), the headline over
    BATCH_MB (the two-code kernel), the dictionary over BATCH_DICT_MB on
    the static big tier, on the fused batch (SREGEX_FUSED=1, phase 2 on
    the gated kernel) and past its device cap (the per-document overflow
    fold), the no-static-tier machine on the legacy core, and the
    log-field extractor over BATCH_FIND_MB of the finditer corpus (the
    tagged kernel; BATCH_SUB_MB for finditer_many and sub_many), every
    document's result against its native count or scan, the generator's
    ovector, or the host Scanner's findall and sub; each call timed
    first, then over a prepare_many handle, beside the per-document loop;
  - index_routes: make_index over 256 MB on the reverse legacy core,
    the lazy reverse core and, under SREGEX_FUSED=1, the dictionary's
    fused reverse core, each map held against a native walk of the
    reversed corpus and its match starts against the generator's;
  - tier_ab: the first-scan A/B of the "ab" band (wide machines of 3
    to 16 rows, SREGEX_TIER_AB on): Scanner.count of a 4-row and a 6-row
    machine over TIER_AB_MB of digit and symbol filler, a match about
    once a MB, the first call served by the fast legacy or the fused
    core and timing it against the static wide tier on a 32 MB slice,
    the next by the winner (a fused core that loses gives way to the
    fast legacy core and its own A/B), every count against the native
    count; then the 4-row machine over a virtual mesh of MESH_SHARDS
    shards;
  - mesh (last): the paths again over a virtual mesh of MESH_SHARDS
    shards of the card (ops/mesh.py), each beside one device in the
    same run and both equal to the oracle: the headline's
    Scanner(mesh=).scan, the 90 keywords' Scanner(mesh=).count, the
    dictionary's core_count_fused(mesh=) and static big count and the
    affine count over their corpora, the no-static-tier machine on the
    legacy core and count_stream over MESH_CORE_MB, count_many over the
    batch phase's keyword documents; dryrun_multichip on the same mesh;
    two processes on the card over gloo (chip_smoke.py --multihost RANK
    INIT CARDS, parallel.multihost, aligned and ragged slices of
    MESH_PROC_MB) against the native engine; where torch sees several
    cards, the same over every card (each process on half of them).

Every phase prints one line; any failure raises, so the script exits
non-zero without the final line.  The kernel launch counts are set to
0 just before each path is driven and read just after it.

Output, in order: one line per phase, the card's name and power limit
as nvidia-smi reports them, a JSON line {"kernels": [...]} with each
kernel's launches on its main path, its largest difference from the
plain version, its time beside the plain version's and its bound at
the main path's shapes, and last {"ok": true, "device": {...}}.

SREGEX_BENCH_MB (the headline and its stream), SREGEX_BENCH_MULTI_MB (the
90 keywords and their stream), SREGEX_BENCH_AFFINE_MB, SREGEX_BENCH_BIG_MB
(the big and core phases), SREGEX_BENCH_FIND_MB (find and finditer),
SREGEX_BENCH_PHI_MB and SREGEX_BENCH_PHI_BIG_MB size the corpora (default
1920 each); the legacy-core stream and each index route run over
STREAM_CORE_MB and INDEX_ROUTE_MB, the batch phase's sets over the
BATCH_*_MB constants.
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
from sregex_tpu_torch.consts import SRE_AGAIN, SRE_ERROR, SRE_OK, sre_isword
from sregex_tpu_torch.dfa import LazyDfa
from sregex_tpu_torch.native_pike import NativePikeCtx
from sregex_tpu_torch.ops import _build
from sregex_tpu_torch.ops import affine as aff
from sregex_tpu_torch.ops import batch as tbatch
from sregex_tpu_torch.ops import big
from sregex_tpu_torch.ops import core as tcore
from sregex_tpu_torch.ops import pair as tpair
from sregex_tpu_torch.ops import phi as tphi
from sregex_tpu_torch.ops import pipeline as tpipe
from sregex_tpu_torch.ops import spec_scan as scan
from sregex_tpu_torch.ops import tdfa_scan as tdfa
from sregex_tpu_torch import stream as tstream
from sregex_tpu_torch.ops.layout import GROUPS
from sregex_tpu_torch.ops.mesh import make_mesh
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
STREAM_CORE_MB = 256          # the legacy-core stream's corpus
PIPE_SEGMENT = 64 << 20       # the pipeline phase's segments
PIPE_DICT_MB = 256            # the dictionary's stream in that phase
INDEX_ROUTE_MB = 256          # each other index route's corpus
BATCH_MB = 1024               # the batch phase's keyword and headline sets
BATCH_DICT_MB = 256           # its dictionary and no-static-tier sets
BATCH_FIND_MB = 256           # its find_many set, cut from finditer's corpus
BATCH_SUB_MB = 64             # its finditer_many / sub_many set
# the dictionary set's words: one every 64 KB, as in the big phase, and
# past each document's first 64 KB (where the batch's core sample never
# reads) one every 12 KB more, whose chunks escape the core: more than
# one phase-2 block row of escapes, so a cap of one row overflows
BATCH_DICT_STEP = 12 << 10
# past the eager DFA budget: no dense machine, the lazy one serves
LAZY_PATTERN = rb"a.{13}b"
# a log-field extractor whose tagged DFA is past the card's dense budget
# (2048 entries): find keeps its one pass on the hot core
FIND_CORE_PATTERN = rb"user=([a-z_]{1,40}) id=([0-9]{4,12})"
# log lines whose ids have 1-3 digits, near misses of FIND_CORE_PATTERN,
# each ending in a newline, so no line and no suffix of one matches
FIND_CORE_LINES = [b"2026-10-16T14:05:28Z INFO auth user=alice id=41 ok\n",
                   b"2026-10-16T14:05:29Z WARN auth user=bob_x id=7 n=3\n",
                   b"2026-10-16T14:05:30Z INFO api user=carol_s id=123 /a\n",
                   b"2026-10-16T14:05:31Z DEBUG api user= id=9 token\n",
                   b"2026-10-16T14:05:32Z INFO cache user=dave id=x12\n"]
FIND_CORE_PLANT = b"2026-10-16T14:05:33Z ERROR auth user=mallory id=31337 x\n"
# the hot-core find's timed reps: its host fold decodes every chunk
FIND_CORE_REPS = 2
# past the eager budget forward and reversed, and on text full of a's no
# hot tagged core fits it: find's start locator is the lazy reverse core
LAZY_FIND_PATTERN = "a.{13}b|cdefghijklmnopqrstuvwxyz"
REPS = 5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA's data sheet
SCALAR_OPS_PER_S = 67e12      # H100 SXM, non-tensor 32-bit rate


def say(phase, **fields):
    print("%s: %s" % (phase, json.dumps(fields)), flush=True)


def mb_env(name, default=1920):
    return int(os.environ.get(name, str(default)))


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


# each kernel row's launch counter: (module, attribute)
LAUNCH_COUNTERS = dict(
    narrow=(scan, "pair_scan_launches"), wide=(scan, "spec_scan_launches"),
    big=(big, "big_smem_launches"), big_global=(big, "big_scan_launches"),
    affine=(aff, "affine_scan_launches"), tdfa=(tdfa, "tdfa_scan_launches"),
    phi=(tphi, "phi_scan_launches"), phi_big=(tphi, "phi_big_scan_launches"),
    gated=(tcore, "gated_scan_launches"))


def launch_counts(base=None):
    """Each kernel row's launch count now (less ``base``)."""
    now = {k: getattr(m, a) for k, (m, a) in LAUNCH_COUNTERS.items()}
    return now if base is None else {k: now[k] - base[k] for k in now}


def tally(launches):
    """Add the counts since the last reset to each kernel row's
    launches."""
    for k, v in launch_counts().items():
        if k in launches:
            launches[k] += v


def reset_launches():
    for m, a in LAUNCH_COUNTERS.values():
        setattr(m, a, 0)
    for route in tcore.gated_route_launches:
        tcore.gated_route_launches[route] = 0


@contextlib.contextmanager
def launches_uncounted():
    """Launches made inside (a check's, not a path's) leave every
    kernel row's count as it was."""
    saved = launch_counts()
    routes = dict(tcore.gated_route_launches)
    try:
        yield
    finally:
        for k, (m, a) in LAUNCH_COUNTERS.items():
            setattr(m, a, saved[k])
        tcore.gated_route_launches.update(routes)


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


def hot_core_tdfa_cases(rng, dev):
    """The tagged kernel's inputs on hot-core planes (the ESC sink's row
    block: a self-loop, UNSET rebuilds, no commits): FIND_CORE_PATTERN's
    core sampled from its log lines, over lines with random letters
    spliced in (escapes) and the plant, and (a{150,300})b's two-state core
    over text with a-runs; each entered as tdfa_spec_find enters it and
    from random kernel states, ESC among them.  Returns [(args, kw)]."""
    out = []
    logs = bytes(log_corpus(1, lines=FIND_CORE_LINES))
    text = bytearray(log_corpus(4, seed=5, lines=FIND_CORE_LINES))
    for at in rng.integers(0, len(text) - 64, 400).tolist():
        text[at:at + 8] = rng.choice(np.frombuffer(
            b"abcdefghijklmnopqrstuvwxyz_0123456789 =", np.uint8), 8).tobytes()
    plant_line(text, 3 << 20, FIND_CORE_PLANT)
    xyz = rng.choice(np.frombuffer(b"xyz mnpq", np.uint8), 4 << 20)
    runs = bytearray(xyz.tobytes())
    for at in rng.integers(0, len(runs) - 300, 300).tolist():
        k = int(rng.integers(100, 250))
        runs[at:at + k + 1] = b"a" * k + b"b"
    for pat, sample, corpus in (
            (FIND_CORE_PATTERN, logs, bytes(text)),
            (rb"(a{150,300})b", xyz[:1 << 16].tobytes(), bytes(runs))):
        ct = tdfa.TdfaCoreTables(compile_regex(parse(pat)[0]), sample, dev)
        data, _, _, _, B = prepare_on_device(ct, corpus, 2048)
        shape = (B, GROUPS, 8, 128)
        tabs, kw = ct.planes()
        s0 = torch.full(shape, ct.seed_premult, dtype=torch.int32, device=dev)
        j0 = torch.zeros_like(s0)
        j0[0, 0, 0, 0] = ct.warmup
        out.append(([data, s0, j0, *tabs], kw))
        s0 = torch.from_numpy((rng.integers(0, ct.H + 1, shape)
                               * ct.ncls).astype(np.int32)).to(dev)
        j0 = torch.from_numpy(rng.integers(0, ct.warmup + 1, shape)
                              .astype(np.int32)).to(dev)
        out.append(([data, s0, j0, *tabs], kw))
    return out


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


def tdfa_times(t, data, dev, errs):
    """The tagged kernel over tables ``t`` and their prep ``data``, entered
    as tdfa_spec_find enters it (every stream at the seed, the true entry
    frozen below W): held against its plain version (errs["tdfa"]),
    timed (20 launches; the plain version once) beside its bound.
    Returns the kernel_time line's fields."""
    s0 = torch.full((data.shape[0], GROUPS, 8, 128), t.seed_premult,
                    dtype=torch.int32, device=dev)
    j0 = torch.zeros_like(s0)
    j0[0, 0, 0, 0] = t.warmup
    tabs, kw = t.planes()
    args = [data, s0, j0, *tabs]
    errs["tdfa"] = max(errs["tdfa"], compare(tdfa.tdfa_scan,
                                             tdfa.tdfa_scan_ref, args, kw))
    ms = time_gpu(lambda: tdfa.tdfa_scan(*args, **kw), 20)
    plain_ms = time_gpu(lambda: tdfa.tdfa_scan_ref(*args, **kw), 1)
    # bytes: the inputs once and the T+R+3 output planes once; operations:
    # one per byte step and one per register rebuilt at each step
    moved = sum(a.numel() * a.element_size() for a in args) \
        + (t.ntags + t.nregs + 3) * s0.numel() * 4
    steps = s0.numel() * data.shape[1] * t.cpw * (1 + t.nregs)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = steps / SCALAR_OPS_PER_S * 1e3
    bms, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return dict(shape=list(data.shape), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by,
                corpus_gbps=s0.numel() * (data.shape[1] * t.cpw - t.warmup)
                / ms / 1e6, R=t.nregs, T=t.ntags, CODE=t.code_bits)


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


def multi_corpus(mb, words, step=64 << 10, positions=None):
    """Disjoint filler words with a dictionary word planted every 64 KB
    (the JAX package's bench_multi corpus); ``step`` None plants none.
    ``positions`` collects each plant's offset (" word " starts there)."""
    rng = random.Random(1234)
    filler = [w.encode() for w in
              ("alpha bravo delta golf hotel juliet kilo lima mike "
               "november oscar papa quebec romeo sierra tango uniform "
               "victor whiskey xray yankee zulu").split()]
    piece = b" ".join(rng.choice(filler) for _ in range(512)) + b" "
    body = piece * (mb * (1 << 20) // len(piece) + 1)
    out = bytearray(body[:mb << 20])
    for pos in range(step, len(out) - 64, step) if step else ():
        w = words[rng.randrange(len(words))]
        out[pos:pos + len(w) + 2] = b" " + w + b" "
        if positions is not None:
            positions.append(pos)
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


def log_corpus(mb, seed=17, block_mb=32, lines=FIND_LINES):
    """Log lines drawn from ``lines``: one seeded block of block_mb MB,
    repeated to mb MB."""
    rng = np.random.default_rng(seed)
    n = min(mb, block_mb) << 20
    mean = sum(map(len, lines)) / len(lines)
    idx = rng.integers(0, len(lines), int(n / mean) + 64)
    block = b"".join(lines[i] for i in idx)[:n]
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


def stream_chunk(mb):
    """The stream phase's chunk length: 64 MB, or a quarter of a corpus
    under 256 MB (never under StreamScanner.DEVICE_THRESHOLD)."""
    return max(sregex_tpu_torch.StreamScanner.DEVICE_THRESHOLD,
               min(64 << 20, (mb << 20) // 4))


def feed_stream(ss, corpus, chunk):
    """Feed ``corpus`` to StreamScanner ``ss`` in ``chunk``-byte pieces
    (views, no copies).  Returns (rc, offset, matched_regex, seconds in
    exec, bytes fed, the entry state of each piece)."""
    view = memoryview(corpus)
    secs, fed, states = 0.0, 0, []
    for lo in range(0, len(corpus), chunk):
        piece = view[lo:lo + chunk]
        states.append(int(ss.state))
        t0 = time.perf_counter()
        rc, off = ss.exec(piece, eof=lo + chunk >= len(corpus))
        secs += time.perf_counter() - t0
        fed += len(piece)
        if rc != SRE_AGAIN:
            break
    return rc, off, ss.matched_regex, secs, fed, states


def stream_case(dev, name, sc, corpus, plant_end, rid, chunk):
    """One StreamScanner run over ``corpus`` with the Scanner's tables,
    checked against the planted match's end and regex id, the native
    engine and Scanner.scan of the whole corpus.  Returns its fields."""
    t0 = time.perf_counter()
    native_first, _ = sc._native.scan_first(corpus, 0)
    native_s = time.perf_counter() - t0
    if native_first != plant_end:
        raise AssertionError("%s: native first end %d, planted %d"
                             % (name, native_first, plant_end))
    ss = sregex_tpu_torch.StreamScanner(sc.dfa, device=dev,
                                        device_tables=sc._spec or None)
    p0 = scan.pair_scan_launches + scan.spec_scan_launches
    rc, off, mrid, secs, fed, states = feed_stream(ss, corpus, chunk)
    launched = scan.pair_scan_launches + scan.spec_scan_launches - p0
    if (rc, off, mrid) != (SRE_OK, plant_end, rid):
        raise AssertionError("%s stream %r != planted %r"
                             % (name, (rc, off, mrid), (plant_end, rid)))
    if ss.exec(b"x") != (SRE_ERROR, -1):
        raise AssertionError("%s: exec after the match" % name)
    t0 = time.perf_counter()
    whole = sc.scan(corpus)
    scan_s = time.perf_counter() - t0
    if whole != (rid, plant_end):
        raise AssertionError("%s: Scanner.scan %r" % (name, whole))
    ct = ss._coret
    tier = type(ct if ct else ss._tables).__name__
    in_core = sum(ct.to_core_premult(s) >= 0 for s in states) if ct else 0
    return dict(bytes=len(corpus), chunk=chunk, chunks=len(states),
                tier=tier, end=off, matched_regex=mrid,
                stream_scan_gbps=fed / secs / 1e9, exec_s=secs,
                nonzero_entries=sum(s != 0 for s in states),
                entries_in_core=in_core, launches=launched,
                scanner_scan_s=scan_s, native_s=native_s)


def stream_phase(dev, mb, mmb, pats, tmb=STREAM_CORE_MB):
    """StreamScanner on the headline pattern over ``mb`` MB and the 90
    keywords over ``mmb`` MB, in 64 MB chunks with one match planted
    across the last chunk boundary, and on the no-static-tier machine
    (the legacy core) over ``tmb`` MB.  Returns the phase's fields and,
    by name, each stream's (Scanner, corpus, planted end, regex id) for
    the pipeline phase."""
    out, cases = {}, {}
    # headline: abccc never matches; "aaabbccb" ends 5 bytes past the
    # last chunk boundary
    chunk = stream_chunk(mb)
    n = mb << 20
    body = (b"abccc" * (n // 5 + 1))[:n]
    p = (n - 1) // chunk * chunk - 4
    corpus = body[:p] + b"xaaabbccb" + body[p + 9:]
    del body
    hsc = sregex_tpu_torch.compile_pattern(HEADLINE, device=dev)
    out["headline"] = stream_case(dev, "headline", hsc, corpus, p + 9, 0,
                                  chunk)
    cases["headline"] = (hsc, corpus, p + 9, 0)
    # 90 keywords: the filler alone (no keyword), one keyword planted
    chunk = stream_chunk(mmb)
    msc = sregex_tpu_torch.compile_pattern(pats, device=dev)
    w = b"deadlock"
    corpus = bytearray(multi_corpus(mmb, pats, step=None))
    p = ((mmb << 20) - 1) // chunk * chunk - 3
    corpus[p:p + len(w) + 2] = b" " + w + b" "
    corpus = bytes(corpus)
    out["multi"] = stream_case(dev, "multi", msc, corpus, p + 1 + len(w),
                               pats.index(w), chunk)
    cases["multi"] = (msc, corpus, p + 1 + len(w), pats.index(w))
    # no static tier: the legacy core from the carried states; the filler
    # has no "b", so only the planted literal matches
    tchunk = stream_chunk(tmb)
    tn = tmb << 20
    tlast = (tn - 1) // tchunk * tchunk
    nsc = sregex_tpu_torch.compile_pattern(NO_TIER_PATTERN, device=dev)
    corpus = bytearray(multi_corpus(tmb, pats, step=None).replace(b"b",
                                                                  b"B"))
    lit = b"cdefghijklmnopqrstuvwxyz"
    p = tlast - 10
    corpus[p:p + len(lit)] = lit
    corpus = bytes(corpus)
    out["no_static_tier"] = stream_case(dev, "no_static_tier", nsc, corpus,
                                        p + len(lit), 0, tchunk)
    cases["no_static_tier"] = (nsc, corpus, p + len(lit), 0)
    if out["no_static_tier"]["tier"] != "CoreTables" \
            or not out["no_static_tier"]["entries_in_core"]:
        raise AssertionError("the no-static-tier stream did not take the "
                             "legacy core: %r" % out["no_static_tier"])
    return out, cases


def user_name(i):
    """A distinct [a-z_]+ user for plant i."""
    return b"u_" + bytes(97 + i // 26 ** k % 26 for k in range(3))


def redacted(data, matches):
    """The expected sub(b"status=$1 user=<redacted>") output, from the
    matches' ovectors."""
    out, pos = [], 0
    for _, ov in matches:
        out += [data[pos:ov[0]], b"status=", data[ov[2]:ov[3]],
                b" user=<redacted>"]
        pos = ov[1]
    out.append(data[pos:])
    return b"".join(out)


def index_kernel_ms(idx, data, dev):
    """The reverse tables' COUNT launch (kernel and on-device summary) on
    the index's prep of ``data``, by CUDA events."""
    t = idx.tables
    prep = prepare_on_device(t, torch.flip(
        torch.from_numpy(np.frombuffer(data, np.uint8)).to(dev), [0]),
        idx.CHUNK)
    pdata, C, K, _, B = prep
    s0, j0 = scan._entry_planes(0, t.warmup, B, dev)
    ms = time_gpu(lambda: t._scan(pdata, s0, j0, C, -1, t.warmup,
                                  COUNT=True), 5)
    return ms, list(pdata.shape)


def finditer_phase(dev, mb):
    """finditer and sub of the log-field extractor over ``mb`` MB of log
    lines with one full match planted every 1 MB (a distinct user each),
    through make_index: every ovector and the sub output held against
    the generator's, and the host walker timed over the same corpus as
    the second oracle.  Returns (the phase's fields, the index, the
    corpus, the Scanner, its finditer events and its sub output over the
    index)."""
    fsc = sregex_tpu_torch.compile_pattern(FIND_PATTERN, device=dev)
    t0 = time.perf_counter()
    corpus = log_corpus(mb)
    oracle = []
    for i in range(mb):
        user = user_name(i)
        p = plant_line(corpus, i << 20, FIND_PLANT.replace(b"bob_x", user))
        oracle.append(find_oracle(corpus, p, user))
    data = bytes(corpus)
    del corpus
    gen_s = time.perf_counter() - t0
    walker = fsc._tdfa_walker()
    t0 = time.perf_counter()
    walked = list(walker.iter_ovectors(data))
    walker_s = time.perf_counter() - t0
    if walked != oracle:
        raise AssertionError("walker: %d matches, planted %d"
                             % (len(walked), len(oracle)))
    launches0 = launch_counts()
    t0 = time.perf_counter()
    idx = fsc.make_index(data)
    index_s = time.perf_counter() - t0
    index_launches = launch_counts(launches0)
    t0 = time.perf_counter()
    got = list(fsc.finditer(data, index=idx))
    finditer_s = time.perf_counter() - t0
    if got != oracle:
        bad = next(i for i, (g, w) in enumerate(zip(got + [None] * len(
            oracle), oracle)) if g != w)
        raise AssertionError("finditer: %d matches; first difference at "
                             "%d: %r != %r" % (len(got), bad,
                                               got[bad:bad + 1],
                                               oracle[bad]))
    t0 = time.perf_counter()
    out, k = fsc.sub(b"status=$1 user=<redacted>", data, index=idx)
    sub_s = time.perf_counter() - t0
    if k != len(oracle) or out != redacted(data, oracle):
        raise AssertionError("sub: %d replacements, output %s"
                             % (k, "differs" if k == len(oracle) else "-"))
    n = len(data)
    return dict(mb=mb, bytes=n, pattern=FIND_PATTERN.decode(),
                matches=len(got), index_gbps=n / index_s / 1e9,
                finditer_gbps=n / finditer_s / 1e9,
                sub_gbps=n / sub_s / 1e9, walker_gbps=n / walker_s / 1e9,
                index_s=index_s, index_timing=idx.timing,
                reverse_route=idx.route,
                reverse_tier=type(idx.tables).__name__,
                reverse_states=fsc._rev_dfa().dfa.nstates,
                reverse_classes=fsc._rev_dfa().dfa.nclasses,
                K=idx.CHUNK, chunks=idx.C, repaired=idx.repaired,
                fired_chunks=len(idx._fires), index_launches=index_launches,
                finditer_s=finditer_s, sub_s=sub_s, walker_s=walker_s,
                corpus_s=gen_s), idx, data, fsc, got, out


def segments(corpus, size=PIPE_SEGMENT):
    """``corpus`` as a file reader yields it: memoryviews of ``size``
    bytes over the host buffer."""
    view = memoryview(corpus)
    return [view[lo:lo + size] for lo in range(0, len(corpus), size)]


def refilled(corpus, size=PIPE_SEGMENT):
    """``corpus`` through one bytearray refilled between yields (the
    readinto pattern)."""
    view, buf = memoryview(corpus), memoryview(bytearray(size))
    for lo in range(0, len(corpus), size):
        m = min(size, len(corpus) - lo)
        buf[:m] = view[lo:lo + m]    # one memcpy, as readinto makes
        yield buf[:m]


def pipe_oracles(cases, dsc, words):
    """Each pipeline case's oracles, computed before the phase's
    launches are counted: Scanner.count of the whole corpus (a launch on
    the one-shot path, not the pipeline's) and the native count, held
    equal.  Adds to ``cases`` the dictionary's stream (PIPE_DICT_MB of
    its corpus, its native first match planted by the filler).  Returns
    (count, Scanner.count seconds, native seconds) by case."""
    dcorpus = multi_corpus(PIPE_DICT_MB, words)
    dfirst, dst = dsc._native.scan_first(dcorpus, 0)
    cases["dictionary"] = (dsc, dcorpus, dfirst,
                           dsc._id_at(dst, dcorpus[dfirst]))
    out = {}
    for name, (sc, corpus, _end, _rid) in cases.items():
        t0 = time.perf_counter()
        whole = sc.count(corpus)
        whole_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = native_count(sc, corpus)
        native_s = time.perf_counter() - t0
        if whole != want:
            raise AssertionError("%s: Scanner.count %d != native %d"
                                 % (name, whole, want))
        out[name] = (want, whole_s, native_s)
    return out


def pipe_case(name, sc, corpus, plant_end, rid, tier, oracle, repairs):
    """count_stream (twice: the first call's time apart), scan_stream and
    match_stream of ``sc`` over ``corpus`` in PIPE_SEGMENT memoryviews,
    each held against its oracle: the count against ``oracle`` (the
    pipe_oracles triple), the scan against the planted end and regex id.
    ``tier``: the tables that must serve the streams; ``repairs``: the
    most chunks the count may repair natively (a wrong warmup tail or
    entry across segments would repair chunk 0 of every segment).
    Returns the case's fields."""
    n = len(corpus)
    want, whole_s, native_s = oracle
    # the first call pins the staging ring's host memory; torch's host
    # allocator keeps it for the calls after it
    counts, secs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        counts.append(sc.count_stream(segments(corpus)))
        secs.append(time.perf_counter() - t0)
        st = sc.stats()
        if counts[-1] != want or st.tier != tier or st.nbytes != n \
                or st.repaired > repairs:
            raise AssertionError("%s: count_stream %d (native %d) on %r"
                                 % (name, counts[-1], want, st))
    got, (first_count_s, count_s) = counts[-1], secs
    t0 = time.perf_counter()
    first = sc.scan_stream(segments(corpus))
    scan_s = time.perf_counter() - t0
    sst = sc.stats()
    if first != (rid, plant_end) or sst.tier != tier:
        raise AssertionError("%s: scan_stream %r != planted %r on %r"
                             % (name, first, (rid, plant_end), sst))
    if not sc.match_stream(segments(corpus)):
        raise AssertionError("%s: match_stream missed the plant" % name)
    segs = -(-n // PIPE_SEGMENT)
    return dict(bytes=n, segments=segs, tier=tier, count=got, end=first[1],
                pipe_count_gbps=n / count_s / 1e9,
                pipe_scan_gbps=n / scan_s / 1e9, count_s=count_s,
                first_count_s=first_count_s, scan_s=scan_s,
                wall_ms_per_segment=count_s / segs * 1e3,
                repaired=st.repaired, chunks=st.chunks,
                scanner_count_s=whole_s, native_s=native_s)


# the tier that serves each pipeline case, and the most chunks its count
# may repair natively: the static tiers validate every chunk (64 MB
# segments are whole chunks), the legacy core re-scans the two chunks
# around the last segment boundary, where the planted literal leaves
# the core
PIPE_TIERS = {"headline": ("SpecTables", 0),   # two-code: pair_scan.cu
              "multi": ("SpecTablesWide", 0),
              "no_static_tier": ("CoreTables", 2),
              "dictionary": ("SpecTablesBig", 0)}


def pipeline_phase(cases, oracles, fsc, fdata, fevents, fsub):
    """The pipelined stream surface: count_stream / scan_stream /
    match_stream over the stream phase's corpora (the headline's and
    multi's, the no-static-tier machine's on the legacy core) and the
    dictionary's (the static big tier), in PIPE_SEGMENT memoryviews,
    against ``oracles`` (pipe_oracles); multi's count again from a
    producer that refills one buffer, at in_flight=3; finditer_stream
    and sub_stream of the log-field extractor over the finditer phase's
    corpus, held against its finditer events and sub output.  Returns
    the phase's fields."""
    out = {}
    for name, (sc, corpus, end, rid) in cases.items():
        tier, repairs = PIPE_TIERS[name]
        out[name] = pipe_case(name, sc, corpus, end, rid, tier,
                              oracles[name], repairs)
    msc, mcorpus = cases["multi"][:2]
    t0 = time.perf_counter()
    got = msc.count_stream(refilled(mcorpus), in_flight=3)
    reuse_s = time.perf_counter() - t0
    if got != out["multi"]["count"] or msc.stats().repaired:
        raise AssertionError("multi from a refilled buffer: %d != %d on %r"
                             % (got, out["multi"]["count"], msc.stats()))
    out["multi"]["refilled_in_flight_3_gbps"] = len(mcorpus) / reuse_s / 1e9
    n = len(fdata)
    t0 = time.perf_counter()
    events = list(fsc.finditer_stream(segments(fdata)))
    fi_s = time.perf_counter() - t0
    if events != fevents:
        raise AssertionError("finditer_stream: %d events, finditer %d"
                             % (len(events), len(fevents)))
    t0 = time.perf_counter()
    edited = b"".join(fsc.sub_stream(b"status=$1 user=<redacted>",
                                     segments(fdata)))
    sub_s = time.perf_counter() - t0
    if edited != fsub:
        raise AssertionError("sub_stream differs from sub")
    out["finditer"] = dict(bytes=n, events=len(events),
                           finditer_stream_gbps=n / fi_s / 1e9,
                           sub_stream_gbps=n / sub_s / 1e9,
                           finditer_stream_s=fi_s, sub_stream_s=sub_s)
    return out


def stage_times(dev, sc, corpus, reps=3):
    """One PIPE_SEGMENT segment's stages timed one after another through
    the pipeline's own steps, each ended by a synchronise (best of
    ``reps``, a new first segment each time): the host copy into the
    slot's pinned memory (stage), its upload on the copy stream (and,
    beside it, the upload of the same bytes from pageable memory), the
    device prep, the kernel with the planes' packing, and the planes'
    readback with the segment's fold.  Returns the rates and the stages'
    seconds."""
    raw = np.frombuffer(memoryview(corpus)[:PIPE_SEGMENT], np.uint8).copy()
    n = len(raw)
    src = torch.from_numpy(raw)
    want, _ = sc._native.count(raw.tobytes(), 0)
    times = {k: [] for k in ("stage", "pageable", "upload", "prep",
                             "kernel", "fold")}

    def timed(key, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        times[key].append(time.perf_counter() - t0)
        return r

    for _ in range(reps):
        pipe = tpipe._Pipeline(sc._spec, tpipe.DEFAULT_K, 0, True, 1)
        slot = pipe.free.popleft()
        spans, geometry = pipe.spans(n)
        slot.reserve(n, [n])
        host = timed("stage", lambda: pipe.stage(slot, [raw], n, spans))
        timed("pageable", lambda: src.to(dev))
        data = timed("upload", lambda: pipe.upload(slot, spans))
        prepared = timed("prep", lambda: pipe.prep(slot, data, geometry))
        packed, C, K = timed("kernel", lambda: pipe.launch(prepared, n))

        def fold():
            pipe.enqueue(slot, packed, host, C, K, n)
            pipe.drain()

        timed("fold", fold)
        if (pipe.total, pipe.base) != (want, n):
            raise AssertionError("the timed segment's count %d != native "
                                 "%d" % (pipe.total, want))
    best = {k: min(v) for k, v in times.items()}
    return dict(segment_bytes=n, stage_gbps=n / best["stage"] / 1e9,
                h2d_pinned_gbps=n / best["upload"] / 1e9,
                h2d_pageable_gbps=n / best["pageable"] / 1e9,
                serial_ms={k: v * 1e3 for k, v in best.items()
                           if k != "pageable"},
                serial_sum_ms=sum(v for k, v in best.items()
                                  if k != "pageable") * 1e3)


def brute_map(native, rdata, K):
    """Entries and counts of a native walk of ``rdata``, chunk by
    chunk."""
    entries, counts, s = [], [], 0
    for lo in range(0, len(rdata), K):
        entries.append(s)
        c, s = native.count(rdata[lo:lo + K], s)
        counts.append(c)
    return entries, counts


def starts_of(loc):
    """Every match start next_start reports, in order."""
    out, s = [], loc.next_start(0)
    while s is not None:
        out.append(s)
        s = loc.next_start(s + 1)
    return out


def route_case(sc, data, rev, oracle):
    """make_index over ``data``: its entries and counts against a native
    walk of the reversed corpus by ``rev``, its start sequence against
    ``oracle``.  Returns (fields, the locator)."""
    t0 = time.perf_counter()
    loc = sc.make_index(data)
    index_s = time.perf_counter() - t0
    if loc is None:
        raise AssertionError("no index")
    t0 = time.perf_counter()
    entries, counts = brute_map(rev, data[::-1], loc.CHUNK)
    brute_s = time.perf_counter() - t0
    if not (np.array_equal(loc.entries, entries)
            and np.array_equal(loc.counts, counts)):
        raise AssertionError("the index's map differs from the native "
                             "walk (%s)" % type(loc.tables).__name__)
    starts = starts_of(loc)
    if starts != oracle:
        raise AssertionError("%d starts, oracle %d"
                             % (len(starts), len(oracle)))
    return dict(bytes=len(data), tier=type(loc.tables).__name__,
                index_gbps=len(data) / index_s / 1e9, index_s=index_s,
                timing=loc.timing, route=loc.route, K=loc.CHUNK,
                chunks=loc.C, repaired=loc.repaired, starts=len(starts),
                fired_chunks=len(loc._fires), native_walk_s=brute_s), loc


def index_routes_phase(dev, words, pats, mb=INDEX_ROUTE_MB):
    """make_index on the three other routes over ``mb`` MB each: the
    legacy reverse core (NO_TIER_PATTERN), the lazy reverse core
    (LAZY_PATTERN) and, under SREGEX_FUSED=1, the fused reverse core (the
    500-keyword dictionary).  Returns the phase's fields."""
    out = {}
    n = mb << 20
    filler = multi_corpus(mb, pats, step=None).replace(b"b", b"B")
    arr = np.frombuffer(filler, np.uint8)
    if (arr == ord("b")).any():
        raise AssertionError("a b in the filler")
    # legacy: a.{10}b planted every 64 KB, the literal every 1 MB
    data = bytearray(filler)
    lit = b"cdefghijklmnopqrstuvwxyz"
    for pos in range(4096, n - 64, 64 << 10):
        data[pos:pos + 12] = b"a0123456789b"
    for pos in range(40000, n - 64, 1 << 20):
        data[pos:pos + len(lit)] = lit
    data = bytes(data)
    a = np.frombuffer(data, np.uint8)
    ia = np.flatnonzero(a[:-11] == ord("a"))
    oracle = ia[a[ia + 11] == ord("b")].tolist()
    oracle = sorted(oracle + list(range(40000, n - 64, 1 << 20)))
    sc = sregex_tpu_torch.compile_pattern(NO_TIER_PATTERN, device=dev)
    rev = sc._rev_dfa()
    if sc._rev_spec is not None:
        raise AssertionError("%s: the reverse machine has a static tier"
                             % NO_TIER_PATTERN)
    out["legacy"], _ = route_case(sc, data, rev, oracle)
    out["legacy"].update(pattern=NO_TIER_PATTERN,
                         reverse_states=rev.dfa.nstates,
                         reverse_classes=rev.dfa.nclasses)
    # lazy: a.{13}b planted every 64 KB
    data = bytearray(filler)
    for pos in range(4096, n - 64, 64 << 10):
        data[pos:pos + 15] = b"a_lazy_machine_b"[:14] + b"b"
    data = bytes(data)
    a = np.frombuffer(data, np.uint8)
    ia = np.flatnonzero(a[:-14] == ord("a"))
    oracle = ia[a[ia + 14] == ord("b")].tolist()
    lsc = sregex_tpu_torch.compile_pattern(LAZY_PATTERN, device=dev)
    if lsc._rev_dfa() is not None:
        raise AssertionError("%r has a dense reverse machine"
                             % LAZY_PATTERN)
    out["lazy"], loc = route_case(lsc, data, lsc._rev_lazy_dfa(), oracle)
    if not isinstance(loc.tables, tcore.LazyCoreTables):
        raise AssertionError("lazy index on %r" % loc.tables)
    out["lazy"].update(pattern=LAZY_PATTERN.decode(), H=loc.tables.H,
                       lazy_states=lsc._rev_lazy_dfa().nstates)
    del data, a, lsc, loc
    # fused: the dictionary, SREGEX_FUSED=1
    positions = []
    data = multi_corpus(mb, words, positions=positions)
    by_len = {}
    for w in words:
        by_len.setdefault(len(w), set()).add(w)
    oracle, ends = [], set()
    for p in positions:
        for s in range(p + 1, p + 14):
            hit = [L for L in by_len if data[s:s + L] in by_len[L]]
            if hit:
                oracle.append(s)
                ends.update(s + L for L in hit)
    with env("SREGEX_FUSED", "1"):
        fsc = sregex_tpu_torch.compile_pattern(words, device=dev)
        fwd_count, _ = fsc._native.count(data, 0)
        if fwd_count != len(ends):
            raise AssertionError("the dictionary matches outside its "
                                 "plants: %d ends, %d planted"
                                 % (fwd_count, len(ends)))
        g0 = dict(tcore.gated_route_launches)
        out["fused"], loc = route_case(fsc, data, fsc._rev_dfa(), oracle)
    fct = fsc._rev_fusedct
    if loc.tables is not fct or not isinstance(fct, tcore.CoreTables):
        raise AssertionError("the fused reverse core did not serve: %r"
                             % loc.tables)
    out["fused"].update(
        keywords=len(words), reverse_states=fsc._rev_dfa().dfa.nstates,
        full_tier=type(fsc._rev_spec).__name__, H=fct.H,
        n_esc=fct.last_escapes[0], overflow=fct.last_escapes[1],
        cause=fct.last_fused_cause,
        gated_routes={r: tcore.gated_route_launches[r] - g0[r]
                      for r in g0})
    return out


def core_find_oracle(corpus, p):
    """The planted match's ovector, from the generator: the line at p
    holds "user=mallory id=31337"."""
    u = p + FIND_CORE_PLANT.index(b"user=")
    i = p + FIND_CORE_PLANT.index(b"31337")
    return (0, [u, i + 5, u + 5, u + 12, i, i + 5])


def timed_find(sc, corpus, want, prepared=None):
    """One Scanner.find, held against ``want``: (seconds, stats)."""
    t0 = time.perf_counter()
    got = sc.find(corpus, prepared=prepared)
    dt = time.perf_counter() - t0
    if got != want:
        raise AssertionError("find %r != %r" % (got, want))
    return dt, sc.stats()


def hot_core_find(dev, mb):
    """Scanner.find of FIND_CORE_PATTERN over ``mb`` MB of log lines with
    one match planted near the end, on the hot core (TdfaCoreTables):
    the first call (the sample walk, the tables, the prep), then
    FIND_CORE_REPS reps over the prepared corpus, each certified and
    equal to the generator's ovector; a certified no-match over the
    corpus without the plant; beside them the multi-pass route that
    served this pattern before the hot core (a Scanner whose tagged
    budget, SREGEX_TDFA_MAX=64, declines every tagged table).  Returns
    (fields, the core tables, their prep of the corpus)."""
    sc = sregex_tpu_torch.compile_pattern(FIND_CORE_PATTERN, device=dev)
    if sc._tdfa_spec is not None:
        raise AssertionError("%r fits the dense tagged tables"
                             % FIND_CORE_PATTERN)
    t0 = time.perf_counter()
    clean = log_corpus(mb, seed=23, lines=FIND_CORE_LINES)
    corpus = bytearray(clean)
    p = plant_line(corpus, len(corpus) - 8192, FIND_CORE_PLANT)
    corpus, clean = bytes(corpus), bytes(clean)
    gen_s = time.perf_counter() - t0
    n = len(corpus)
    exp = core_find_oracle(corpus, p)
    # the native DFA's first match end is the boundary after the id's
    # fourth digit, and the native Pike engine over a window that begins
    # 64 KB before the line agrees with the generator
    first, _ = sc._native.scan_first(corpus, 0)
    if first != exp[1][4] + 4:
        raise AssertionError("first match end %d, planted id at %d"
                             % (first, exp[1][4]))
    if pike_window(sc.program, corpus, p - 65536) != exp:
        raise AssertionError("Pike window != the planted match %r" % (exp,))
    l0 = launch_counts()
    prep = sc.prepare(corpus)
    first_s, st = timed_find(sc, corpus, exp, prep)
    ct = sc._tdfa_coret
    if not isinstance(ct, tdfa.TdfaCoreTables) or (
            st.tier, st.certified) != ("TdfaCoreTables", True):
        raise AssertionError("the hot core did not serve find: %r" % (st,))
    reps = []
    for _ in range(FIND_CORE_REPS):
        dt, st = timed_find(sc, corpus, exp, prep)
        if (st.tier, st.certified) != ("TdfaCoreTables", True):
            raise AssertionError("a hot-core rep: %r" % (st,))
        reps.append((dt, dict(ct.last_timing)))
    dt, split = min(reps, key=lambda r: r[0])
    cprep = sc.prepare(clean)
    nomatch_s, nst = timed_find(sc, clean, None, cprep)
    if (nst.tier, nst.certified) != ("TdfaCoreTables", True):
        raise AssertionError("the no-match find: %r" % (nst,))
    del cprep, clean
    launches = launch_counts(l0)
    if launches["tdfa"] != 2 + FIND_CORE_REPS:
        raise AssertionError("hot-core finds launched %r" % launches)
    with env("SREGEX_TDFA_MAX", "64"):
        msc = sregex_tpu_torch.compile_pattern(FIND_CORE_PATTERN, device=dev)
        mprep = msc.prepare(corpus)
        mp = [timed_find(msc, corpus, exp, mprep) for _ in range(2)]
    if msc._tdfa_coret is not False or mp[0][1].certified is not None:
        raise AssertionError("the multi-pass Scanner took a tagged route")
    fields = dict(
        mb=mb, bytes=n, pattern=FIND_CORE_PATTERN.decode(), match=exp,
        find_core_gbps=n / dt / 1e9, reps=FIND_CORE_REPS, rep_s=dt,
        rep_split_s=split, first_call_s=first_s, nomatch_s=nomatch_s,
        tier=st.tier, certified=st.certified, repaired=st.repaired,
        chunks=st.chunks, H=ct.H, rows=ct.rows, ncls=ct.ncls, R=ct.nregs,
        T=ct.ntags, CODE=ct.code_bits, bits=ct.bits,
        hot_launches=launches, corpus_s=gen_s,
        multi_pass=dict(gbps=n / min(m[0] for m in mp) / 1e9,
                        first_call_s=mp[0][0], prefilter_tier=mp[0][1].tier,
                        reverse_tier=type(msc._rev_spec).__name__))
    return fields, ct, prep


def reverse_core_find(dev, pattern, mb, pats, gap):
    """Scanner.find of ``pattern`` over ``mb`` MB of index_routes_phase's
    filler (no b) with "a", ``gap`` digits and "b" planted near the end:
    no hot tagged core fits these a's, so the multi-pass route runs and
    its start locator scans the reversed corpus on the reverse machine's
    core (core_scan_last_bytes).  The result is held against the plant
    and a Pike window, the core's answer against the host walk it
    replaces (scan_last over the same reversed bytes), each timed.
    Returns the fields."""
    filler = multi_corpus(mb, pats, step=None).replace(b"b", b"B")
    data = bytearray(filler)
    n = len(data)
    at = data.index(b" ", n - 4096) + 1
    data[at:at + gap + 2] = b"a" + b"0123456789012"[:gap] + b"b"
    data = bytes(data)
    exp = (0, [at, at + gap + 2])
    sc = sregex_tpu_torch.compile_pattern(pattern, device=dev)
    if pike_window(sc.program, data, at - 65536) != exp:
        raise AssertionError("Pike window != the plant in %s" % pattern)
    l0 = launch_counts()
    find_s, st = timed_find(sc, data, exp)
    launches = launch_counts(l0)
    lazy = sc.dfa is None
    rct = sc._rev_lz_coret if lazy else sc._rev_coret
    want = tcore.LazyCoreTables if lazy else tcore.CoreTables
    if sc._tdfa_coret is not False or type(rct) is not want \
            or rct.last_repair is None:
        raise AssertionError("the reverse core did not serve find (%s): "
                             "%r" % (pattern, rct))
    repaired, chunks = rct.last_repair
    rev = sc._rev_lazy_dfa() if lazy else sc._rev_dfa()
    rdata = data[::-1]
    t0 = time.perf_counter()
    got = tcore.core_scan_last_bytes(rct, rdata)
    core_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q, rstate = rev.scan_last(rdata, 0)
    host_s = time.perf_counter() - t0
    if got != (rstate, q):
        raise AssertionError("core_scan_last_bytes %r != scan_last %r"
                             % (got, (rstate, q)))
    return dict(pattern=pattern, bytes=n, match=exp, find_s=find_s,
                prefilter_tier=st.tier, reverse_tier=type(rct).__name__,
                H=rct.H, inner=type(rct.inner).__name__, repaired=repaired,
                chunks=chunks, launches=launches, core_scan_last_s=core_s,
                host_scan_last_s=host_s, speedup=host_s / core_s)


def lazy_hot_core_find(dev, mb, pats):
    """Scanner.find of LAZY_PATTERN (past the eager budget) over the same
    filler with one a.{13}b near the end: the tagged hot core fits this
    machine, so find certifies in one pass.  Returns the fields."""
    data = bytearray(multi_corpus(mb, pats, step=None).replace(b"b", b"B"))
    at = data.index(b" ", len(data) - 4096) + 1
    data[at:at + 15] = b"a0123456789012b"
    data = bytes(data)
    sc = sregex_tpu_torch.compile_pattern(LAZY_PATTERN, device=dev)
    l0 = launch_counts()
    find_s, st = timed_find(sc, data, (0, [at, at + 15]))
    if (st.tier, st.certified) != ("TdfaCoreTables", True):
        raise AssertionError("%r: %r" % (LAZY_PATTERN, st))
    return dict(pattern=LAZY_PATTERN.decode(), bytes=len(data),
                find_s=find_s, tier=st.tier, certified=st.certified,
                H=sc._tdfa_coret.H, repaired=st.repaired, chunks=st.chunks,
                launches=launch_counts(l0))


def precompile_case(dev, pats, mcorpus, mexp, fused):
    """A fresh Scanner of the 90 keywords: precompile over the multi
    corpus's length (under SREGEX_FUSED=1 with the corpus's head as the
    sample), then the first count, exact against the native count, and
    the tier that served it.  Returns the fields."""
    with env("SREGEX_FUSED", "1" if fused else "0"):
        sc = sregex_tpu_torch.compile_pattern(pats, device=dev)
        sample = mcorpus[:4 * sc.CORE_SAMPLE] if fused else b""
        pre_s = sc.precompile(len(mcorpus), sample=sample)
        t0 = time.perf_counter()
        c = sc.count(mcorpus)
        first_s = time.perf_counter() - t0
    want = "CoreTables" if fused else "SpecTablesWide"
    if c != mexp or sc.stats().tier != want or pre_s <= 0:
        raise AssertionError("count after precompile %r (native %r), %r"
                             % (c, mexp, sc.stats()))
    return dict(precompile_s=pre_s, first_count_s=first_s,
                tier=sc.stats().tier)


def find_core_phase(dev, fmb, pats, mmb, mexp):
    """find past the static tiers and Scanner.precompile: the hot-core
    tagged find over ``fmb`` MB (hot_core_find), the reverse legacy core
    (NO_TIER_PATTERN) and the lazy reverse core (LAZY_FIND_PATTERN) over
    INDEX_ROUTE_MB each (reverse_core_find), LAZY_PATTERN's find on its
    hot core, then precompile and a first count of the 90 keywords over
    the multi corpus (``mmb`` MB, native count ``mexp``) on the static
    wide tier and on the fused tier, beside a first count without it.
    Returns (fields, the hot core's tables and prep)."""
    out, ct, prep = hot_core_find(dev, fmb)
    out["reverse_legacy"] = reverse_core_find(dev, NO_TIER_PATTERN,
                                              INDEX_ROUTE_MB, pats, 10)
    out["reverse_lazy"] = reverse_core_find(dev, LAZY_FIND_PATTERN,
                                            INDEX_ROUTE_MB, pats, 13)
    out["lazy_hot_core"] = lazy_hot_core_find(dev, INDEX_ROUTE_MB, pats)
    mcorpus = multi_corpus(mmb, pats)
    cold = sregex_tpu_torch.compile_pattern(pats, device=dev)
    t0 = time.perf_counter()
    if cold.count(mcorpus) != mexp:
        raise AssertionError("multi count != native %d" % mexp)
    out["precompile"] = dict(
        mb=mmb, cold_first_count_s=time.perf_counter() - t0,
        static=precompile_case(dev, pats, mcorpus, mexp, False),
        fused=precompile_case(dev, pats, mcorpus, mexp, True))
    return out, ct, prep


def doc_lengths(mb, seed, K=2048):
    """The lengths of the documents cut from ``mb`` MB: a seeded
    log-uniform draw in 512 B - 4 MB (every one below
    Scanner.DEVICE_THRESHOLD), 8 empty documents and 8 shorter than one
    chunk at seeded places, the last document cut so they sum to mb
    MB."""
    rng = np.random.default_rng(seed)
    total = mb << 20
    draw = np.exp(rng.uniform(np.log(512), np.log(4 << 20),
                              total // 4096 + 64)).astype(np.int64)
    cum = np.cumsum(draw)
    lens = list(draw[:int(np.searchsorted(cum, total)) + 1])
    for n in [0] * 8 + list(rng.integers(1, K, 8)):
        lens.insert(int(rng.integers(0, len(lens))), int(n))
    lens[-1] = 0
    lens[-1] = total - sum(lens)
    if lens[-1] <= 0:
        raise AssertionError("document lengths overran %d MB" % mb)
    return lens


def cut_docs(corpus, lens):
    ends = np.cumsum(lens)
    return [bytes(corpus[e - n:e]) for e, n in zip(ends, lens)]


def straddle(corpus, lens, word, every=10):
    """``corpus`` (a bytearray, edited) with ``word`` planted across every
    ``every``-th document boundary, its first half ending one document
    and its rest starting the next, where both hold 32 bytes.  Returns
    the boundaries' indices (the document before each)."""
    ends = np.cumsum(lens)
    h = len(word) // 2
    out = []
    for j in range(every - 1, len(lens) - 1, every):
        if lens[j] >= 32 and lens[j + 1] >= 32:
            b = int(ends[j])
            corpus[b - h:b - h + len(word)] = word
            out.append(j)
    return out


def plant_past_heads(corpus, lens, words, step, head=64 << 10):
    """Plant a dictionary word every ``step`` bytes of each document past
    its first ``head`` bytes (edits the bytearray ``corpus``)."""
    rng = random.Random(99)
    ends = np.cumsum(lens)
    for e, n in zip(ends, lens):
        for pos in range(int(e) - n + head, int(e) - 64, step):
            w = words[rng.randrange(len(words))]
            corpus[pos:pos + len(w) + 2] = b" " + w + b" "


def batch_check(name, got, want):
    if got != want:
        i = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError("%s: document %d: %r != %r (%d documents)"
                             % (name, i, got[i], want[i], len(want)))


def batch_case(name, sc, api, docs, want, loop, tier):
    """Scanner.<api> over ``docs``: the first call (the pack and upload
    included), then REPS calls over a prepare_many handle, each held
    against ``want``; then one timed per-document loop (``loop``, what a
    user pays without batching) held against it too.  ``tier``: the
    tables that must serve.  Returns the case's fields and the launches
    of its batch calls."""
    fn = getattr(sc, api)
    n = sum(map(len, docs))
    base = launch_counts()
    t0 = time.perf_counter()
    batch_check(name, fn(docs), want)
    first_s = time.perf_counter() - t0
    st = sc.stats()
    if (st.api, st.tier) != (api, tier):
        raise AssertionError("%s: %s served by %r" % (name, api, st))
    t0 = time.perf_counter()
    handle = sc.prepare_many(docs, for_find=api == "find_many")
    prepare_s = time.perf_counter() - t0
    if handle is None:
        raise AssertionError("%s: no prepare_many handle" % name)
    reps = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        got = fn(docs, prepared=handle)
        reps.append(time.perf_counter() - t0)
        batch_check(name, got, want)
    timing = dict(tbatch.last_timing)
    launched = launch_counts(base)
    t0 = time.perf_counter()
    batch_check(name + " loop", [loop(d) for d in docs], want)
    loop_s = time.perf_counter() - t0
    key = api.replace("_many", "")
    return dict(
        docs=len(docs), bytes=n, tier=st.tier, chunks=st.chunks,
        repaired=st.repaired, **{key + "_many_gbps": n / min(reps) / 1e9,
                                 key + "_many_first_gbps": n / first_s / 1e9},
        loop_gbps=n / loop_s / 1e9, rep_ms=min(reps) * 1e3,
        dispatch_ms=timing["dispatch_s"] * 1e3,
        readback_ms=timing["readback_s"] * 1e3,
        fold_ms=timing["fold_s"] * 1e3, prepare_s=prepare_s,
        first_s=first_s, loop_s=loop_s,
        launches={k: v for k, v in launched.items() if v}), launched


def find_oracle_docs(docs, lens, matches, hsc):
    """Each document's first find() result from the generator's matches
    (ovectors over the corpus the documents were cut from): the first
    match wholly inside the document, moved to its offsets, else None;
    a document that a match only partly overlaps (a cut plant) is found
    by the host Scanner ``hsc``."""
    ends = np.cumsum(lens)
    spans = [(ov[0], ov[1], ov) for _, ov in matches]
    out, k, host = [], 0, 0
    for d, e, n in zip(docs, ends, lens):
        s = e - n
        while k < len(spans) and spans[k][1] <= s:
            k += 1
        hit = None
        if k < len(spans) and spans[k][0] < e:
            lo, hi, ov = spans[k]
            if lo >= s and hi <= e:
                hit = (0, [v - s for v in ov])
            else:
                hit = hsc.find(d)
                host += 1
        out.append(hit)
    return out, host


def batch_phase(dev, pats, words, bsc, fsc, fdata, fmatches, keep=None):
    """The batched document surface (Scanner.*_many, ops/batch.py) on
    document sets cut from the script's corpora (doc_lengths: ~2,300
    documents a GB, each below DEVICE_THRESHOLD), every document's
    result held against its oracle:

      - the 90 keywords over BATCH_MB (the wide tier): count_many,
        scan_many and match_many against each document's native count
        and scan, a keyword planted across every tenth document boundary
        (it must not count: each document starts at the seed);
      - the headline over BATCH_MB: scan_many (the two-code kernel);
      - the dictionary over BATCH_DICT_MB (more words past each
        document's head, BATCH_DICT_STEP):
        count_many on the static big tier, then by a Scanner with
        SREGEX_FUSED=1 on the fused batch (phase 2 on the gated kernel),
        then with tcore.FUSED_CAP at one block row, under the set's
        escapes, so the per-document overflow fold serves;
      - the no-static-tier machine over the dictionary's documents:
        count_many on the legacy core;
      - the log-field extractor over BATCH_FIND_MB of the finditer
        corpus: find_many (the tagged kernel), each ovector against the
        generator's; finditer_many and sub_many over BATCH_SUB_MB of
        those documents against each document's host findall and sub.

    Returns the phase's fields and the launches by kernel; ``keep``, a
    dict, gets the keyword set's documents and counts ("multi")."""
    out = {}
    launched = dict.fromkeys(launch_counts(), 0)

    def run(name, *args, **kw):
        fields, lc = batch_case(name, *args, **kw)
        for k, v in lc.items():
            launched[k] += v
        return fields

    # the 90 keywords, with keywords across document boundaries
    t0 = time.perf_counter()
    lens = doc_lengths(BATCH_MB, 5)
    corpus = bytearray(multi_corpus(BATCH_MB, pats))
    bounds = straddle(corpus, lens, b"throughput")
    docs = cut_docs(corpus, lens)
    del corpus
    msc = sregex_tpu_torch.compile_pattern(pats, device=dev)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    counts = [native_count(msc, d) for d in docs]
    scans = []
    for d in docs:
        f, st = msc._native.scan_first(d, 0)
        scans.append((msc._id_at(st, d[f]), f) if f >= 0 else None)
    native_s = time.perf_counter() - t0
    # each planted boundary's two halves match only together
    for j in bounds:
        tail, head = docs[j][-24:], docs[j + 1][:24]
        if native_count(msc, tail + head) <= (native_count(msc, tail)
                                              + native_count(msc, head)):
            raise AssertionError("no match across boundary %d" % j)
    out["multi"] = run("multi count_many", msc, "count_many", docs, counts,
                       msc.count, "SpecTablesWide")
    out["multi"]["scan"] = run("multi scan_many", msc, "scan_many", docs,
                               scans, msc.scan, "SpecTablesWide")
    batch_check("multi match_many", msc.match_many(docs),
                [s is not None for s in scans])
    out["multi"].update(straddles=len(bounds), corpus_s=gen_s,
                        native_s=native_s,
                        matching_docs=sum(c > 0 for c in counts))
    if keep is not None:
        keep["multi"] = (docs, counts)
    del docs, msc

    # the headline: scan_many on the two-code kernel
    lens = doc_lengths(BATCH_MB, 6)
    corpus = bytearray(headline_corpus(BATCH_MB))
    for pos in range(1 << 20, len(corpus) - 16, 8 << 20):
        corpus[pos:pos + 9] = b"xaaabbccb"
    docs = cut_docs(corpus, lens)
    del corpus
    hsc = sregex_tpu_torch.compile_pattern(HEADLINE, device=dev)
    scans = []
    for d in docs:
        f, st = hsc._native.scan_first(d, 0)
        scans.append((hsc._id_at(st, d[f]), f) if f >= 0 else None)
    out["headline"] = run("headline scan_many", hsc, "scan_many", docs,
                          scans, hsc.scan, "SpecTables")
    out["headline"]["matching_docs"] = sum(s is not None for s in scans)
    del docs, hsc

    # the dictionary: static big, fused, the fused overflow; the legacy
    # core over the same documents
    lens = doc_lengths(BATCH_DICT_MB, 7)
    corpus = bytearray(multi_corpus(BATCH_DICT_MB, words))
    plant_past_heads(corpus, lens, words, BATCH_DICT_STEP)
    docs = cut_docs(corpus, lens)
    del corpus
    counts = [native_count(bsc, d) for d in docs]
    out["dictionary"] = run("dictionary count_many", bsc, "count_many",
                            docs, counts, bsc.count, "SpecTablesBig")
    with env("SREGEX_FUSED", "1"):
        t0 = time.perf_counter()
        usc = sregex_tpu_torch.Scanner(bsc.program, device=dev, dfa=bsc.dfa)
        build_s = time.perf_counter() - t0
        out["fused"] = run("fused count_many", usc, "count_many", docs,
                           counts, usc.count, "CoreTables")
        fct = usc._fusedct
        n_esc, over = fct.last_escapes
        ocap = GROUPS * 1024
        if over or n_esc <= ocap:
            raise AssertionError("fused batch escapes %d (overflow %r): "
                                 "not past one block row" % (n_esc, over))
        out["fused"].update(n_esc=n_esc, H=fct.H, scanner_build_s=build_s,
                            inner=type(fct.inner).__name__)
        cap0, tcore.FUSED_CAP = tcore.FUSED_CAP, ocap
        try:
            base = launch_counts()
            t0 = time.perf_counter()
            batch_check("fused overflow", usc.count_many(docs), counts)
            o_s = time.perf_counter() - t0
            for k, v in launch_counts(base).items():
                launched[k] += v
        finally:
            tcore.FUSED_CAP = cap0
        ost = usc.stats()
        if not fct.last_escapes[1] or ost.tier != "CoreTables":
            raise AssertionError("the capped fused batch did not overflow: "
                                 "%r %r" % (fct.last_escapes, ost))
        out["fused"]["overflow_arm"] = dict(
            cap=ocap, count_many_gbps=sum(map(len, docs)) / o_s / 1e9,
            repaired=ost.repaired, chunks=ost.chunks,
            fold_ms=tbatch.last_timing["fold_s"] * 1e3)
    del usc, fct
    nsc = sregex_tpu_torch.compile_pattern(NO_TIER_PATTERN, device=dev)
    ncounts = [native_count(nsc, d) for d in docs]
    out["no_static_tier"] = run("no-static-tier count_many", nsc,
                                "count_many", docs, ncounts, nsc.count,
                                "CoreTables")
    del docs, nsc

    # the log-field extractor: find_many, then finditer_many and sub_many
    lens = doc_lengths(BATCH_FIND_MB, 8)
    docs = cut_docs(fdata, lens)
    hsc = sregex_tpu_torch.compile_pattern(FIND_PATTERN, device=None)
    want, cut = find_oracle_docs(docs, lens, fmatches, hsc)
    if sum(w is not None for w in want) < BATCH_FIND_MB // 2:
        raise AssertionError("find_many: %d documents hold a match"
                             % sum(w is not None for w in want))
    out["find"] = run("find_many", fsc, "find_many", docs, want, fsc.find,
                      "TdfaSpecTables")
    out["find"].update(matching_docs=sum(w is not None for w in want),
                       cut_plants=cut)
    sub_n = int(np.searchsorted(np.cumsum(lens), BATCH_SUB_MB << 20))
    sdocs = docs[:sub_n]
    base = launch_counts()
    t0 = time.perf_counter()
    found = fsc.finditer_many(sdocs)
    fi_s = time.perf_counter() - t0
    batch_check("finditer_many", found, [hsc.findall(d) for d in sdocs])
    repl = b"status=$1 user=<redacted>"
    t0 = time.perf_counter()
    subbed = fsc.sub_many(repl, sdocs)
    sub_s = time.perf_counter() - t0
    batch_check("sub_many", subbed, [hsc.sub(repl, d) for d in sdocs])
    for k, v in launch_counts(base).items():
        launched[k] += v
    sn = sum(map(len, sdocs))
    out["find"].update(sub_docs=len(sdocs), sub_bytes=sn,
                       matches=sum(map(len, found)),
                       finditer_many_gbps=sn / fi_s / 1e9,
                       sub_many_gbps=sn / sub_s / 1e9)
    return out, launched


MESH_SHARDS = 4               # the mesh phase's virtual mesh on one card
MESH_CORE_MB = 256            # its legacy-core and stream corpora
MESH_PROC_MB = 256            # its two processes' corpus
MESH_PROC_K = 2048
# the scan kernels' wrappers, by each module that calls them, and the
# kernel row each launch counts under
KERNEL_SITES = ((scan, "spec_scan"), (tpair, "spec_scan"),
                (tcore, "spec_scan"), (big, "big_scan"),
                (aff, "affine_scan"), (tcore, "gated_scan"))


@contextlib.contextmanager
def recorded_launches():
    """Record each scan kernel launch made inside: (wrapper, args,
    keywords, a copy of its planes), in launch order."""
    rec, saved = [], []
    for mod, name in KERNEL_SITES:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def wrapper(*a, _fn=fn, **kw):
            planes = _fn(*a, **kw)
            rec.append((_fn, a, kw, tuple(p.clone() for p in planes)))
            return planes
        setattr(mod, name, wrapper)
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def hold_against_plain(rec, errs):
    """Each recorded launch held against its kernel's plain version on
    the same inputs, bit-exact (the gated kernel on its active block
    rows); each error goes to its row in ``errs``.  Returns {row: [the
    block rows of each launch held]}."""
    def without(kw, *keys):
        return {k: v for k, v in kw.items() if k not in keys}

    held = {}
    for fn, a, kw, got in rec:
        if fn is scan.spec_scan:
            row = "narrow" if kw.get("pair") is not None else "wide"
            want = spec_scan_ref(*a, **without(kw, "pair"))
        elif fn is big.big_scan:
            row = "big"
            want = big.big_scan_ref(*a, **without(kw, "t16"))
        elif fn is aff.affine_scan:
            row = "affine"
            want = aff.affine_scan_ref(*a, **without(kw, "relaid",
                                                     "generic"))
        else:
            row = "gated"
            want = tcore.gated_scan_ref(*a, **without(kw, "big", "t16",
                                                      "out"))
            nblk = tcore._active_rows(a[4], a[1])
            got, want = [g[:nblk] for g in got], [w[:nblk] for w in want]
        err = max_abs_err(got, want) if got[0].numel() else 0
        if err:
            raise AssertionError("a %s launch differs from its plain "
                                 "version by %d (%d block rows)"
                                 % (row, err, a[1].shape[0]))
        errs[row] = max(errs[row], err)
        held.setdefault(row, []).append(a[1].shape[0])
    return held


def scanner_repairs(sc):
    """What a Scanner's last call repaired: (tier, chunks, chunks walked
    natively)."""
    st = sc.stats()
    return st.tier, st.chunks, st.repaired


def mesh_pair(n, single, sharded, check, repairs, errs):
    """The same work on one device (``single``) and sharded over the
    mesh (``sharded``), each result checked, each timed (min of REPS,
    after a first call that prepares).  Every kernel launch of the first
    sharded call is held against its plain version (hold_against_plain),
    and what the sharded calls repaired on the host (``repairs[1]()``)
    must equal what the one-device calls did (``repairs[0]()``): a shard
    that scanned the wrong rows would be repaired to the right answer.
    Returns the case's fields, the sharded calls' launches among them."""
    check(single())
    t1 = min_rep_seconds(single, check)
    want_rep = repairs[0]()
    base = launch_counts()
    t0 = time.perf_counter()
    with recorded_launches() as rec:
        got = sharded()
    first_s = time.perf_counter() - t0
    check(got)
    held = hold_against_plain(rec, errs)
    del rec
    tm = min_rep_seconds(sharded, check)
    got_rep = repairs[1]()
    if got_rep != want_rep:
        raise AssertionError("the mesh repaired %r, one device %r"
                             % (got_rep, want_rep))
    return dict(gbps=n / tm / 1e9, single_gbps=n / t1 / 1e9,
                first_call_s=first_s, repairs=got_rep,
                held_rows={k: sorted(set(v)) for k, v in held.items()},
                held_launches={k: len(v) for k, v in held.items()},
                launches={k: v for k, v in launch_counts(base).items() if v})


def equal_to(want, what):
    """A check: the result equals ``want``."""
    def check(got):
        if got != want:
            raise AssertionError("%s %r != %r" % (what, got, want))
    return check


def mesh_cases(mesh, inp, errs):
    """Each case of the mesh phase over ``mesh``, beside one device, every
    result equal to the one-device result and its oracle, every kernel
    launch of a sharded call held against its plain version (into
    ``errs``); returns {case: fields}."""
    dev = mesh.lead
    out = {}
    # the headline's first-match scan (the two-code kernel)
    corpus, prog, ast, dfa, exp_first = inp["headline"]
    sc1 = Scanner(prog, device=dev, ast=ast, dfa=dfa)
    scm = Scanner(prog, device=dev, ast=ast, dfa=dfa, mesh=mesh)
    p1, pm = sc1.prepare(corpus), scm.prepare(corpus)
    want = sc1.scan(corpus, prepared=p1)
    equal_to(exp_first, "headline end")(want[1])
    out["headline_scan"] = mesh_pair(
        len(corpus), lambda: sc1.scan(corpus, prepared=p1),
        lambda: scm.scan(corpus, prepared=pm), equal_to(want, "scan"),
        (lambda: scanner_repairs(sc1), lambda: scanner_repairs(scm)), errs)
    del p1, pm, sc1
    # the 90 keywords' Scanner.count (the wide tier)
    mcorpus, msc, mprep, mexp = inp["multi"]
    mscm = Scanner(msc.program, device=dev, ast=msc.ast, dfa=msc.dfa,
                   mesh=mesh)
    mpm = mscm.prepare(mcorpus)
    out["multi_count"] = mesh_pair(
        len(mcorpus), lambda: msc.count(mcorpus, prepared=mprep),
        lambda: mscm.count(mcorpus, prepared=mpm), equal_to(mexp, "count"),
        (lambda: scanner_repairs(msc), lambda: scanner_repairs(mscm)), errs)
    del mpm
    # the dictionary: the fused count (core_count_fused) and the static
    # big count
    bcorpus, bsc, bprep, bexp = inp["dictionary"]
    spec = bsc._spec
    fct = tcore.CoreTables(bsc.dfa, bsc._core_sample(bcorpus),
                           max_escape_frac=tcore.FUSED_ESCAPE_FRAC,
                           require_fast=False, no_pair=True,
                           prefer_small=True, device=dev)
    ck = tcore.fused_chunk(fct.inner, spec)
    pc1 = tstream.PreparedCorpus(bcorpus, dev)
    pcm = tstream.PreparedCorpus(bcorpus, dev, mesh=mesh)

    def fused(pc, m):
        st, c = tcore.core_count_fused(
            fct, spec, bcorpus, chunk_len=ck,
            prepared_core=pc.for_tables(fct.inner, ck),
            prepared_full=pc.for_tables(spec, ck), mesh=m)
        return c + int(bsc.dfa.match_eof[st]), fct.last_fused_cause

    def fused_repairs():
        return fct.last_escapes, fct.last_repair

    out["dictionary_fused"] = mesh_pair(
        len(bcorpus), lambda: fused(pc1, None), lambda: fused(pcm, mesh),
        equal_to((bexp, None), "fused count, cause"),
        (fused_repairs, fused_repairs), errs)
    out["dictionary_fused"].update(H=fct.H, K=ck)

    def static(pc, m):
        st, c = scan.spec_count_bytes(spec, bcorpus, prepared=pc, mesh=m)
        return c + int(bsc.dfa.match_eof[st])

    out["dictionary_big"] = mesh_pair(
        len(bcorpus), lambda: static(bprep.for_tables(spec), None),
        lambda: static(pcm.for_tables(spec), mesh),
        equal_to(bexp, "big count"),
        (lambda: spec.last_repair, lambda: spec.last_repair), errs)
    del pc1, pcm, fct
    # the piecewise-affine count
    acorpus, asc, aprep, aexp = inp["affine"]
    at = asc._spec
    apm = tstream.PreparedCorpus(acorpus, dev, mesh=mesh)

    def affine(prep, m):
        st, c = scan.spec_count_bytes(at, acorpus, prepared=prep, mesh=m)
        return c + int(asc.dfa.match_eof[st])

    out["affine_count"] = mesh_pair(
        len(acorpus), lambda: affine(aprep.for_tables(at), None),
        lambda: affine(apm.for_tables(at), mesh),
        equal_to(aexp, "affine count"),
        (lambda: at.last_repair, lambda: at.last_repair), errs)
    del apm
    # the no-static-tier machine on the legacy core
    ncorpus = bcorpus[:MESH_CORE_MB << 20]
    nsc = sregex_tpu_torch.compile_pattern(NO_TIER_PATTERN, device=dev)
    nscm = Scanner(nsc.program, device=dev, ast=nsc.ast, dfa=nsc.dfa,
                   mesh=mesh)
    nexp = native_count(nsc, ncorpus)
    n1, nm = nsc.prepare(ncorpus), nscm.prepare(ncorpus)
    out["no_static_tier"] = mesh_pair(
        len(ncorpus), lambda: nsc.count(ncorpus, prepared=n1),
        lambda: nscm.count(ncorpus, prepared=nm),
        equal_to(nexp, "no-tier count"),
        (lambda: scanner_repairs(nsc), lambda: scanner_repairs(nscm)), errs)
    out["no_static_tier"]["mb"] = MESH_CORE_MB
    del n1, nm, nsc, nscm
    # count_many over the batch phase's keyword documents
    docs, counts = inp["docs"]
    h1, hm = msc.prepare_many(docs), mscm.prepare_many(docs)
    out["count_many"] = mesh_pair(
        sum(map(len, docs)), lambda: msc.count_many(docs, prepared=h1),
        lambda: mscm.count_many(docs, prepared=hm),
        equal_to(counts, "count_many"),
        (lambda: scanner_repairs(msc), lambda: scanner_repairs(mscm)), errs)
    out["count_many"].update(docs=len(docs), api=mscm.stats().api)
    del h1, hm
    # count_stream of the keywords over 64 MB segments
    scorpus = mcorpus[:MESH_CORE_MB << 20]
    sexp = native_count(msc, scorpus)
    out["count_stream"] = mesh_pair(
        len(scorpus), lambda: msc.count_stream(segments(scorpus)),
        lambda: mscm.count_stream(segments(scorpus)),
        equal_to(sexp, "count_stream"),
        (lambda: scanner_repairs(msc), lambda: scanner_repairs(mscm)), errs)
    out["count_stream"].update(mb=MESH_CORE_MB, api=mscm.stats().api)
    return out


def multihost_corpus():
    """The two processes' corpus: the headline's text (one match near the
    end), and the ragged split's cut."""
    corpus = headline_corpus(MESH_PROC_MB)
    return corpus, len(corpus) * 2 // 5 + 12345


def multihost_worker(rank, init, cards):
    """One of the mesh phase's two processes (chip_smoke.py --multihost
    RANK INIT CARDS): joins the gloo group through the file INIT, scans
    its slice of multihost_corpus() on a mesh of the cards CARDS (indices,
    comma-separated; "0,0" is two shards of cuda:0) with
    parallel.multihost, aligned (host_slices) and ragged, and prints the
    results and host-clock seconds (the second of two calls; the first's
    beside it) as one JSON line."""
    from sregex_tpu_torch.parallel import distributed, multihost
    devs = [torch.device("cuda", int(c)) for c in cards.split(",")]
    distributed.initialize("file://" + init, num_processes=2,
                           process_id=rank)
    mesh = make_mesh(devs)
    tables = scan.SpecTables(build_dfa(compile_regex(parse(HEADLINE)[0])),
                             devs[0])
    corpus, cut = multihost_corpus()
    n, K = len(corpus), MESH_PROC_K
    out = {}
    for name, slices in (("aligned", multihost.host_slices(
            n, 2, K, 2 * mesh.size)), ("ragged", [(0, cut), (cut, n)])):
        lo, hi = slices[rank]
        part = corpus[lo:hi]
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            count = multihost.count_multihost(tables, part, mesh, K, n)
            t1 = time.perf_counter()
            first = multihost.scan_multihost(tables, part, mesh, K, n)
            times.append((t1 - t0, time.perf_counter() - t1))
        out[name] = dict(count=list(count), scan=list(first), bytes=hi - lo,
                         count_s=times[1][0], scan_s=times[1][1],
                         first_count_s=times[0][0],
                         first_scan_s=times[0][1])
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def multihost_processes(cards=("0,0", "0,0")):
    """Two processes over gloo (multihost_worker), process r on the cards
    cards[r], each result equal to the native engine's over the whole
    corpus."""
    import tempfile
    tmp = tempfile.mkdtemp()
    init = os.path.join(tmp, "pg")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost", str(r),
         init, cards[r]], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        corpus, cut = multihost_corpus()
        ast, _ = parse(HEADLINE)
        sc = Scanner(compile_regex(ast), device=None, ast=ast)
        k, kst = sc._native.count(corpus, 0)
        f, rid, fst = sc._native.scan_first_id(corpus, 0)
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for name in os.listdir(tmp):
            os.remove(os.path.join(tmp, name))
        os.rmdir(tmp)
    wall = time.perf_counter() - t0
    got = []
    for r, (p, (so, se)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError("process %d failed:\n%s" % (r, se[-3000:]))
        got.append(json.loads(so.strip().splitlines()[-1]))
    want = dict(count=[kst, k], scan=[fst, f, rid])
    for r, g in enumerate(got):
        for name in ("aligned", "ragged"):
            for key in ("count", "scan"):
                if g[name][key] != want[key]:
                    raise AssertionError("process %d, %s %s: %r != %r" % (
                        r, name, key, g[name][key], want[key]))
    return dict(mb=MESH_PROC_MB, bytes=len(corpus), K=MESH_PROC_K, cut=cut,
                cards=list(cards), count=k, end=f, wall_s=wall, **{
                    name: {key: (max(g[name][key] for g in got)
                                 if key.endswith("_s")
                                 else [g[name][key] for g in got])
                           for key in ("bytes", "count_s", "scan_s",
                                       "first_count_s", "first_scan_s")}
                    for name in ("aligned", "ragged")})


# the tier_ab phase: the two mid-band wide machines (stream._core_band
# "ab"; wide rows 4 and 6, the legacy and the fused core's arms), the
# plants of each, and each one's corpus
TIER_AB_MB = 256
TIER_AB_MACHINES = (
    (rb"(foo|bar|baz|qux)=[0-9a-f]{2,8}",
     (b"foo=1a2b", b"qux=ff", b"bar=0c0ffee1")),
    (rb"(GET|POST|PUT|HEAD) /[a-z]{1,12}\.(html|php|js)",
     (b"GET /index.html", b"POST /a.php", b"HEAD /zz.js")))


def tier_ab_corpus(mb, plants, sample, seed):
    """mb MB of digit and symbol filler, in which no prefix of a match
    starts (the log-scan shape the fast core needs), with one of
    ``plants`` about once a MB at a seeded offset, none in the four
    core-sample slices of ``sample`` bytes (Scanner._core_sample), so
    that the mid-band machine's core builds."""
    n = mb << 20
    unit = b"0123 456 789 -- 01 2345 "
    out = bytearray((unit * (n // len(unit) + 1))[:n])
    cuts = {0, n // 3, 2 * n // 3, n - sample}
    rng = np.random.default_rng(seed)
    for i in range(mb):
        pos = (i << 20) + int(rng.integers(0, (1 << 20) - 64))
        if any(c - 64 <= pos < c + sample for c in cuts):
            continue
        w = plants[i % len(plants)]
        out[pos:pos + len(w)] = w
    return bytes(out)


# the A/B's arms, by their names in the stream module
AB_ARMS = ("spec_count_bytes", "core_count_bytes", "core_count_fused")


def arm_repairs(name, t):
    """What an arm's call on tables ``t`` repaired on the host: their
    last_repair, the fused core's escapes beside it."""
    if name == "core_count_fused":
        return t.last_escapes, t.last_repair
    return t.last_repair


@contextlib.contextmanager
def recorded_arms():
    """Record the last call of each of the A/B's arms made inside
    (Scanner._maybe_tier_ab reads them by their module names; a call a
    tier serves takes _TIER_CALLS' own references): {arm: (arguments,
    result, what it repaired)}."""
    rec, saved = {}, {name: getattr(tstream, name) for name in AB_ARMS}
    for name, fn in saved.items():
        def arm(*a, _fn=fn, _name=name, **kw):
            r = _fn(*a, **kw)
            rec[_name] = (a, r, arm_repairs(_name, a[0]))
            return r
        setattr(tstream, name, arm)
    try:
        yield rec
    finally:
        for name, fn in saved.items():
            setattr(tstream, name, fn)


def hold_arms_on_one_device(rec):
    """Each A/B arm's last call (recorded_arms) made again on one device,
    unprepared and outside the launch tally: the same result and the same
    host repairs, so that a launch which was wrong but repaired, or a
    shard that scanned the wrong rows, shows.  Returns {arm: repairs}."""
    out = {}
    with launches_uncounted():
        for name, (a, r, rep) in rec.items():
            one = getattr(tstream, name)(*a)
            if one != r or arm_repairs(name, a[0]) != rep:
                raise AssertionError(
                    "the A/B's %s gave %r repairing %r, one device %r "
                    "repairing %r" % (name, r, rep, one,
                                      arm_repairs(name, a[0])))
            out[name] = rep
    return out


def tier_ab_case(sc, corpus, errs):
    """Scanner.count of a mid-band machine until a call runs no A/B: the
    first is served by its core and times it against the static tier
    (Scanner._maybe_tier_ab); a fused core that loses gives way to the
    fast legacy core, whose own A/B the next call runs.  Every count
    equals the native count, and the last call is served by the last
    winner.  Every kernel launch of every call, the A/B's arms included,
    is held against its plain version (hold_against_plain, into
    ``errs``; the planes' copies fall inside the timed arms), and each
    arm's result and host repairs against one device's
    (hold_arms_on_one_device).  Returns the fields: each call's tier, wall
    seconds, held launches and the tier_ab record it made, with the A/B's
    seconds, its share of the call and its arms' repairs."""
    want = native_count(sc, corpus)
    run_ab, made = sc._maybe_tier_ab, []

    def timed_ab(data):
        was = getattr(sc, "tier_ab", None)
        t0 = time.perf_counter()
        run_ab(data)
        if getattr(sc, "tier_ab", None) is not was:
            made.append(dict(sc.tier_ab, seconds=time.perf_counter() - t0))

    sc._maybe_tier_ab = timed_ab
    calls = []
    try:
        while not calls or calls[-1]["tier_ab"] is not None:
            if len(calls) == 3:
                raise AssertionError("an A/B on every call: %r" % calls)
            del made[:]
            t0 = time.perf_counter()
            with recorded_launches() as rec, recorded_arms() as arms:
                got = sc.count(corpus)
            call = dict(seconds=time.perf_counter() - t0,
                        tier=sc.stats().tier,
                        tier_ab=made[0] if made else None)
            if got != want:
                raise AssertionError("a mid-band count %d != native %d"
                                     % (got, want))
            held = hold_against_plain(rec, errs)
            del rec
            call["held_launches"] = {k: len(v) for k, v in held.items()}
            if call["tier_ab"] is not None:
                call["ab_share"] = call["tier_ab"]["seconds"] \
                    / call["seconds"]
                if set(arms) != {"spec_count_bytes",
                                 call["tier_ab"]["core_arm"] == "_fusedct"
                                 and "core_count_fused"
                                 or "core_count_bytes"}:
                    raise AssertionError("the A/B's arms: %r" % list(arms))
                call["arm_repairs"] = hold_arms_on_one_device(arms)
            del arms
            calls.append(call)
    finally:
        del sc._maybe_tier_ab
    last = calls[-2]["tier_ab"]["winner"] if len(calls) > 1 else None
    if last is None or calls[0]["tier"] != "CoreTables" \
            or calls[-1]["tier"] != ("SpecTablesWide" if last == "static"
                                     else "CoreTables"):
        raise AssertionError("the A/B's tiers: %r" % calls)
    return dict(rows=sc._spec.rows, bytes=len(corpus), count=want,
                calls=calls)


def tier_ab_phase(dev, errs, mb=TIER_AB_MB):
    """The first-scan A/B of the "ab" band on the card: each mid-band
    machine over ``mb`` MB (tier_ab_case), then the rows-4 machine over
    a virtual mesh of MESH_SHARDS shards of ``dev``; every launch held
    against its plain version into ``errs``.  Returns the phase's
    fields."""
    out = {}
    with env("SREGEX_TIER_AB", "1"):
        for i, (pattern, plants) in enumerate(TIER_AB_MACHINES):
            sc = sregex_tpu_torch.compile_pattern(pattern, device=dev)
            if tstream._core_band(sc._spec) != "ab":
                raise AssertionError("%r is not mid-band" % pattern)
            corpus = tier_ab_corpus(mb, plants, sc.CORE_SAMPLE, 31 + i)
            name = "rows%d" % sc._spec.rows
            out[name] = tier_ab_case(sc, corpus, errs)
            if i == 0:
                msc = Scanner(sc.program, device=dev, ast=sc.ast, dfa=sc.dfa,
                              mesh=make_mesh([dev] * MESH_SHARDS))
                out[name + "_mesh"] = tier_ab_case(msc, corpus, errs)
                del msc
            del sc, corpus
    return out


def mesh_phase(dev, inp, errs):
    """The multi-device layer on the card: the mesh_cases over a virtual
    mesh of MESH_SHARDS shards of ``dev`` on main's corpora and oracles
    ``inp``, dryrun_multichip on the same virtual mesh, and two processes
    over gloo on it; where torch sees more than one card, the same over
    every card (each process on half of them).  Each sharded call's
    kernel launches are held against their plain versions into
    ``errs``.  Returns the phase's fields."""
    from sregex_tpu_torch.parallel.dryrun import dryrun_multichip
    t0 = time.perf_counter()
    out = dict(shards=MESH_SHARDS,
               virtual=mesh_cases(make_mesh([dev] * MESH_SHARDS), inp,
                                  errs))
    t1 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(MESH_SHARDS, [dev] * MESH_SHARDS)
    out["dryrun_s"] = time.perf_counter() - t1
    out["processes"] = multihost_processes()
    ncards = torch.cuda.device_count()
    if ncards > 1:
        out["cards"] = mesh_cases(make_mesh(), inp, errs)
        out["cards_dryrun"] = dryrun_multichip(ncards)
        half = [",".join(str(c) for c in range(lo, lo + ncards // 2))
                for lo in (0, ncards // 2)]
        out["cards_processes"] = multihost_processes(half)
    else:
        out["cards"] = "not run: torch sees one card"
    out["seconds"] = time.perf_counter() - t0
    return out


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
    core_cases = hot_core_tdfa_cases(rng, dev)
    for args, kw in core_cases:
        errs["tdfa"] = max(errs["tdfa"], compare(
            tdfa.tdfa_scan, tdfa.tdfa_scan_ref, args, kw))
    del core_cases
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
        + len(tdfa_cases) + 4 + len(phi_cases) + len(kgram_cases)
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
    # the corpora and oracles the mesh phase runs again
    mesh_inp = dict(headline=(corpus, prog, ast, dfa, exp_first),
                    multi=(mcorpus, msc, mprep, mexp))

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

    mesh_inp["affine"] = (acorpus, asc, aprep, aexp)

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
    mesh_inp["dictionary"] = (bcorpus, bsc, bprep, bexp)
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

    # --- 9b. find_core: find past the static tiers, then precompile ------
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    kline, kct, kprep = find_core_phase(dev, fmb, pats, mmb, mexp)
    klaunch = launch_counts()
    tally(launches)
    if klaunch["tdfa"] <= 0 or klaunch["narrow"] + klaunch["wide"] <= 0 \
            or klaunch["gated"] <= 0:
        raise AssertionError("the find_core phase's kernels: %r" % klaunch)
    say("find_core", **kline, launches=klaunch,
        seconds=time.perf_counter() - t0,
        peak_mem_bytes=torch.cuda.max_memory_allocated())

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

    # --- 12. the stream, finditer and the index's routes ----------------
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    sline, scases = stream_phase(dev, mb, mmb, pats)
    tally(launches)
    if min(v["launches"] for v in sline.values()) <= 0:
        raise AssertionError("a stream ran no kernel: %r" % sline)
    say("stream", core_mb=STREAM_CORE_MB, **sline,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fline, idx, data, fsc, fevents, fsub = finditer_phase(dev, fmb)
    tally(launches)
    if sum(fline["index_launches"].values()) <= 0:
        raise AssertionError("the index ran no kernel: %r" % fline)
    # timed after the tally: these launches are not the path's
    fline["count_launch_ms"], fline["count_launch_shape"] = \
        index_kernel_ms(idx, data, dev)
    del idx
    say("finditer", **fline, peak_mem_bytes=torch.cuda.max_memory_allocated())
    # the pipelined stream surface over the stream and finditer corpora;
    # the oracles' launches (Scanner.count) come before the reset
    poracles = pipe_oracles(scases, bsc, words)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    pline = pipeline_phase(scases, poracles, fsc, data, fevents, fsub)
    pipe_s = time.perf_counter() - t0
    plaunch = launch_counts()
    tally(launches)
    if min(plaunch["narrow"], plaunch["wide"], plaunch["big"]) <= 0:
        raise AssertionError("the pipeline's kernels: %r" % plaunch)
    # timed after the tally: these launches are not the path's
    stages = stage_times(dev, scases["headline"][0], scases["headline"][1])
    bound_gbps = min(stages["stage_gbps"], stages["h2d_pinned_gbps"])
    for name in ("headline", "multi", "no_static_tier", "dictionary"):
        pline[name]["bound_s"] = pline[name]["bytes"] / bound_gbps / 1e9
    say("pipeline", segment_mb=PIPE_SEGMENT >> 20, **pline, **stages,
        bound_gbps=bound_gbps,
        stream_scan_gbps={k: sline[k]["stream_scan_gbps"] for k in sline},
        launches=plaunch, seconds=pipe_s,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    # the batched document surface, over sets cut from the corpora
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    keep = {}
    bline, blaunch = batch_phase(dev, pats, words, bsc, fsc, data, fevents,
                                 keep)
    mesh_inp["docs"] = keep["multi"]
    tally(launches)
    if min(blaunch[k] for k in ("narrow", "wide", "big", "gated",
                                "tdfa")) <= 0:
        raise AssertionError("the batch phase's kernels: %r" % blaunch)
    say("batch", mb=BATCH_MB, dict_mb=BATCH_DICT_MB, find_mb=BATCH_FIND_MB,
        sub_mb=BATCH_SUB_MB, **bline, launches=blaunch,
        seconds=time.perf_counter() - t0,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    del scases, data, fsc, fevents, fsub
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rline = index_routes_phase(dev, words, pats)
    rlaunch = launch_counts()
    tally(launches)
    if rlaunch["gated"] <= 0 or rlaunch["narrow"] + rlaunch["wide"] <= 0:
        raise AssertionError("the index routes' kernels: %r" % rlaunch)
    say("index_routes", mb=INDEX_ROUTE_MB, **rline, launches=rlaunch,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
    # the "ab" band's first-scan A/B: the arms' launches are the path's
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    aline = tier_ab_phase(dev, errs)
    alaunch = launch_counts()
    tally(launches)
    if min(alaunch[k] for k in ("narrow", "wide", "gated")) <= 0:
        raise AssertionError("the tier_ab phase's kernels: %r" % alaunch)
    say("tier_ab", mb=TIER_AB_MB, shards=MESH_SHARDS, **aline,
        launches=alaunch, seconds=time.perf_counter() - t0,
        peak_mem_bytes=torch.cuda.max_memory_allocated())

    if min(launches.values()) <= 0:
        raise AssertionError("a main path skipped its kernel: %r"
                             % launches)

    # --- 13. kernel vs plain time at the main path's shapes ---------------
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
    # the tagged kernel at the find phase's shape and on the hot core's
    # planes at the find_core phase's, entered as tdfa_spec_find enters it
    tline = tdfa_times(ft, fprep.for_tables(ft)[0], dev, errs)
    timings["tdfa"] = tuple(tline[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by", "shape"))
    say("kernel_time", tier="tdfa", **tline,
        steps_1mb=tdfa_step_shares(ft, fcorpus))
    say("kernel_time", tier="tdfa_core", H=kct.H,
        **tdfa_times(kct, kprep.for_tables(kct)[0], dev, errs))
    del kprep
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
    phi_stats.clear()

    # --- 14. the mesh: the paths again, sharded, and two processes --------
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mline = mesh_phase(dev, mesh_inp, errs)
    mlaunch = launch_counts()
    tally(launches)
    if min(mlaunch[k] for k in ("narrow", "wide", "big", "affine",
                                "gated")) <= 0:
        raise AssertionError("the mesh phase's kernels: %r" % mlaunch)
    say("mesh", **mline, launches=mlaunch,
        peak_mem_bytes=torch.cuda.max_memory_allocated())
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
    if sys.argv[1:2] == ["--multihost"]:
        multihost_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()
