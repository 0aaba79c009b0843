"""Batched multi-document scan: one kernel pass over a whole set of
documents.

Counterpart of the JAX package's ops/batch.py.  The serving shape is
many independent documents (log files, requests, records), each below
the Scanner's DEVICE_THRESHOLD, so a per-document loop would send every
one of them to the host engine.  Here the whole set is packed into one
chunk stream and one kernel pass scans it; the reference itself scans
one buffer per exec call.

It stays exact with no kernel change: the speculative kernels treat
every chunk on its own (each speculates from the seed through its
warmup window, and the chain is validated afterwards), and a document
boundary is exactly the chunk-0 situation, which the per-chunk (state0,
j0) planes already handle: j0 = W freezes the stream through its warmup
so it starts live at the seed.  Batching therefore

  - rounds each document up to whole chunks with a pad byte of class 0
    (the zero-class tail pad every tier already certifies against);
  - sets j0 = W at every document-start chunk (its warmup window holds
    the previous document's tail, frozen and never read);
  - folds the validation chain per document on the host: entries
    restart at the seed, trusted full chunks decode from the planes,
    missed chunks and each document's ragged tail re-walk natively (pad
    bytes are never trusted).

Documents shorter than one chunk fold natively (their only chunk is
ragged); a smaller chunk_len (the packing quantum is 16 bytes) gives
them device coverage.

The fused batch (core_*_many_fused) runs the fused two-phase tier over
the packed stream: escaped chunks are redone on the device by the full
machine's kernel, and the per-document validation folds on the device
too (ops/core._fused_batch), so the common case reads back 2 + 2*ndocs
ints and no planes.

``last_timing`` holds the host clock's split of the last batch call
(here or ops/tdfa_scan.tdfa_find_many): "dispatch_s" (the prep where
needed, the entry planes, enqueueing the kernel), "readback_s" (waiting
for the planes or the summary: the first sync) and "fold_s" (the
per-document fold after it).
"""

import time

import numpy as np
import torch

from ..native import NativeDfa
from .big import SpecTablesBig
from .core import (_fused_batch, _fused_cap, _hot_map, _tier_statics,
                   fused_chunk)
from .layout import DEFAULT_K, GROUPS, TILE, effective_chunk
from .mesh import fits
from .prep import prepare_auto
from .spec_scan import SpecTables, SpecTablesWide, _unpack

# the host clock's split of the last batch call (module docstring)
last_timing = None


class BatchUnsupported(Exception):
    """The tier cannot serve a batched scan (no byte maps to class 0:
    every byte of the alphabet is significant to the pattern)."""


def _pad_byte(tables):
    z = np.where(np.asarray(tables.class_map) == 0)[0]
    if len(z) == 0:
        raise BatchUnsupported("no zero-class byte to pad with")
    return int(z[0])


def _batch_entry_planes(w, starts, seed, B):
    """state0/j0 planes [B, G, 8, 128] on the device of ``starts`` (the
    document-start chunk indices, int64): every stream enters at
    ``seed`` (premultiplied; usually 0, a renumbered tier maps it
    elsewhere), with the warmup frozen (j0 = w) at each document
    start.  Device ops only: nothing waits on the card."""
    s0 = torch.full((B, GROUPS, 8, TILE // 8), int(seed), dtype=torch.int32,
                    device=starts.device)
    j0 = torch.zeros_like(s0)
    j0.view(-1).index_fill_(0, starts, int(w))
    return s0, j0


class PreparedBatch:
    """The pack and upload of a document set, done once (the batch
    analogue of PreparedCorpus): reuse it across count_many / scan_many
    calls of the same Scanner over the same document list, and the pad
    and upload are paid once.  The handle is bound to the tables'
    packing (chunk length, class map); pass it only with the documents
    it was built from.

    spans[d] = (first chunk, chunks, len(doc)); ``prepared`` the prep
    tuple (packed, C, K, J, B), made for a mesh where batch_prepare was
    given one (its blocks divide over the mesh, and on a split mesh each
    shard's lie on its device); ``starts`` the document-start chunk
    indices on the device (int64); ``full`` the full machine's prep of
    the same set for the fused batch (Scanner.prepare_many fills it);
    ``aux`` the fused batch's per-chunk document metadata on the device,
    built at its first call and reused."""

    __slots__ = ("K", "spans", "prepared", "nbytes", "_key", "starts",
                 "full", "aux")

    def __init__(self, K, spans, prepared, nbytes, key):
        self.K = K
        self.spans = spans
        self.prepared = prepared
        self.nbytes = nbytes
        self._key = key
        # one upload of the document starts, shared by every call
        self.starts = torch.from_numpy(
            np.fromiter((s for s, _, _ in spans), dtype=np.int64,
                        count=len(spans))).to(prepared[0].device)
        self.full = None
        self.aux = None


def _pack_key(tables):
    return (type(tables).__name__, tables.ncls,
            getattr(tables, "bits", 4), getattr(tables, "bpu", 1),
            tables.warmup)


def _fits(prepared, tables, docs, K=None, mesh=None):
    """Whether a handle was built for ``tables``' packing (and chunk
    length K, where given) from documents of these lengths, and fits
    ``mesh`` (ops/mesh.fits).  A handle built from other documents would
    decode garbage silently, so any length mismatch re-preps (the cheap
    check; byte identity is the caller's side of the contract)."""
    return (prepared is not None and prepared._key == _pack_key(tables)
            and (K is None or prepared.K == K)
            and fits(prepared.prepared, mesh)
            and len(prepared.spans) == len(docs)
            and all(s[2] == len(d) for s, d in zip(prepared.spans, docs)))


def batch_prepare(tables, docs, chunk_len=DEFAULT_K, mesh=None):
    """Pack the document set into one chunk stream and put it on the
    tables' device (ops/prep.prepare_auto: the device prep for a large
    set), or prepare it for ``mesh``."""
    K = effective_chunk(tables, chunk_len)
    pad = bytes([_pad_byte(tables)])
    spans = []
    parts = []
    c = 0
    nbytes = 0
    for d in docs:
        if not isinstance(d, (bytes, bytearray)):
            d = bytes(d)
        n = len(d)
        nbytes += n
        cd = max(1, -(-n // K))
        spans.append((c, cd, n))
        parts.append(d)
        if cd * K > n:
            parts.append(pad * (cd * K - n))
        c += cd
    buf = b"".join(parts)
    prepared = prepare_auto(tables, buf, K, mesh=mesh)
    assert prepared[2] == K and prepared[1] == c, (prepared[1:4], K, c)
    return PreparedBatch(K, spans, prepared, nbytes, _pack_key(tables))


def _batch_dispatch(tables, docs, chunk_len, count, prepared=None,
                    mesh=None):
    """Pack the documents into one chunk stream (or reuse a
    PreparedBatch built for them and fit for ``mesh``), run one kernel
    pass, sharded over ``mesh``, and read the per-chunk planes back.
    Returns (K, spans, phi, cnt_or_any, swarm) as int64 numpy over the C
    chunks.  The whole-stream summary is not taken: its chain breaks at
    every document boundary by construction, and the per-document fold
    reads the planes, so a core tier's ESC check happens there too
    (_DocFold's ok_extra)."""
    global last_timing
    t0 = time.perf_counter()
    if not _fits(prepared, tables, docs, mesh=mesh):
        prepared = batch_prepare(tables, docs, chunk_len, mesh)
    data, C, _, _, B = prepared.prepared
    W = tables.warmup
    topm = getattr(tables, "to_premult", None)
    s0, j0 = _batch_entry_planes(W, prepared.starts,
                                 topm(0) if topm else 0, B)
    _, packed = tables._scan(data, s0, j0, C, -1, W, COUNT=count,
                             summary=False, mesh=mesh)
    t1 = time.perf_counter()
    phi, aux, swarm = _unpack(packed, C)
    last_timing = {"dispatch_s": t1 - t0,
                   "readback_s": time.perf_counter() - t1, "fold_s": 0.0}
    return prepared.K, prepared.spans, phi, aux, swarm


def _fold_done(t_fold):
    """Record the fold's host time in last_timing."""
    last_timing["fold_s"] = time.perf_counter() - t_fold


class _DocFold:
    """Vectorised per-document repair fold over the per-chunk planes,
    the batch analogue of ops/core._Fold.  The chain links are computed
    with numpy and each maximal TRUSTED RUN resolves in O(1), so the
    Python work scales with documents, breaks and repairs, not chunks.

    ok[c] marks a chunk that can be trusted on its own (full length,
    plus any caller condition such as phi != ESC; fire-free when
    ``quiet``); the run may extend from c to c+1 when c+1 is ok, its
    speculated entry is c's exit and it does not start a document
    (document starts always begin a fresh run at the seed)."""

    __slots__ = ("phi", "cnt", "swarm", "ok", "ok_raw", "breaks", "cum")

    def __init__(self, phi, cnt, swarm, spans, K, quiet=False,
                 ok_extra=None):
        C = len(phi)
        self.phi, self.cnt, self.swarm = phi, cnt, swarm
        full = np.zeros(C, dtype=bool)
        doc_start = np.zeros(C, dtype=bool)
        for c0, cd, n in spans:
            full[c0:c0 + cd] = True
            if cd * K > n:
                full[c0 + cd - 1] = False   # ragged tail: never trust
            doc_start[c0] = True
        ok = full
        if ok_extra is not None:
            ok = ok & ok_extra
        # ok_raw ignores the quiet (fire-free) condition: a scan fold uses
        # it to tell a trusted chunk that fires (an exact native pin from
        # a validated entry, not a repair) from a miss
        self.ok_raw = ok
        if quiet:
            ok = ok & (cnt == 0)
        self.ok = ok
        cont = np.zeros(C, dtype=bool)
        if C > 1:
            cont[:C - 1] = (ok[1:] & (swarm[1:] == phi[:C - 1])
                            & ~doc_start[1:])
        self.breaks = np.flatnonzero(~cont)   # C-1 is always a break
        self.cum = np.cumsum(cnt.astype(np.int64))

    def run_end(self, c):
        """Last chunk b >= c of the maximal trusted run from c (it never
        crosses a document boundary: document starts break it)."""
        i = np.searchsorted(self.breaks, c)
        return int(self.breaks[i])

    def run_count(self, c, b):
        lo = self.cum[c - 1] if c else 0
        return int(self.cum[b] - lo)


def _raw(doc):
    return doc if isinstance(doc, (bytes, bytearray)) else bytes(doc)


def spec_count_many(tables, docs, chunk_len=DEFAULT_K, prepared=None,
                    mesh=None):
    """Per-document match-boundary counts (boundaries 0..n_d-1; the EOF
    boundary is the caller's, per document).  Returns (counts,
    final_states, nat_chunks, total_chunks); nat_chunks counts the
    chunks re-walked natively (ragged tails and speculation misses).
    ``mesh`` shards the one kernel pass over its devices."""
    K, spans, phi, cnt, swarm = _batch_dispatch(tables, docs, chunk_len,
                                                True, prepared, mesh)
    t_fold = time.perf_counter()
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    native = NativeDfa(tables.dfa)
    fold = _DocFold(phi, cnt, swarm, spans, K)
    counts = []
    finals = []
    nat = 0
    for (c0, cd, n), doc in zip(spans, docs):
        raw = _raw(doc)
        e = topm(0)                 # the seed, premultiplied
        total = 0
        c = c0
        end = c0 + cd
        while c < end:
            if fold.ok[c] and int(swarm[c]) == e:
                b = fold.run_end(c)     # a trusted run [c..b] in the doc
                total += fold.run_count(c, b)
                e = int(phi[b])
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            k, st = native.count(bytes(raw[lo:hi]), frpm(e))
            total += k
            e = topm(st)
            nat += 1
            c += 1
        counts.append(total)
        finals.append(frpm(e))
    _fold_done(t_fold)
    return counts, finals, nat, len(phi)


def spec_scan_many(tables, docs, chunk_len=DEFAULT_K, prepared=None,
                   mesh=None):
    """Per-document first-match scan.  Returns (results, nat_chunks,
    total_chunks); results[d] = (state at the boundary, boundary) for a
    match at boundaries 0..n_d-1, else (final state, -1).  EOF
    acceptance is the caller's (tables.match_eof), as for
    spec_scan_bytes.  ``mesh`` as for spec_count_many."""
    K, spans, phi, many, swarm = _batch_dispatch(tables, docs, chunk_len,
                                                 False, prepared, mesh)
    t_fold = time.perf_counter()
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    native = NativeDfa(tables.dfa)
    fold = _DocFold(phi, many, swarm, spans, K, quiet=True)
    results = []
    nat = 0
    for (c0, cd, n), doc in zip(spans, docs):
        raw = _raw(doc)
        e = topm(0)
        hit = None
        c = c0
        end = c0 + cd
        while c < end:
            if fold.ok[c] and int(swarm[c]) == e:
                b = fold.run_end(c)     # a fire-free trusted run
                e = int(phi[b])
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            # fired or untrusted: one native scan pins it exactly
            f, st = native.scan_first(bytes(raw[lo:hi]), frpm(e))
            if not (fold.ok_raw[c] and int(swarm[c]) == e):
                nat += 1
            if f >= 0:
                hit = (st, lo + f)
                break
            e = topm(st)
            c += 1
        results.append(hit if hit is not None else (frpm(e), -1))
    _fold_done(t_fold)
    return results, nat, len(phi)


def _doc_meta(spans, K, ndocs, Cp, device):
    """The fused batch's per-chunk document metadata on the device:
    doc_id [Cp] (padding ndocs), fullv and doc_startv [Cp] 0/1,
    last_full [ndocs] (each document's last full chunk, -1 where none).
    One upload each."""
    doc_id = np.full(Cp, ndocs, np.int32)
    fullv = np.zeros(Cp, np.int32)
    startv = np.zeros(Cp, np.int32)
    last_full = np.full(ndocs, -1, np.int32)
    for i, (c0, cd, nd) in enumerate(spans):
        doc_id[c0:c0 + cd] = i
        fcd = cd - 1 if cd * K > nd else cd
        fullv[c0:c0 + fcd] = 1
        startv[c0] = 1
        if fcd > 0:
            last_full[i] = c0 + fcd - 1
    return tuple(torch.from_numpy(a).to(device)
                 for a in (doc_id, fullv, startv, last_full))


def _fused_batch_dispatch(ct, full_tables, docs, chunk_len, prepared_core,
                          prepared_full):
    """Set-up and dispatch of the fused batched scan: both batch preps
    aligned on one chunk length, phase-1 entry planes with the warmup
    frozen at document starts, the phase-2 j0 plane likewise (a
    document-start redo must not warm up over the previous document's
    tail).  Returns None where the shapes disqualify the fused tier (the
    caller falls back to the legacy core or the static tier), else a
    dict with the summary read back and the planes left on the device.
    The document metadata is cached on the core prep's handle (aux)."""
    global last_timing
    t0 = time.perf_counter()
    inner = ct.inner
    if not isinstance(inner, (SpecTables, SpecTablesWide)) \
            or not isinstance(full_tables, (SpecTables, SpecTablesWide,
                                            SpecTablesBig)):
        return None
    if getattr(inner, "bpu", 1) != 1 \
            or getattr(full_tables, "bpu", 1) != 1:
        return None
    K = fused_chunk(inner, full_tables, chunk_len)
    if K is None:
        return None

    def prep(tables, prepared):
        if not _fits(prepared, tables, docs, K):
            prepared = batch_prepare(tables, docs, K)
        return prepared

    pc = prep(inner, prepared_core)
    pf = prep(full_tables, prepared_full)
    spans = pc.spans
    assert pf.spans == spans, "batch preps disagree on spans"
    core_data, C, Kp, _, B1 = pc.prepared
    full_data, Cf, Kf, _, _ = pf.prepared
    assert (C, Kp) == (Cf, Kf) == (C, K)

    _, w1, _, _, _ = _tier_statics(inner)
    _, w2, _, _, _ = _tier_statics(full_tables)
    cap = _fused_cap(B1)
    ndocs = len(docs)
    Cp = B1 * GROUPS * TILE
    if pc.aux is None:
        pc.aux = _doc_meta(spans, K, ndocs, Cp, core_data.device)
    doc_id, fullv, startv, last_full = pc.aux
    # the core's seed premult is 0 by construction
    s01, j01 = _batch_entry_planes(w1, pc.starts, 0, B1)
    p2_j0 = torch.zeros(Cp, dtype=torch.int32, device=core_data.device) \
        .index_fill_(0, pc.starts, int(w2))
    summary, merged, packed, _ = _fused_batch(
        core_data, full_data, s01, j01, p2_j0, inner, full_tables,
        _hot_map(ct), C, doc_id, fullv, startv, last_full,
        CAP=cap,
        ESC=ct.esc_premult, NDOCS=ndocs)
    t1 = time.perf_counter()
    summ = summary.cpu().numpy().astype(np.int64)
    last_timing = {"dispatch_s": t1 - t0,
                   "readback_s": time.perf_counter() - t1, "fold_s": 0.0}
    ct.last_escapes = (int(summ[1]), int(summ[1]) > cap)
    return {"K": K, "spans": spans, "C": C,
            "all_ok": bool(summ[0]), "n_esc": int(summ[1]),
            "overflow": int(summ[1]) > cap,
            "dcounts": summ[2:2 + ndocs], "dfinals": summ[2 + ndocs:],
            # the planes stay on the device: only the repair paths read
            # them
            "merged": merged, "packed_core": packed}


def core_count_many_fused(ct, full_tables, docs, chunk_len=DEFAULT_K,
                          prepared_core=None, prepared_full=None):
    """Per-document counts through the fused two-phase batch dispatch:
    escaped chunks are redone by the FULL machine's kernel on the device
    (one dispatch for the whole set) instead of one native host walk
    each.  Contract of core_count_many; None where the shapes disqualify
    the fused tier."""
    d = _fused_batch_dispatch(ct, full_tables, docs, chunk_len,
                              prepared_core, prepared_full)
    if d is None:
        return None
    t_fold = time.perf_counter()
    K, spans = d["K"], d["spans"]
    native = ct.native
    ncls_f = full_tables.ncls
    counts, finals, nat = [], [], 0
    if d["all_ok"] and sum(s[2] for s in spans) < 2 ** 31:
        # every document's full-chunk chain validated on the device, and
        # the int32 counts cannot wrap: only ragged tails finish on the
        # host, from each document's device exit
        dcounts, dfinals = d["dcounts"], d["dfinals"]
        for i, ((c0, cd, nd), doc) in enumerate(zip(spans, docs)):
            raw = _raw(doc)
            fcd = cd - 1 if cd * K > nd else cd
            if fcd > 0:
                total = int(dcounts[i])
                e_full = int(dfinals[i]) // ncls_f
            else:
                total = 0
                e_full = 0
            lo = fcd * K
            if lo < nd:
                k, st = native.count(bytes(raw[lo:nd]), e_full)
                total += k
                e_full = st
                nat += 1
            counts.append(total)
            finals.append(e_full)
    elif d["overflow"]:
        # more escapes than the device cap: the legacy fold over the
        # CORE-space planes (core_count_many's)
        phi, cnt, swarm = d["packed_core"].cpu().numpy().astype(np.int64)
        fold = _DocFold(phi, cnt, swarm, spans, K,
                        ok_extra=(phi != ct.esc_premult))
        for (c0, cd, n), doc in zip(spans, docs):
            raw = _raw(doc)
            e_full = 0
            total = 0
            c = c0
            end = c0 + cd
            while c < end:
                cp = ct.to_core_premult(e_full)
                if cp >= 0 and fold.ok[c] and int(swarm[c]) == cp:
                    b = fold.run_end(c)
                    total += fold.run_count(c, b)
                    e_full = ct.to_full(int(fold.phi[b]))
                    c = b + 1
                    continue
                lo = (c - c0) * K
                hi = min(lo + K, n)
                k, st = native.count(bytes(raw[lo:hi]), e_full)
                total += k
                e_full = st
                nat += 1
                c += 1
            counts.append(total)
            finals.append(e_full)
    else:
        # a merged chain broke: walk the merged (full-space) planes
        phi_m, fm_m, swarm_m = d["merged"].cpu().numpy().astype(np.int64)
        fold = _DocFold(phi_m, fm_m, swarm_m, spans, K,
                        ok_extra=(phi_m >= 0))
        for (c0, cd, n), doc in zip(spans, docs):
            raw = _raw(doc)
            e = 0                   # full premult; the seed's is 0
            total = 0
            c = c0
            end = c0 + cd
            while c < end:
                if e >= 0 and fold.ok[c] and int(swarm_m[c]) == e:
                    b = fold.run_end(c)
                    total += fold.run_count(c, b)
                    e = int(phi_m[b])
                    c = b + 1
                    continue
                lo = (c - c0) * K
                hi = min(lo + K, n)
                k, st = native.count(bytes(raw[lo:hi]),
                                     max(e, 0) // ncls_f)
                total += k
                e = st * ncls_f
                nat += 1
                c += 1
            counts.append(total)
            finals.append(max(e, 0) // ncls_f)
    _fold_done(t_fold)
    return counts, finals, nat, d["C"]


def core_scan_many_fused(ct, full_tables, docs, chunk_len=DEFAULT_K,
                         prepared_core=None, prepared_full=None):
    """Per-document first-match scan through the fused batch dispatch;
    contract of core_scan_many (FULL-machine states).  None where the
    shapes disqualify the fused tier."""
    d = _fused_batch_dispatch(ct, full_tables, docs, chunk_len,
                              prepared_core, prepared_full)
    if d is None:
        return None
    t_fold = time.perf_counter()
    K, spans = d["K"], d["spans"]
    native = ct.native
    ncls_f = full_tables.ncls
    results, nat = [], 0
    if d["all_ok"] and sum(s[2] for s in spans) < 2 ** 31:
        # validated on the device: a fire-free document goes straight to
        # its tail; a firing one resolves with ONE early-exit native scan
        # from its start (exact; sparse in the serving shape, where
        # finditer_many uses it to drop match-free documents)
        dcounts, dfinals = d["dcounts"], d["dfinals"]
        for i, ((c0, cd, nd), doc) in enumerate(zip(spans, docs)):
            raw = _raw(doc)
            fcd = cd - 1 if cd * K > nd else cd
            if int(dcounts[i]) > 0:
                f, st = native.scan_first(bytes(raw[:nd]), 0)
                results.append((st, f))
                continue
            e_full = int(dfinals[i]) // ncls_f if fcd > 0 else 0
            lo = fcd * K
            hit = None
            if lo < nd:
                f, st = native.scan_first(bytes(raw[lo:nd]), e_full)
                nat += 1
                if f >= 0:
                    hit = (st, lo + f)
                else:
                    e_full = st
            results.append(hit if hit is not None else (e_full, -1))
    elif d["overflow"]:
        phi, many, swarm = d["packed_core"].cpu().numpy().astype(np.int64)
        fold = _DocFold(phi, many, swarm, spans, K, quiet=True,
                        ok_extra=(phi != ct.esc_premult))
        for (c0, cd, n), doc in zip(spans, docs):
            raw = _raw(doc)
            e_full = 0
            hit = None
            c = c0
            end = c0 + cd
            while c < end:
                cp = ct.to_core_premult(e_full)
                if cp >= 0 and fold.ok[c] and int(swarm[c]) == cp:
                    b = fold.run_end(c)
                    e_full = ct.to_full(int(fold.phi[b]))
                    c = b + 1
                    continue
                lo = (c - c0) * K
                hi = min(lo + K, n)
                f, st = native.scan_first(bytes(raw[lo:hi]), e_full)
                if not (cp >= 0 and fold.ok_raw[c]
                        and int(swarm[c]) == cp):
                    nat += 1
                if f >= 0:
                    hit = (st, lo + f)
                    break
                e_full = st
                c += 1
            results.append(hit if hit is not None else (e_full, -1))
    else:
        phi_m, fm_m, swarm_m = d["merged"].cpu().numpy().astype(np.int64)
        fold = _DocFold(phi_m, fm_m, swarm_m, spans, K, quiet=True,
                        ok_extra=(phi_m >= 0))
        for (c0, cd, n), doc in zip(spans, docs):
            raw = _raw(doc)
            e = 0
            hit = None
            c = c0
            end = c0 + cd
            while c < end:
                if e >= 0 and fold.ok[c] and int(swarm_m[c]) == e:
                    b = fold.run_end(c)
                    e = int(phi_m[b])
                    c = b + 1
                    continue
                lo = (c - c0) * K
                hi = min(lo + K, n)
                f, st = native.scan_first(bytes(raw[lo:hi]),
                                          max(e, 0) // ncls_f)
                if not (e >= 0 and fold.ok_raw[c]
                        and int(swarm_m[c]) == e):
                    nat += 1
                if f >= 0:
                    hit = (st, lo + f)
                    break
                e = st * ncls_f
                c += 1
            results.append(hit if hit is not None
                           else (max(e, 0) // ncls_f, -1))
    _fold_done(t_fold)
    return results, nat, d["C"]


def core_count_many(ct, docs, chunk_len=DEFAULT_K, prepared=None,
                    mesh=None):
    """Per-document counts on the legacy core tier: one kernel pass over
    the sampled hot-core machine serves the whole set (the batched
    core_count_bytes, for machines with no static tier).

    Exactness is the core tier's contract applied per document: a chunk
    is trusted only when it is full length, its speculated entry matches
    the chained entry and it never left the core (phi != ESC); escapes,
    ragged tails and cold entries re-walk natively on the FULL machine
    (ct.native).  Returns (counts, final FULL states, nat_chunks,
    total_chunks).  ``mesh`` as for spec_count_many."""
    K, spans, phi, cnt, swarm = _batch_dispatch(ct.inner, docs, chunk_len,
                                                True, prepared, mesh)
    t_fold = time.perf_counter()
    native = ct.native
    fold = _DocFold(phi, cnt, swarm, spans, K,
                    ok_extra=(phi != ct.esc_premult))
    counts, finals, nat = [], [], 0
    for (c0, cd, n), doc in zip(spans, docs):
        raw = _raw(doc)
        e_full = 0                   # every document starts at the seed
        total = 0
        c = c0
        end = c0 + cd
        while c < end:
            cp = ct.to_core_premult(e_full)
            if cp >= 0 and fold.ok[c] and int(swarm[c]) == cp:
                b = fold.run_end(c)
                total += fold.run_count(c, b)
                e_full = ct.to_full(int(fold.phi[b]))
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            k, st = native.count(bytes(raw[lo:hi]), e_full)
            total += k
            e_full = st
            nat += 1
            c += 1
        counts.append(total)
        finals.append(e_full)
    _fold_done(t_fold)
    return counts, finals, nat, len(phi)


def core_scan_many(ct, docs, chunk_len=DEFAULT_K, prepared=None,
                   mesh=None):
    """Per-document first-match scan on the legacy core tier; the
    contract of spec_scan_many with FULL-machine states: results[d] =
    (full state at the boundary, boundary) or (final full state, -1).
    ``mesh`` as for spec_count_many."""
    K, spans, phi, many, swarm = _batch_dispatch(ct.inner, docs, chunk_len,
                                                 False, prepared, mesh)
    t_fold = time.perf_counter()
    native = ct.native
    fold = _DocFold(phi, many, swarm, spans, K, quiet=True,
                    ok_extra=(phi != ct.esc_premult))
    results, nat = [], 0
    for (c0, cd, n), doc in zip(spans, docs):
        raw = _raw(doc)
        e_full = 0
        hit = None
        c = c0
        end = c0 + cd
        while c < end:
            cp = ct.to_core_premult(e_full)
            if cp >= 0 and fold.ok[c] and int(swarm[c]) == cp:
                b = fold.run_end(c)
                e_full = ct.to_full(int(fold.phi[b]))
                c = b + 1
                continue
            lo = (c - c0) * K
            hi = min(lo + K, n)
            f, st = native.scan_first(bytes(raw[lo:hi]), e_full)
            if not (cp >= 0 and fold.ok_raw[c] and int(swarm[c]) == cp):
                nat += 1
            if f >= 0:
                hit = (st, lo + f)
                break
            e_full = st
            c += 1
        results.append(hit if hit is not None else (e_full, -1))
    _fold_done(t_fold)
    return results, nat, len(phi)
