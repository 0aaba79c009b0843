"""Pipelined streaming scan: overlap each segment's upload with the
kernel of the segment before it.

Counterpart of the JAX package's ops/pipeline.py.  The single-buffer scans
(spec_scan_bytes / spec_count_bytes, ops/spec_scan.py) prepare the whole
corpus, then scan it.  Here the corpus arrives as an iterable of
segments (file reads, network chunks); each segment is staged, uploaded,
prepared and scanned without the host waiting, so the card scans
segment i while segment i+1 is still being copied.  Only the fold (the
per-segment readback of the per-chunk repair planes) waits, one or more
segments behind the uploads.

Where the JAX package gets this overlap from its asynchronous dispatch,
the port stages it by hand, in a ring of in_flight + 1 slots.  A slot
holds a pinned host buffer, a device buffer, a pinned buffer for the
packed planes, a pinned buffer for the warmup tail's classes and two
CUDA events.  dispatch (in the steps stage, upload, prep, launch and
enqueue) copies the segment into its slot's pinned buffer
(the snapshot: a producer may refill its read buffer between yields,
and the fold re-reads these bytes for native repair), uploads it with a
non-blocking copy on a copy stream that records the slot's "uploaded"
event, and on the compute stream waits for that event, runs
prepare_on_device on the slot's device bytes (bit-identical to the host
prep), the kernel (_entry_planes + tables._scan, without the summary:
every segment folds from its planes) and a non-blocking copy
of the packed planes into the slot's pinned planes buffer, after which
it records the slot's "done" event.  fold_one waits for that one event
and frees the slot.  Nothing on the dispatch path copies to or from
pageable memory or synchronises the device: the class LUT stays on the
device with its tables (prep._class_lut) and the tail classes go up
from the slot's pinned tail buffer.  On device="cpu" the same code runs
on CPU tensors, with no pinned memory, no streams and no events.  On
the card a failed pinning, stream or launch raises.

Cross-segment exactness is the same speculation-validation argument
as the in-segment chunk chain (ops/spec_scan.py module docstring):

  - a non-first segment's chunk 0 gets a real warmup window, the last W
    bytes of the stream before it (threaded into the prep as class ids,
    prev_tail_cls), and speculates from the seed state like every
    interior chunk;
  - at fold time the true entry state of each segment is known (the
    previous segment's validated exit), so the host validates swarm[0]
    against it exactly as it validates interior chunks, and re-scans
    mismatched or ragged chunks with the native engine.

Segments of any size compose: a ragged final chunk inside a non-final
segment is repaired natively (bad_tail), and its exact exit state feeds
the next segment's validation.  For pair-unit tables (bpu=2) an odd
trailing byte is held back and prepended to the next segment, so pair
alignment holds stream-wide.  A segment larger than MAX_SEGMENT is
dispatched in pieces of whole chunks, so every piece fits the device
prep.

On a mesh (ops/mesh.py) each segment is prepared with its block count a
multiple of the mesh's size and scanned sharded, as the single-buffer
scans are; the planes come back to the lead device in global order, so
the folds do not change.  Each shard's bytes (ops/prep.shard_spans: its
chunks and the W bytes before them) go from the slot's pinned buffer to
a buffer of the shard's on its device, on that device's copy stream,
behind a per-shard "uploaded" event its compute stream waits for, and
are prepared there (ops/prep.pack_shards): nothing on the dispatch path
waits on any device.
"""

from collections import deque

import numpy as np
import torch

from ..native import NativeDfa
from .core import _Fold
from .layout import DEFAULT_K, effective_chunk
from .prep import _host_u8, pack_shards, prepare_on_device, shard_spans
from .spec_scan import _entry_planes, _unpack

# default number of segments in flight before the oldest is folded
# (2 = double buffering: fold segment i while i+1 executes and i+2
# uploads)
IN_FLIGHT = 2

# the largest piece a segment is dispatched in (rounded down to whole
# chunks): the device prep indexes the padded segment with int32 and
# hands anything from 2 GiB on to the host prep, which would read the
# bytes back from the device; a piece of 1 GiB pads to under 1.5 GiB
MAX_SEGMENT = 1 << 30


def _as_np(seg):
    """A uint8 numpy view of a bytes-like segment (no copy)."""
    if isinstance(seg, np.ndarray):
        return seg.reshape(-1).view(np.uint8)
    return np.frombuffer(seg, dtype=np.uint8)


def _cut(parts, lo, hi):
    """Bytes [lo, hi) of the concatenated ``parts``, as views."""
    out, off = [], 0
    for p in parts:
        a, b = max(lo - off, 0), min(hi - off, len(p))
        if a < b:
            out.append(p[a:b])
        off += len(p)
    return out


def _fold_count(native, raw, n, C, K, ncls, phi, cnt, swarm, e,
                topm=None, frpm=None):
    """Validate one segment's chunk chain from the true entry
    (premultiplied) ``e``; returns (exit_premult, segment_count,
    natively_repaired_chunks).  Vectorised in the common all-validated
    case; mismatched or ragged chunks re-count natively."""
    topm = topm or (lambda v: v * ncls)
    frpm = frpm or (lambda v: v // ncls)
    ragged = C * K > n
    pred = np.concatenate(([e], phi[:-1]))
    ok = swarm == pred
    if ragged:
        ok[C - 1] = False
    if ok.all():
        return int(phi[-1]), int(np.sum(cnt, dtype=np.int64)), 0
    # by induction the prefix before the first failure is exact
    fb = int(np.argmin(ok))
    total = int(np.sum(cnt[:fb], dtype=np.int64))
    e = int(pred[fb])
    c = fb
    nat = 0
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        if swarm[c] == e and hi - lo == K:
            total += int(cnt[c])
            e = int(phi[c])
        else:
            k, st = native.count(raw[lo:hi].tobytes(), frpm(e))
            total += k
            e = topm(st)
            nat += 1
        c += 1
    return int(e), total, nat


def _fold_first(native, raw, n, C, K, ncls, phi, fm, swarm, e,
                topm=None, frpm=None):
    """Validate one segment's chain from entry ``e`` looking for the
    FIRST match boundary.  Returns (exit_premult, rel_boundary or -1,
    natively_repaired_chunks); on a match the exit is the state AT
    the boundary (spec_scan_bytes contract)."""
    topm = topm or (lambda v: v * ncls)
    frpm = frpm or (lambda v: v // ncls)
    ragged = C * K > n
    pred = np.concatenate(([e], phi[:-1]))
    ok = (swarm == pred) & (fm == 0)
    if ragged:
        ok[C - 1] = False
    if ok.all():
        return int(phi[-1]), -1, 0
    fb = int(np.argmin(ok))
    e = int(pred[fb])
    c = fb
    nat = 0
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        if swarm[c] == e and hi - lo == K and fm[c] == 0:
            e = int(phi[c])
            c += 1
            continue
        f, st = native.scan_first(raw[lo:hi].tobytes(), frpm(e))
        if f >= 0:
            return topm(st), lo + f, nat
        e = topm(st)
        c += 1
        nat += 1
    return int(e), -1, nat


def _fold_core_count(ct, packed, raw, n, C, K, e_full):
    """Core-tier segment fold (count): the trusted-run walk of
    core_count_bytes, from the segment's true FULL entry state.
    Returns (exit_full, count, natively_repaired_chunks)."""
    fold = _Fold(ct, packed, C, K, n, quiet=False)
    total = 0
    nat = 0
    c = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            total += fold.run_count(c, b)
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        k, st = ct.native.count(raw[lo:hi].tobytes(), e_full)
        total += k
        e_full = st
        c += 1
        nat += 1
    return e_full, total, nat


def _fold_core_first(ct, packed, raw, n, C, K, e_full):
    """Core-tier segment fold (first match): fired, escaped or
    speculation-missed chunks re-scan natively on the FULL machine.
    Returns (exit_full_or_state_at_boundary, rel_boundary or -1,
    natively_repaired_chunks)."""
    fold = _Fold(ct, packed, C, K, n, quiet=True)
    c = 0
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        f, st = ct.native.scan_first(raw[lo:hi].tobytes(), e_full)
        if f >= 0:
            return st, lo + f, nat
        e_full = st
        c += 1
        nat += 1
    return e_full, -1, nat


class _Slot:
    """One segment's staging buffers: the raw bytes on the host (pinned
    on the card) and on the device (one buffer an upload target: the
    device, or each shard of a mesh), the packed planes and the
    warmup tail's classes on the host (pinned on the card), an
    "uploaded" event a target and the "done" event (None on the CPU).
    Buffers grow to the largest segment the slot has held; a slot is
    refilled only after its fold, which waited for its "done" event, so
    no copy or kernel still reads a buffer that is replaced or
    rewritten."""

    def __init__(self, targets, W, copy_streams):
        self.targets = targets
        self.cuda = targets[0].type == "cuda"
        self.copy_streams = copy_streams
        self.host = self.planes = None
        self.dev = [None] * len(targets)
        self.tail = torch.empty(W, dtype=torch.uint8, pin_memory=self.cuda)
        self.uploaded = ([torch.cuda.Event() for _ in targets]
                         if self.cuda else None)
        self.done = torch.cuda.Event() if self.cuda else None

    def reserve(self, n, sizes):
        """Room for n raw bytes on the host and sizes[i] on target i."""
        if self.host is None or self.host.numel() < n:
            self.host = torch.empty(n, dtype=torch.uint8,
                                    pin_memory=self.cuda)
        for i, (dev, size) in enumerate(zip(self.targets, sizes)):
            if not self.cuda:
                self.dev[i] = self.host
            elif self.dev[i] is None or self.dev[i].numel() < size:
                copy = self.copy_streams[dev]
                with torch.cuda.device(dev):
                    buf = torch.empty(size, dtype=torch.uint8, device=dev)
                    # the block may have been freed on the compute stream
                    # with work that reads it still queued there: the copy
                    # stream waits for that work before its first write
                    copy.wait_stream(torch.cuda.current_stream(dev))
                # made on the compute stream, written on the copy stream
                buf.record_stream(copy)
                self.dev[i] = buf

    def planes_view(self, packed):
        """A host tensor shaped like ``packed`` over the planes buffer."""
        nbytes = packed.numel() * packed.element_size()
        if self.planes is None or self.planes.numel() < nbytes:
            self.planes = torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=self.cuda)
        return self.planes[:nbytes].view(packed.dtype).view(packed.shape)


class _Pipeline:
    """Shared dispatch/fold machinery of pipelined_count and
    pipelined_scan.

    Serves the static tiers (SpecTables / wide / pair / affine / big:
    state carry in premultiplied table space) and the legacy core tier
    (CoreTables / LazyCoreTables, detected by esc_premult: kernels run
    the inner core tables, the carry is a FULL-machine state, and folds
    reuse the core's trusted-run walk with native full-machine repair;
    the sticky-ESC argument does not depend on the segment size)."""

    def __init__(self, tables, chunk_len, entry_state, count_mode,
                 in_flight, mesh=None):
        self.ct = tables if hasattr(tables, "esc_premult") else None
        inner = tables.inner if self.ct is not None else tables
        self.tables = inner
        self.chunk_len = chunk_len
        self.count_mode = count_mode
        self.in_flight = max(1, int(in_flight))
        self.ncls = inner.ncls
        self.W = inner.warmup
        self.bpu = getattr(inner, "bpu", 1)
        self.cm = inner.class_map.tobytes()
        K = effective_chunk(inner, chunk_len)
        self.max_segment = max(1, MAX_SEGMENT // K) * K   # pair-aligned
        if self.ct is not None:
            self.native = self.ct.native      # the FULL machine
            self.e_full = entry_state         # full-state carry
            self.ct.last_repair = None        # set on completed folds
        else:
            self.native = NativeDfa(inner.dfa)
            # closures over ncls, not self: with no reference cycle the
            # slots' pinned buffers go back to torch's host allocator as
            # pipelined_count / pipelined_scan return, and the next pipeline
            # reuses them
            ncls = self.ncls
            self.topm = getattr(inner, "to_premult", None) \
                or (lambda v: v * ncls)
            self.frpm = getattr(inner, "from_premult", None) \
                or (lambda v: v // ncls)
            self.e = self.topm(entry_state)  # premultiplied carry
        self.device = inner.device
        self.mesh = mesh
        # upload targets: the tables' device, or each shard of a mesh
        targets = [self.device] if mesh is None else list(mesh.devices)
        if self.device.type == "cuda":
            self.computes = {d: torch.cuda.current_stream(d)
                             for d in targets}
            self.copies = {d: torch.cuda.Stream(d) for d in targets}
            self.compute = torch.cuda.current_stream(self.device)
        else:
            self.computes = self.copies = self.compute = None
        self.free = deque(_Slot(targets, self.W, self.copies)
                          for _ in range(self.in_flight + 1))
        self.total = 0
        self.first_abs = -1
        self.first_byte = -1               # byte AT the boundary
        self.base = 0                      # absolute offset folded
        self.nat = 0                       # natively repaired chunks
        self.nchunks = 0
        self.tail = b""                    # last <= W raw stream bytes
        self.first_seg = True
        self.pending = deque()

    def spans(self, n):
        """The byte ranges of an n-byte segment each upload target takes
        ([(0, n)] off a mesh), and the mesh prep's geometry (None off a
        mesh)."""
        if self.mesh is None:
            return [(0, n)], None
        C, K, B, spans = shard_spans(self.tables, n, self.chunk_len,
                                     self.mesh)
        return spans, (C, K, B)

    def stage(self, slot, parts, n, spans):
        """Copy the segment (the uint8 arrays ``parts``, n bytes in all)
        into the slot's host buffer: the snapshot the fold re-reads.
        Returns its host view."""
        slot.reserve(n, [hi - lo for lo, hi in spans])
        off = 0
        for p in parts:
            # torch's copy runs on its intra-op threads
            slot.host[off:off + len(p)].copy_(_host_u8(p))
            off += len(p)
        return slot.host.numpy()[:n]

    def upload(self, slot, spans):
        """Start each target's upload of its span on its device's copy
        stream; that device's compute stream waits for it.  Returns the
        spans' bytes on their devices."""
        if slot.uploaded is None:
            return [slot.host[lo:hi] for lo, hi in spans]
        out = []
        for i, (dev, (lo, hi)) in enumerate(zip(slot.targets, spans)):
            copy = self.copies[dev]
            with torch.cuda.stream(copy):
                slot.dev[i][:hi - lo].copy_(slot.host[lo:hi],
                                            non_blocking=True)
                slot.uploaded[i].record(copy)
            self.computes[dev].wait_event(slot.uploaded[i])
            out.append(slot.dev[i][:hi - lo])
        return out

    def _tail_cls(self, slot):
        """Chunk 0's warmup classes on the device (None for the first
        segment: class 0, the single-buffer protocol's padding): the
        last W stream bytes class-mapped and right-aligned, as the JAX
        package's prev_tail_cls, uploaded from the slot's tail buffer."""
        if self.first_seg:
            return None
        t = slot.tail.numpy()
        t[:] = 0
        mapped = np.frombuffer(self.tail.translate(self.cm), dtype=np.uint8)
        if len(mapped):
            t[self.W - len(mapped):] = mapped
        return slot.tail.to(self.device, non_blocking=True)

    def prep(self, slot, segs, geometry):
        """The device prep of the slot's device bytes (each shard's on
        its device on a mesh), with chunk 0's warmup from the stream
        before them."""
        tail = self._tail_cls(slot)
        if geometry is None:
            return prepare_on_device(self.tables, segs[0], self.chunk_len,
                                     prev_tail_cls=tail)
        C, K, B = geometry
        return (pack_shards(self.tables, segs, K, B, self.mesh, tail), C, K,
                self.W + K, B)

    def launch(self, prepared, n):
        """Enqueue the segment's kernel (no summary).  Returns its
        packed planes on the device, C and K."""
        data, C, K, _J, B = prepared
        frozen = None
        if self.first_seg:
            if self.ct is None:
                frozen = self.e
            else:
                # core mode: the entry can be frozen only if it is a
                # hot state; otherwise chunk 0 speculates and the
                # fold repairs it natively (exactness unconditional)
                ep = self.ct.to_core_premult(self.e_full)
                if ep >= 0:
                    frozen = ep
        if frozen is not None:
            # exact entry, warmup frozen (the single-buffer protocol)
            s0p, j0p = _entry_planes(frozen, self.W, B, self.device)
        else:
            # chunk 0 speculates over the real previous-segment tail;
            # validation against the true entry happens at fold time
            s0p, j0p = _entry_planes(0, 0, B, self.device)
        bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K \
            else -1
        kw = {} if self.ct is None else {"esc": self.ct.esc_premult}
        _, packed = self.tables._scan(
            data, s0p, j0p, C, bad_tail, self.W, COUNT=self.count_mode,
            summary=False, mesh=self.mesh, **kw)
        return packed, C, K

    def enqueue(self, slot, packed, raw, C, K, n):
        """Copy the planes into the slot's pinned buffer, record its
        "done" event and queue its fold; fold the oldest segments past
        in_flight."""
        planes = slot.planes_view(packed)
        planes.copy_(packed, non_blocking=True)
        if slot.done is not None:
            slot.done.record(self.compute)
        self.first_seg = False
        if self.W:
            self.tail = (self.tail + raw[-self.W:].tobytes())[-self.W:]
        self.pending.append((slot, planes, raw, C, K, n))
        while len(self.pending) > self.in_flight:
            self.fold_one()

    def dispatch(self, parts):
        """Stage, prepare and enqueue one segment (the uint8 arrays
        ``parts``, concatenated) without waiting for the device, in
        pieces of at most max_segment bytes."""
        n = sum(len(p) for p in parts)
        for lo in range(0, n, self.max_segment):
            hi = min(n, lo + self.max_segment)
            piece = parts if hi - lo == n else _cut(parts, lo, hi)
            slot = self.free.popleft()
            spans, geometry = self.spans(hi - lo)
            raw = self.stage(slot, piece, hi - lo, spans)
            prepared = self.prep(slot, self.upload(slot, spans), geometry)
            packed, C, K = self.launch(prepared, hi - lo)
            self.enqueue(slot, packed, raw, C, K, hi - lo)
            if self.done_early:
                return

    def _release(self):
        """Drop the segments still in flight (dispatched past the first
        match), once the device is done with their slots."""
        while self.pending:
            slot = self.pending.popleft()[0]
            if slot.done is not None:
                slot.done.synchronize()
            self.free.append(slot)

    def fold_one(self):
        if self.done_early:
            # the earliest match is already pinned: later segments'
            # results are past it by construction (the fold is FIFO)
            self._release()
            return
        slot, planes, raw, C, K, n = self.pending.popleft()
        if slot.done is not None:
            slot.done.synchronize()
        packed = planes.numpy()
        self.nchunks += C
        if self.ct is not None:
            if self.count_mode:
                self.e_full, add, nat = _fold_core_count(
                    self.ct, packed, raw, n, C, K, self.e_full)
                self.total += add
                self.nat += nat
            else:
                self.e_full, rel, nat = _fold_core_first(
                    self.ct, packed, raw, n, C, K, self.e_full)
                self.nat += nat
                if rel >= 0:
                    self.first_abs = self.base + rel
                    self.first_byte = int(raw[rel])
        else:
            phi, fmcnt, swarm = _unpack(packed, C)
            if self.count_mode:
                self.e, add, nat = _fold_count(
                    self.native, raw, n, C, K, self.ncls, phi, fmcnt,
                    swarm, self.e, topm=self.topm, frpm=self.frpm)
                self.total += add
                self.nat += nat
            else:
                self.e, rel, nat = _fold_first(
                    self.native, raw, n, C, K, self.ncls, phi, fmcnt,
                    swarm, self.e, topm=self.topm, frpm=self.frpm)
                self.nat += nat
                if rel >= 0:
                    self.first_abs = self.base + rel
                    self.first_byte = int(raw[rel])
        self.base += n
        # the fold has read the slot's bytes and planes: free it
        self.free.append(slot)

    def drain(self):
        while self.pending:
            self.fold_one()
            if self.done_early:
                self._release()

    @property
    def done_early(self):
        return not self.count_mode and self.first_abs >= 0


def _run(tables, segments, chunk_len, entry_state, count_mode, in_flight,
         mesh):
    pipe = _Pipeline(tables, chunk_len, entry_state, count_mode, in_flight,
                     mesh)
    holdback = None
    for seg in segments:
        parts = [p for p in (holdback, _as_np(seg))
                 if p is not None and len(p)]
        holdback = None
        if pipe.bpu == 2 and sum(len(p) for p in parts) % 2:
            # pair-unit tables: keep the stream pair-aligned by holding
            # an odd trailing byte for the next segment (a copy: the
            # producer may refill its buffer)
            holdback = parts[-1][-1:].copy()
            parts[-1] = parts[-1][:-1]
            parts = [p for p in parts if len(p)]
        if not parts:
            continue
        pipe.dispatch(parts)
        if pipe.done_early:
            break
    if holdback is not None and not pipe.done_early:
        pipe.dispatch([holdback])
    pipe.drain()
    # observability: total bytes folded (== stream length unless a
    # first-match fold exited early), read by Scanner.stats()
    (pipe.ct if pipe.ct is not None
     else pipe.tables).last_fold_bytes = pipe.base
    if pipe.ct is not None:
        # completed (no-early-exit) scans feed the Scanner's re-core
        # logic; early-match scans leave the stats None like
        # core_scan_bytes' matched path (their fold stops at the match,
        # so repair fractions would mean nothing)
        if count_mode:
            pipe.ct.last_repair = (pipe.nat, max(pipe.nchunks, 1))
            return pipe.e_full, pipe.total
        if pipe.first_abs < 0:
            pipe.ct.last_repair = (pipe.nat, max(pipe.nchunks, 1))
        return (pipe.e_full, pipe.first_abs, pipe.first_byte, pipe.base)
    # static tiers: the same stats convention (Scanner.stats() reads it)
    if count_mode or pipe.first_abs < 0:
        pipe.tables.last_repair = (pipe.nat, max(pipe.nchunks, 1))
    else:
        pipe.tables.last_repair = None
    if count_mode:
        return pipe.frpm(pipe.e), pipe.total
    return (pipe.frpm(pipe.e), pipe.first_abs, pipe.first_byte, pipe.base)


def pipelined_count(tables, segments, chunk_len=DEFAULT_K,
                    entry_state=0, in_flight=IN_FLIGHT, mesh=None):
    """Count every interior match boundary across a SEGMENTED stream.
    Equivalent to spec_count_bytes on the concatenation, without ever
    materialising it; uploads overlap scans.  Returns (final_state,
    count); the EOF boundary is the caller's (tables.match_eof).

    ``tables`` may be a static tier (SpecTables / wide / pair / affine /
    big) or the legacy core tier (CoreTables / LazyCoreTables); entry
    and final states are always FULL-machine state ids.  Segments are
    any bytes-like objects or uint8 arrays, and may be reused by their
    producer once the next one is asked for.  ``mesh`` shards every
    segment's scan over its devices."""
    return _run(tables, segments, chunk_len, entry_state, True, in_flight,
                mesh)


def pipelined_scan(tables, segments, chunk_len=DEFAULT_K,
                   entry_state=0, in_flight=IN_FLIGHT, mesh=None):
    """First match boundary across a SEGMENTED stream.  Equivalent to
    spec_scan_bytes on the concatenation: returns (state, boundary or
    -1, byte_at_boundary or -1, bytes_folded) with the state AT the
    boundary on a match (so the regex id is dfa.id_at(state, byte)).
    bytes_folded is the total stream length when no match was found
    (the EOF-boundary case); on an early match it only covers the
    folded prefix.  Segments already dispatched when the match folds
    are discarded unfolded.  ``mesh`` as for pipelined_count."""
    return _run(tables, segments, chunk_len, entry_state, False, in_flight,
                mesh)
