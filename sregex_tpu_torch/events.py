"""Device-rate streaming match events: the engine under
Scanner.finditer_stream / Scanner.sub_stream.

Counterpart of the JAX package's events.py.  The reference's production
shape is the streaming replace filter (ngx_replace_filter over the Pike
re-arm loop): an unbounded chunked stream in, matches (or edited bytes)
out, bounded memory.  Its per-byte cost is the Pike VM.  Here the
byte-level work rides the device: a FORWARD per-chunk fire map
(spec_chunk_map, one validated kernel pass per window of at least the
Scanner's DEVICE_THRESHOLD bytes; the native engine below it) says
which chunks contain match-ending boundaries at all, and the Pike VM
runs only around those fires; fire-free gaps are teleported across,
not simulated.

Teleport soundness (the exactness argument):

  bounded patterns (max_match_len = L): with pos the re-arm position
  and F the first fire boundary >= pos, any chosen match [s, e) has
  e >= F (no earlier fire) and s >= e - L >= F - L, so seeding a
  FRESH Pike ctx (with the boundary byte carry) at t = max(pos, F - L)
  skips no chosen match and resurrects no dead one: a thread with
  start < t would need its end-fire e <= s + L < t + L <= F, which
  contradicts F being first.

  unbounded patterns: t = the latest STERILE chunk boundary <= F (a
  DFA state whose every live thread is still inside the `.*?` scan
  loop — dfa.py sterile; computed on the pending sets and AND-merged
  through minimization).  At a sterile boundary the true engine IS a
  fresh ctx, and no fire in (pos, t] means no chosen match was
  skipped.

  probe discard: whenever a probe reports SRE_AGAIN with NO pending
  match and NO committed save-0 (t0 < 0), the live thread set is the
  fresh closure — the engine certifies its own sterility — so the ctx
  is dropped and pos jumps to the probe frontier.  This bounds the
  Pike work after false fires (fires whose matches start before pos,
  i.e. inside already-consumed bytes).

Matches that straddle the mapped horizon suspend naturally: the Pike
ctx returns SRE_AGAIN and resumes on the next push.  Memory is
O(window + teleport lookback): bytes behind min(active-probe start,
next-teleport bound) are released (and reported as ``final`` so the
editor surface can flush them verbatim).
"""

import numpy as np

from .ast_nodes import max_match_len
from .consts import SRE_AGAIN, SRE_DECLINED, sre_isword
from .native import NativeDfa
from .ops.layout import effective_chunk
from .ops.spec_scan import spec_chunk_map


class StreamEvents:
    """Push segments, collect exact (regex_id, ovector) events.

    push(segment, eof=False) -> list of (rid, ov) with ABSOLUTE
    offsets, in match order (the re-arm protocol of Scanner.finditer:
    identical events for every segmentation of the same stream).

    ``final`` (absolute offset): bytes before it can belong to no
    future match and are released unless the caller raises
    ``keep_from``.  ``read(lo, hi)`` returns held bytes (callers
    rendering replacements read gap and match bytes through it).
    """

    # feed the probe in slices so a false fire cannot run the Pike VM
    # to the end of the buffer before re-checking its discard rule; a
    # probe's first slice is PROBE_FIRST bytes past its fire and each
    # next one four times larger, up to PROBE_SLICE, so the probe that
    # follows every match (seeded at its end, where the map's fire for
    # it lies) is dropped after a few KB of Pike work, not 256 KB
    PROBE_FIRST = 4 << 10
    PROBE_SLICE = 256 << 10

    def __init__(self, scanner, chunk_len=2048, map_window=8 << 20):
        self.sc = scanner
        self.dfa = scanner.dfa
        if self.dfa is None:
            raise ValueError("streaming events need the dense DFA")
        self.native = NativeDfa(self.dfa)
        self.L = None
        if scanner.ast is not None:
            self.L = max_match_len(scanner.ast.right)
        self.sterile = self.dfa.sterile
        tables = scanner._spec if scanner.device is not None else None
        self.tables = tables
        if tables is not None:
            self.K = effective_chunk(tables, chunk_len)
        else:
            self.K = chunk_len
        self.map_window = max(map_window, 4 * self.K)
        # rolling byte buffer
        self.buf = bytearray()
        self.base = 0              # absolute offset of buf[0]
        self.total = 0             # absolute bytes received
        self.eof = False
        # fire map over absolute chunk grid [c0*K, (c0+len)*K)
        self.c0 = 0
        self.counts = np.zeros(0, dtype=np.int64)
        self.entries = np.zeros(0, dtype=np.int64)
        self.mapped = 0            # absolute boundary mapped so far
        self.map_state = 0         # DFA state at `mapped`
        # match machinery
        self.pos = 0               # next chosen match STARTS >= pos
        self.end_min = 0           # ... and ENDS >= end_min
        self.ctx = None            # active probe ctx
        self.probe_empty = False   # ctx armed after an empty match
        self.fed = 0               # absolute offset the ctx expects
        self.t_active = 0          # probe start (memory bound)
        self.probe_f = 0           # the fire this probe chases
        self.slice = self.PROBE_FIRST  # the probe's next slice
        self.done = False          # DECLINED: no further matches
        self.final = 0             # bytes < final are match-free
        self.keep_from = None      # caller retention (sub_stream)
        # observability
        self.device_chunks = 0
        self.native_chunks = 0
        self.teleports = 0
        self.probes = 0
        self.refine_calls = 0      # native scan_first calls of _refine
        self._walks = {}           # chunk -> (boundary offset, state, bytes)

    # ---- byte access ------------------------------------------------

    def read(self, lo, hi):
        """Held bytes [lo, hi) — absolute offsets."""
        if lo >= hi:
            return b""
        if lo < self.base:
            raise ValueError("bytes before %d were released" % self.base)
        # one copy (a bytearray slice would make two); the view is
        # released at once, so the buffer stays resizable
        with memoryview(self.buf) as mv:
            return bytes(mv[lo - self.base:hi - self.base])

    def _byte(self, i):
        return self.buf[i - self.base]

    # ---- fire map ---------------------------------------------------

    def _map_more(self):
        """Extend the fire map over every complete unmapped chunk (all
        of them at eof, plus the ragged tail as one native piece)."""
        want = self.total - self.mapped
        if not self.eof and want < self.map_window:
            return
        m = want // self.K
        if m > 0:
            region = self.read(self.mapped, self.mapped + m * self.K)
            if self.tables is not None \
                    and len(region) >= self.sc.DEVICE_THRESHOLD:
                entries, counts, fin = spec_chunk_map(
                    self.tables, region, self.K,
                    entry_state=self.map_state)
                self.device_chunks += m
            else:
                entries = np.zeros(m, dtype=np.int64)
                counts = np.zeros(m, dtype=np.int64)
                st = self.map_state
                for c in range(m):
                    entries[c] = st
                    k, st = self.native.count(
                        region[c * self.K:(c + 1) * self.K], st)
                    counts[c] = k
                fin = st
                self.native_chunks += m
            self.counts = np.concatenate([self.counts, counts])
            self.entries = np.concatenate([self.entries, entries])
            self.mapped += m * self.K
            self.map_state = int(fin)
        if self.eof and self.mapped < self.total:
            tail = self.read(self.mapped, self.total)
            k, st = self.native.count(tail, self.map_state)
            self.counts = np.concatenate(
                [self.counts, np.array([k], dtype=np.int64)])
            self.entries = np.concatenate(
                [self.entries, np.array([self.map_state],
                                        dtype=np.int64)])
            self.mapped = self.total
            self.map_state = int(st)
            self.native_chunks += 1

    def _chunk_span(self, c):
        """Absolute byte range of chunk index c (ragged eof tail)."""
        lo = c * self.K
        return lo, min(lo + self.K, self.total)

    def _next_fire(self, pos):
        """First fire boundary >= pos among mapped chunks, else None.
        Prunes chunks that fall wholly behind pos."""
        lo = max(pos // self.K, self.c0) - self.c0
        for i in np.flatnonzero(self.counts[lo:]):
            b = self._refine(self.c0 + lo + int(i), pos)
            if b is not None:
                return b
        return None

    def _refine(self, c, pos):
        """First fire boundary >= pos inside chunk c (native walk from
        the chunk's exact entry state).

        The walk resumes where the chunk's last call stopped when pos
        lies past the boundary it returned: from that boundary's state,
        one byte on.  Any other call walks from the entry state.  The
        boundaries are those of the JAX package's walk, which always
        starts again at the entry state; this departs from it in cost
        only, so a chunk's native calls grow with its fires, not with
        their square."""
        lo, hi = self._chunk_span(c)
        trans = self.dfa.trans
        cmap = self.dfa.class_map
        w = self._walks.get(c)
        if w is not None and lo + w[0] <= pos:
            rel, st2, data = w
            if lo + rel == pos:
                return pos
            st = int(trans[st2, cmap[data[rel]]])
            rel += 1
        else:
            data = np.frombuffer(self.read(lo, hi), dtype=np.uint8)
            st = int(self.entries[c - self.c0])
            rel = 0
        while rel < len(data):
            f, st2 = self.native.scan_first(data[rel:], st)
            self.refine_calls += 1
            if f < 0:
                return None
            b = lo + rel + f
            self._walks[c] = (rel + f, st2, data)
            if b >= pos:
                return b
            # step past this boundary: consume byte b, keep walking
            st = int(trans[st2, cmap[data[rel + f]]])
            rel += f + 1
        return None

    def _teleport(self, F):
        """Latest provably-exact fresh-ctx seed point in [pos, F]."""
        pos = self.pos
        if self.L is not None:
            return max(pos, F - self.L)
        if self.sterile is not None and len(self.counts):
            # latest sterile chunk boundary x = c*K with pos <= x <= F
            chi = min(F // self.K, self.c0 + len(self.counts) - 1)
            clo = max(self.c0, -(-pos // self.K))
            if chi >= clo:
                ent = self.entries[clo - self.c0:chi - self.c0 + 1]
                ok = np.flatnonzero(self.sterile[ent])
                if len(ok):
                    return (clo + int(ok[-1])) * self.K
        return pos

    def _sterile_in(self, lo, hi):
        """Latest mapped sterile chunk boundary x with lo < x <= hi,
        else None."""
        if self.sterile is None or not len(self.counts):
            return None
        chi = min(hi // self.K, self.c0 + len(self.counts) - 1)
        clo = max(self.c0, lo // self.K + 1)
        if chi < clo:
            return None
        ent = self.entries[clo - self.c0:chi - self.c0 + 1]
        ok = np.flatnonzero(self.sterile[ent])
        if not len(ok):
            return None
        return (clo + int(ok[-1])) * self.K

    # ---- the probe --------------------------------------------------

    def _seed(self, t, F):
        self.ctx = self.sc._pike_ctx()
        self.probe_empty = False
        if t > 0:
            prev = self._byte(t - 1)
            self.ctx.set_carry(t, prev == 10, sre_isword(prev))
        self.fed = t
        self.t_active = t
        self.probe_f = F
        self.slice = self.PROBE_FIRST
        if t > self.pos:
            self.teleports += 1
        self.probes += 1

    def _drive(self, events):
        """Run the event loop over everything mapped; returns when out
        of fires/bytes (suspending any active probe)."""
        while not self.done:
            if self.ctx is None:
                F = self._next_fire(max(self.pos, self.end_min))
                if F is None:
                    if self.eof and self.mapped >= self.total \
                            and self.pos <= self.total \
                            and self.dfa.match_eof[self.map_state]:
                        self._seed(self._teleport(self.total),
                                   self.total)
                    else:
                        # no fire in [pos, mapped): no chosen match
                        # ENDS there, so the frontier can advance —
                        # but only to a provably-fresh seed point,
                        # since a chosen match may START in the gap
                        # and end past `mapped`: its start is
                        # >= mapped - L (bounded; no earlier fire),
                        # and no match spans a sterile boundary
                        # (unbounded).
                        if self.L is not None:
                            self.pos = max(self.pos,
                                           self.mapped - self.L)
                        else:
                            self.pos = self._teleport(self.mapped)
                        return
                else:
                    self._seed(self._teleport(F), F)
            # feed the probe one slice
            hi = min(self.total, max(self.fed + self.slice,
                                     self.probe_f + 1))
            at_eof = self.eof and hi >= self.total
            piece = self.read(self.fed, hi)
            if not piece and not at_eof:
                return                      # need more stream
            rc, pending = self.ctx.exec(piece, at_eof,
                                        want_pending=True)
            if piece:
                # a nonempty chunk consumes the post-empty-match
                # skip-one flag (sre_vm_pike.c:179-194)
                self.probe_empty = False
            if rc >= 0:
                ov = [int(v) for v in self.ctx.ovector]
                events.append((rc, ov))
                self.pos = ov[1]
                self.fed = ov[1]
                if at_eof and ov[1] >= self.total and ov[0] == ov[1]:
                    self.done = True        # final empty match
                elif ov[0] < ov[1]:
                    # the re-arm after a NON-empty match is exactly a
                    # fresh ctx at ov[1] with the byte carry (the same
                    # replacement finditer's teleports make) — drop it
                    # so the loop re-decides with a teleport instead
                    # of thread-simulating to the next fire.  Empty
                    # matches must keep the armed ctx: its
                    # empty_capture skip-one flag is not
                    # reconstructible from outside.
                    self.ctx = None
                else:
                    self.probe_f = max(self.probe_f, ov[1])
                    self.t_active = ov[1]
                    self.probe_empty = True
                    # the skip-one protocol: after an empty match at
                    # e, the next chosen match starts >= e + 1 — a
                    # later reseed must not re-find this match
                    self.pos = ov[1] + 1
                continue
            if rc == SRE_DECLINED:
                self.done = True
                self.pos = self.total
                return
            if rc != SRE_AGAIN:
                raise RuntimeError("pike engine error (SRE_ERROR)")
            self.fed = hi
            self.slice = min(4 * self.slice, self.PROBE_SLICE)
            if pending is None and hi > self.probe_f \
                    and not self.probe_empty:
                # (an armed post-empty-match ctx can report no
                # pending before its skip-one reseed runs — its
                # empty_capture flag is not reconstructible, so it
                # is never dropped)
                # the fire is behind us and the probe holds NO match
                # candidate: no chosen match ends BEFORE `hi` (one
                # ending AT `hi` may still materialize via $/\z if
                # eof lands exactly there, so end_min = hi, not hi+1).
                if int(self.ctx.ovector[0]) < 0:
                    # self-certified sterile: the live set is the
                    # fresh closure — drop; starts < hi are all dead
                    self.ctx = None
                    self.pos = hi
                elif self.L is not None:
                    # bounded: future ends >= hi ⇒ starts >= hi - L,
                    # and a later reseed at max(pos, F' - L) covers
                    # every such start — the held threads are
                    # reconstructible, drop the probe
                    self.ctx = None
                    self.end_min = max(self.end_min, hi)
                    self.pos = max(self.pos, hi - self.L)
                else:
                    # unbounded: droppable at a crossed sterile
                    # mapped boundary x (the forward engine is fresh
                    # there, so the probe — whose threads are a
                    # start-subset — is too)
                    x = self._sterile_in(self.t_active, hi)
                    if x is not None:
                        self.ctx = None
                        self.end_min = max(self.end_min, hi)
                        self.pos = max(self.pos, x)
            if self.ctx is None:
                continue
            if hi >= self.total:
                return                      # suspended: more stream
            # else: keep feeding (candidate or fire still ahead)

    # ---- memory / finality -------------------------------------------

    def _settle(self):
        """Recompute the finality bound and release bytes."""
        if self.done:
            bound = self.total
        else:
            cands = []
            if self.ctx is not None:
                cands.append(self.t_active)
            else:
                cands.append(self.pos)
            # future fires land >= mapped; their teleport lookback:
            if self.L is not None:
                cands.append(max(self.pos, self.mapped - self.L))
            elif self.sterile is not None:
                cands.append(self._teleport(self.mapped))
            else:
                cands.append(self.pos)
            bound = min(cands)
        self.final = max(self.final, bound)
        keep = bound - 1                    # carry byte for reseeds
        # a probe can consume past the mapped horizon; the mapper
        # still needs bytes from `mapped`
        keep = min(keep, self.mapped)
        if self.keep_from is not None:
            keep = min(keep, self.keep_from)
        keep = max(keep, 0)
        if keep > self.base:
            del self.buf[:keep - self.base]
            self.base = keep
        # prune consumed map chunks
        c = self.pos // self.K
        if c > self.c0:
            drop = min(c - self.c0, len(self.counts))
            self.counts = self.counts[drop:]
            self.entries = self.entries[drop:]
            self.c0 += drop
            for k in [k for k in self._walks if k < self.c0]:
                del self._walks[k]

    # ---- public -----------------------------------------------------

    def push(self, segment, eof=False):
        """Feed one segment (b'' allowed); eof=True on the last call.
        Returns the newly final (rid, ovector) events."""
        if self.eof:
            raise RuntimeError("stream already finished")
        if segment:
            self.buf += segment
            self.total += len(segment)
        self.eof = bool(eof)
        events = []
        self._map_more()
        self._drive(events)
        if self.eof and not self.done and self.ctx is None \
                and self.mapped >= self.total:
            self.done = True
        self._settle()
        return events
