"""Whole-corpus scanning API over the device tiers.

Counterpart of the main-path subset of the JAX package's stream.py:
Scanner.match/count/scan/find/prepare/stats, PreparedCorpus and the
warmup ladder.  The entry points run on the card: ``Scanner(prog)`` and
``compile_pattern(p)`` take ``device="cuda"`` and raise when there is
no card; ``device="cpu"`` runs the device path's plain torch versions
on the CPU; ``device=None``, passed explicitly, serves every call from
the native host engine (the JAX package's use_device=False).

The tier chain is the JAX package's static chain: pair (narrow) ->
narrow -> affine (P <= 6) -> wide -> affine -> big.  A machine that no
tier accepts raises NotImplementedError when a device is asked for, as
does the lazy machine.  Where the JAX package sends big machines to its
adaptive core and fused tiers, the port serves them with the static
big tier until those are ported; the results are the same.  Unlike the
JAX package, no device failure is swallowed: a failed build or launch
raises.

A machine whose state depends on history with no bound (run parity,
a residue mod n) defeats every speculation window: once two
repair-heavy scans find the warmup ladder exhausted, the Scanner
switches it to the exact transfer-composition tier (ops/phi.py:
PhiTables for S <= 128, PhiTablesBig up to 1024 states), which counts
and scans with no speculation and no host repair.

find() takes the JAX package's dense-DFA paths: the one-pass tagged-DFA
kernel (ops/tdfa_scan.py) where it can certify its result, else the
exact multi-pass path (the DFA prefilter, the reverse-DFA start
locator, a Pike pass over the match region).  The hot-core tagged and
reverse tiers wait for the core tiers; the results do not differ.
"""

import functools
import os
import time

from .compiler import compile_regex
from .consts import sre_isword
from .dfa import DfaTooLarge, build_dfa
from .diag import ScanStats
from .native import NativeDfa
from .native_pike import NativePikeCtx, NativeProgram
from .ops.affine import SpecTablesAffine
from .ops.big import SpecTablesBig
from .ops.layout import DEFAULT_K
from .ops.pair import SpecTablesPair
from .ops.phi import (PhiTables, PhiTablesBig, phi_count_bytes,
                      phi_prepare, phi_scan_bytes)
from .ops.prep import DEVICE_PREP_MIN, _host_u8, prepare_auto
from .ops.spec_scan import (SpecTables, SpecTablesWide, resolve_device,
                            spec_count_bytes, spec_scan_bytes,
                            spec_scan_last_bytes, with_warmup)
from .ops.tdfa_scan import TdfaSpecTables, tdfa_spec_find
from .parser import parse, parse_multi
from .pike_vm import PikeCtx
from .reverse import reverse_wrapped_ast

_NOT_PORTED = (
    "the JAX package serves it with the adaptive core tiers, which are "
    "not ported yet (ROADMAP.md, Queue 1 items 5 and 6); use device=None "
    "for the host engines")


def _build_spec_tables(dfa, device):
    """The static tier chain, fastest first, as in the JAX package:
    narrow pair-step (SREGEX_PAIR=0 disables), narrow, piecewise affine
    with at most 6 pieces, wide, piecewise affine, big
    (SREGEX_AFFINE=0 drops both affine tiers).  Raises
    NotImplementedError when none accepts the machine."""
    chain = []
    if os.environ.get("SREGEX_PAIR") != "0":
        chain.append(functools.partial(SpecTablesPair, narrow_only=True))
    chain.append(SpecTables)
    if os.environ.get("SREGEX_AFFINE") != "0":
        chain += [functools.partial(SpecTablesAffine, max_pieces=6),
                  SpecTablesWide, SpecTablesAffine, SpecTablesBig]
    else:
        chain += [SpecTablesWide, SpecTablesBig]
    for cls in chain:
        try:
            return cls(dfa, device)
        except ValueError:
            continue
    raise NotImplementedError(
        "no ported device tier accepts this automaton (S*ncls = %d > %d "
        "entries, not piecewise affine): %s"
        % (dfa.nstates * dfa.nclasses, SpecTablesBig.MAX_ENTRIES,
           _NOT_PORTED))


class PreparedCorpus:
    """Device-resident packed corpus, reusable across scans: prepare
    once, then every match/count/scan over it skips the pre-pass.
    Obtained from Scanner.prepare(data); passed back via ``prepared=``.
    Layouts differ per tier and per warmup, so entries are cached per
    tables object (a warmup escalation re-preps under the new tables)."""

    def __init__(self, data, device, chunk_len=DEFAULT_K):
        self.data = data
        self.device = device
        self.chunk_len = chunk_len
        self._by_tables = {}
        self._raw_dev = None

    def _raw(self):
        """The raw bytes on the device, uploaded once."""
        if self._raw_dev is None:
            self._raw_dev = _host_u8(self.data).to(self.device)
        return self._raw_dev

    def for_tables(self, tables):
        # the entry holds its tables, so no later tables object can
        # reuse the key
        key = id(tables)
        hit = self._by_tables.get(key)
        if hit is None:
            knob = os.environ.get("SREGEX_DEVICE_PREP")
            use_dev = (len(self.data) >= DEVICE_PREP_MIN if knob is None
                       else knob == "1")
            src = self._raw() if use_dev else self.data
            prep = (phi_prepare if isinstance(tables, (PhiTables,
                                                       PhiTablesBig))
                    else prepare_auto)
            hit = (tables, prep(tables, src, self.chunk_len))
            self._by_tables[key] = hit
        return hit[1]


class Scanner:
    """Whole-corpus API over a compiled pattern set.

    match(data)  -> bool (any match)
    count(data)  -> number of boundaries where a match ends (EOF too)
    scan(data)   -> (regex_id, end_boundary) of the earliest match end,
                    or None
    find(data)   -> (regex_id, ovector) of the leftmost-first match per
                    full Pike semantics, or None

    Corpora of at least DEVICE_THRESHOLD bytes go to the device tier;
    smaller ones, and every corpus when device=None, to the native
    engine."""

    DEVICE_THRESHOLD = 4 << 20   # below this the host engine wins
    # Warmup escalation, as in the JAX package: a corpus whose runs
    # exceed the speculation window repairs natively chunk by chunk;
    # for bounded-history automata (counted repetitions) a longer
    # warmup converges on any corpus.  Two consecutive completed scans
    # with more than CORE_DRIFT_FRAC of their chunks repaired move the
    # tables one rung up WARM_LADDER.  Past the last rung (or at once,
    # for tables that cannot host a longer window, such as the pair
    # tier's) such a pair of scans switches the machine to the phi tier,
    # where it has one (_phi_tables): no speculation, no repair.
    WARM_LADDER = (128, 512, 2048)
    CORE_DRIFT_FRAC = 0.25

    def __init__(self, prog, device="cuda", ast=None):
        self.program = prog
        self.ast = ast
        try:
            dfa = build_dfa(prog)
        except DfaTooLarge:
            raise NotImplementedError(
                "the pattern exceeds the eager DFA budget; the JAX "
                "package's lazy machine is not ported yet") from None
        self.dfa = dfa
        self._native = NativeDfa(dfa)
        self.device = None if device is None else resolve_device(device)
        self._spec = (None if self.device is None
                      else _build_spec_tables(dfa, self.device))
        self._tdfa_spec = None
        if self.device is not None:
            try:
                self._tdfa_spec = TdfaSpecTables(prog, self.device)
            except (DfaTooLarge, ValueError):
                # too large for the tagged kernel: the multi-pass path
                # covers it (TdfaTooLarge is a DfaTooLarge)
                self._tdfa_spec = None
        # reverse automaton (lazy): locates match STARTS by scanning
        # backwards, so find() only simulates the match region
        self._rev = False
        self._rev_spec = None
        # the C++ Pike engine resolves captures when it builds
        self._pike_nprog = (NativeProgram(prog)
                            if NativePikeCtx.available() else None)
        self.last_stats = None
        self._warm_escalations = 0
        self._warm_strikes = 0
        self._phi = None           # phi tables: None untried, False none
        self._phi_active = False

    def prepare(self, data, chunk_len=DEFAULT_K):
        """Pack ``data`` once for device scanning; pass the handle back
        via ``prepared=`` on match/count/scan."""
        return PreparedCorpus(data, self.device, chunk_len)

    def _on_device(self, data):
        return self._spec is not None \
            and len(data) >= self.DEVICE_THRESHOLD

    def _note_stats(self, api, tier, nbytes, t0, certified=None):
        """Record one completed scan: the tables that served it (None =
        the native engine) with its chunk and repair counts; for find,
        whether the one-pass tagged result was certified (True) or fell
        back to the multi-pass path (False; None: not tried)."""
        rep = tier.last_repair if tier is not None else None
        nat, chunks = rep if rep is not None else (0, 0)
        name = type(tier).__name__ if tier is not None else "native"
        self.last_stats = ScanStats(
            api, name, nbytes, chunks=chunks, repaired=nat,
            warm_events=self._warm_escalations,
            elapsed_ms=(time.perf_counter() - t0) * 1e3,
            certified=certified)

    def stats(self):
        """The last completed match/count/scan/find call's ScanStats
        (tier, chunks, natively repaired chunks, warmup escalations so
        far, wall ms; for find whether the one-pass result certified),
        or None."""
        return self.last_stats

    def _escalate_warmup(self):
        """Move the tables one rung up WARM_LADDER.  Returns True on
        escalation."""
        sp = self._spec
        nxt = next((w for w in self.WARM_LADDER if w > sp.warmup), None)
        t = with_warmup(sp, nxt) if nxt is not None else None
        if t is None:
            return False
        self._spec = t
        self._warm_escalations += 1
        return True

    def _spec_note(self):
        """After a completed device scan: two consecutive repair-heavy
        scans escalate the warmup; past the ladder they switch to the
        phi tier, which counts as one more warmup event."""
        rep = self._spec.last_repair
        if rep is None:
            return
        nat, C = rep
        if C >= 16 and nat > C * self.CORE_DRIFT_FRAC:
            self._warm_strikes += 1
            if self._warm_strikes >= 2:
                self._warm_strikes = 0
                if not self._escalate_warmup() \
                        and self._phi_tables() is not None:
                    self._phi_active = True
                    self._warm_escalations += 1
        else:
            self._warm_strikes = 0

    def _phi_tables(self):
        """The exact phi tier's tables (PhiTables, else PhiTablesBig),
        built at first use; None when the machine fits neither."""
        if self._phi is None:
            self._phi = False
            for cls in (PhiTables, PhiTablesBig):
                try:
                    self._phi = cls(self.dfa, self.device)
                    break
                except ValueError:
                    continue
        return self._phi or None

    def _scan_first(self, data, prepared):
        t0 = time.perf_counter()
        if self._phi_active and self._on_device(data):
            pt = self._phi
            state, first = phi_scan_bytes(
                pt, data, prepared=prepared.for_tables(pt)
                if prepared else None)
            self._note_stats("scan", pt, len(data), t0)
            return first, state
        if self._on_device(data):
            spec = self._spec
            state, first = spec_scan_bytes(
                spec, data, prepared=prepared.for_tables(spec)
                if prepared else None)
            self._note_stats("scan", spec, len(data), t0)
            self._spec_note()
            return first, state
        r = self._native.scan_first(data, 0)
        self._note_stats("scan", None, len(data), t0)
        return r

    def match(self, data, prepared=None):
        first, state = self._scan_first(data, prepared)
        return first >= 0 or bool(self.dfa.match_eof[state])

    def scan(self, data, prepared=None):
        """Earliest match END with the matched regex id: (regex_id,
        end_boundary) or None; end_boundary == len(data) means the
        match ends at EOF."""
        first, state = self._scan_first(data, prepared)
        if first >= 0:
            return self.dfa.id_at(state, data[first]), first
        rid = int(self.dfa.match_eof_id[state])
        return (rid, len(data)) if rid >= 0 else None

    def _pike_ctx(self):
        """Capture-resolution ctx for the high-level API: EXACT mode,
        i.e. true leftmost-first with the reference's lossy prefilter
        re-seed disabled.  The C++ engine when it built, else the
        Python one."""
        if self._pike_nprog is not None:
            return NativePikeCtx(self._pike_nprog, exact=True)
        return PikeCtx(self.program, exact=True)

    def _pike_from(self, data, start):
        """Pike resolution from ``start`` with the preceding byte's
        newline/word carry: (regex_id, ovector) or None."""
        ctx = self._pike_ctx()
        if start > 0:
            prev = data[start - 1]
            ctx.set_carry(start, prev == 10, sre_isword(prev))
        rc, _ = ctx.exec(data[start:], True)
        if rc < 0:
            return None
        return rc, [int(v) for v in ctx.ovector]

    def _rev_dfa(self):
        """The reverse automaton's native engine (None when the pattern
        has no AST or its reverse exceeds the eager budget), with its
        device tables in _rev_spec (None when no tier accepts it)."""
        if self._rev is False:
            self._rev = None
            if self.ast is not None:
                try:
                    rdfa = build_dfa(compile_regex(
                        reverse_wrapped_ast(self.ast)))
                except (DfaTooLarge, ValueError):
                    return None
                self._rev = NativeDfa(rdfa)
                if self.device is not None:
                    try:
                        self._rev_spec = _build_spec_tables(rdfa,
                                                            self.device)
                    except NotImplementedError:
                        self._rev_spec = None
        return self._rev

    def _tdfa_find(self, data, prepared=None):
        """Device tagged-DFA find: one kernel pass yields the span,
        regex id and tracked capture slots (ops/tdfa_scan.py).

        Returns (rid, ovector) for a certified match, (-1, None) for a
        certified no-match, or None when the device result cannot be
        certified exact (the caller then runs the multi-pass path)."""
        tables = self._tdfa_spec
        r = tdfa_spec_find(tables, data,
                           prepared=prepared.for_tables(tables)
                           if prepared else None)
        if r == "fallback":
            return None
        if r is None:
            return -1, None
        return self._tdfa_resolve(tables, r, data)

    def _tdfa_resolve(self, tables, r, data):
        """Map a certified (rid, bank) from the tagged kernel to the
        find() result (rid, user ovector), resolving inner groups with
        a windowed Pike pass when only $0 pairs are tracked.  Returns
        None when the Pike resolution cannot certify (the caller falls
        back to the multi-pass path)."""
        rid, bank = r
        prog = self.program
        ofs = tables.tdfa.slice_ofs[rid]
        nslots = 2 * (prog.multi_ncaps[rid] + 1)
        if tables.tags == tuple(range(prog.ovecsize)):
            # every slot tracked: the bank IS the capture vector; lay
            # out the user ovector like prepare_matched_captures
            # (the matched regex's slice first, -1 fill the rest)
            ov = [int(v) for v in bank[ofs:ofs + nslots]]
            ov += [-1] * (prog.ovecsize - len(ov))
            return rid, ov
        # partial tracking ($0 pairs only): the device pinned the
        # winner's start; Pike resolves inner groups over the match
        # region alone
        ti = tables.tags.index(ofs)
        start = int(bank[ti])
        if nslots == 2:
            ov = [start, int(bank[ti + 1])]
            ov += [-1] * (prog.ovecsize - 2)
            return rid, ov
        return self._pike_from(data, start)

    def find(self, data, prepared=None):
        """Leftmost-first match with captures (Pike semantics):
        (regex_id, ovector) or None.

        On a device corpus the tagged-DFA kernel answers in one pass
        where it can certify its result.  Otherwise the exact multi-pass
        path: the forward DFA proves a match exists, a REVERSE automaton
        scan of the reversed corpus locates the winner's start (the
        leftmost-first winner starts at the minimal start of any
        completed match), and the Pike engine resolves exact captures
        from there with the proper seen_word/seen_newline carry."""
        t0 = time.perf_counter()
        n = len(data)
        on_device = self._on_device(data)
        certified = None
        if self._tdfa_spec is not None and on_device:
            r = self._tdfa_find(data, prepared)
            if r is not None:
                self._note_stats("find", self._tdfa_spec, n, t0,
                                 certified=True)
                rc, ov = r
                return (rc, ov) if rc >= 0 else None
            certified = False
        # DFA prefilter: no match end anywhere => no match at all
        tier = ((self._phi if self._phi_active else self._spec)
                if on_device else None)
        first, state = self._scan_first(data, prepared)
        result = None
        if first >= 0 or self.dfa.match_eof[state]:
            start = 0
            rev = self._rev_dfa()
            if rev is not None:
                rdata = data[::-1]
                if self._rev_spec is not None and on_device:
                    rstate, q = spec_scan_last_bytes(self._rev_spec, rdata)
                else:
                    q, rstate = rev.scan_last(rdata, 0)
                if not rev.match_eof[rstate] and q >= 0:
                    start = n - q     # else a match starts at offset 0
            result = self._pike_from(data, start)
        self._note_stats("find", tier, n, t0, certified=certified)
        return result

    def count(self, data, prepared=None):
        """Number of match-ending boundaries (including EOF)."""
        t0 = time.perf_counter()
        if self._phi_active and self._on_device(data):
            pt = self._phi
            state, c = phi_count_bytes(
                pt, data, prepared=prepared.for_tables(pt)
                if prepared else None)
            self._note_stats("count", pt, len(data), t0)
        elif self._on_device(data):
            spec = self._spec
            state, c = spec_count_bytes(
                spec, data, prepared=prepared.for_tables(spec)
                if prepared else None)
            self._note_stats("count", spec, len(data), t0)
            self._spec_note()
        else:
            c, state = self._native.count(data, 0)
            self._note_stats("count", None, len(data), t0)
        if self.dfa.match_eof[state]:
            c += 1
        return c


def compile_pattern(pattern, flags=0, device="cuda"):
    """Pattern (str/bytes) or list of patterns -> Scanner on ``device``
    (the card by default; "cpu" for the plain versions, None for the
    host engines alone)."""
    if isinstance(pattern, (list, tuple)):
        ast, _ = parse_multi(list(pattern),
                             [flags] * len(pattern)
                             if isinstance(flags, int) else flags)
    else:
        ast, _ = parse(pattern, flags)
    return Scanner(compile_regex(ast), device=device, ast=ast)
