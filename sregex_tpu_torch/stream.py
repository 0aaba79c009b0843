"""Whole-corpus scanning API over the device tiers.

Counterpart of the main-path subset of the JAX package's stream.py:
Scanner.match/count/scan/find/prepare/stats, PreparedCorpus and the
warmup ladder.  The entry points run on the card: ``Scanner(prog)`` and
``compile_pattern(p)`` take ``device="cuda"`` and raise when there is
no card; ``device="cpu"`` runs the device path's plain torch versions
on the CPU; ``device=None``, passed explicitly, serves every call from
the native host engine (the JAX package's use_device=False).

The static tier chain is the JAX package's: pair (narrow) -> narrow ->
affine (P <= 6) -> wide -> affine -> big.  Above it sit the adaptive
hot-core tiers (ops/core.py), tried first, in the JAX order: the fused
two-phase tier, then the legacy core.  Which machines they serve is the
decision band _core_band, measured on the card and narrower than the
JAX package's: only a machine no static tier accepts gets the legacy
core (escapes repaired natively), or the native engine where no core
fits (CoreTables declines), as stats().tier then says.  Every static
tier, wide and big included, serves its machines itself.  The fused
tier (a core sampled from the corpus, escapes redone on the card by the
static tier's kernel) is the TPU's route for long-chain wide and big
machines; on the card it is slower than the static tier it would
replace, so it serves only when SREGEX_FUSED=1 asks for it, and a scan
that overflows its device cap hands the machine back to the static
tier.  SREGEX_CORE=0 keeps every core tier out.  Unlike the JAX
package, no device failure is swallowed: a failed build or launch
raises.

A pattern past the eager DFA budget (DfaTooLarge) gets no dense
machine and no static tier, as in the JAX package: every call is
served by the lazy machine (dfa.LazyDfa, subset construction on
demand, its walkers native), stats().tier "lazy", and on a device
corpus by the legacy core over it (ops/core.LazyCoreTables), whose
escapes re-scan on the lazy machine.

A machine whose state depends on history with no bound (run parity,
a residue mod n) defeats every speculation window: once two
repair-heavy scans find the warmup ladder exhausted, the Scanner
switches it to the exact transfer-composition tier (ops/phi.py:
PhiTables for S <= 128, PhiTablesBig up to 1024 states), which counts
and scans with no speculation and no host repair.

find() takes the JAX package's dense-DFA paths: the one-pass tagged-DFA
kernel (ops/tdfa_scan.py) where it can certify its result, else the
exact multi-pass path (the DFA prefilter, the reverse-DFA start
locator, a Pike pass over the match region).  On the lazy machine the
prefilter is the lazy scan and the start locator the lazy reverse
machine, walked on the host.  find's hot-core tagged and reverse tiers
are not ported yet; the results do not differ.
"""

import functools
import os
import time

from .compiler import compile_regex
from .consts import sre_isword
from .dfa import DfaTooLarge, LazyDfa, build_dfa
from .diag import ScanStats
from .native import NativeDfa
from .native_pike import NativePikeCtx, NativeProgram
from .ops.affine import SpecTablesAffine
from .ops.big import SpecTablesBig
from .ops.core import (FUSED_ESCAPE_FRAC, CoreTables, LazyCoreTables,
                       core_count_bytes, core_count_fused, core_scan_bytes,
                       core_scan_fused, fused_chunk)
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

def _build_spec_tables(dfa, device):
    """The static tier chain, fastest first, as in the JAX package:
    narrow pair-step (SREGEX_PAIR=0 disables), narrow, piecewise affine
    with at most 6 pieces, wide, piecewise affine, big
    (SREGEX_AFFINE=0 drops both affine tiers).  None when none accepts
    the machine."""
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
    return None


def _core_band(spec):
    """The core-vs-static decision band of a static tier: "core" = the
    legacy core is tried first, "static" = the static tier serves.

    The JAX package's bands (its stream.py:101-117) were measured on the
    TPU: static up to 2 wide rows, "ab" (a first-scan A/B) up to 16,
    core past that and for the big tier or none.  On the card every
    static tier is "static", and there is no "ab" band:

      - a wide table sits whole in shared memory and costs one lookup a
        byte whatever its rows, so the TPU's reason to leave a
        long-chain wide tier, its row-select chain, does not exist (the
        90-keyword set: wide 1221.01 GB/s, the fused tier 795.33);
      - the big tier reads its table through L1/L2 at about 800 GB/s on
        the 500-keyword dictionary, where the fused tier measured 755.74
        and the legacy core, which re-scans every escaped chunk on the
        host, 1.97 GB/s (chip_smoke.py on an H100 at 700 W; PERF.md).

    Only a machine with no static tier is "core"."""
    return "core" if spec is None else "static"


def _core_requirement(spec):
    """The legacy core's eligibility over a static tier: None = it stays
    out (the band is "static", or SREGEX_CORE=0), else the require_fast
    flag for CoreTables (False: with no static tier any core helps)."""
    if os.environ.get("SREGEX_CORE") == "0" or _core_band(spec) != "core":
        return None
    return False


def _fused_eligible(spec):
    """Whether the fused tier may serve over static tables ``spec``: only
    when SREGEX_FUSED=1 asks for it (the card's band keeps every static
    tier, _core_band) and SREGEX_CORE=0 does not keep the core tiers
    out, over the tables the JAX package builds it for, whose kernel
    phase 2 reruns: a long-chain wide tier or the big tier."""
    if os.environ.get("SREGEX_FUSED") != "1" \
            or os.environ.get("SREGEX_CORE") == "0":
        return False
    return (isinstance(spec, SpecTablesWide) and spec.rows > 4) \
        or isinstance(spec, SpecTablesBig)


# per api: the fused, legacy core, phi and static tiers' entry points
_TIER_CALLS = {
    "count": (core_count_fused, core_count_bytes, phi_count_bytes,
              spec_count_bytes),
    "scan": (core_scan_fused, core_scan_bytes, phi_scan_bytes,
             spec_scan_bytes),
}


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

    def for_tables(self, tables, chunk_len=None):
        """The prep for one tables object.  ``chunk_len`` overrides the
        corpus default: the fused tier aligns its two preps (the core's
        and the full machine's) on one chunk length (core.fused_chunk)."""
        ck = self.chunk_len if chunk_len is None else chunk_len
        # the entry holds its tables, so no later tables object can
        # reuse the key
        key = (id(tables), ck)
        hit = self._by_tables.get(key)
        if hit is None:
            knob = os.environ.get("SREGEX_DEVICE_PREP")
            use_dev = (len(self.data) >= DEVICE_PREP_MIN if knob is None
                       else knob == "1")
            src = self._raw() if use_dev else self.data
            prep = (phi_prepare if isinstance(tables, (PhiTables,
                                                       PhiTablesBig))
                    else prepare_auto)
            hit = (tables, prep(tables, src, ck))
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

    Corpora of at least DEVICE_THRESHOLD bytes go to the device tiers;
    smaller ones, and every corpus when device=None, to the native
    engine."""

    DEVICE_THRESHOLD = 4 << 20   # below this the host engine wins
    CORE_SAMPLE = 256 << 10      # bytes per hot-core sample slice
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
    # Re-core on drift, as in the JAX package: a core sampled from one
    # corpus turns repair-heavy on a corpus of another distribution.
    # Two consecutive completed core scans with more than
    # CORE_DRIFT_FRAC of their chunks repaired rebuild it from the next
    # corpus; past MAX_RECORE rebuilds the tier declines for the
    # Scanner's life.  Only speed is at stake.
    MAX_RECORE = 2

    def __init__(self, prog, device="cuda", ast=None):
        self.program = prog
        self.ast = ast
        try:
            dfa = build_dfa(prog)
        except DfaTooLarge:
            # past the eager budget: the lazy machine serves (_lazy_dfa)
            dfa = None
        self.dfa = dfa
        self._native = None if dfa is None else NativeDfa(dfa)
        self._lazy = None
        self.device = None if device is None else resolve_device(device)
        self._spec = (None if self.device is None or dfa is None
                      else _build_spec_tables(dfa, self.device))
        # the core tiers (ops/core.py), built from a corpus sample at
        # first use: None untried, False declined
        self._coret = None
        self._fusedct = None
        self._core_strikes = 0     # the legacy core's drifted scans
        self._core_rebuilds = 0    # its re-cores
        self._tdfa_spec = None
        if self.device is not None and dfa is not None:
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
        self._rev_lz = None        # the lazy reverse machine: None untried
        # the C++ Pike engine resolves captures when it builds
        self._pike_nprog = (NativeProgram(prog)
                            if NativePikeCtx.available() else None)
        self.last_stats = None
        self._warm_escalations = 0
        self._warm_strikes = 0
        self._fused_warm_strikes = 0
        self._phi = None           # phi tables: None untried, False none
        self._phi_active = False

    def prepare(self, data, chunk_len=DEFAULT_K):
        """Pack ``data`` once for device scanning; pass the handle back
        via ``prepared=`` on match/count/scan."""
        return PreparedCorpus(data, self.device, chunk_len)

    def _on_device(self, data):
        return self.device is not None \
            and len(data) >= self.DEVICE_THRESHOLD

    def _note_stats(self, api, tier, nbytes, t0, certified=None):
        """Record one completed scan: the tables that served it (None =
        the native engine) with its chunk and repair counts; for find,
        whether the one-pass tagged result was certified (True) or fell
        back to the multi-pass path (False; None: not tried)."""
        rep = tier.last_repair if tier is not None else None
        nat, chunks = rep if rep is not None else (0, 0)
        name = type(tier).__name__ if tier is not None else (
            "native" if self.dfa is not None else "lazy")
        self.last_stats = ScanStats(
            api, name, nbytes, chunks=chunks, repaired=nat,
            recore_events=self._core_rebuilds,
            warm_events=self._warm_escalations,
            elapsed_ms=(time.perf_counter() - t0) * 1e3,
            certified=certified)

    def stats(self):
        """The last completed match/count/scan/find call's ScanStats
        (tier, chunks, natively repaired chunks, re-cores and warmup
        escalations so far, wall ms; for find whether the one-pass
        result certified), or None."""
        return self.last_stats

    def _lazy_dfa(self):
        """The lazy machine of a pattern past the eager budget, built at
        first use."""
        if self._lazy is None:
            self._lazy = LazyDfa(self.program)
        return self._lazy

    def _host(self):
        """The host engine: the dense machine's NativeDfa, else the lazy
        machine (the same count / scan_first / scan_last contract)."""
        return self._native if self.dfa is not None else self._lazy_dfa()

    def _eof_id(self, state):
        """Regex id of a match ending at EOF in ``state``, or -1."""
        if self.dfa is not None:
            return int(self.dfa.match_eof_id[state])
        return self._lazy_dfa().match_eof_id(state)

    def _id_at(self, state, byte):
        """Regex id of the match ending where ``state`` meets ``byte``."""
        if self.dfa is not None:
            return self.dfa.id_at(state, byte)
        return self._lazy_dfa().id_at(state, byte)

    def _core_sample(self, data):
        """Four slices spread over the corpus, so the hot-core sample
        sees more than the head's byte distribution."""
        n = len(data)
        w = self.CORE_SAMPLE
        cuts = sorted({0, max(0, n // 3), max(0, 2 * n // 3),
                       max(0, n - w)})
        return b"".join(bytes(data[c:c + w]) for c in cuts)

    def _core_tables(self, data):
        """The legacy core tier: where the static chain finds no tier at
        all, sample the corpus once and build a core the pair/narrow/wide
        kernels run (LazyCoreTables over the lazy machine when there is
        no dense one).  Escapes repair natively, so a poor core only
        costs speed.  Cached (False = declined: no core covers the
        sample)."""
        if self._coret is None:
            self._coret = False
            req = _core_requirement(self._spec)
            if req is not None:
                try:
                    sample = self._core_sample(data)
                    self._coret = (
                        CoreTables(self.dfa, sample, require_fast=req,
                                   device=self.device)
                        if self.dfa is not None else
                        LazyCoreTables(self._lazy_dfa(), sample,
                                       require_fast=req,
                                       device=self.device))
                except ValueError:
                    self._coret = False
        return self._coret or None

    def _fused_core_tables(self, data):
        """The core of the fused two-phase tier: escaped chunks are
        redone on the device by the static tier's kernel, so a wide
        core and a loose escape budget are fine.  Built only where
        _fused_eligible allows it (SREGEX_FUSED=1).  Cached (False =
        declined: the static tier serves)."""
        if self._fusedct is None:
            self._fusedct = False
            if not _fused_eligible(self._spec):
                return None
            try:
                self._fusedct = CoreTables(
                    self.dfa, self._core_sample(data),
                    max_escape_frac=FUSED_ESCAPE_FRAC, require_fast=False,
                    no_pair=True, prefer_small=True, device=self.device)
            except ValueError:
                self._fusedct = False
        return self._fusedct or None

    def _core_note(self, ct):
        """After a completed legacy core scan: re-core (back to None,
        rebuilt from the next corpus) after two drifted scans in a row,
        or decline (False) past MAX_RECORE rebuilds."""
        rep = ct.last_repair
        if rep is None:
            return
        nat, C = rep
        if C >= 16 and nat > C * self.CORE_DRIFT_FRAC:
            self._core_strikes += 1
            if self._core_strikes >= 2:
                self._core_strikes = 0
                self._core_rebuilds += 1
                self._coret = (None if self._core_rebuilds <= self.MAX_RECORE
                               else False)
        else:
            self._core_strikes = 0

    def _fused_note(self, fct):
        """After a completed fused scan.  Its host repairs have two
        causes (core.core_count_fused).  "overflow", more escapes than
        the device cap: the host re-scans every escaped chunk, hundreds
        of times slower than the static tier, which is exact on the
        device at about the fused tier's rate, so one such scan declines
        the fused tier and the static tier serves from then on (the JAX
        package re-cores instead: its static big tier was slower than
        its host fold).  "miss", a merged chain that broke because a
        speculation window did not converge over a long excursion, in
        phase 2 or in phase 1: two repair-heavy misses in a row escalate
        the warmup ladder on both machines in lockstep, the static
        tables (phase 2) through _escalate_warmup and the core's inner
        tables (phase 1) through with_warmup; a core that cannot host
        the window declines the fused tier.  A scan with neither cause
        repaired nothing."""
        if fct.last_fused_cause == "overflow":
            self._fusedct = False
            return
        if fct.last_fused_cause != "miss":
            return
        rep = fct.last_repair
        if rep is None:
            return
        nat, C = rep
        if C >= 16 and nat > C * self.CORE_DRIFT_FRAC:
            self._fused_warm_strikes += 1
            if self._fused_warm_strikes >= 2:
                self._fused_warm_strikes = 0
                self._escalate_warmup()
                sp = self._spec
                if sp.warmup > fct.inner.warmup:
                    inner2 = with_warmup(fct.inner, sp.warmup)
                    if inner2 is not None:
                        fct.inner = inner2
                    else:
                        self._fusedct = False
        else:
            self._fused_warm_strikes = 0

    def _escalate_warmup(self):
        """Move the tables one rung up WARM_LADDER.  Returns True on
        escalation."""
        sp = self._spec
        if sp is None:
            return False
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

    def _device_scan(self, api, data, prepared, t0):
        """One device count (api "count") or first-match scan ("scan")
        through the tiers in the JAX order: fused, legacy core, phi,
        static.  Returns (tables, (state, value)), value the count or
        the first match boundary, or (None, None) when no device tier
        serves the corpus (the caller asks the native engine).  Records
        the stats and makes the serving tier's post-scan note."""
        if not self._on_device(data):
            return None, None
        fused_fn, core_fn, phi_fn, spec_fn = _TIER_CALLS[api]

        def prep(tables, ck=None):
            return prepared.for_tables(tables, ck) if prepared else None

        fct = self._fused_core_tables(data)
        if fct is not None:
            spec = self._spec
            ck = fused_chunk(fct.inner, spec)
            r = None if ck is None else fused_fn(
                fct, spec, data, prepared_core=prep(fct.inner, ck),
                prepared_full=prep(spec, ck))
            if r is None:
                self._fusedct = False     # the shapes disqualify it
            else:
                self._fused_note(fct)
                self._note_stats(api, fct, len(data), t0)
                return fct, r
        ct = self._core_tables(data)
        if ct is not None:
            r = core_fn(ct, data, prepared=prep(ct.inner))
            self._core_note(ct)
            self._note_stats(api, ct, len(data), t0)
            return ct, r
        if self._phi_active:
            pt = self._phi
            r = phi_fn(pt, data, prepared=prep(pt))
            self._note_stats(api, pt, len(data), t0)
            return pt, r
        spec = self._spec
        if spec is None:
            return None, None
        r = spec_fn(spec, data, prepared=prep(spec))
        self._note_stats(api, spec, len(data), t0)
        self._spec_note()
        return spec, r

    def _scan_first(self, data, prepared):
        """(first match boundary or -1, state there or at the end, the
        tables that served the scan or None for the native engine)."""
        t0 = time.perf_counter()
        tier, r = self._device_scan("scan", data, prepared, t0)
        if r is not None:
            state, first = r
            return first, state, tier
        first, state = self._host().scan_first(data, 0)
        self._note_stats("scan", None, len(data), t0)
        return first, state, None

    def match(self, data, prepared=None):
        first, state, _ = self._scan_first(data, prepared)
        return first >= 0 or self._eof_id(state) >= 0

    def scan(self, data, prepared=None):
        """Earliest match END with the matched regex id: (regex_id,
        end_boundary) or None; end_boundary == len(data) means the
        match ends at EOF."""
        first, state, _ = self._scan_first(data, prepared)
        if first >= 0:
            return self._id_at(state, data[first]), first
        rid = self._eof_id(state)
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

    def _rev_lazy_dfa(self):
        """The lazy reverse machine of a pattern past the eager budget
        (None when the pattern has no AST), built at first use: the start
        locator of find on the lazy machine."""
        if self._rev_lz is None:
            self._rev_lz = False
            if self.ast is not None:
                self._rev_lz = LazyDfa(compile_regex(
                    reverse_wrapped_ast(self.ast)))
        return self._rev_lz or None

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
                    self._rev_spec = _build_spec_tables(rdfa, self.device)
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
        first, state, tier = self._scan_first(data, prepared)
        result = None
        if first >= 0 or self._eof_id(state) >= 0:
            start = 0
            # the lazy reverse machine walks on the host (the JAX
            # package's device locator for it, _rev_lazy_core, needs
            # core_scan_last_bytes, not ported yet)
            rev = self._rev_dfa() if self.dfa is not None \
                else self._rev_lazy_dfa()
            if rev is not None:
                rdata = data[::-1]
                if self._rev_spec is not None and on_device:
                    rstate, q = spec_scan_last_bytes(self._rev_spec, rdata)
                else:
                    q, rstate = rev.scan_last(rdata, 0)
                eof = (rev.match_eof[rstate] if self.dfa is not None
                       else rev.match_eof(rstate))
                if not eof and q >= 0:
                    start = n - q     # else a match starts at offset 0
            result = self._pike_from(data, start)
        self._note_stats("find", tier, n, t0, certified=certified)
        return result

    def count(self, data, prepared=None):
        """Number of match-ending boundaries (including EOF)."""
        t0 = time.perf_counter()
        _, r = self._device_scan("count", data, prepared, t0)
        if r is not None:
            state, c = r
        else:
            c, state = self._host().count(data, 0)
            self._note_stats("count", None, len(data), t0)
        if self._eof_id(state) >= 0:
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
