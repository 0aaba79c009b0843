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
decision band _core_band.  A machine no static tier accepts gets the
legacy core (escapes repaired natively), or the native engine where no
core fits (CoreTables declines), as stats().tier then says.  A wide
machine of 3 to 16 rows is in the JAX package's "ab" band: the forward
Scanner builds a core for it (the fused one past 4 rows, else a fast
legacy one) and its first count or scan of at least DEVICE_THRESHOLD
bytes times that core against the static tier (_maybe_tier_ab,
recorded in Scanner.tier_ab); the loser is declined for the Scanner's
life; the batch and stream paths, which run no A/B, take such a core
only once an A/B kept it.  SREGEX_TIER_AB=0 turns the A/B off.  Every
other static tier, wide and big included, serves its machines itself,
as measured on the card (the JAX package sends wide machines past 16
rows and big ones to the core tiers).  The fused tier (a core sampled from the corpus,
escapes redone on the card by the static tier's kernel) serves them
only when SREGEX_FUSED=1 asks for it, and a scan that overflows its
device cap hands the machine back to the static tier.  SREGEX_CORE=0
keeps every core tier out.  Unlike the JAX package, no device failure
is swallowed: a failed build or launch raises.

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

find() takes the JAX package's paths: the one-pass tagged-DFA kernel
(ops/tdfa_scan.py) where it can certify its result, over the dense
tables or, past their budget, over a hot core sampled from the corpus
(TdfaCoreTables, escapes re-walked on the host); else the exact
multi-pass path (the DFA prefilter, the reverse-DFA start locator, a
Pike pass over the match region).  On a device corpus the start locator
runs on the reverse machine's legacy core (core_scan_last_bytes) where
it has no static tier, else on its static tier; on the lazy machine the
prefilter is the lazy scan and the locator the lazy reverse core, or
the lazy reverse machine walked on the host where no core fits.
precompile() warms a count's device path on a zero-filled stand-in.

finditer / findall / sub / split (the substitution loop: the Pike ctx
re-arms at each match end) take the native TDFA walker
(native_tdfa.NativeTdfa) on the host, or, on a device corpus or with an
explicit ``index=``, the reverse chunk map of make_index (_StartLocator:
one COUNT pass of the REVERSE machine over the reversed corpus, on its
static tier, its legacy or lazy core, or, under SREGEX_FUSED=1, its
fused tier), between whose match starts the Pike ctx teleports.
StreamEditor is the chunk-in / chunk-out substitution filter over the
Pike engine; StreamScanner the resumable first-match scanner over one
stream, whose large chunks go to the static tier (or the legacy core)
from the stream's carried state.  count_stream / scan_stream /
match_stream take a segmented stream through the pipeline
(ops/pipeline.py: each segment staged in pinned memory and uploaded
while the one before it is scanned), and finditer_stream / sub_stream
through the events engine (events.py: a forward fire map, the Pike
engine only around its fires).  count_many / scan_many / match_many /
find_many / finditer_many / sub_many take a set of documents, each
possibly below DEVICE_THRESHOLD, through one kernel pass over them all
(ops/batch.py: the documents packed into one chunk stream, each start
entered at the seed, each document folded on its own); prepare_many
packs a set once for reuse.

``Scanner(prog, mesh=make_mesh(...))`` (ops/mesh.py) shards every device
count and scan over the mesh's devices, as the JAX package's
Scanner(mesh=) does: the static tiers, the legacy core, the fused tier
(per-shard phases, the stitch on the host), the batch (the fused batch
stays out, as there) and the pipeline; each shard launches the tier's
own kernel, and the folds see the planes in global order.  The
Scanner's device is the mesh's lead device (a device= that disagrees
raises); the phi tier, find's tagged tier and the chunk maps of
make_index take no mesh there or here and run on the lead device.
"""

import functools
import itertools
import os
import time

import numpy as np
import torch

from .compiler import compile_regex
from .consts import SRE_AGAIN, SRE_DECLINED, SRE_ERROR, SRE_OK, sre_isword
from .dfa import DfaTooLarge, LazyDfa, build_dfa
from .diag import ScanStats
from .events import StreamEvents
from .native import NativeDfa
from .native_pike import NativePikeCtx, NativeProgram
from .native_tdfa import NativeTdfa
from .ops.affine import SpecTablesAffine
from .ops.batch import (BatchUnsupported, batch_prepare, core_count_many,
                        core_count_many_fused, core_scan_many,
                        core_scan_many_fused, spec_count_many,
                        spec_scan_many)
from .ops.big import SpecTablesBig
from .ops.core import (FUSED_ESCAPE_FRAC, CoreTables, LazyCoreTables,
                       core_chunk_map, core_chunk_map_fused,
                       core_count_bytes, core_count_fused, core_scan_bytes,
                       core_scan_fused, core_scan_last_bytes, fused_chunk)
from .ops.layout import DEFAULT_K, effective_chunk
from .ops.pair import SpecTablesPair
from .ops.phi import (PhiTables, PhiTablesBig, phi_count_bytes,
                      phi_prepare, phi_scan_bytes)
from .ops.pipeline import IN_FLIGHT, pipelined_count, pipelined_scan
from .ops.prep import (DEVICE_PREP_MIN, _host_u8, prepare_auto,
                       prepare_on_device)
from .ops.spec_scan import (SpecTables, SpecTablesWide, _host_bytes,
                            resolve_device, spec_chunk_map,
                            spec_count_bytes, spec_scan_bytes,
                            spec_scan_last_bytes, with_warmup)
from .ops.tdfa_scan import (TdfaCoreTables, TdfaSpecTables, tdfa_find_many,
                            tdfa_spec_find)
from .parser import parse, parse_multi
from .pike_vm import PikeCtx
from .reverse import reverse_wrapped_ast
from .tdfa import TdfaTooLarge


def _as_docs(docs):
    """A document set as a list of bytes-like documents."""
    return [d if isinstance(d, (bytes, bytearray)) else bytes(d)
            for d in docs]


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
    legacy core is tried first, "static" = the static tier serves, "ab"
    = the forward Scanner times both on its first large scan
    (Scanner._maybe_tier_ab) and keeps the winner.

    The JAX package's bands (its stream.py:101-117) were measured on the
    TPU: static up to 2 wide rows, "ab" up to 16, core past that and for
    the big tier or none.  The port keeps the first two and departs for
    the rest, which the card measured "static":

      - a wide table sits whole in shared memory and costs one lookup a
        byte whatever its rows, so the TPU's reason to leave a
        long-chain wide tier, its row-select chain, does not exist (the
        90-keyword set: wide 1221.01 GB/s, the fused tier 795.33);
      - the big tier reads its table through L1/L2 at about 800 GB/s on
        the 500-keyword dictionary, where the fused tier measured 755.74
        and the legacy core, which re-scans every escaped chunk on the
        host, 1.97 GB/s (chip_smoke.py on an H100 at 700 W; PERF.md).

    The mid-band is left to the A/B, which measures both arms on the
    Scanner's own corpus.  Only a machine with no static tier is
    "core"."""
    if spec is None:
        return "core"
    if isinstance(spec, SpecTablesWide) and 2 < spec.rows <= 16:
        return "ab"
    return "static"


def _core_requirement(spec):
    """The legacy core's eligibility over a static tier without the A/B:
    None = it stays out (the band is "static" or "ab", or SREGEX_CORE=0),
    else the require_fast flag for CoreTables (False: with no static tier
    any core helps).  The reverse cores and StreamScanner take it as it
    is; the forward Scanner through Scanner._core_eligible."""
    if os.environ.get("SREGEX_CORE") == "0" or _core_band(spec) != "core":
        return None
    return False


def _fused_eligible(spec):
    """Whether SREGEX_FUSED=1 puts the fused tier over static tables
    ``spec``: it asks for it, SREGEX_CORE=0 does not keep the core tiers
    out, and the tables are those the JAX package builds it for, whose
    kernel phase 2 reruns: a long-chain wide tier or the big tier."""
    if os.environ.get("SREGEX_FUSED") != "1" \
            or os.environ.get("SREGEX_CORE") == "0":
        return False
    return (isinstance(spec, SpecTablesWide) and spec.rows > 4) \
        or isinstance(spec, SpecTablesBig)


def _tier_ab_band(spec):
    """Whether the forward Scanner's first-scan A/B applies to static
    tables ``spec``: their band is "ab", SREGEX_TIER_AB=0 does not turn
    the A/B off and SREGEX_CORE=0 does not keep the core tiers out."""
    return _core_band(spec) == "ab" \
        and os.environ.get("SREGEX_TIER_AB") != "0" \
        and os.environ.get("SREGEX_CORE") != "0"


# per api: the fused, legacy core, phi and static tiers' entry points
_TIER_CALLS = {
    "count": (core_count_fused, core_count_bytes, phi_count_bytes,
              spec_count_bytes),
    "scan": (core_scan_fused, core_scan_bytes, phi_scan_bytes,
             spec_scan_bytes),
}


class StreamScanner:
    """Resumable boolean scanner over one stream (Thompson-equivalent
    semantics: reports the earliest boundary where any match ends).

    Chunks of at least DEVICE_THRESHOLD bytes go to the device, entered
    in the stream's carried state: the legacy core where the card's
    band gives the machine one (no static tier, _core_requirement) and
    the state is in its core, else the static tier; smaller chunks, and
    every chunk when device=None, to the native engine.  ``device`` as
    for Scanner: the card by default (raises without one), "cpu" for
    the plain versions, None for the host engine alone."""

    DEVICE_THRESHOLD = 1 << 20  # chunks >= 1 MiB go to the device
    CORE_SAMPLE = 256 << 10     # hot-core sample bytes (chunk head)

    def __init__(self, dfa, device="cuda", device_tables=None):
        self.dfa = dfa
        self.state = 0
        self.processed_bytes = 0
        self.eof = False
        # regex id of the match that produced SRE_OK (multi-regex
        # programs; 0 for single-regex), -1 before any match
        self.matched_regex = -1
        self.device = None if device is None else resolve_device(device)
        self._tables = device_tables
        self._coret = None   # legacy core tier; False = declined
        self._native = NativeDfa(dfa)

    def _device_tables(self):
        """The static tier's tables, built at first use (False: none)."""
        if self._tables is None:
            self._tables = _build_spec_tables(self.dfa, self.device) \
                or False
        return self._tables

    def _core_tables(self, chunk):
        """The legacy core, sampled once from the first large chunk's
        head where the card's band gives the machine one.  Exactness
        never depends on the sample (escape repair)."""
        if self._coret is None:
            self._coret = False
            req = _core_requirement(self._device_tables() or None)
            if req is not None:
                try:
                    self._coret = CoreTables(
                        self.dfa, bytes(chunk[:self.CORE_SAMPLE]),
                        require_fast=req, device=self.device)
                except ValueError:
                    self._coret = False
        return self._coret or None

    def exec(self, chunk, eof=False):
        """Feed one chunk.  Returns (rc, match_end_abs):
        rc = SRE_OK (match; match_end_abs = absolute stream offset of
        the earliest match end), SRE_AGAIN (feed more), SRE_DECLINED
        (stream ended, no match), SRE_ERROR (stream already finished).
        On SRE_OK, ``self.matched_regex`` holds the id of the matched
        regex (multi-regex programs; 0 for single-regex).

        After SRE_OK or SRE_DECLINED the stream is finished: further
        exec() calls return SRE_ERROR (the reference's misuse contract,
        sre_vm_pike.c:165-168)."""
        if self.eof:
            return SRE_ERROR, -1
        if chunk is None:
            chunk = b""

        if len(chunk):
            first = None
            if self.device is not None \
                    and len(chunk) >= self.DEVICE_THRESHOLD:
                ct = self._core_tables(chunk)
                if ct is not None \
                        and ct.to_core_premult(self.state) >= 0:
                    state, first = core_scan_bytes(
                        ct, chunk, entry_state=self.state)
                else:
                    tables = self._device_tables()
                    if tables:
                        state, first = spec_scan_bytes(
                            tables, chunk, entry_state=self.state)
            if first is None:
                first, state = self._native.scan_first(chunk, self.state)
            if first >= 0:
                # post-match contract: the scanner is finished, and both
                # engines return the state AT the boundary, so the
                # matched regex id is one table lookup
                self.eof = True
                self.matched_regex = self.dfa.id_at(state, chunk[first])
                return SRE_OK, self.processed_bytes + first
            self.state = state
            self.processed_bytes += len(chunk)

        if eof:
            self.eof = True
            rid = int(self.dfa.match_eof_id[self.state])
            if rid >= 0:
                self.matched_regex = rid
                return SRE_OK, self.processed_bytes
            return SRE_DECLINED, -1
        return SRE_AGAIN, -1


class PreparedCorpus:
    """Device-resident packed corpus, reusable across scans: prepare
    once, then every match/count/scan over it skips the pre-pass.
    Obtained from Scanner.prepare(data); passed back via ``prepared=``.
    Layouts differ per tier and per warmup, so entries are cached per
    tables object (a warmup escalation re-preps under the new tables)."""

    def __init__(self, data, device, chunk_len=DEFAULT_K, mesh=None):
        self.data = data
        self.device = device
        self.chunk_len = chunk_len
        self.mesh = mesh
        self._by_tables = {}
        self._raw_dev = None

    def _raw(self):
        """The raw bytes on the device, uploaded once."""
        if self._raw_dev is None:
            self._raw_dev = _host_u8(self.data).to(self.device)
        return self._raw_dev

    def for_tables(self, tables, chunk_len=None):
        """The prep for one tables object (for the corpus's mesh, except
        the phi and tagged tiers', which take none).  ``chunk_len``
        overrides the corpus default: the fused tier aligns its two preps
        (the core's and the full machine's) on one chunk length
        (core.fused_chunk)."""
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
            if isinstance(tables, (PhiTables, PhiTablesBig)):
                prep = phi_prepare(tables, src, ck)
            else:
                mesh = None if isinstance(tables, TdfaSpecTables) \
                    else self.mesh
                prep = prepare_auto(tables, src, ck, mesh=mesh)
            hit = (tables, prep)
            self._by_tables[key] = hit
        return hit[1]


class Scanner:
    """Whole-corpus API over a compiled pattern set.

    match(data)    -> bool (any match)
    count(data)    -> number of boundaries where a match ends (EOF too)
    scan(data)     -> (regex_id, end_boundary) of the earliest match
                      end, or None
    find(data)     -> (regex_id, ovector) of the leftmost-first match per
                      full Pike semantics, or None
    finditer(data) -> yields successive Pike matches (the re-arm
                      protocol, including empty-match handling); also
                      findall, sub, split and editor (StreamEditor)

    Corpora of at least DEVICE_THRESHOLD bytes go to the device tiers;
    smaller ones, and every corpus when device=None, to the native
    engine.  ``dfa``: prebuilt tables (serialize.load_compiled), which
    skip subset construction.  ``mesh`` (ops/mesh.Mesh) shards the device
    counts and scans over its devices; the Scanner then lives on its lead
    device."""

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

    def __init__(self, prog, device="cuda", ast=None, dfa=None, mesh=None):
        self.program = prog
        self.mesh = mesh
        if mesh is not None:
            want = None if device is None else torch.device(device)
            lead = mesh.lead
            if want is None or want.type != lead.type or (
                    want.index is not None and want.index != lead.index):
                raise ValueError("device=%r disagrees with the mesh, whose "
                                 "lead device is %s" % (device, lead))
            device = lead
        self.ast = ast
        if dfa is None:
            try:
                dfa = build_dfa(prog)
            except DfaTooLarge:
                # past the eager budget: the lazy machine serves
                # (_lazy_dfa)
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
        # an "ab"-band core built and not yet timed against the static
        # tier (_maybe_tier_ab)
        self._ab_pending = False
        self._core_strikes = 0     # the legacy core's drifted scans
        self._core_rebuilds = 0    # its re-cores
        self._rev_core_strikes = 0     # the same for the reverse core
        self._rev_core_rebuilds = 0    # (_rev_coret, find's locator)
        self._tdfa_spec = None
        # the hot-core tagged tables of a machine past the dense budget,
        # sampled from the corpus: None untried, False declined
        self._tdfa_coret = None
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
        # the reverse machine's core tiers (make_index), as _coret and
        # _fusedct: None untried, False declined
        self._rev_coret = None
        self._rev_fusedct = None
        self._rev_lz_coret = None
        # the native TDFA walker of finditer's host path: None untried,
        # False declined (too large, SREGEX_FINDITER=pike, or no g++)
        self._walker = None
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
        return PreparedCorpus(data, self.device, chunk_len, self.mesh)

    def precompile(self, nbytes, sample=b"", chunk_len=DEFAULT_K):
        """Warm what a count() over an ``nbytes``-long corpus needs on the
        device, without the corpus: a zero-filled stand-in of that length
        is made on the device (torch.zeros, so nothing is uploaded),
        prepared (a host zeros array stands in for the ragged tail the
        host walks) and counted through count()'s flow: the fused tier
        where ``sample`` gives it a core (SREGEX_FUSED=1, or the "ab"
        band: _fused_core_tables) and fused_chunk accepts it, else the
        static tier (an "ab"-band core's A/B waits for the first real
        count or scan).  On the card this takes the kernels' nvcc build
        and load, the class map's upload and the allocator's first blocks
        out of the first real call; run it beside host work (the oracle's count, reading the corpus).
        ``sample`` seeds the core tiers as the real corpus would (pass
        its head: a zeros sample builds another core).  Returns wall
        seconds, 0.0 when there is nothing to warm (no dense machine, no
        device, nbytes <= 0)."""
        t0 = time.perf_counter()
        if self.dfa is None or self.device is None or nbytes <= 0:
            return 0.0
        spec = self._spec
        fct = self._fused_core_tables(bytes(sample)) if len(sample) else None
        zeros_dev = torch.zeros(nbytes, dtype=torch.uint8, device=self.device)
        zeros_host = np.zeros(nbytes, np.uint8)
        ck = (fused_chunk(fct.inner, spec, chunk_len)
              if fct is not None and spec is not None else None)
        mesh = self.mesh
        if ck is not None:
            core_count_fused(
                fct, spec, zeros_host, chunk_len=ck,
                prepared_core=prepare_auto(fct.inner, zeros_dev, ck,
                                           mesh=mesh),
                prepared_full=prepare_auto(spec, zeros_dev, ck, mesh=mesh),
                mesh=mesh)
        elif spec is not None:
            spec_count_bytes(spec, zeros_host, chunk_len,
                             prepared=prepare_auto(spec, zeros_dev,
                                                   chunk_len, mesh=mesh),
                             mesh=mesh)
        return time.perf_counter() - t0

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
            recore_events=self._core_rebuilds + self._rev_core_rebuilds,
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

    def _new_core(self, dfa, lazy, sample, req):
        """A legacy core of the machine ``dfa`` (the lazy machine
        ``lazy`` where dfa is None), built from ``sample`` where ``req``,
        its eligibility (_core_requirement or _core_eligible), is not
        None; the pair/narrow/wide kernels run it.  Escapes repair
        natively, so a poor core only costs speed.  False = declined (no
        device, the band, or no core covers the sample)."""
        if self.device is None or req is None:
            return False
        try:
            if dfa is not None:
                return CoreTables(dfa, sample, require_fast=req,
                                  device=self.device)
            return LazyCoreTables(lazy, sample, require_fast=req,
                                  device=self.device)
        except ValueError:
            return False

    def _new_fused_core(self, dfa, sample, admit):
        """The core of the fused two-phase tier over the machine ``dfa``:
        escaped chunks are redone on the device by the static tier's
        kernel, so a wide core and a loose escape budget are fine.  Built
        only where ``admit`` (_fused_eligible, or the "ab" band for the
        forward machine); False = declined (the static tier serves)."""
        if self.device is None or not admit:
            return False
        try:
            return CoreTables(dfa, sample,
                              max_escape_frac=FUSED_ESCAPE_FRAC,
                              require_fast=False, no_pair=True,
                              prefer_small=True, device=self.device)
        except ValueError:
            return False

    @staticmethod
    def _core_eligible(spec):
        """The forward legacy core's eligibility over static tables
        ``spec``, as in the JAX package: None = it stays out, else the
        require_fast flag for CoreTables.  In the "ab" band with the A/B
        on (_tier_ab_band) it is True, since over a wide tier that
        survives only a fast core can help; elsewhere, and under
        SREGEX_TIER_AB=0 or SREGEX_CORE=0, it is _core_requirement's."""
        return True if _tier_ab_band(spec) else _core_requirement(spec)

    @staticmethod
    def _fused_admit(spec):
        """Whether the forward fused core may be built over static tables
        ``spec``: where SREGEX_FUSED=1 asks for it (_fused_eligible), or,
        as the JAX package builds it, for an "ab"-band machine past 4
        rows with the A/B on, unless SREGEX_FUSED=0."""
        return _fused_eligible(spec) or (
            _tier_ab_band(spec) and spec.rows > 4
            and os.environ.get("SREGEX_FUSED") != "0")

    def _ab_kept(self, attr):
        """Whether a path that runs no A/B (the batch and stream paths)
        may take the core held in ``attr``: always outside the band or
        with the A/B off; in the band only the core an A/B timed and
        kept.  Until then those paths take the static tier, which every
        A/B on the card has chosen (PERF.md), where the JAX package lets
        them ride the band's untimed core."""
        if not _tier_ab_band(self._spec):
            return True
        ab = getattr(self, "tier_ab", None)
        return not self._ab_pending and ab is not None \
            and ab["winner"] == "core" and ab["core_arm"] == attr

    def _core_tables(self, data):
        """The legacy core tier (_new_core under _core_eligible;
        LazyCoreTables over the lazy machine when there is no dense one),
        sampled from the corpus.  An "ab"-band core waits for its A/B
        (_ab_pending).  Cached (False = declined)."""
        if self._coret is None:
            self._coret = self._new_core(
                self.dfa, self.dfa is None and self._lazy_dfa(),
                self._core_sample(data), self._core_eligible(self._spec))
            if self._coret and _tier_ab_band(self._spec):
                self._ab_pending = True
        return self._coret or None

    def _fused_core_tables(self, data):
        """The fused tier's core (_new_fused_core under _fused_admit),
        sampled from the corpus; an "ab"-band core waits for its A/B
        (_ab_pending).  Cached (False = declined)."""
        if self._fusedct is None:
            self._fusedct = self._new_fused_core(
                self.dfa, self._core_sample(data),
                self._fused_admit(self._spec))
            if self._fusedct and _tier_ab_band(self._spec):
                self._ab_pending = True
        return self._fusedct or None

    def _core_note(self, ct, attr="_coret"):
        """After a completed legacy core scan by ``ct``, the Scanner's
        attribute ``attr`` ("_coret", or "_rev_coret" for find's reverse
        core): re-core it (back to None, rebuilt from the next corpus)
        after two drifted scans in a row, or decline it (False) past
        MAX_RECORE rebuilds.  Each core keeps its own strikes and
        rebuilds (_core_*, _rev_core_*)."""
        rep = ct.last_repair
        if rep is None:
            return
        nat, C = rep
        pre = attr[:-1]                    # "_core" or "_rev_core"
        strikes = pre + "_strikes"
        if C >= 16 and nat > C * self.CORE_DRIFT_FRAC:
            setattr(self, strikes, getattr(self, strikes) + 1)
            if getattr(self, strikes) >= 2:
                setattr(self, strikes, 0)
                rebuilds = getattr(self, pre + "_rebuilds") + 1
                setattr(self, pre + "_rebuilds", rebuilds)
                setattr(self, attr,
                        None if rebuilds <= self.MAX_RECORE else False)
        else:
            setattr(self, strikes, 0)

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

    # the first-scan A/B of the "ab" band, as in the JAX package: the
    # corpus slice both arms count, and how far the static tier must
    # beat the core to displace it (the arms interleave in one process,
    # each the min of 2 reps)
    TIER_AB_BYTES = 32 << 20
    TIER_AB_MARGIN = 1.1

    def _maybe_tier_ab(self, data):
        """The first-scan A/B of an "ab"-band machine, once per core
        built (_ab_pending): after that core served a count or scan of
        ``data``, count the first TIER_AB_BYTES of it with the core (the
        fused tier's core_count_fused where the core is _fusedct, else
        core_count_bytes) and with the static tier (spec_count_bytes),
        one untimed rep of each and then the min of 2 timed reps,
        interleaved.  Each arm reads its count back to the host, so the
        host clock covers the device's work; the slice is prepared for
        both arms before the clock starts.  The static tier wins only
        when it beats the core by more than TIER_AB_MARGIN, and the loser
        is declined for the Scanner's life (the core attribute set to
        False).  The result is kept in ``self.tier_ab``: bytes, static_s,
        core_s, winner ("static" or "core"), core_arm ("_fusedct" or
        "_coret"), static_gbps and core_gbps.  A corpus below
        DEVICE_THRESHOLD leaves the A/B pending.

        Four departures from the JAX package: a failing arm raises (the
        JAX package declines it and lets the other serve); arms that
        disagree raise (the JAX package warns and keeps the core), since
        one tier is then wrong; a fused core that overflowed its device
        cap on the call it served was declined there by the port's
        overflow rule (_fused_note), so it loses before it is timed: the
        A/B finds no core and records nothing; and the batch and stream
        paths, which run no A/B, take the band's core only once an A/B
        has kept it (_ab_kept), where the JAX package serves them the
        untimed core."""
        if not self._ab_pending:
            return
        fct = self._fusedct
        ct = fct or self._coret
        if not ct:
            self._ab_pending = False       # declined or re-cored since
            return
        if len(data) < self.DEVICE_THRESHOLD:
            return
        self._ab_pending = False
        spec = self._spec
        ab = data[:self.TIER_AB_BYTES]
        abp = PreparedCorpus(ab, self.device, mesh=self.mesh)
        mesh = self.mesh
        attr = "_fusedct" if fct else "_coret"
        if fct:
            ck = fused_chunk(fct.inner, spec)
            pcore, pfull = abp.for_tables(fct.inner, ck), \
                abp.for_tables(spec, ck)

            def core_arm():
                return core_count_fused(fct, spec, ab, prepared_core=pcore,
                                        prepared_full=pfull, mesh=mesh)
        else:
            pcore = abp.for_tables(ct.inner)

            def core_arm():
                return core_count_bytes(ct, ab, prepared=pcore, mesh=mesh)
        pstatic = abp.for_tables(spec)

        def static_arm():
            return spec_count_bytes(spec, ab, prepared=pstatic, mesh=mesh)

        r_s, r_c = static_arm(), core_arm()
        if r_s != r_c:
            raise RuntimeError(
                "tier A/B: the core (%s) and the static tier disagree on "
                "the first %d bytes: %r against %r" % (attr, len(ab), r_c,
                                                       r_s))
        ts, tc = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            static_arm()
            ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            core_arm()
            tc.append(time.perf_counter() - t0)
        s, c = min(ts), min(tc)
        winner = "static" if s * self.TIER_AB_MARGIN < c else "core"
        self.tier_ab = {
            "bytes": len(ab), "static_s": s, "core_s": c,
            "winner": winner, "core_arm": attr,
            "static_gbps": len(ab) / s / 1e9,
            "core_gbps": len(ab) / c / 1e9,
        }
        if winner == "static":
            setattr(self, attr, False)

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
        the stats and makes the serving tier's post-scan note; after a
        core tier served, runs an "ab"-band machine's pending A/B
        (_maybe_tier_ab)."""
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
                prepared_full=prep(spec, ck), mesh=self.mesh)
            if r is None:
                self._fusedct = False     # the shapes disqualify it
            else:
                self._fused_note(fct)
                self._note_stats(api, fct, len(data), t0)
                self._maybe_tier_ab(data)
                return fct, r
        ct = self._core_tables(data)
        if ct is not None:
            r = core_fn(ct, data, prepared=prep(ct.inner), mesh=self.mesh)
            self._core_note(ct)
            self._note_stats(api, ct, len(data), t0)
            self._maybe_tier_ab(data)
            return ct, r
        if self._phi_active:
            pt = self._phi
            r = phi_fn(pt, data, prepared=prep(pt))
            self._note_stats(api, pt, len(data), t0)
            return pt, r
        spec = self._spec
        if spec is None:
            return None, None
        r = spec_fn(spec, data, prepared=prep(spec), mesh=self.mesh)
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

    def _tdfa_core_tables(self, data):
        """The hot-core tagged tables (ops/tdfa_scan.TdfaCoreTables) of a
        tagged machine past the dense budget, sampled from the corpus
        (_core_sample) and cached (False = declined: TdfaTooLarge, a
        DfaTooLarge, or ValueError; any other failure raises).  Exactness
        never depends on the sample: ESC escapes re-walk on the host TDFA
        in the chunk-repair fold."""
        if self._tdfa_coret is None:
            self._tdfa_coret = False
            if self.device is not None:
                try:
                    self._tdfa_coret = TdfaCoreTables(
                        self.program, self._core_sample(data), self.device)
                except (DfaTooLarge, ValueError):
                    self._tdfa_coret = False
        return self._tdfa_coret or None

    def _tdfa_find(self, data, prepared=None, tables=None):
        """Device tagged-DFA find over ``tables`` (the dense _tdfa_spec
        unless given, e.g. the hot core): one kernel pass yields the span,
        regex id and tracked capture slots (ops/tdfa_scan.py).

        Returns (rid, ovector) for a certified match, (-1, None) for a
        certified no-match, or None when the device result cannot be
        certified exact (the caller then runs the multi-pass path)."""
        if tables is None:
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
        where it can certify its result: over the dense tables, or, for
        a tagged machine past their budget, over the hot core sampled
        from the corpus (TdfaCoreTables).  Otherwise the exact multi-pass
        path: the forward DFA proves a match exists, a REVERSE automaton
        scan of the reversed corpus locates the winner's start (the
        leftmost-first winner starts at the minimal start of any
        completed match), and the Pike engine resolves exact captures
        from there with the proper seen_word/seen_newline carry.  On a
        device corpus the reverse scan runs on the reverse machine's
        legacy core (core_scan_last_bytes) where it has no static tier,
        on its static tier, or, for a reverse machine past the eager
        budget, on the lazy reverse core; else on the host."""
        t0 = time.perf_counter()
        n = len(data)
        on_device = self._on_device(data)
        certified = None
        tagged = self._tdfa_spec
        if tagged is None and on_device:
            tagged = self._tdfa_core_tables(data)
        if tagged is not None and on_device:
            r = self._tdfa_find(data, prepared, tables=tagged)
            if r is not None:
                self._note_stats("find", tagged, n, t0, certified=True)
                rc, ov = r
                return (rc, ov) if rc >= 0 else None
            certified = False
        # DFA prefilter: no match end anywhere => no match at all
        first, state, tier = self._scan_first(data, prepared)
        result = None
        if first >= 0 or self._eof_id(state) >= 0:
            start = 0
            rev = self._rev_dfa() if self.dfa is not None \
                else self._rev_lazy_dfa()
            if rev is not None:
                rdata = data[::-1]
                r = None
                if on_device:
                    rct = (self._rev_core_tables(data)
                           if self.dfa is not None
                           else self._rev_lazy_core(data))
                    if rct is not None:
                        r = core_scan_last_bytes(rct, rdata)
                        if self.dfa is not None:
                            self._core_note(rct, "_rev_coret")
                    elif self._rev_spec is not None:
                        r = spec_scan_last_bytes(self._rev_spec, rdata)
                if r is None:
                    q, rstate = rev.scan_last(rdata, 0)
                else:
                    rstate, q = r
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

    # -----------------------------------------------------------------
    # document sets: one kernel pass over many documents (ops/batch.py)
    # -----------------------------------------------------------------

    def _batch_on_device(self, docs):
        """Whether a document set goes to the device: the whole set, not
        each document, must reach DEVICE_THRESHOLD (batching exists so
        that documents below it share a launch).  The lazy machine has
        no batch path: its set loops over the single-buffer calls."""
        return self.device is not None and self.dfa is not None \
            and sum(len(d) for d in docs) >= self.DEVICE_THRESHOLD

    def _batch_eligible(self, docs):
        """The static tier serves a batched scan when the set goes to the
        device and the machine has one."""
        return self._spec is not None and self._batch_on_device(docs)

    @staticmethod
    def _batch_sample(docs):
        """The core sample of a document set: the heads of its first 256
        documents."""
        return b"".join(bytes(d[:1 << 16]) for d in docs[:256])

    def _batch_core(self, docs):
        """The legacy core tier for a batched scan: the single-buffer
        selector (_core_tables: the band, the Scanner's cache),
        its sample spread over the document set.  None where the core
        stays out (the static batch path or the loop serves), an
        "ab"-band core among them until its A/B keeps it (_ab_kept)."""
        if not self._batch_on_device(docs) or not self._ab_kept("_coret"):
            return None
        if self._coret is not None:
            return self._coret or None      # cached: no sample needed
        return self._core_tables(self._batch_sample(docs))

    def _batch_fused_core(self, docs):
        """The fused tier's core for a batched scan (_fused_core_tables):
        the set's escaped chunks are redone by the full machine's kernel
        inside the one batch dispatch, not walked on the host one each.
        None where the fused tier stays out, an "ab"-band core among them
        until its A/B keeps it (_ab_kept).

        Declined on a mesh Scanner, as in the JAX package: its batches take
        the sharded legacy core or static paths."""
        if not self._batch_on_device(docs) or self.mesh is not None \
                or not self._ab_kept("_fusedct"):
            return None
        if self._fusedct is not None:
            return self._fusedct or None
        return self._fused_core_tables(self._batch_sample(docs))

    def prepare_many(self, docs, chunk_len=DEFAULT_K, for_find=False):
        """Pack and upload a document set once (ops/batch.PreparedBatch)
        for reuse across count_many / scan_many calls over the same
        documents, the batch analogue of prepare().  ``for_find=True``
        packs for the tagged tables instead (find_many's; the packings
        differ where the machines' class maps do).  Under the fused batch
        the handle carries the full machine's prep too (``full``), both
        on one chunk length.  None where the set cannot take the device
        path (the *_many calls then loop)."""
        docs = _as_docs(docs)
        full = None
        if for_find:
            tables = self._tdfa_spec
        else:
            fct = self._batch_fused_core(docs)
            ct = fct or self._batch_core(docs)
            tables = ct.inner if ct is not None else self._spec
            if fct is not None:
                ck = fused_chunk(fct.inner, self._spec, chunk_len)
                if ck is not None:
                    full, chunk_len = self._spec, ck
        if tables is None or not self._batch_on_device(docs):
            return None
        try:
            # find_many's tagged tier takes no mesh
            pb = batch_prepare(tables, docs, chunk_len,
                               None if for_find else self.mesh)
            if full is not None:
                pb.full = batch_prepare(full, docs, chunk_len)
            return pb
        except BatchUnsupported:
            return None

    def _batch_scan(self, api, docs, chunk_len, prepared):
        """One batched count (api "count_many") or first-match scan
        ("scan_many") through the tiers in the JAX order: the fused batch,
        the legacy core, the static tier.  None of them takes a
        post-scan note, and the phi tier is never taken.  A tier without
        a zero-class pad byte (BatchUnsupported) or shapes the fused tier
        cannot take hand the set to the next; a failed launch raises.
        Returns the tier's (results..., nat, C), recording last_repair and
        the stats, or None where no tier served (the caller loops)."""
        t0 = time.perf_counter()
        fused_fn, core_fn, spec_fn = (
            (core_count_many_fused, core_count_many, spec_count_many)
            if api == "count_many" else
            (core_scan_many_fused, core_scan_many, spec_scan_many))

        def served(tier, run):
            try:
                r = run()
            except BatchUnsupported:
                return None
            if r is not None:
                tier.last_repair = r[-2:]
                self._note_stats(api, tier, sum(len(d) for d in docs), t0)
            return r

        fct = self._batch_fused_core(docs)
        if fct is not None:
            r = served(fct, lambda: fused_fn(
                fct, self._spec, docs, chunk_len, prepared_core=prepared,
                prepared_full=getattr(prepared, "full", None)))
            if r is not None:
                return r
        ct = self._batch_core(docs)
        if ct is not None:
            r = served(ct, lambda: core_fn(ct, docs, chunk_len,
                                           prepared=prepared,
                                           mesh=self.mesh))
            if r is not None:
                return r
        if self._batch_eligible(docs):
            return served(self._spec, lambda: spec_fn(
                self._spec, docs, chunk_len, prepared=prepared,
                mesh=self.mesh))
        return None

    def count_many(self, docs, chunk_len=DEFAULT_K, prepared=None):
        """Per-document count() over a document set in one device
        dispatch: every document is packed into one chunk stream
        (document starts enter at the seed through the per-chunk entry
        planes; no kernel change, ops/batch.py) and one kernel pass scans
        them all; each document's chain folds on its own, so the result
        is exactly [self.count(d) for d in docs].  A document shorter
        than one chunk folds natively: a lower chunk_len (quantum 16
        bytes) gives small documents device coverage.  ``prepared``: a
        prepare_many() handle built from the same documents."""
        docs = _as_docs(docs)
        r = self._batch_scan("count_many", docs, chunk_len, prepared)
        if r is None:
            return [self.count(d) for d in docs]
        counts, finals = r[:2]
        return [c + (1 if self._eof_id(s) >= 0 else 0)
                for c, s in zip(counts, finals)]

    def scan_many(self, docs, chunk_len=DEFAULT_K, prepared=None):
        """Per-document scan() in one device dispatch: [self.scan(d) for
        d in docs], each (regex_id, end_boundary) or None."""
        docs = _as_docs(docs)
        r = self._batch_scan("scan_many", docs, chunk_len, prepared)
        if r is None:
            return [self.scan(d) for d in docs]
        out = []
        for (st, b), d in zip(r[0], docs):
            if b >= 0:
                out.append((self._id_at(st, d[b]), b))
            else:
                rid = self._eof_id(st)
                out.append((rid, len(d)) if rid >= 0 else None)
        return out

    def match_many(self, docs, chunk_len=DEFAULT_K, prepared=None):
        """Per-document match() in one device dispatch."""
        return [r is not None
                for r in self.scan_many(docs, chunk_len, prepared)]

    def finditer_many(self, docs, chunk_len=DEFAULT_K, prepared=None):
        """Per-document findall() over a document set: [self.findall(d)
        for d in docs].  One batched scan (scan_many) drops the
        match-free documents exactly (a document whose scan never reaches
        a match boundary, EOF included, has no Pike match anywhere), so
        only the matching documents are resolved on the host: the
        sparse grep-over-many-files shape, where the card reads every
        byte once and the host only the matching documents."""
        docs = _as_docs(docs)
        firsts = self.scan_many(docs, chunk_len, prepared)
        return [[] if f is None else self.findall(d)
                for f, d in zip(firsts, docs)]

    def sub_many(self, repl, docs, count=0, chunk_len=DEFAULT_K,
                 prepared=None):
        """Per-document sub() over a document set: [(new_bytes,
        n_replacements), ...].  Match-free documents, found by one
        batched scan, come back unchanged without host resolution; the
        matching ones take the exact sub loop."""
        docs = _as_docs(docs)
        firsts = self.scan_many(docs, chunk_len, prepared)
        return [(bytes(d), 0) if f is None
                else self.sub(repl, d, count=count)
                for f, d in zip(firsts, docs)]

    def find_many(self, docs, chunk_len=DEFAULT_K, prepared=None):
        """Per-document find() (leftmost-first match with captures) in
        one tagged-kernel launch (ops/tdfa_scan.tdfa_find_many): every
        document's chunk chain folds through the chunk-repair walk, so the
        result is exactly [self.find(d) for d in docs]; a document the
        kernel cannot certify takes its own exact multi-pass find.
        ``prepared``: prepare_many(docs, for_find=True)."""
        docs = _as_docs(docs)
        t0 = time.perf_counter()
        tables = self._tdfa_spec
        if tables is not None and self._batch_on_device(docs):
            try:
                rs = tdfa_find_many(tables, docs, chunk_len,
                                    prepared=prepared)
            except BatchUnsupported:
                rs = None
            if rs is not None:
                out = []
                for r, d in zip(rs, docs):
                    m = None
                    if r is not None and r != "fallback":
                        # None: the windowed Pike resolution could not
                        # certify
                        m = self._tdfa_resolve(tables, r, d)
                    out.append(None if r is None
                               else m if m is not None else self.find(d))
                self._note_stats("find_many", tables,
                                 sum(len(d) for d in docs), t0)
                return out
        return [self.find(d) for d in docs]

    # -----------------------------------------------------------------
    # segmented streams: the pipelined count / scan
    # -----------------------------------------------------------------

    def _stream_tables(self, segments):
        """Tables and segment iterator for the pipelined stream calls.
        Peeks segments until DEVICE_THRESHOLD bytes have come (below it
        the host carry loop wins, as for a whole corpus).  Where the
        band gives the machine the legacy core (_core_tables: no static
        tier, the dense or the lazy machine, or an "ab"-band machine
        whose core an A/B kept: _ab_kept) and the first segment holds
        CORE_SAMPLE bytes, the core is sampled from it and rides the
        pipeline; else the static tier.  Never the fused or the phi
        tier, and no A/B.  A producer may refill its read buffer once
        the next segment is asked for, so each peeked segment but the
        last is snapshotted.  Returns (tables or None, iterator, whether
        the tables are the legacy core)."""
        it = iter(segments)
        peeked = []
        total = 0
        for seg in it:
            total += memoryview(seg).nbytes
            if total >= self.DEVICE_THRESHOLD:
                peeked.append(seg)
                break
            peeked.append(bytes(seg))   # the next pull may refill it
        rest = itertools.chain(peeked, it)
        if total < self.DEVICE_THRESHOLD:
            return None, rest, False
        if memoryview(peeked[0]).nbytes >= self.CORE_SAMPLE \
                and self._ab_kept("_coret"):
            ct = self._core_tables(peeked[0])
            if ct is not None:
                return ct, rest, True
        return self._spec, rest, False

    def _stream_noted(self, api, tables, is_core, t0):
        """After a pipelined scan: the serving tier's post-scan note and
        the stats."""
        if is_core:
            self._core_note(tables)
        else:
            self._spec_note()
        self._note_stats(api, tables, tables.last_fold_bytes, t0)

    def count_stream(self, segments, chunk_len=DEFAULT_K,
                     in_flight=IN_FLIGHT):
        """Pipelined streaming count: ``count(b"".join(segments))``
        without ever joining them.  On the device path each segment's
        upload overlaps the previous segment's kernel (ops/pipeline.py);
        cross-segment exactness rides the speculation-validation chain
        of in-segment chunks.  Segments are bytes-like (a producer may
        refill its buffer once the next segment is asked for).  With
        device=None, or below DEVICE_THRESHOLD, the native (or lazy)
        engine carries the state from segment to segment."""
        t0 = time.perf_counter()
        if self.device is not None:
            tables, segments, is_core = self._stream_tables(segments)
            if tables is not None:
                state, c = pipelined_count(tables, segments,
                                           chunk_len=chunk_len,
                                           in_flight=in_flight,
                                           mesh=self.mesh)
                self._stream_noted("count_stream", tables, is_core, t0)
                return c + (1 if self._eof_id(state) >= 0 else 0)
        eng = self._host()
        state, c, nbytes = 0, 0, 0
        for seg in segments:
            if len(seg) == 0:
                continue
            k, state = eng.count(seg, state)
            c += k
            nbytes += len(seg)
        self._note_stats("count_stream", None, nbytes, t0)
        return c + (1 if self._eof_id(state) >= 0 else 0)

    def match_stream(self, segments, chunk_len=DEFAULT_K,
                     in_flight=IN_FLIGHT):
        """True iff the joined stream holds a match
        (``match(b"".join(segments))``); stops dispatching shortly after
        the first match of an unbounded stream."""
        return self.scan_stream(segments, chunk_len=chunk_len,
                                in_flight=in_flight) is not None

    def scan_stream(self, segments, chunk_len=DEFAULT_K,
                    in_flight=IN_FLIGHT):
        """Pipelined streaming earliest-match scan:
        ``scan(b"".join(segments))``, (regex_id, end_boundary) or None;
        an end equal to the stream's length is a match ending at EOF.
        Segments dispatched past the match are dropped unfolded, so an
        unbounded stream ends shortly after its first match."""
        t0 = time.perf_counter()
        if self.device is not None:
            tables, segments, is_core = self._stream_tables(segments)
            if tables is not None:
                state, first, byte, nbytes = pipelined_scan(
                    tables, segments, chunk_len=chunk_len,
                    in_flight=in_flight, mesh=self.mesh)
                # a scan-only workload on a drifted corpus must still
                # reach the re-core / warmup logic
                self._stream_noted("scan_stream", tables, is_core, t0)
                if first >= 0:
                    return self._id_at(state, byte), first
                rid = self._eof_id(state)
                return (rid, nbytes) if rid >= 0 else None
        eng = self._host()
        state, base = 0, 0
        for seg in segments:
            if len(seg) == 0:
                continue
            f, st = eng.scan_first(seg, state)
            if f >= 0:
                self._note_stats("scan_stream", None, base + f, t0)
                return self._id_at(st, seg[f]), base + f
            state = st
            base += len(seg)
        self._note_stats("scan_stream", None, base, t0)
        rid = self._eof_id(state)
        return (rid, base) if rid >= 0 else None

    # -----------------------------------------------------------------
    # finditer and the substitution loop
    # -----------------------------------------------------------------

    def _tdfa_walker(self):
        """The native TDFA walker (native_tdfa.NativeTdfa) or None:
        built at first use; declined (False) when the tagged automaton
        exceeds the host budgets (TdfaTooLarge), when
        SREGEX_FINDITER=pike asks for the Pike loop, or where the
        walker's library does not build (no g++), as the native Pike
        engine declines."""
        if self._walker is None:
            self._walker = False
            if os.environ.get("SREGEX_FINDITER") != "pike" \
                    and NativeTdfa.available():
                try:
                    self._walker = NativeTdfa(self.program)
                except TdfaTooLarge:
                    self._walker = False
        return self._walker or None

    def _rev_core_tables(self, data):
        """The legacy core of the REVERSE machine (the finditer start
        locator; _new_core over its static tier, under _core_requirement:
        the band's A/B is the forward machine's), sampled from the
        forward corpus and reversed.  Cached (False = declined)."""
        if self._rev_coret is None:
            rev = self._rev_dfa()
            self._rev_coret = rev is not None and self._new_core(
                rev.dfa, None, self._core_sample(data)[::-1],
                _core_requirement(self._rev_spec))
        return self._rev_coret or None

    def _rev_fused_core_tables(self, data):
        """The fused tier's core of the REVERSE machine (_new_fused_core
        over its static tier): the start locator's chunk map redoes its
        escapes on the device (core_chunk_map_fused).  Cached (False =
        declined)."""
        if self._rev_fusedct is None:
            rev = self._rev_dfa()
            self._rev_fusedct = rev is not None and self._new_fused_core(
                rev.dfa, self._core_sample(data)[::-1],
                _fused_eligible(self._rev_spec))
        return self._rev_fusedct or None

    def _rev_lazy_core(self, data):
        """LazyCoreTables over the lazy REVERSE machine (_new_core, no
        static tier): the start locator of a pattern whose reverse
        machine is past the eager budget.  Cached (False = declined)."""
        if self._rev_lz_coret is None:
            rl = self._rev_lazy_dfa()
            self._rev_lz_coret = rl is not None and self._new_core(
                None, rl, self._core_sample(data)[::-1],
                _core_requirement(None))
        return self._rev_lz_coret or None

    def make_index(self, data):
        """The reusable corpus index of finditer: one COUNT pass of the
        REVERSE machine over the reversed corpus, mapping every chunk
        that holds a completed-match START (_StartLocator).  Build it
        once and pass it to finditer / sub / split (``index=``) to
        iterate the same corpus more than once.  Returns None when no
        device tables exist for the reverse machine (device=None among
        them); a failed build or launch raises."""
        rev = self._rev_dfa()
        if rev is not None:
            fct = self._rev_fused_core_tables(data)
            if fct is not None:
                return _StartLocator(rev, fct, data,
                                     full_tables=self._rev_spec)
            tables = self._rev_core_tables(data) or self._rev_spec
            if tables is None:
                return None
            return _StartLocator(rev, tables, data)
        # reverse machine past the eager budget: the lazy reverse machine
        # through its lazy core
        if self.device is None:
            return None
        ct = self._rev_lazy_core(data)
        if ct is None:
            return None
        return _StartLocator(self._rev_lazy_dfa(), ct, data)

    def finditer(self, data, index=None):
        """Iterate successive matches (regex_id, ovector) (the
        substitution-loop protocol: after each final match the engine
        re-arms and continues from the match end,
        sre_vm_pike.c:624-635).

        On a device corpus, or with an explicit ``index``, the reverse
        fire map (make_index) locates every completed-match START;
        between matches the Pike ctx teleports across start-free gaps
        instead of thread-simulating them.  The teleport is exact: no
        completed match starts in the gap, so no thread alive at the
        teleport point can ever reach MATCH, and a fresh ctx with the
        boundary carry is indistinguishable.  Resolution stays
        byte-exact Pike, fed in geometrically growing windows.  Without
        an index the native TDFA walker emits every match from its
        registers, else the Pike loop walks the corpus."""
        n = len(data)
        starts = index
        if starts is None and self._on_device(data):
            starts = self.make_index(data)
        if starts is None:
            walker = self._tdfa_walker()
            if walker is not None:
                yield from walker.iter_ovectors(data)
                return
        ctx = self._pike_ctx()
        pos = 0
        while True:
            if starts is not None and pos < n:
                s_star = starts.next_start(pos)
                if s_star is None:
                    return
                if s_star > pos:
                    # teleport across the start-free gap
                    ctx = self._pike_ctx()
                    prev = data[s_star - 1]
                    ctx.set_carry(s_star, prev == 10, sre_isword(prev))
                    pos = s_star
            if starts is not None:
                rc = self._pike_stream(ctx, data, pos)
            else:
                rc, _ = ctx.exec(data[pos:], True)
            if rc < 0:
                return
            ov = [int(v) for v in ctx.ovector]
            yield rc, ov
            # the ctx re-armed at the match end (absolute offset)
            if ov[1] >= len(data) and ov[0] == ov[1]:
                return
            pos = ov[1]

    def findall(self, data, index=None):
        """All matches as a list of (regex_id, ovector): finditer,
        collected."""
        return list(self.finditer(data, index=index))

    def sub(self, repl, data, count=0, index=None):
        """Replace matches (the streaming substitution loop of
        ngx_replace_filter over the Pike re-arm, sre_vm_pike.c:624-635).
        Returns (new_bytes, n_replacements).

        repl: bytes template (``$0``..``$9`` / ``${nn}`` substitute
        capture groups of the matched regex, $0 the whole match, unset
        groups empty; ``$$`` a literal dollar) or a callable
        (regex_id, ovector, data) -> bytes.  count limits replacements
        (0 = all).  Rides finditer, so large corpora take the device
        index (pass a prebuilt ``index`` to reuse it)."""
        out = []
        pos = 0
        done = 0
        for rid, ov in self.finditer(data, index=index):
            if count and done >= count:
                break
            out.append(data[pos:ov[0]])
            if callable(repl):
                out.append(repl(rid, ov, data))
            else:
                out.append(_expand_template(repl, ov, data))
            pos = ov[1]
            done += 1
        out.append(data[pos:])
        return b"".join(out), done

    def editor(self, repl, count=0):
        """Streaming substitution: a StreamEditor over this pattern set
        (chunk-in / chunk-out replace filter)."""
        return StreamEditor(self, repl, count=count)

    def split(self, data, maxsplit=0, index=None):
        """Split ``data`` around matches (re.split without group
        interpolation): the list of between-match segments.  maxsplit
        limits splits (0 = all).  Rides finditer."""
        out = []
        pos = 0
        done = 0
        for _rid, ov in self.finditer(data, index=index):
            if maxsplit and done >= maxsplit:
                break
            out.append(data[pos:ov[0]])
            pos = ov[1]
            done += 1
        out.append(data[pos:])
        return out

    def _events_engine(self, chunk_len, map_window):
        """The fire-map events engine over this pattern set (None without
        a dense DFA: the Pike re-arm loop serves)."""
        if self.dfa is None:
            return None
        return StreamEvents(self, chunk_len=chunk_len,
                            map_window=map_window)

    def finditer_stream(self, segments, chunk_len=DEFAULT_K,
                        map_window=8 << 20):
        """finditer over a segmented (or unbounded) stream: yields
        (regex_id, ovector) with ABSOLUTE stream offsets, identical to
        finditer(b"".join(segments)) for every segmentation, in
        O(map_window + teleport lookback) memory.

        The events engine (events.py): a forward per-chunk fire map
        (spec_chunk_map on the static tier for windows of at least
        DEVICE_THRESHOLD bytes, the native engine below) locates every
        chunk that can hold a match end; the Pike VM runs only around
        those fires and teleports across fire-free gaps: bounded
        patterns seed max_match_len before a fire, unbounded ones at
        sterile chunk boundaries (dfa.sterile).  Patterns past the eager
        DFA budget stream through the Pike re-arm loop directly."""
        eng = self._events_engine(chunk_len, map_window)
        if eng is None:
            yield from self._finditer_stream_pike(segments)
            return
        for seg in segments:
            yield from eng.push(seg)
        yield from eng.push(b"", eof=True)

    def _finditer_stream_pike(self, segments):
        """The lazy machine's stream: the bare streaming re-arm loop
        (the Pike ctx as a stream consumer).  Memory is the
        pending-match bound, as StreamEditor's."""
        ctx = self._pike_ctx()
        held = bytearray()
        hb = 0          # absolute offset of held[0] == ctx feed point
        total = 0
        segs = iter(segments)
        eof = False
        piece = b""
        while True:
            if not piece and not eof:
                nxt = next(segs, None)
                if nxt is None:
                    eof = True
                    piece = b""
                else:
                    piece = bytes(nxt)
                    held += piece
                    total += len(piece)
            rc, pending = ctx.exec(piece, eof, want_pending=True)
            piece = b""
            if rc >= 0:
                ov = [int(v) for v in ctx.ovector]
                yield rc, ov
                if ov[1] >= total and ov[0] == ov[1] and eof:
                    return
                del held[:ov[1] - hb]
                hb = ov[1]
                piece = bytes(held)
                if not piece and eof:
                    # drain the re-armed engine at eof
                    continue
            elif rc == SRE_AGAIN:
                if eof:
                    return
                # release bytes no future re-feed can need: re-feeds
                # start at match ends >= any pending/candidate start
                bound = total
                t0 = int(ctx.ovector[0])
                if t0 >= 0:
                    bound = min(bound, t0)
                if pending is not None:
                    bound = min(bound, int(pending[0]))
                if bound > hb:
                    del held[:bound - hb]
                    hb = bound
            else:
                return

    def sub_stream(self, repl, segments, count=0, chunk_len=DEFAULT_K,
                   map_window=8 << 20):
        """Streaming replace over a segmented stream: yields output
        pieces whose concatenation equals sub(repl, b"".join(segments))
        for every segmentation (the reference's replace filter over the
        fire-map events engine of finditer_stream).  repl: a template or
        a callable (regex_id, ovector, window) -> bytes, ovector relative
        to ``window``, as StreamEditor's; count limits replacements (0 =
        all), after which the stream passes through verbatim."""
        eng = self._events_engine(chunk_len, map_window)
        if eng is None:
            ed = StreamEditor(self, repl, count=count)
            for seg in segments:
                out = ed.feed(seg)
                if out:
                    yield out
            if not ed.finished:
                out = ed.feed(b"", eof=True)
                if out:
                    yield out
            return
        emitted = 0
        done = 0
        passthrough = False
        eng.keep_from = 0

        def render(events, eof):
            nonlocal emitted, done, passthrough
            out = []
            for rid, ov in events:
                if passthrough:
                    continue
                out.append(eng.read(emitted, ov[0]))
                window = eng.read(ov[0], ov[1])
                rel = [v - ov[0] if v >= 0 else -1 for v in ov]
                if callable(repl):
                    out.append(repl(rid, rel, window))
                else:
                    out.append(_expand_template(repl, rel, window))
                emitted = ov[1]
                done += 1
                if count and done >= count:
                    passthrough = True
            bound = eng.total if (eof or passthrough) else eng.final
            if bound > emitted:
                out.append(eng.read(emitted, bound))
                emitted = bound
            eng.keep_from = emitted
            return b"".join(out)

        for seg in segments:
            out = render(eng.push(seg), False)
            if out:
                yield out
        out = render(eng.push(b"", eof=True), True)
        if out:
            yield out

    @staticmethod
    def _pike_stream(ctx, data, pos, first=1 << 16):
        """Drive the Pike ctx with geometrically growing chunks from
        ``pos`` until it resolves: the work per match is O(match
        region), not O(corpus tail)."""
        n = len(data)
        win = first
        while True:
            hi = min(pos + win, n)
            rc, _ = ctx.exec(data[pos:hi], hi >= n)
            if rc != SRE_AGAIN:
                return rc
            pos = hi
            win *= 4


def _expand_template(repl, ov, data):
    """Expand $0..$9 / ${nn} / $$ in a replacement template against
    one match's ovector (the ngx_replace_filter template dialect)."""
    out = []
    i = 0
    n = len(repl)
    while i < n:
        c = repl[i:i + 1]
        if c != b"$" or i + 1 >= n:
            out.append(c)
            i += 1
            continue
        nxt = repl[i + 1:i + 2]
        if nxt == b"$":
            out.append(b"$")
            i += 2
        elif nxt == b"{":
            j = repl.find(b"}", i + 2)
            if j < 0 or not repl[i + 2:j].isdigit():
                out.append(c)
                i += 1
                continue
            out.append(_group(ov, int(repl[i + 2:j]), data))
            i = j + 1
        elif nxt.isdigit():
            out.append(_group(ov, int(nxt), data))
            i += 2
        else:
            out.append(c)
            i += 1
    return b"".join(out)


def _group(ov, g, data):
    lo = 2 * g
    if lo + 1 >= len(ov) or ov[lo] < 0:
        return b""
    return data[ov[lo]:ov[lo + 1]]


class StreamEditor:
    """Streaming substitution over an unbounded chunked stream (the
    reference's production use case: ngx_replace_filter over the Pike
    re-arm loop, sre_vm_pike.c:624-635; buffering contract from the
    pending/temp-capture outputs, sre_vm_pike.c:640-658, 692-735).

    feed(chunk, eof=False) -> bytes: consume one input chunk, return
    the next piece of edited output.  Output is emitted as early as
    provably final: after every chunk the engine's temp captures (the
    conservative $0 span over live threads) and the pending-match span
    bound the bytes that could still belong to a match; everything
    before that bound is flushed verbatim.  Memory is O(longest
    potential match), independent of stream length.

    repl: bytes template ($0..$9 / ${nn} / $$, as Scanner.sub) or a
    callable (regex_id, ovector, window) -> bytes where ``ovector``
    indexes into ``window`` (the held byte window holding the match).
    count limits replacements (0 = all); once reached the rest of the
    stream passes through verbatim.

    The concatenated output equals Scanner.sub(repl, whole_stream) for
    every chunking."""

    def __init__(self, scanner, repl, count=0):
        self.scanner = scanner
        self.repl = repl
        self.count = count
        self.n_replacements = 0
        self._ctx = scanner._pike_ctx()
        self._held = bytearray()   # input bytes [held_base, total)
        self._held_base = 0        # == absolute bytes emitted so far
        self._total = 0            # absolute bytes received
        self._passthrough = False  # count reached: verbatim tail
        self._finished = False

    @property
    def finished(self):
        return self._finished

    def feed(self, chunk, eof=False):
        """Feed one chunk (b"" allowed); eof=True on the last call.
        Returns the output bytes that became final.  Feeding after eof
        is misuse and raises (the reference's SRE_ERROR contract,
        sre_vm_pike.c:165-168)."""
        if self._finished:
            raise RuntimeError("stream already finished")
        chunk = bytes(chunk or b"")
        self._total += len(chunk)
        if self._passthrough:
            if eof:
                self._finished = True
            self._held_base = self._total
            return chunk
        self._held += chunk
        out = []
        piece = chunk
        while True:
            rc, pending = self._ctx.exec(piece, eof, want_pending=True)
            if rc >= 0:
                ov = [int(v) for v in self._ctx.ovector]
                a, b = ov[0], ov[1]
                # every final match starts at/after the flush bound
                assert a >= self._held_base, (a, self._held_base)
                out.append(bytes(self._held[:a - self._held_base]))
                window = bytes(self._held)
                rel = [v - self._held_base if v >= 0 else -1
                       for v in ov]
                if callable(self.repl):
                    out.append(self.repl(rc, rel, window))
                else:
                    out.append(_expand_template(self.repl, rel, window))
                del self._held[:b - self._held_base]
                self._held_base = b
                self.n_replacements += 1
                if self.count and self.n_replacements >= self.count:
                    out.append(bytes(self._held))
                    self._held.clear()
                    self._held_base = self._total
                    self._passthrough = True
                    if eof:
                        self._finished = True
                    return b"".join(out)
                # the engine re-armed at b: re-feed the already-received
                # tail (the reference caller's re-feed loop)
                piece = bytes(self._held)
                if not piece and not eof:
                    break
            elif rc == SRE_AGAIN:
                bound = self._total
                t0 = int(self._ctx.ovector[0])
                if t0 >= 0:
                    bound = min(bound, t0)
                if pending is not None:
                    bound = min(bound, int(pending[0]))
                if bound > self._held_base:
                    out.append(bytes(
                        self._held[:bound - self._held_base]))
                    del self._held[:bound - self._held_base]
                    self._held_base = bound
                break
            elif rc == SRE_DECLINED:
                out.append(bytes(self._held))
                self._held.clear()
                self._held_base = self._total
                self._finished = True
                break
            else:
                self._finished = True
                raise RuntimeError("pike engine error (SRE_ERROR)")
        if eof:
            self._finished = True
        return b"".join(out)


class _StartLocator:
    """Locates the next completed-match START at or after a position,
    from one COUNT pass of the REVERSE machine over the reversed corpus
    (spec_chunk_map on its static tier, core_chunk_map on its legacy or
    lazy core, core_chunk_map_fused on its fused tier).

    Reverse boundary q fires  <=>  some match starts at n - q
    (reverse.py; the relation find() uses).  next_start finds the
    chunks with a non-zero fire count at or below the boundary n - pos
    by array search, last first, and pins the position with one native
    chunk scan.

    The fold and the position pins read a reversed view of the forward
    bytes (no host copy).  A device corpus (prepare_auto's rule:
    DEVICE_PREP_MIN bytes, or SREGEX_DEVICE_PREP=1) is reversed on the
    device: the forward bytes are uploaded once and flipped there, and
    the prep packs the same words as the host prep of the reversed
    bytes; a host corpus is reversed into one contiguous copy for the
    host prep.  ``route`` says which, ``timing`` the host-clock seconds
    of the reversal, the prep and the map (launch, readback, fold),
    ``tables`` the reverse machine's tables that served the map and
    ``repaired`` their last_repair after it."""

    CHUNK = DEFAULT_K

    def __init__(self, rev_native, rev_tables, data, full_tables=None):
        t0 = time.perf_counter()
        fwd = _host_bytes(data)
        self.n = n = len(fwd)
        self.rdata = fwd[::-1]
        self.rev = rev_native
        self.tables = rev_tables
        knob = os.environ.get("SREGEX_DEVICE_PREP")
        on_dev = n >= DEVICE_PREP_MIN if knob is None else knob == "1"
        if on_dev:
            self.route = "device flip"
            src = torch.flip(_host_u8(fwd).to(rev_tables.device), [0])
        else:
            self.route = "host copy"
            src = np.ascontiguousarray(self.rdata)
        self.timing = {"reverse_s": time.perf_counter() - t0,
                       "prep_s": 0.0}

        def prep(tables, ck):
            t = time.perf_counter()
            p = (prepare_on_device if on_dev else prepare_auto)(
                tables, src, ck)
            self.timing["prep_s"] += time.perf_counter() - t
            return p

        r = None
        if full_tables is not None and isinstance(rev_tables, CoreTables):
            # fused two-phase chunk map: escaped chunks redone by the
            # full reverse machine's kernel on the device
            ck = fused_chunk(rev_tables.inner, full_tables, self.CHUNK)
            if ck is not None:
                preps = prep(rev_tables.inner, ck), prep(full_tables, ck)
                t = time.perf_counter()
                r = core_chunk_map_fused(rev_tables, full_tables,
                                         self.rdata, ck,
                                         prepared_core=preps[0],
                                         prepared_full=preps[1])
                self.timing["map_s"] = time.perf_counter() - t
                del preps
            if r is not None:
                self.CHUNK = ck
            # else the shapes disqualified it: the legacy chunk map
        if r is None:
            if isinstance(rev_tables, CoreTables):
                # the locator's position math agrees with the prep's K
                self.CHUNK = effective_chunk(rev_tables.inner, self.CHUNK)
                fn, p = core_chunk_map, prep(rev_tables.inner, self.CHUNK)
            else:
                self.CHUNK = effective_chunk(rev_tables, self.CHUNK)
                fn, p = spec_chunk_map, prep(rev_tables, self.CHUNK)
            t = time.perf_counter()
            r = fn(rev_tables, self.rdata, self.CHUNK, prepared=p)
            self.timing["map_s"] = time.perf_counter() - t
            del p
        del src
        self.entries, self.counts, final = r
        self.repaired = rev_tables.last_repair
        me = rev_native.match_eof
        self.start0 = bool(me(final)) if callable(me) else bool(me[final])
        self.C = len(self.counts)
        self._fires = np.flatnonzero(self.counts)

    def next_start(self, pos):
        """Smallest s >= pos such that a completed match starts at s,
        else None."""
        n, K = self.n, self.CHUNK
        if pos <= 0 and self.start0:
            return 0
        Q = n - max(pos, 1)          # max reverse boundary of interest
        if Q < 0:
            return None
        c = min(Q // K, self.C - 1)
        # the firing chunks at or below c, last first
        i = int(np.searchsorted(self._fires, c, side="right")) - 1
        while i >= 0:
            c = int(self._fires[i])
            lo = c * K
            hi_b = min(K - 1, Q - lo)
            q_local, _ = self.rev.scan_last(
                self.rdata[lo:lo + hi_b + 1].tobytes(),
                int(self.entries[c]))
            if q_local >= 0:
                return n - (lo + q_local)
            i -= 1
        return None


def compile_pattern(pattern, flags=0, device="cuda", mesh=None):
    """Pattern (str/bytes) or list of patterns -> Scanner on ``device``
    (the card by default; "cpu" for the plain versions, None for the
    host engines alone); ``mesh`` shards its device scans over the
    mesh's devices (Scanner)."""
    if isinstance(pattern, (list, tuple)):
        ast, _ = parse_multi(list(pattern),
                             [flags] * len(pattern)
                             if isinstance(flags, int) else flags)
    else:
        ast, _ = parse(pattern, flags)
    return Scanner(compile_regex(ast), device=device, ast=ast, mesh=mesh)
