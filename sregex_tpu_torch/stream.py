"""Whole-corpus scanning API over the device tiers.

Counterpart of the main-path subset of sregex_tpu/stream.py:
Scanner.match/count/scan/prepare/stats and PreparedCorpus.  The
device path is ``Scanner(prog, device="cuda")``; ``device=None`` serves
every call from the native host engine (the JAX package's
use_device=False) and ``device="cpu"`` runs the device path's plain
torch versions on the CPU.

The tier chain is pair (narrow) -> narrow -> wide.  A machine that none
of them accepts raises NotImplementedError when a device is asked for;
the JAX package would serve it with tiers that are not ported yet.
Unlike the JAX package, no device failure is swallowed: a failed build
or launch raises.
"""

import functools
import os
import time

from sregex_tpu.compiler import compile_regex
from sregex_tpu.dfa import DfaTooLarge, build_dfa
from sregex_tpu.diag import ScanStats
from sregex_tpu.native import NativeDfa
from sregex_tpu.parser import parse, parse_multi

from .ops.layout import DEFAULT_K
from .ops.pair import SpecTablesPair
from .ops.prep import DEVICE_PREP_MIN, _host_u8, prepare_auto
from .ops.spec_scan import (SpecTables, SpecTablesWide, resolve_device,
                            spec_count_bytes, spec_scan_bytes)

_NOT_PORTED = (
    "the JAX package serves it with the big, affine or adaptive core "
    "tiers (or the phi tier), which are not ported yet (ROADMAP.md, "
    "Queue 1 items 5, 6, 9 and 13); use device=None for the host engines")


def _build_spec_tables(dfa, device):
    """The ported tier chain, fastest first: narrow pair-step, narrow,
    wide.  Raises NotImplementedError when none accepts the machine."""
    chain = []
    if os.environ.get("SREGEX_PAIR") != "0":
        chain.append(functools.partial(SpecTablesPair, narrow_only=True))
    chain += [SpecTables, SpecTablesWide]
    for cls in chain:
        try:
            return cls(dfa, device)
        except ValueError:
            continue
    raise NotImplementedError(
        "no ported device tier accepts this automaton (S*ncls = %d > %d "
        "entries): %s" % (dfa.nstates * dfa.nclasses,
                          SpecTablesWide.MAX_ENTRIES, _NOT_PORTED))


class PreparedCorpus:
    """Device-resident packed corpus, reusable across scans: prepare
    once, then every match/count/scan over it skips the pre-pass.
    Obtained from Scanner.prepare(data); passed back via ``prepared=``.
    Layouts differ per tier, so entries are cached per tables object."""

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
        key = id(tables)
        p = self._by_tables.get(key)
        if p is None:
            knob = os.environ.get("SREGEX_DEVICE_PREP")
            use_dev = (len(self.data) >= DEVICE_PREP_MIN if knob is None
                       else knob == "1")
            src = self._raw() if use_dev else self.data
            p = prepare_auto(tables, src, self.chunk_len)
            self._by_tables[key] = p
        return p


class Scanner:
    """Whole-corpus API over a compiled pattern set.

    match(data)  -> bool (any match)
    count(data)  -> number of boundaries where a match ends (EOF too)
    scan(data)   -> (regex_id, end_boundary) of the earliest match end,
                    or None

    Corpora of at least DEVICE_THRESHOLD bytes go to the device tier
    when a device was given; smaller ones to the native engine."""

    DEVICE_THRESHOLD = 4 << 20   # below this the host engine wins

    def __init__(self, prog, device=None, ast=None):
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
        self.last_stats = None

    def prepare(self, data, chunk_len=DEFAULT_K):
        """Pack ``data`` once for device scanning; pass the handle back
        via ``prepared=`` on match/count/scan."""
        return PreparedCorpus(data, self.device, chunk_len)

    def _on_device(self, data):
        return self._spec is not None \
            and len(data) >= self.DEVICE_THRESHOLD

    def _note_stats(self, api, tier, nbytes, t0):
        """Record one completed scan: the tables that served it (None =
        the native engine) with its chunk and repair counts."""
        rep = tier.last_repair if tier is not None else None
        nat, chunks = rep if rep is not None else (0, 0)
        name = type(tier).__name__ if tier is not None else "native"
        self.last_stats = ScanStats(
            api, name, nbytes, chunks=chunks, repaired=nat,
            elapsed_ms=(time.perf_counter() - t0) * 1e3)

    def stats(self):
        """The last completed match/count/scan call's ScanStats (tier,
        chunks, natively repaired chunks, wall ms), or None."""
        return self.last_stats

    def _scan_first(self, data, prepared):
        t0 = time.perf_counter()
        if self._on_device(data):
            spec = self._spec
            state, first = spec_scan_bytes(
                spec, data, prepared=prepared.for_tables(spec)
                if prepared else None)
            self._note_stats("scan", spec, len(data), t0)
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

    def count(self, data, prepared=None):
        """Number of match-ending boundaries (including EOF)."""
        t0 = time.perf_counter()
        if self._on_device(data):
            spec = self._spec
            state, c = spec_count_bytes(
                spec, data, prepared=prepared.for_tables(spec)
                if prepared else None)
            self._note_stats("count", spec, len(data), t0)
        else:
            c, state = self._native.count(data, 0)
            self._note_stats("count", None, len(data), t0)
        if self.dfa.match_eof[state]:
            c += 1
        return c


def compile_pattern(pattern, flags=0, device=None):
    """Pattern (str/bytes) or list of patterns -> Scanner.  ``device``
    enables the device tiers for large corpora."""
    if isinstance(pattern, (list, tuple)):
        ast, _ = parse_multi(list(pattern),
                             [flags] * len(pattern)
                             if isinstance(flags, int) else flags)
    else:
        ast, _ = parse(pattern, flags)
    return Scanner(compile_regex(ast), device=device, ast=ast)
