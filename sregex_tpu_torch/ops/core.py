"""Adaptive hot-core tiers: big automata at the small tables' speed.

Counterpart of the JAX package's ops/pallas_core.py (the count,
first-match, last-match, chunk-map and batch parts, over the dense or
the lazy machine, on one device or sharded over a device mesh,
ops/mesh.py).

A DFA scan over real data visits a small, skewed subset of its states.
The core tiers sample the corpus, count the visits per state with the
native engine (NativeDfa.visits) and build a CORE machine over the hot
states plus one sticky ESC state (dfa.build_core_dfa): transitions
that leave the hot set go to ESC, which only loops and always carries
the match bit.  The core runs on the ordinary pair/narrow/wide tiers.
A chunk whose exit is not ESC ran inside the core all along, so its
exit and counts are the full machine's; a chunk that exits in ESC
fails the summary's ESC check.  Exactness never depends on the sample.
LazyCoreTables builds the same core over a LazyDfa, for patterns past
the eager DFA budget (no dense machine exists): only the hot states
are materialised, and escapes re-scan on the lazy machine's walkers.

Two tiers repair the escaped chunks differently:

  - legacy (core_count_bytes, core_scan_bytes, core_scan_last_bytes):
    the host re-scans each failed chunk with the native engine on the
    full machine (_Fold);
  - fused two-phase (core_count_fused, core_scan_fused): phase 1 scans
    the corpus on the core; the escaped chunks are compacted on the
    device into a prefix of FUSED_CAP chunk slots (a slot -> chunk
    map), and phase 2 redoes them with the full machine (gated_scan:
    it reads each slot's window in place in the full machine's prep
    through the map, and block rows past the escapes are skipped,
    decided on the device).  The planes merge in full premultiplied
    state space and one 11-int summary comes back; the host repairs
    only past the device cap ("overflow") or where the merged chain
    still broke ("miss").

Everything here is torch ops on the tables' device and one stream; the
first host sync of a fused scan is its summary readback.  On the card
gated_scan launches csrc/gated_scan.cu; on the CPU it takes
gated_scan_ref, which gathers the windows (_gather_windows) first.

On a mesh the legacy tier's scan shards as the static tiers' does, and
the fused tier runs both phases, the compaction and the merge per shard
over its own blocks (_fused_count_mesh, the JAX package's
_fused_count_mesh): chunk slots are in order within a shard, so phase 2
never reads another shard's prep, and the cap is per shard.  The merged
chain is stitched by one copy of each shard's last merged exit to the
next shard's device; each shard reports an 11-int partial summary, and
_combine_fused_summaries folds them on the host into the single-device
summary, so the folds downstream are mesh-agnostic.
"""

import functools
import os

import numpy as np
import torch

from .. import diag
from ..dfa import build_core_dfa, core_from_rows
from ..native import NativeDfa
from .big import MAX_ENTRIES as BIG_MAX_ENTRIES
from .big import SpecTablesBig, check_t16
from .layout import DEFAULT_K, GROUPS, SMEM_TABLE_MAX, TILE, effective_chunk
from .mesh import fits, replica, shard_blocks, shard_rows
from .pair import SpecTablesPair
from .prep import prepare_auto
from .spec_scan import (SpecTables, SpecTablesWide, _chain_ends, _chain_map,
                        _check_scan_args, _entry_planes, _host_bytes,
                        _unpack, launch_planes, resolve_device, spec_scan,
                        spec_scan_ref)

# sampled visit mass allowed OUTSIDE a legacy core (per byte): an escape
# costs one native chunk re-scan on the host, so the budget is tight
MAX_ESCAPE_FRAC = 1e-5

# candidate hot-set sizes tried (descending): the largest fast-tier
# (pair/narrow) fit wins, else the largest (or, prefer_small, the
# smallest) wide fit
_CANDIDATE_MS = (4096, 2048, 1024, 512, 256, 128, 96, 64, 48, 32, 24,
                 16, 12, 8, 6, 4, 3, 2, 1)

# most escaped chunks the fused tier's device redo absorbs per scan,
# rounded up at dispatch to whole phase-2 blocks (GROUPS*1024 slots);
# more take the host fold ("overflow").  Read as the JAX package reads it.
FUSED_CAP = int(os.environ.get("SREGEX_FUSED_CAP", str(32768)))

# sampled visit mass allowed outside a FUSED core: its escapes cost a
# device redo, not a host walk, so the budget is far looser and the
# candidate search may drop rare states for a much smaller core
FUSED_ESCAPE_FRAC = float(os.environ.get("SREGEX_FUSED_ESCAPE", "1e-3"))

# gated kernel launches since the last reset (the CUDA path only), in
# all and by route (GATED_ROUTES: csrc/gated_scan.cu's route codes 0-2)
GATED_ROUTES = ("smem", "global", "big16")
gated_scan_launches = 0
gated_route_launches = dict.fromkeys(GATED_ROUTES, 0)


def _inner_tables(core, narrow_only, no_pair=False, device="cuda"):
    """Fast-first tier chain over the core machine: pair (narrow only)
    -> narrow -> wide.  narrow_only keeps the wide tier out; no_pair
    keeps the pair tier out (the fused tier needs byte units, so its
    chunking matches the full tables').  None when none fits."""
    chain = []
    if not no_pair and os.environ.get("SREGEX_PAIR") != "0":
        chain.append(functools.partial(SpecTablesPair, narrow_only=True))
    chain.append(SpecTables)
    if not narrow_only:
        chain.append(SpecTablesWide)
    for cls in chain:
        try:
            return cls(core, device)
        except ValueError:
            continue
    return None


class CoreTables:
    """Hot-core tables for one (full automaton, corpus sample) pair, on
    ``device``.  Raises ValueError when no worthwhile core exists: no
    state subset small enough for the pair/narrow/wide tiers covers the
    sampled visit mass within ``max_escape_frac``.

    require_fast: accept only a pair/narrow core.  no_pair: byte-unit
    inner tables only (the fused tier).  prefer_small: the smallest
    wide fit above the mass floor instead of the largest (the fused
    tier, whose escapes cost a device redo, not a host walk)."""

    def __init__(self, dfa, sample, max_escape_frac=MAX_ESCAPE_FRAC,
                 require_fast=False, no_pair=False, prefer_small=False,
                 device="cuda"):
        native = NativeDfa(dfa)
        device = resolve_device(device)
        counts, _ = native.visits(sample, 0)
        total = float(counts.sum())
        if total <= 0:
            raise ValueError("empty sample")
        counts = counts.copy()
        counts[0] += 1                      # the entry state is always hot
        visited = np.nonzero(counts)[0]
        order = visited[np.argsort(-counts[visited], kind="stable")]
        order = np.concatenate([[0], order[order != 0]])
        V = len(order)
        csum = np.cumsum(counts[order].astype(np.float64))
        allowed = max_escape_frac * total
        # covering the whole visited set (no escapes) always qualifies
        m_min = min(V, int(np.searchsorted(csum,
                                           total + 1 - allowed)) + 1)
        ms = sorted({m for m in (V,) + _CANDIDATE_MS
                     if m_min <= m <= V}, reverse=True)

        fast_fit = None                     # (inner, core, maps)
        wide_fit = None
        for m in ms:
            core, hot2full, full2core = build_core_dfa(dfa, order[:m])
            if fast_fit is None:
                inner = _inner_tables(core, True, no_pair, device)
                if inner is not None:
                    # the fast tiers' rate does not depend on the rows,
                    # so the largest fast fit escapes least at one speed
                    fast_fit = (inner, core, hot2full, full2core)
                    break
            if not require_fast:
                inner = _inner_tables(core, False, no_pair, device)
                if inner is not None and (wide_fit is None
                                          or prefer_small):
                    wide_fit = (inner, core, hot2full, full2core)
        fit = fast_fit or wide_fit
        if fit is None:
            raise ValueError("no fast core tier fits the sampled "
                             "hot set (visited %d states)" % V)
        self._adopt(dfa, native, device, *fit)

    def _adopt(self, dfa, native, device, inner, core, hot2full, full2core):
        """Hold the chosen core: the FULL machine ``dfa`` and its native
        engine, the inner tables over ``core``, and the state maps."""
        self.dfa = dfa
        self.native = native
        self.device = device
        self.inner, self.core = inner, core
        self.hot2full, self.full2core = hot2full, full2core
        self.H = len(hot2full)
        # premultiplied sticky-escape id in the inner alphabet
        self.esc_premult = self.H * self.inner.ncls
        # set by each completed scan: (natively repaired chunks, chunks);
        # None after a scan that returned at a match.  The Scanner reads
        # it to re-core on drift
        self.last_repair = None
        # the fused tier's: why the last scan repaired on the host
        # ("overflow", "miss" or None)
        self.last_fused_cause = None
        # the fused tier's last (escaped chunks, overflow)
        self.last_escapes = None
        self._h2f_dev = None

    def to_core_premult(self, full_state):
        """Premultiplied core id of a full state, or -1 if not hot."""
        c = int(self.full2core[full_state])
        if c >= self.H:
            return -1
        return c * self.inner.ncls

    def to_full(self, core_premult):
        """Full state id of a (non-ESC) premultiplied core id."""
        return int(self.hot2full[core_premult // self.inner.ncls])

    def to_full_vec(self, premult_arr):
        """to_full over an array of non-ESC premultiplied ids."""
        return self.hot2full[np.asarray(premult_arr) // self.inner.ncls]


class LazyCoreTables(CoreTables):
    """The legacy hot-core tier over a LazyDfa full machine: patterns
    past the eager DFA budget get a device path when the sampled hot
    set is small.  Only the hot core is materialised as tables; escaped
    chunks re-scan on the lazy machine (its native walkers), so a
    drifted corpus costs speed, which the Scanner's re-core and decline
    logic bounds.  Full states are lazy state ids and full2core is a
    dict; the folds (core_count_bytes, core_scan_bytes,
    core_scan_last_bytes) take it as they take CoreTables.  Raises ValueError when no core fits, as
    CoreTables does."""

    def __init__(self, lazy, sample, max_escape_frac=MAX_ESCAPE_FRAC,
                 require_fast=False, device="cuda"):
        device = resolve_device(device)
        counts, _ = lazy.visits(sample, 0)
        counts[0] = counts.get(0, 0) + 1    # the entry state is always hot
        total = float(sum(counts.values()))
        order = [0] + sorted((s for s in counts if s != 0),
                             key=lambda s: (-counts[s], s))
        V = len(order)
        csum = np.cumsum([counts[s] for s in order]).astype(np.float64)
        allowed = max_escape_frac * total
        # covering the whole visited set (no escapes) always qualifies
        m_min = min(V, int(np.searchsorted(csum,
                                           total + 1 - allowed)) + 1)
        ms = sorted({m for m in (V,) + _CANDIDATE_MS
                     if m_min <= m <= V}, reverse=True)

        fast_fit = None
        wide_fit = None
        for m in ms:
            core = self._build(lazy, order[:m])
            if fast_fit is None:
                inner = _inner_tables(core, True, False, device)
                if inner is not None:
                    fast_fit = (inner, core, order[:m])
                    break
            if wide_fit is None and not require_fast:
                inner = _inner_tables(core, False, False, device)
                if inner is not None:
                    wide_fit = (inner, core, order[:m])
        fit = fast_fit or wide_fit
        if fit is None:
            raise ValueError("no fast core tier fits the sampled "
                             "hot set (visited %d states)" % V)
        inner, core, hot = fit
        # the LazyDfa is its own native engine: its walkers take the
        # folds' calls (scan_first, count, scan_last) with NativeDfa's
        # signatures
        self._adopt(lazy, lazy, device, inner, core,
                    np.asarray(hot, dtype=np.int64),
                    {sid: i for i, sid in enumerate(hot)})
        self.lazy = lazy

    @staticmethod
    def _build(lazy, hot):
        """The core machine over the hot lazy states ``hot``: their rows
        materialised through the lazy machine, out-of-core targets to
        the sticky ESC state."""
        H = len(hot)
        ncls = lazy.nclasses
        f2c = {sid: i for i, sid in enumerate(hot)}
        ct = np.full((H, ncls), H, np.int32)
        m = np.zeros((H, ncls), dtype=bool)
        eof = np.zeros(H, dtype=bool)
        for i, sid in enumerate(hot):
            eof[i] = lazy.match_eof(sid)
            for c in range(ncls):
                ns, mid = lazy._step(sid, c)
                ct[i, c] = f2c.get(ns, H)
                m[i, c] = mid >= 0
        return core_from_rows(lazy.program, lazy.class_map, ct, m, eof)

    def to_core_premult(self, full_state):
        """Premultiplied core id of a lazy state, or -1 if not hot."""
        c = self.full2core.get(int(full_state), self.H)
        if c >= self.H:
            return -1
        return c * self.inner.ncls


class _Fold:
    """Vectorised repair fold over the per-chunk core planes.  A
    maximal TRUSTED RUN [c..b] (entry speculation matched, each chunk
    clean: not ESC, full length, fire-free when ``quiet``) resolves in
    O(1) from precomputed chain links, so the host work is O(escapes),
    not O(chunks)."""

    def __init__(self, ct, packed, C, K, n, quiet):
        self.ct = ct
        self.phi, self.cnt, self.swarm = _unpack(packed, C)
        ok = self.phi != ct.esc_premult
        if C * K > n and (n - (C - 1) * K) != K:
            ok[C - 1] = False
        if quiet:
            ok &= self.cnt == 0
        self.ok = ok
        # a trusted run cannot extend past these; C-1 is always one
        self.breaks = _chain_ends(self.phi, self.swarm, ok)
        self.cum = np.cumsum(self.cnt.astype(np.int64))

    def run_end(self, c):
        """Last chunk b >= c of the trusted run starting at chunk c."""
        return int(self.breaks[np.searchsorted(self.breaks, c)])

    def trusted(self, c, e_full):
        """True when chunk c, entered in FULL state e_full, can be
        trusted: its speculated entry matched and it ran clean."""
        cp = self.ct.to_core_premult(e_full)
        return cp >= 0 and self.ok[c] and int(self.swarm[c]) == cp

    def run_count(self, c, b):
        """Sum of the device fire counts over chunks [c..b]."""
        lo = self.cum[c - 1] if c else 0
        return int(self.cum[b] - lo)


def _run(ct, data_np, chunk_len, entry_state, prepared, COUNT, mesh=None):
    """Prep (unless given and fit for ``mesh``) and the inner tier's scan
    with the ESC check, sharded over ``mesh`` (the fold is
    mesh-agnostic).  Returns (summary int64 [10], packed planes on the
    device, raw host bytes, C, K, n)."""
    diag.phase("sregex.launch")
    inner = ct.inner
    n = len(data_np)
    W = inner.warmup
    if prepared is None or not fits(prepared, mesh):
        prepared = prepare_auto(inner, data_np, chunk_len, mesh=mesh)
    data, C, K, _J, B = prepared
    ep = ct.to_core_premult(entry_state)
    assert ep >= 0, "entry state must be in the core (caller checks)"
    s0p, j0p = _entry_planes(ep, W, B, data.device)
    bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K else -1
    summary, packed = inner._scan(data, s0p, j0p, C, bad_tail, W,
                                  COUNT=COUNT, esc=ct.esc_premult,
                                  mesh=mesh)
    summ = diag.read_back(summary).numpy().astype(np.int64)
    ct.last_repair = None   # set by completed scans: (native chunks, C)
    return summ, packed, _host_bytes(data_np), C, K, n


def core_scan_bytes(ct, data_np, chunk_len=DEFAULT_K, entry_state=0,
                    prepared=None, mesh=None):
    """Whole-buffer first-match scan on the legacy core tier.  Contract
    of spec_scan_bytes: (final FULL state, first match boundary or -1);
    on a match the state is the full state AT the boundary.  Escaped,
    fired or speculation-missed chunks re-scan natively on the FULL
    machine.  ``mesh`` shards the scan over its devices."""
    n = len(data_np)
    if n == 0:
        return entry_state, -1
    summ, packed, raw, C, K, n = _run(ct, data_np, chunk_len,
                                      entry_state, prepared, False, mesh)
    if bool(summ[0]):
        # every chunk validated: no fires, no escapes, chain exact
        ct.last_repair = (0, C)
        return ct.to_full(int(summ[6])), -1
    fold = _Fold(ct, packed, C, K, n, quiet=True)
    native = ct.native
    e_full = ct.to_full(int(summ[2]))   # entries[fb]: validated, !ESC
    c = int(summ[1])
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)         # fire-free trusted run [c..b]
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        f, st = native.scan_first(raw[lo:hi].tobytes(), e_full)
        if f >= 0:
            return st, lo + f
        e_full = st
        c += 1
        nat += 1
    ct.last_repair = (nat, C)
    return e_full, -1


def core_scan_last_bytes(ct, data_np, chunk_len=DEFAULT_K, entry_state=0,
                         prepared=None, mesh=None):
    """The LAST boundary (0..n-1) at which a match ends, on the legacy
    core tier: the contract of spec_scan_last_bytes with FULL states,
    (final FULL state, last match boundary or -1); find's reverse start
    locator over CoreTables and LazyCoreTables.  One COUNT scan with the
    ESC check; the position inside the last firing chunk is always
    pinned by a native scan_last of that one chunk on the FULL machine,
    so the core's match bits never reach the answer.  ``mesh`` as for
    core_scan_bytes."""
    n = len(data_np)
    if n == 0:
        return entry_state, -1
    summ, packed, raw, C, K, n = _run(ct, data_np, chunk_len,
                                      entry_state, prepared, True, mesh)
    native = ct.native
    if bool(summ[0]):
        ct.last_repair = (0, C)
        last_fire = int(summ[8])
        final = ct.to_full(int(summ[6]))
        if last_fire < 0:
            return final, -1
        lo = last_fire * K
        r, _ = native.scan_last(raw[lo:lo + K].tobytes(),
                                ct.to_full(int(summ[9])))
        return final, lo + r
    # the summary's last fire covers the validated prefix; the fold takes
    # the rest in trusted runs.  Only the last firing chunk of all needs a
    # native pin, so it is kept as a record: ("pin", chunk, entry) for a
    # trusted firing chunk, ("pos", boundary) for a natively scanned one;
    # chunks come in order, so the latest record wins
    last = None
    if int(summ[8]) >= 0:
        last = ("pin", int(summ[8]), ct.to_full(int(summ[9])))
    fold = _Fold(ct, packed, C, K, n, quiet=False)
    e_full = ct.to_full(int(summ[2]))
    c = int(summ[1])
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            if fold.run_count(c, b):
                j = c + int(np.flatnonzero(fold.cnt[c:b + 1])[-1])
                last = ("pin", j, ct.to_full(int(fold.swarm[j])))
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        r, st = native.scan_last(raw[lo:hi].tobytes(), e_full)
        if r >= 0:
            last = ("pos", lo + r)
        e_full = st
        c += 1
        nat += 1
    ct.last_repair = (nat, C)
    if last is None:
        return e_full, -1
    if last[0] == "pos":
        return e_full, last[1]
    _, j, ej = last
    lo = j * K
    r, _ = native.scan_last(raw[lo:min(lo + K, n)].tobytes(), ej)
    return e_full, lo + r


def core_count_bytes(ct, data_np, chunk_len=DEFAULT_K, entry_state=0,
                     prepared=None, mesh=None):
    """Count match-ending boundaries (0..n-1; EOF is the caller's) on
    the legacy core tier.  Contract of spec_count_bytes with FULL
    states.  ``mesh`` as for core_scan_bytes."""
    n = len(data_np)
    if n == 0:
        return entry_state, 0
    summ, packed, raw, C, K, n = _run(ct, data_np, chunk_len,
                                      entry_state, prepared, True, mesh)
    if bool(summ[0]):
        ct.last_repair = (0, C)
        if n < 2 ** 31:
            return ct.to_full(int(summ[6])), int(summ[7])
        # the device prefix is int32: re-sum the chunk counts in int64
        _, cnt, _ = _unpack(packed, C)
        return (ct.to_full(int(summ[6])),
                int(np.sum(cnt, dtype=np.int64)))
    fold = _Fold(ct, packed, C, K, n, quiet=False)
    native = ct.native
    total = int(summ[7])                # validated-prefix count
    e_full = ct.to_full(int(summ[2]))
    c = int(summ[1])
    nat = 0
    while c < C:
        if fold.trusted(c, e_full):
            b = fold.run_end(c)
            total += fold.run_count(c, b)
            e_full = ct.to_full(int(fold.phi[b]))
            c = b + 1
            continue
        lo = c * K
        hi = min(lo + K, n)
        k, st = native.count(raw[lo:hi].tobytes(), e_full)
        total += k
        e_full = st
        c += 1
        nat += 1
    ct.last_repair = (nat, C)
    return e_full, total


def core_chunk_map(ct, data_np, chunk_len=DEFAULT_K, entry_state=0,
                   prepared=None, mesh=None):
    """Validated per-chunk scan map on the legacy core tier (CoreTables
    or LazyCoreTables): (entries [C] FULL plain states, counts [C],
    final FULL state), all exact.  Contract of spec_chunk_map, the
    finditer start locator's building block: every trusted run (the
    validated prefix among them) maps in one vector op; escaped or
    speculation-missed chunks are re-counted natively on the FULL
    machine.  ``mesh`` as for core_scan_bytes."""
    n = len(data_np)
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                entry_state)
    _, packed, raw, C, K, n = _run(ct, data_np, chunk_len, entry_state,
                                   prepared, True, mesh)
    fold = _Fold(ct, packed, C, K, n, quiet=False)
    entries = np.zeros(C, dtype=np.int64)
    counts = fold.cnt.astype(np.int64).copy()
    e_full, nat = _fold_map(ct, fold, raw, K, entry_state, entries, counts)
    ct.last_repair = (nat, C)
    return entries, counts, e_full


def _fold_map(ct, fold, raw, K, e_full, entries, counts):
    """_chain_map over a core fold's planes, from chunk 0 entered in FULL
    state e_full: a chunk re-counts natively on the FULL machine.
    Returns (the final FULL state, the chunks re-counted)."""
    def recount(c, e):
        return ct.native.count(raw[c * K:(c + 1) * K].tobytes(), e)

    return _chain_map(fold.phi, fold.swarm, fold.ok, e_full, entries,
                      counts, ct.to_core_premult, ct.to_full_vec, recount)


# ---------------------------------------------------------------------
# The gated phase-2 kernel and its plain version
# ---------------------------------------------------------------------

def gated_scan(data, state0, j0, table, n_esc, *, W, CPW, BITS, big=False,
               t16=None, sel=None, out=None):
    """The COUNT-mode speculative scan of B2 block rows of chunk slots,
    gated per block row: rows b >= ceil(n_esc / (G*1024)) are skipped
    and their outputs left unwritten.  state0/j0 int32 [B2, G, 8, 128];
    data int32 [B, Jw, G, 8, 128]: with ``sel`` (int32 [B2*G*1024], the
    slot -> chunk map of _compact_escapes) the full corpus, slot i
    reading chunk sel[i] in place; without it the windows themselves (B
    = B2, slot i reading chunk i, the JAX gated launch's input).  table
    int32 [R*128] (in shared memory, or with ``big`` up to 2**17
    entries); ``t16`` (``big`` only) None or big16_table's Big16 of
    ``table``; n_esc an int32 tensor of one element on the same device.
    Returns (phi, fm, swarm): ``out`` when given, else new planes.

    CUDA tensors launch sre_gated_scan (csrc/gated_scan.cu) on the
    current stream, reading n_esc on the device, or raise: the table in
    shared memory (route "smem"), the 16-bit table where ``t16`` is
    given ("big16"), else the fused table in global memory ("global").
    CPU tensors take gated_scan_ref (zeros in the skipped rows, or
    ``out`` left as it was there)."""
    global gated_scan_launches
    rows = state0.shape[0] if sel is not None else None
    _check_scan_args(data, state0, j0, table, W, CPW, BITS,
                     max_table=BIG_MAX_ENTRIES if big else SMEM_TABLE_MAX,
                     extra=(n_esc,) + tuple(out or ())
                     + (() if sel is None else (sel,)), rows=rows)
    if n_esc.numel() != 1:
        raise ValueError("n_esc must hold one int32")
    if big and BITS not in (4, 8):
        raise ValueError("the big tier packs 4 or 8 bits, got %r" % BITS)
    if t16 is not None and not big:
        raise ValueError("t16 serves big tables only")
    if sel is not None and (sel.dim() != 1
                            or sel.numel() != state0.numel()):
        raise ValueError("sel must be int32 [%d], one chunk a slot, got %s"
                         % (state0.numel(), tuple(sel.shape)))
    if out is not None and any(tuple(o.shape) != tuple(state0.shape)
                               for o in out):
        raise ValueError("out planes must be shaped like state0")
    if data.device.type == "cpu":
        planes = gated_scan_ref(data, state0, j0, table, n_esc, W=W,
                                CPW=CPW, BITS=BITS, sel=sel)
        if out is None:
            return planes
        nblk = _active_rows(n_esc, state0)
        for o, p in zip(out, planes):
            o[:nblk] = p[:nblk]
        return tuple(out)
    if data.device.type != "cuda":
        raise ValueError("gated_scan runs on cuda or cpu tensors, got %s"
                         % data.device)
    if t16 is None:
        route, t16_args = "global" if big else "smem", (None, 0, 0, 0)
    else:
        tt = check_t16(t16, data, BITS)
        route, t16_args = "big16", (tt.data_ptr(), tt.numel(), t16.ncls,
                                    t16.rows)
    if table.data_ptr() % 16 or (t16_args[0] or 0) % 16:
        raise ValueError("the gated kernel stages 16-byte aligned tables")
    planes = launch_planes("sre_gated_scan", data, state0, j0, table, (
        W, CPW, BITS, n_esc.data_ptr(),
        None if sel is None else sel.data_ptr(), data[:, 0].numel(),
        GATED_ROUTES.index(route), *t16_args), out=out)
    gated_scan_launches += 1
    gated_route_launches[route] += 1
    return planes


def _active_rows(n_esc, planes):
    """Block rows the gate lets through: min(B2, ceil(n_esc/(G*1024)))
    for planes [B2, G, 8, 128]."""
    slots = planes.shape[1] * TILE
    return max(0, min(planes.shape[0], -(-int(n_esc.reshape(())) // slots)))


def gated_scan_ref(data, state0, j0, table, n_esc, *, W, CPW, BITS,
                   sel=None):
    """The plain torch version of gated_scan: with ``sel`` the windows
    gathered first (_gather_windows; an entry outside the corpus's
    chunks reads chunk 0, as the kernel does), then spec_scan_ref
    (COUNT) on the active block rows, zeros in the others.  Reads n_esc
    on the host."""
    if sel is not None:
        chunks = data[:, 0].numel()
        sel = torch.where((sel >= 0) & (sel < chunks), sel, 0)
        data = _gather_windows(data, sel, sel.numel())
    nblk = _active_rows(n_esc, state0)
    out = tuple(torch.zeros_like(state0) for _ in range(3))
    if nblk:
        planes = spec_scan_ref(data[:nblk], state0[:nblk], j0[:nblk],
                               table, W=W, CPW=CPW, BITS=BITS, COUNT=True)
        for o, p in zip(out, planes):
            o[:nblk] = p
    return out


# ---------------------------------------------------------------------
# Fused two-phase count
# ---------------------------------------------------------------------

def _tier_statics(tables):
    """(kind, W, CPW, BITS, R) of a SpecTables / SpecTablesWide /
    SpecTablesBig object ("narrow" / "wide" / "big")."""
    if isinstance(tables, SpecTables):
        kind, R = "narrow", 1
    elif isinstance(tables, SpecTablesBig):
        kind, R = "big", tables.rows
    else:
        kind, R = "wide", tables.rows
    return kind, tables.warmup, tables.cpw, tables.bits, R


def fused_chunk(inner, full_tables, chunk_len=DEFAULT_K):
    """The chunk length both fused preps agree on, or None.  The two
    tiers' packing quanta can differ, so iterate the mutual round-down
    to a fixed point."""
    K1 = effective_chunk(inner, chunk_len)
    K2 = effective_chunk(full_tables, chunk_len)
    for _ in range(6):
        if K1 == K2:
            return K1
        k = min(K1, K2)
        K1 = effective_chunk(inner, k)
        K2 = effective_chunk(full_tables, k)
    return K1 if K1 == K2 else None


def _at(v, i):
    """v[i] for a 0-d index tensor, as a 1-element tensor (no sync)."""
    return v.index_select(0, i.reshape(1).long())


def _compact_escapes(phi1, live, ESC, CAP):
    """The escaped live chunks of phase 1, compacted on the device into
    an ascending prefix of CAP slots.  Returns (n_esc 0-d int32,
    overflow 0-d bool, sel_g, sel_s): the slots' chunk indices to
    gather from (padding: chunk 0) and to scatter to (padding: the dump
    slot Cp, never a real chunk, so a padding write cannot clobber a
    redone chunk)."""
    Cp = phi1.numel()
    escaped = (phi1 == ESC) & live
    n_esc = escaped.sum(dtype=torch.int32)
    idx = torch.arange(Cp, dtype=torch.int32, device=phi1.device)
    big = 1 << 30
    sel = torch.sort(torch.where(escaped, idx, big)).values[:CAP]
    valid = sel < big
    return (n_esc, n_esc > CAP, torch.where(valid, sel, 0),
            torch.where(valid, sel, Cp).long())


def _gather_windows(full_data, sel_g, CAP):
    """The full machine's windows of the selected chunks, gathered with
    one index straight into the phase-2 layout [B2, Jw, G, 8, 128]."""
    G = full_data.shape[2]
    B2 = CAP // (G * TILE)
    Jw = full_data.shape[1]
    itype = torch.int64 if full_data.numel() >= 2 ** 31 else torch.int32
    sel_g = sel_g.to(itype)
    # word w of chunk c = (b*G + g)*1024 + t sits at flat index
    # ((b*Jw + w)*G + g)*1024 + t
    base = sel_g // (G * TILE) * (Jw * G * TILE) + sel_g % (G * TILE)
    step = torch.arange(Jw, dtype=itype, device=sel_g.device) * (G * TILE)
    gidx = base.view(B2, 1, G, TILE) + step.view(1, Jw, 1, 1)
    return full_data.reshape(-1).index_select(0, gidx.reshape(-1)) \
        .view(B2, Jw, G, 8, TILE // 8)


def _phase2(full_data, sel_g, full_tables, n_esc, p2_j0=None):
    """The full machine's COUNT scan of the escaped chunks, read in place
    through the slot map sel_g; block rows past the escapes hold only
    padding and are gated off.  Every slot speculates from the seed at
    j0 = 0, or, with ``p2_j0`` (int32 [Cp], one j0 a chunk), at its
    chunk's j0, gathered through the slot map."""
    kind, W, CPW, BITS, _ = _tier_statics(full_tables)
    z = torch.zeros((sel_g.numel() // (GROUPS * TILE), GROUPS, 8, 128),
                    dtype=torch.int32, device=full_data.device)
    j0 = z if p2_j0 is None else \
        p2_j0.index_select(0, sel_g).view(z.shape)
    return gated_scan(full_data, z, j0, full_tables.fused, n_esc.reshape(1),
                      W=W, CPW=CPW, BITS=BITS, big=kind == "big",
                      t16=full_tables.t16 if kind == "big" else None,
                      sel=sel_g)


def _fused_phases(core_data, full_data, s01, j01, inner, full_tables,
                  hot2full, live, *, CAP, ESC, p2_j0=None):
    """Phase 1 on the core, escape compaction, the gated phase 2 over the
    escaped chunks of the full machine's prep and the merge, all on the
    device.  Returns (phi_m, fm_m, swarm_m) merged in FULL premultiplied
    space (ESC -> -1 where not redone), the phase-1 core planes (phi1,
    fm1, swarm1), n_esc (0-d int32) and the overflow flag (0-d bool).

    ``p2_j0``: None, or int32 [Cp] on the device, the phase-2 j0 of each
    chunk.  The batched documents (ops/batch.py) freeze the redo's
    warmup (j0 = W2) at every document-start chunk, whose warmup window
    holds the previous document's tail.  A padding slot of the slot map
    reads chunk 0 and so takes p2_j0[0]; its result goes to the dump
    slot Cp."""
    Cp = core_data.shape[0] * GROUPS * TILE
    _, W1, CPW1, BITS1, _ = _tier_statics(inner)
    phi1, fm1, swarm1 = (p.reshape(Cp) for p in spec_scan(
        core_data, s01, j01, inner.fused, W=W1, CPW=CPW1, BITS=BITS1,
        COUNT=True))
    n_esc, overflow, sel_g, sel_s = _compact_escapes(phi1, live, ESC, CAP)
    phi2, fm2, swarm2 = (p.reshape(CAP) for p in _phase2(
        full_data, sel_g, full_tables, n_esc, p2_j0))

    # core premult -> full premult, ESC -> -1 (the index clamped into
    # hot2full's H+1 entries first)
    ncls_c, ncls_f = inner.ncls, full_tables.ncls

    def to_full(x):
        h = torch.clamp(x // ncls_c, 0, hot2full.numel() - 1)
        return torch.where(x == ESC, -1,
                           hot2full.index_select(0, h) * ncls_f)

    # the merge: phase-2 results over the escaped slots, padding into
    # the dump slot Cp
    def merge(plane, redo):
        out = torch.empty(Cp + 1, dtype=torch.int32, device=plane.device)
        out[:Cp] = plane
        out[sel_s] = redo
        return out[:Cp]

    return (merge(to_full(phi1), phi2), merge(fm1, fm2),
            merge(to_full(swarm1), swarm2), phi1, fm1, swarm1, n_esc,
            overflow)


def _fused_count(core_data, full_data, inner, full_tables, hot2full, C,
                 entry_core, entry_full, *, CAP, ESC):
    """Returns (summary int32 [11], merged int32 [3, Cp] in FULL premult
    space, core packed int32 [3, Cp] in core space), on the device.

    summary: [0] all_ok (merged chain valid, no overflow)
             [1] fb  [2] entry@fb  [3] swarm@fb  [4] phi@fb
             [5] phi@C-1  [6] prefix count (sum fm[0:fb])
             [7] overflow (escaped > CAP)  [8] n_escaped
             [9] first firing chunk in the validated prefix (-1)
             [10] entry @ that chunk."""
    Cp = core_data.shape[0] * GROUPS * TILE
    dev = core_data.device
    idx = torch.arange(Cp, dtype=torch.int32, device=dev)
    live = idx < C
    s01, j01 = _entry_planes(entry_core, inner.warmup, core_data.shape[0],
                             dev)
    (phi_m, fm_m, swarm_m, phi1, fm1, swarm1, n_esc,
     overflow) = _fused_phases(core_data, full_data, s01, j01, inner,
                               full_tables, hot2full, live, CAP=CAP,
                               ESC=ESC)
    diag.phase("sregex.summary")
    e0 = torch.full((1,), entry_full, dtype=torch.int32, device=dev)
    summary = _chain_summary(phi_m, fm_m, swarm_m, e0, idx, live, 0, C,
                             overflow, n_esc)
    merged = torch.stack([phi_m, fm_m, swarm_m])
    packed_core = torch.stack([phi1, fm1, swarm1])
    return summary, merged, packed_core


def _chain_summary(phi_m, fm_m, swarm_m, entry0, idx, live, base, C,
                   overflow, n_esc):
    """The merged validation chain (FULL premult space) over a run of
    chunk slots entered at ``entry0`` (int32 [1]), and its 11-int
    summary (_fused_count's layout).  ``idx`` the slots' local indices,
    ``live`` whether each holds a chunk below C, ``base`` the global
    index of the first slot (0 on one device, a shard's offset on a
    mesh): [1] and [9] are global, [5] reads the slot of chunk C-1
    clipped to the run (only its owner's is read on a mesh)."""
    i32 = torch.int32
    entries = torch.cat([entry0, phi_m[:-1]])
    okv = (swarm_m == entries) | ~live
    chain_ok = okv.all()
    fb = torch.argmin(okv.to(i32))
    fb_eff = torch.where(chain_ok, phi_m.shape[0], fb)
    valid = (idx < fb_eff) & live
    prefix = torch.where(valid, fm_m, 0).sum()
    # the first firing chunk in the validated prefix and its exact entry
    # (a first-match scan pins the boundary with one native chunk scan)
    firev = (fm_m > 0) & valid
    any_fire = firev.any()
    ff = torch.where(any_fire, torch.argmax(firev.to(i32)), 0)
    last = min(max(C - 1 - base, 0), phi_m.shape[0] - 1)
    return torch.cat([
        (chain_ok & ~overflow).to(i32).reshape(1),
        (fb + base).to(i32).reshape(1), _at(entries, fb),
        _at(swarm_m, fb), _at(phi_m, fb), phi_m[last:last + 1],
        prefix.to(i32).reshape(1), overflow.to(i32).reshape(1),
        n_esc.reshape(1),
        torch.where(any_fire, ff + base, -1).to(i32).reshape(1),
        _at(entries, ff)])


def _fused_batch(core_data, full_data, s01, j01, p2_j0, inner, full_tables,
                 hot2full, C, doc_id, fullv, doc_startv, last_full, *, CAP,
                 ESC, NDOCS):
    """The fused two-phase dispatch over a batched document stream
    (ops/batch.py): both phases, the escape redo and the per-document
    validation fold, all on the device, so the common case reads back
    2 + 2*NDOCS ints and no planes.

    A full chunk is ok when its speculated entry equals its
    predecessor's exit (a document start's entry is the seed); all_ok
    says every full chunk of every document validated and nothing
    overflowed; a document's count is the segment sum of its ok chunks'
    counts over doc_id, and its final state the merged exit of its last
    full chunk.  Ragged tails finish on the host from those exits.

    s01/j01: phase-1 entry planes (the seed everywhere, j0 = W1 at
    document starts); p2_j0 int32 [Cp], the phase-2 j0 of each chunk
    (W2 at document starts); doc_id int32 [Cp] (padding NDOCS, dropped),
    fullv / doc_startv int32 [Cp] 0/1, last_full int32 [NDOCS] (each
    document's last full chunk; -1 where it has none, which the host
    masks).

    Returns (summary int32 [2 + 2*NDOCS] = [all_ok, n_esc | counts |
    finals], merged int32 [3, Cp] in FULL premult space, the phase-1
    core planes int32 [3, Cp], flags int32 [2] = [n_esc, overflow]), on
    the device: read only the summary unless all_ok is 0."""
    Cp = core_data.shape[0] * GROUPS * TILE
    dev = core_data.device
    i32 = torch.int32
    live = torch.arange(Cp, dtype=i32, device=dev) < C
    (phi_m, fm_m, swarm_m, phi1, fm1, swarm1, n_esc,
     overflow) = _fused_phases(core_data, full_data, s01, j01, inner,
                               full_tables, hot2full, live, CAP=CAP,
                               ESC=ESC, p2_j0=p2_j0)
    diag.phase("sregex.summary")
    # the per-document chains: a document start is entered at the seed
    prev = torch.cat([torch.zeros(1, dtype=i32, device=dev), phi_m[:-1]])
    entries = torch.where(doc_startv == 1, 0, prev)
    full = fullv == 1
    okv = (swarm_m == entries) & full
    all_ok = (okv | ~full).all() & ~overflow
    # the padding id NDOCS lands in one extra slot, dropped (int32 sums
    # are exact; the host keeps the fast path below 2**31 bytes)
    dcounts = torch.zeros(NDOCS + 1, dtype=i32, device=dev).index_add_(
        0, doc_id, torch.where(okv, fm_m, 0))[:NDOCS]
    dfinals = phi_m.index_select(0, last_full.clamp(0, Cp - 1))
    summary = torch.cat([all_ok.to(i32).reshape(1), n_esc.reshape(1),
                         dcounts, dfinals])
    merged = torch.stack([phi_m, fm_m, swarm_m])
    packed = torch.stack([phi1, fm1, swarm1])
    flags = torch.stack([n_esc, overflow.to(i32)])
    return summary, merged, packed, flags


def _fused_count_mesh(core_data, full_data, ct, inner, full_tables, C,
                      entry_core, entry_full, *, CAP, ESC, mesh):
    """_fused_count sharded over ``mesh`` (the JAX package's
    _fused_count_mesh): each shard runs _fused_phases over its own block
    rows, with ``live`` from the global chunk index (base + idx < C) and
    the global entry planes' slice (the true entry, its warmup frozen,
    only at global chunk 0), then its link of the merged chain, entered
    at the previous shard's last merged exit (one copy to its device;
    shard 0 takes the caller's entry).  Shard order keeps every launch
    of every shard enqueued before the first exit is read.

    Returns (per-shard partial summaries int32 [ndev, 11], merged int32
    [3, Cp] and core planes int32 [3, Cp] in global chunk order), on the
    lead device.  A partial summary is _chain_summary's over the shard's
    link: [0] its chain valid and no overflow, [1] the global index of
    its first break, [5] phi at its slot of chunk C-1 (clipped), [9] its
    first fire in its validated prefix (global, -1 none)."""
    lead = mesh.lead
    i32 = torch.int32
    rows = shard_rows(core_data.shape[0], mesh)
    Cp_l = rows * GROUPS * TILE
    s01, j01 = _entry_planes(entry_core, inner.warmup, core_data.shape[0],
                             lead)
    cores = shard_blocks(core_data, mesh)
    fulls = shard_blocks(full_data, mesh)
    shards = []
    for i, dev in enumerate(mesh.devices):
        cut = slice(i * rows, (i + 1) * rows)
        base = i * Cp_l
        idx = torch.arange(Cp_l, dtype=i32, device=dev)
        live = idx + base < C
        out = _fused_phases(
            cores[i], fulls[i], s01[cut].to(dev, non_blocking=True),
            j01[cut].to(dev, non_blocking=True), replica(inner, dev),
            replica(full_tables, dev), _hot_map(replica(ct, dev)), live,
            CAP=CAP, ESC=ESC)
        shards.append((dev, base, idx, live, out))
    diag.phase("sregex.summary")
    summaries, merged, packed = [], [], []
    prev = torch.full((1,), entry_full, dtype=i32, device=lead)
    for dev, base, idx, live, out in shards:
        phi_m, fm_m, swarm_m, phi1, fm1, swarm1, n_esc, overflow = out
        summary = _chain_summary(phi_m, fm_m, swarm_m,
                                 prev.to(dev, non_blocking=True), idx, live,
                                 base, C, overflow, n_esc)
        prev = phi_m[-1:]
        summaries.append(summary.to(lead, non_blocking=True))
        merged.append(torch.stack([phi_m, fm_m, swarm_m])
                      .to(lead, non_blocking=True))
        packed.append(torch.stack([phi1, fm1, swarm1])
                      .to(lead, non_blocking=True))
    return (torch.stack(summaries), torch.cat(merged, 1),
            torch.cat(packed, 1))


def _combine_fused_summaries(S, C, Cp_l):
    """Host fold of the per-shard partial summaries (_fused_count_mesh)
    into the exact single-device 11-int summary, the JAX package's
    _combine_fused_summaries.  The global chain validates iff every
    shard's local chain (its stitch included) validates; the first break
    is the first breaking shard's, the validated-prefix count sums the
    whole shards before it and its local prefix, and the first fire is
    the first firing shard's at or before it.  int64 numpy [11]."""
    S = np.asarray(S).astype(np.int64)
    ndev = S.shape[0]
    owner = min((C - 1) // Cp_l, ndev - 1)
    phi_last = int(S[owner, 5])
    n_esc = int(S[:, 8].sum())
    overflow = int(bool(S[:, 7].any()))
    bad = np.flatnonzero(S[:, 0] == 0)
    if len(bad) == 0:
        all_ok, s_star = 1, ndev
        fb, e_fb, sw_fb, phi_fb = C, 0, 0, 0
        prefix = int(S[:, 6].sum())
    else:
        all_ok, s_star = 0, int(bad[0])
        fb = int(S[s_star, 1])
        e_fb = int(S[s_star, 2])
        sw_fb = int(S[s_star, 3])
        phi_fb = int(S[s_star, 4])
        prefix = int(S[:s_star, 6].sum() + S[s_star, 6])
    ff, e_ff = -1, 0
    for s in range(min(s_star + 1, ndev)):
        if S[s, 9] >= 0:
            ff, e_ff = int(S[s, 9]), int(S[s, 10])
            break
    return np.array([all_ok, fb, e_fb, sw_fb, phi_fb, phi_last,
                     prefix, overflow, n_esc, ff, e_ff], dtype=np.int64)


def _hot_map(ct):
    """The hot -> full state map on ct.device (entry H, the clamp target
    of ESC, is -1): uploaded once per CoreTables (a mesh shard reads its
    replica's, ops/mesh.replica)."""
    if ct._h2f_dev is None:
        h2f = np.full(ct.H + 1, -1, dtype=np.int32)
        h2f[:ct.H] = np.asarray(ct.hot2full[:ct.H], dtype=np.int32)
        ct._h2f_dev = torch.from_numpy(h2f).to(ct.device)
    return ct._h2f_dev


def _fused_cap(B1):
    """The phase-2 capacity for B1 phase-1 block rows: FUSED_CAP, never
    more chunk slots than phase 1 has, and always whole phase-2 block
    rows (GROUPS*1024 slots)."""
    blk = GROUPS * TILE
    cap = min(FUSED_CAP, B1 * blk)
    return max(blk, -(-cap // blk) * blk)


def _fused_dispatch(ct, full_tables, data_np, chunk_len, entry_state,
                    prepared_core, prepared_full, mesh=None):
    """Shared set-up and dispatch of the fused entry points.  Returns
    None when the shapes disqualify the fused tier, else a dict with
    the summary (int64 numpy, or None), the merged and core planes on
    the device, and the chunking.  ``mesh`` shards the whole two-phase
    dispatch (_fused_count_mesh; the cap is per shard); the per-shard
    summaries (``shard_summ``, int64 [ndev, 11]) are folded into the
    single-device summary here, so the folds of the entry points stay
    mesh-agnostic.  A caller's prep that does not fit the mesh is made
    again."""
    inner = ct.inner
    if not isinstance(inner, (SpecTables, SpecTablesWide)) \
            or not isinstance(full_tables, (SpecTables, SpecTablesWide,
                                            SpecTablesBig)):
        return None
    K1 = fused_chunk(inner, full_tables, chunk_len)
    if K1 is None:
        return None
    n = len(data_np)
    ep = ct.to_core_premult(entry_state)
    if ep < 0:
        return None
    # a caller's prep that predates K alignment, or does not fit the mesh
    if n and prepared_core is not None and (
            prepared_core[2] != K1 or not fits(prepared_core, mesh)):
        prepared_core = None
    if n and prepared_full is not None and (
            prepared_full[2] != K1 or not fits(prepared_full, mesh)):
        prepared_full = None
    if n == 0:
        return {"summ": None, "C": 0, "Cfull": 0, "K": K1, "n": 0,
                "B1": 0, "merged": None, "packed_core": None}
    diag.phase("sregex.launch")
    if prepared_core is None:
        prepared_core = prepare_auto(inner, data_np, K1, mesh=mesh)
    if prepared_full is None:
        prepared_full = prepare_auto(full_tables, data_np, K1, mesh=mesh)
    core_data, C, K, _, B1 = prepared_core
    full_data, Cf, Kf, _, _ = prepared_full
    assert (C, K) == (Cf, Kf), "preps disagree on chunking"

    # full-chunk region only: the ragged tail (and EOF) finish on the
    # host from the composed exit
    Cfull = C - 1 if C * K > n and (n - (C - 1) * K) != K else C

    ndev = 1 if mesh is None else mesh.size
    cap = _fused_cap(B1 // ndev)
    summ = merged = packed_core = shard_summ = None
    if Cfull > 0:
        if mesh is None:
            summary, merged, packed_core = _fused_count(
                core_data, full_data, inner, full_tables,
                _hot_map(ct), Cfull, ep,
                entry_state * full_tables.ncls, CAP=cap,
                ESC=ct.esc_premult)
            summ = diag.read_back(summary).numpy().astype(np.int64)
        else:
            summary, merged, packed_core = _fused_count_mesh(
                core_data, full_data, ct, inner, full_tables, Cfull, ep,
                entry_state * full_tables.ncls, CAP=cap,
                ESC=ct.esc_premult, mesh=mesh)
            shard_summ = diag.read_back(summary).numpy().astype(np.int64)
            summ = _combine_fused_summaries(
                shard_summ, Cfull, B1 // ndev * GROUPS * TILE)
        ct.last_escapes = (int(summ[8]), bool(summ[7]))
    return {"summ": summ, "C": C, "Cfull": Cfull, "K": K, "n": n,
            "B1": B1, "merged": merged, "packed_core": packed_core,
            "shard_summ": shard_summ}


def _core_fold(ct, d, quiet):
    """The overflow repair: the legacy fold over the CORE-space planes
    of the full-chunk region."""
    return _Fold(ct, d["packed_core"].reshape(3, d["B1"], GROUPS, 8,
                                              TILE // 8),
                 d["Cfull"], d["K"], min(d["n"], d["Cfull"] * d["K"]),
                 quiet=quiet)


def core_count_fused(ct, full_tables, data_np, chunk_len=DEFAULT_K,
                     entry_state=0, prepared_core=None,
                     prepared_full=None, mesh=None):
    """Count match-ending boundaries (0..n-1; EOF is the caller's) on
    the fused two-phase tier.  Contract of core_count_bytes.  Returns
    None when the shapes disqualify it (the caller then declines the
    tier).  ct.last_fused_cause says why the scan repaired on the host:
    "overflow" (more escapes than the device cap: re-coring helps),
    "miss" (the merged chain broke: a longer warmup helps) or None.
    ``mesh`` shards the two-phase dispatch over its devices."""
    d = _fused_dispatch(ct, full_tables, data_np, chunk_len, entry_state,
                        prepared_core, prepared_full, mesh)
    if d is None:
        return None
    if d["n"] == 0:
        return entry_state, 0
    summ, Cfull, K, n = d["summ"], d["Cfull"], d["K"], d["n"]
    tail_lo = Cfull * K
    native = ct.native
    ncls_f = full_tables.ncls
    raw = _host_bytes(data_np)
    ct.last_repair = None
    ct.last_fused_cause = None

    if summ is None:
        e_full, total = entry_state, 0
        ct.last_repair = (0, 0)
    elif bool(summ[0]):
        # the merged chain validated end to end: no host repair
        ct.last_repair = (0, Cfull)
        e_full = int(summ[5]) // ncls_f
        if n >= 2 ** 31:
            # the device prefix is int32: re-sum the merged counts
            fm64 = diag.read_back(d["merged"][1, :Cfull]).numpy().astype(
                np.int64)
            total = int(fm64.sum())
        else:
            total = int(summ[6])
    elif bool(summ[7]):
        ct.last_fused_cause = "overflow"
        fold = _core_fold(ct, d, quiet=False)
        total = 0
        e_full = entry_state
        c = 0
        nat = 0
        while c < Cfull:
            if fold.trusted(c, e_full):
                b = fold.run_end(c)
                total += fold.run_count(c, b)
                e_full = ct.to_full(int(fold.phi[b]))
                c = b + 1
                continue
            lo = c * K
            k, st = native.count(raw[lo:lo + K].tobytes(), e_full)
            total += k
            e_full = st
            c += 1
            nat += 1
        ct.last_repair = (nat, Cfull)
    else:
        # a residual speculation miss: walk the MERGED (full-space)
        # planes from the first break
        ct.last_fused_cause = "miss"
        phi_m, fm_m, swarm_m = diag.read_back(d["merged"]).numpy().astype(
            np.int64)
        c = int(summ[1])
        # an int64 prefix where the int32 device sum could wrap
        total = int(fm_m[:c].sum()) if n >= 2 ** 31 else int(summ[6])
        e = int(summ[2])
        nat = 0
        while c < Cfull:
            if int(swarm_m[c]) == e and e >= 0:
                total += int(fm_m[c])
                e = int(phi_m[c])
                c += 1
                continue
            lo = c * K
            k, st = native.count(raw[lo:lo + K].tobytes(),
                                 max(e, 0) // ncls_f)
            total += k
            e = st * ncls_f
            c += 1
            nat += 1
        e_full = e // ncls_f
        ct.last_repair = (nat, Cfull)

    if tail_lo < n:
        k, e_full = native.count(raw[tail_lo:].tobytes(), e_full)
        total += k
    return e_full, total


def core_scan_fused(ct, full_tables, data_np, chunk_len=DEFAULT_K,
                    entry_state=0, prepared_core=None, prepared_full=None,
                    mesh=None):
    """First-match scan on the fused two-phase tier.  Contract of
    core_scan_bytes: (state, boundary or -1), the state AT the boundary
    on a match.  Returns None when the shapes disqualify the tier.  The
    first firing chunk's exact position is pinned with one native
    full-machine chunk scan from its validated entry.  ``mesh`` as for
    core_count_fused."""
    d = _fused_dispatch(ct, full_tables, data_np, chunk_len, entry_state,
                        prepared_core, prepared_full, mesh)
    if d is None:
        return None
    if d["n"] == 0:
        return entry_state, -1
    summ, Cfull, K, n = d["summ"], d["Cfull"], d["K"], d["n"]
    tail_lo = Cfull * K
    native = ct.native
    ncls_f = full_tables.ncls
    raw = _host_bytes(data_np)
    ct.last_repair = None
    ct.last_fused_cause = None     # see core_count_fused

    e_full = entry_state
    if summ is not None:
        ff = int(summ[9])
        if ff >= 0:
            # the first firing chunk in the validated prefix: its entry
            # (summ[10], full premult) is exact by the chain argument
            lo = ff * K
            f, st = native.scan_first(raw[lo:lo + K].tobytes(),
                                      int(summ[10]) // ncls_f)
            return st, lo + f
        if bool(summ[0]):
            ct.last_repair = (0, Cfull)
            e_full = int(summ[5]) // ncls_f
        elif bool(summ[7]):
            # overflow: the quiet core-plane fold (a fired or escaped
            # chunk re-scans natively and may return a match)
            ct.last_fused_cause = "overflow"
            fold = _core_fold(ct, d, quiet=True)
            c = 0
            nat = 0
            while c < Cfull:
                if fold.trusted(c, e_full):
                    b = fold.run_end(c)
                    e_full = ct.to_full(int(fold.phi[b]))
                    c = b + 1
                    continue
                lo = c * K
                f, st = native.scan_first(raw[lo:lo + K].tobytes(),
                                          e_full)
                if f >= 0:
                    return st, lo + f
                e_full = st
                c += 1
                nat += 1
            ct.last_repair = (nat, Cfull)
        else:
            # the chain broke before any fire: walk the merged planes
            ct.last_fused_cause = "miss"
            phi_m, fm_m, swarm_m = \
                diag.read_back(d["merged"]).numpy().astype(np.int64)
            e = int(summ[2])
            c = int(summ[1])
            nat = 0
            while c < Cfull:
                if int(swarm_m[c]) == e and e >= 0 \
                        and int(fm_m[c]) == 0:
                    e = int(phi_m[c])
                    c += 1
                    continue
                lo = c * K
                f, st = native.scan_first(raw[lo:lo + K].tobytes(),
                                          max(e, 0) // ncls_f)
                if f >= 0:
                    return st, lo + f
                e = st * ncls_f
                c += 1
                nat += 1
            e_full = e // ncls_f
            ct.last_repair = (nat, Cfull)

    if tail_lo < n:
        f, st = native.scan_first(raw[tail_lo:].tobytes(), e_full)
        if f >= 0:
            return st, tail_lo + f
        e_full = st
    return e_full, -1


def core_chunk_map_fused(ct, full_tables, data_np, chunk_len=DEFAULT_K,
                         entry_state=0, prepared_core=None,
                         prepared_full=None, mesh=None):
    """Validated per-chunk scan map on the fused two-phase tier:
    (entries [C] FULL plain states, counts [C], final FULL state), all
    exact; the contract of core_chunk_map, with escaped chunks redone by
    the full machine's kernel on the device (the gated phase 2) instead
    of one native host walk each.  Returns None when the shapes
    disqualify the fused tier.  The full-chunk region maps through
    _chain_map over the merged planes, or on an overflow (more escapes
    than the device cap) over the legacy core planes; the ragged tail
    finishes natively.  ct.last_fused_cause and ``mesh`` as in
    core_count_fused."""
    d = _fused_dispatch(ct, full_tables, data_np, chunk_len, entry_state,
                        prepared_core, prepared_full, mesh)
    if d is None:
        return None
    if d["n"] == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                entry_state)
    summ, C, Cfull, K = d["summ"], d["C"], d["Cfull"], d["K"]
    ncls_f = full_tables.ncls
    raw = _host_bytes(data_np)
    ct.last_repair = None
    ct.last_fused_cause = None
    entries = np.zeros(C, dtype=np.int64)
    counts = np.zeros(C, dtype=np.int64)

    def recount(c, e):
        return ct.native.count(raw[c * K:(c + 1) * K].tobytes(), e)

    if summ is not None and bool(summ[7]):
        # escape overflow: the legacy core-plane fold
        ct.last_fused_cause = "overflow"
        fold = _core_fold(ct, d, quiet=False)
        counts[:Cfull] = fold.cnt
        e_full, nat = _fold_map(ct, fold, raw, K, entry_state, entries,
                                counts)
        ct.last_repair = (nat, Cfull)
    elif summ is not None:
        # the merged planes (FULL premult; -1 only where an escape was
        # not redone)
        phi_m, fm_m, swarm_m = diag.read_back(
            d["merged"][:, :Cfull]).numpy().astype(np.int64)
        counts[:Cfull] = fm_m
        e_full, nat = _chain_map(
            phi_m, swarm_m, phi_m >= 0, entry_state, entries[:Cfull],
            counts[:Cfull], lambda e: e * ncls_f, lambda a: a // ncls_f,
            recount)
        if nat:
            ct.last_fused_cause = "miss"
        ct.last_repair = (nat, Cfull)
    else:
        e_full = entry_state
        ct.last_repair = (0, 0)

    # the ragged tail chunk: native
    for c in range(Cfull, C):
        entries[c] = e_full
        counts[c], e_full = recount(c, e_full)
    return entries, counts, e_full
