"""Piecewise-affine tier: counted-repetition automata at a cost per byte
that does not grow with the state count.

Counterpart of the JAX package's ops/pallas_affine.py.  Counted
repetitions (`a{400,499}b` -> 402 states) are counting chains: their
transition function is piecewise affine in the state id,

    next(s, c) = s + d[p, c]   (relative: the chain advances)
              or   t[p, c]     (absolute: reset / dead / accept hop)

with p the piece that holds s, and a few pieces cover hundreds of
states.  A step is then a piece search over P - 1 breakpoints, one
lookup in a [P * ncls] table and a select (csrc/affine_scan.cu).
Detection is exact by construction and verified; a machine that is not
piecewise affine within the piece cap declines to the other tiers.

Branching counted repetitions ((?:ab?c){60,140}z) interleave a few
substate types per chain step; renumbering the states residue-major
(periodic_perm) makes them piecewise affine.  The to_premult /
from_premult hooks keep every fold conversion in the original dfa ids.

Everything else (prep, speculation, the summary, native repair, the
folds of ops/spec_scan.py) is shared with the other tiers; the repair
planes are the 3-int32 format, since states reach 2**26.
"""

import numpy as np
import torch

from .layout import SMEM_BYTES, max_chunk_bytes
from .spec_scan import (_CPW, _Tables, _check_scan_args,
                        _summary_and_planes, launch_planes)

_VAL_MASK = (1 << 27) - 1     # |delta*ncls + OFF| or absolute premult
_MODE_BIT = 28                # 1 = relative (state + delta)
_MATCH_BIT = 30
MAX_PIECES = 48               # the lookup table stays small
MAX_ENTRIES = 1 << 26         # S * ncls cap (premult fits the mask)

# kernel launches since the last reset (the CUDA path only)
affine_scan_launches = 0


def detect_pieces(dfa):
    """Greedy exact piecewise-affine factorization.  Returns
    (bounds list [P], mode [P, ncls] bool, val [P, ncls] int64,
    match [P, ncls]) or raises ValueError when P > MAX_PIECES.

    Piece p covers states bounds[p] .. bounds[p+1]-1; for class c:
    mode=True: next = s + val (val = common delta), else next = val
    (common absolute target).  Exact by construction: a piece only
    extends while one representation stays consistent for EVERY
    class and the match bits agree."""
    S, ncls = dfa.nstates, dfa.nclasses
    if S * ncls > MAX_ENTRIES:
        raise ValueError("automaton exceeds the affine premult mask")
    t = dfa.trans.astype(np.int64)
    m = dfa.match.astype(np.int64)
    bounds = [0]
    abs_ok = np.ones(ncls, bool)
    rel_ok = np.ones(ncls, bool)
    for s in range(1, S):
        a_ok = abs_ok & (t[s] == t[s - 1]) & (m[s] == m[s - 1])
        r_ok = rel_ok & (t[s] - s == t[s - 1] - (s - 1)) \
            & (m[s] == m[s - 1])
        if np.all(a_ok | r_ok):
            abs_ok, rel_ok = a_ok, r_ok
        else:
            bounds.append(s)
            abs_ok = np.ones(ncls, bool)
            rel_ok = np.ones(ncls, bool)
        if len(bounds) > MAX_PIECES:
            raise ValueError("not piecewise affine (P > %d)"
                             % MAX_PIECES)
    P = len(bounds)
    mode = np.zeros((P, ncls), bool)
    val = np.zeros((P, ncls), np.int64)
    match = np.zeros((P, ncls), np.int64)
    ext = bounds + [S]
    for p in range(P):
        lo, hi = ext[p], ext[p + 1]
        match[p] = m[lo]
        for c in range(ncls):
            if hi - lo == 1 or np.all(t[lo:hi, c] == t[lo, c]):
                mode[p, c] = False          # absolute
                val[p, c] = t[lo, c]
            else:
                mode[p, c] = True           # relative
                val[p, c] = t[lo, c] - lo
    # verification (cheap, proves the representation exact)
    s_ids = np.arange(S)
    pid = np.searchsorted(np.asarray(bounds), s_ids, side="right") - 1
    rebuilt = np.where(mode[pid], s_ids[:, None] + val[pid], val[pid])
    if not (np.array_equal(rebuilt, t)
            and np.array_equal(match[pid], m)):
        raise ValueError("affine verification failed")  # never
    return bounds, mode, val, match


def periodic_perm(dfa, max_w=64, max_extra=96):
    """Residue-major renumbering for product chains.

    Branching counted repetitions interleave W substate types per chain
    step, so consecutive-state deltas are not constant, but rows repeat
    exactly with period W.  Reordering states residue-major ((type,
    step) instead of (step, type)) turns every per-(type, class) action
    into a constant relative delta or a constant absolute target,
    which detect_pieces then factorizes (and verifies) as usual.

    Returns a permutation array perm (old id -> new id) or None when
    no period W <= max_w leaves fewer than max_extra aperiodic
    states."""
    S, ncls = dfa.nstates, dfa.nclasses
    if S < 8:
        return None
    t = dfa.trans.astype(np.int64)
    m = dfa.match.astype(np.int64)
    for W in range(1, min(max_w, S // 2) + 1):
        base = np.arange(S)[:, None]
        rel = t - base
        per_c = (t[W:] == t[:-W]) | (rel[W:] == rel[:-W])
        ok = np.all(per_c, axis=1) & np.all(m[W:] == m[:-W], axis=1)
        # longest contiguous True run in ok (ok[i] covers state i+W)
        if not ok.any():
            continue
        best_len, best_lo = 0, 0
        run_lo = None
        for i, v in enumerate(np.concatenate([ok, [False]])):
            if v and run_lo is None:
                run_lo = i
            elif not v and run_lo is not None:
                if i - run_lo > best_len:
                    best_len, best_lo = i - run_lo, run_lo
                run_lo = None
        if best_len <= 0:
            continue
        H = best_lo            # states [H, T) are W-periodic
        T = best_lo + best_len + W
        if (S - (T - H)) + 2 * W > max_extra:
            continue
        if best_len < 4 * W:
            continue           # not meaningfully periodic
        order = list(range(0, H))
        for rcls in range(W):
            order += list(range(H + rcls, T, W))
        order += list(range(T, S))
        perm = np.zeros(S, np.int64)
        perm[np.asarray(order)] = np.arange(S)
        return perm
    return None


class _PermutedDfa:
    """Renumbered view for detect_pieces (trans/match/nstates only)."""

    def __init__(self, dfa, perm):
        inv = np.argsort(perm)
        self.nstates = dfa.nstates
        self.nclasses = dfa.nclasses
        self.trans = perm[dfa.trans[inv]]
        self.match = dfa.match[inv]


class SpecTablesAffine(_Tables):
    """Piecewise-affine tables for the scan folds: premultiplied states
    throughout, the 3-int32-plane repair format (``wide``).

    ``fused`` holds the [P * ncls] entries (val | rel << 28 | match <<
    30), zero padded to whole rows of 128; ``bp`` the P - 1 premultiplied
    breakpoints as an int32 tensor (``bp_premult`` as a tuple); ``off``
    = S * ncls.  States may be renumbered (``perm``, ``inv``)."""

    wide = True

    def __init__(self, dfa, device, max_pieces=MAX_PIECES):
        S, ncls = dfa.nstates, dfa.nclasses
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        self.perm = None
        try:
            bounds, mode, val, match = detect_pieces(dfa)
        except ValueError:
            perm = periodic_perm(dfa)
            if perm is None:
                raise
            # the renumbered machine may still not be affine (the
            # period was structural luck): detect_pieces re-raises
            bounds, mode, val, match = detect_pieces(
                _PermutedDfa(dfa, perm))
            self.perm = perm
            self.inv = np.argsort(perm)
        if len(bounds) > max_pieces:
            raise ValueError("P=%d exceeds the requested piece cap"
                             % len(bounds))
        self.nstates = S
        self.ncls = ncls
        self.pieces = P = len(bounds)
        self.bp_premult = tuple(int(b) * ncls for b in bounds[1:])
        self.off = S * ncls
        ent = np.where(mode, val * ncls + self.off, val * ncls)
        ent = ent | (mode.astype(np.int64) << _MODE_BIT) \
            | ((match != 0).astype(np.int64) << _MATCH_BIT)
        assert int(ent.max()) < 2 ** 31
        self.rows = -(-(P * ncls) // 128)
        flat = np.zeros(self.rows * 128, dtype=np.int32)
        flat[:P * ncls] = ent.reshape(-1).astype(np.int32)
        self.bits = 4 if ncls <= 16 else 8
        self.cpw = _CPW[self.bits]
        self.warmup = 4 * self.cpw
        self.max_chunk = max_chunk_bytes(self.cpw)
        self._finish(dfa, flat, device)
        self.bp = torch.tensor(self.bp_premult, dtype=torch.int32,
                               device=self.device)

    # fold hooks: kernel states live in the renumbered space when perm
    # is set; entries and returned / repair states stay in dfa ids
    def to_premult(self, s):
        if self.perm is None:
            return s * self.ncls
        return int(self.perm[s]) * self.ncls

    def from_premult(self, p):
        if self.perm is None:
            return p // self.ncls
        return int(self.inv[p // self.ncls])

    def from_premult_vec(self, arr):
        a = np.asarray(arr) // self.ncls
        return a if self.perm is None else self.inv[a]

    def _scan(self, data, state0, j0, C, bad_tail, W, COUNT=False):
        planes = affine_scan(data, state0, j0, self.fused, self.bp, W=W,
                             CPW=self.cpw, BITS=self.bits, NCLS=self.ncls,
                             OFF=self.off, COUNT=COUNT)
        return _summary_and_planes(planes, state0, C, bad_tail, COUNT,
                                   wide=True)


def affine_scan(data, state0, j0, table, bp, *, W, CPW, BITS, NCLS, OFF,
                COUNT):
    """Run the piecewise-affine scan kernel.  data int32 [B, Jw, G, 8,
    128] (CPW BITS-bit classes per word, BITS 4 or 8); state0/j0 int32
    [B, G, 8, 128]; table int32 [R*128]; bp int32 [P-1] sorted
    premultiplied breakpoints; NCLS the class count; OFF = S * NCLS; W
    the warmup in bytes.  Returns (phi, fm, swarm), each int32
    [B, G, 8, 128]; fm is the match count (COUNT) or the 0/1 OR.

    CUDA tensors launch csrc/affine_scan.cu on the current stream (no
    synchronisation) or raise.  CPU tensors take affine_scan_ref."""
    global affine_scan_launches
    _check_scan_args(data, state0, j0, table, W, CPW, BITS, extra=(bp,))
    if BITS not in (4, 8):
        raise ValueError("the affine tier packs 4 or 8 bits, got %r" % BITS)
    if bp.dim() != 1 or bp.numel() >= MAX_PIECES:
        raise ValueError("bp must be int32 [P-1] with P <= %d, got %s"
                         % (MAX_PIECES, tuple(bp.shape)))
    if (table.numel() + bp.numel()) * 4 > SMEM_BYTES:
        raise ValueError("table and breakpoints exceed shared memory")
    if data.device.type == "cpu":
        return affine_scan_ref(data, state0, j0, table, bp, W=W, CPW=CPW,
                               BITS=BITS, NCLS=NCLS, OFF=OFF, COUNT=COUNT)
    if data.device.type != "cuda":
        raise ValueError("affine_scan runs on cuda or cpu tensors, got %s"
                         % data.device)
    planes = launch_planes("sre_affine_scan", data, state0, j0, table,
                           (W, CPW, BITS, int(bool(COUNT)), bp.data_ptr(),
                            bp.numel(), int(NCLS), int(OFF)))
    affine_scan_launches += 1
    return planes


def affine_scan_ref(data, state0, j0, table, bp, *, W, CPW, BITS, NCLS,
                    OFF, COUNT):
    """The plain torch version of affine_scan, on any device: a loop
    over the units, vectorised over all streams.  An index outside the
    table reads entry (index & 127); int32 arithmetic wraps, as the
    kernel's does."""
    cmask = (1 << BITS) - 1
    n = table.numel()
    bps = list(bp)

    def step(s, word, k):
        pid = torch.zeros_like(s)
        for b in bps:
            pid += (s >= b).to(torch.int32)
        idx = pid * NCLS + ((word >> (BITS * k)) & cmask)
        idx = torch.where(idx < n, idx, idx & 127)
        e = table[idx.long()]
        val = e & _VAL_MASK
        rel = (e >> _MODE_BIT) & 1
        nxt = torch.where(rel == 1, s + val - OFF, val)
        return nxt, (e >> _MATCH_BIT) & 1

    s = state0
    for w in range(W // CPW):
        word = data[:, w]
        for k in range(CPW):
            nxt, _ = step(s, word, k)
            s = torch.where(w * CPW + k >= j0, nxt, s)
    swarm = s
    acc = torch.zeros_like(s)
    for w in range(W // CPW, data.shape[1]):
        word = data[:, w]
        for k in range(CPW):
            s, mbit = step(s, word, k)
            acc = acc + mbit if COUNT else acc | mbit
    return s, acc, swarm
