"""Piecewise-affine tier: counted-repetition automata at a cost per byte
that does not grow with the state count.

Counterpart of the JAX package's ops/pallas_affine.py.  Counted
repetitions (`a{400,499}b` -> 402 states) are counting chains: their
transition function is piecewise affine in the state id,

    next(s, c) = s + d[p, c]   (relative: the chain advances)
              or   t[p, c]     (absolute: reset / dead / accept hop)

with p the piece that holds s, and a few pieces cover hundreds of
states.  A step is then a piece search over P - 1 breakpoints, one
lookup in a [P * ncls] table and a select (affine_scan_ref).  The card's
kernel (csrc/affine_scan.cu) walks a re-laid copy of the table
(relay_table): an 8-byte entry for every piece and class code, found
with no multiply and no guard, and one multiply-add a step;
affine_relaid_ref is a plain model of that walk.
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

import ctypes
from collections import namedtuple

import numpy as np
import torch

from .layout import SMEM_BYTES, max_chunk_bytes
from .spec_scan import _CPW, _Tables, _check_scan_args, launch_planes

_VAL_MASK = (1 << 27) - 1     # |delta*ncls + OFF| or absolute premult
_MODE_BIT = 28                # 1 = relative (state + delta)
_MATCH_BIT = 30
MAX_PIECES = 48               # the lookup table stays small
MAX_ENTRIES = 1 << 26         # S * ncls cap (premult fits the mask)

# kernel launches since the last reset (the CUDA path only)
affine_scan_launches = 0

# The kernel's table (relay_table): ``bp`` the breakpoints and ``offsets``
# the byte offsets of the P rows, as tuples; ``table`` int32
# [P * 2**bits * 2] and ``pieces`` int32 [2P - 1] (bp, then offsets) on
# the device; ``host`` the pieces as a ctypes int32 array.
Relaid = namedtuple("Relaid", "bp offsets table pieces host")


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
    = S * ncls; ``relaid`` the kernel's table (relay_table).  States may
    be renumbered (``perm``, ``inv``)."""

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
        self.relaid = relay_table(flat, self.bp_premult, ncls, self.bits,
                                  self.off, self.device)

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

    def _kernel(self, data, state0, j0, W, COUNT):
        return affine_scan(data, state0, j0, self.fused, self.bp, W=W,
                           CPW=self.cpw, BITS=self.bits, NCLS=self.ncls,
                           OFF=self.off, COUNT=COUNT, relaid=self.relaid)


def relay_table(fused, bp, ncls, bits, off, device):
    """The kernel's table for the fused table ``fused`` (int32 numpy
    [R*128]) of a machine with breakpoints ``bp`` (sorted premultiplied,
    P - 1 of them), ``ncls`` classes, BITS-bit class codes and OFF =
    S * ncls: a Relaid.

    The row of piece pid starts at byte offsets[pid] = pid << (bits + 3)
    | sw(pid) << 3, and code c's 8-byte entry lies at byte (c << 3) ^
    offsets[pid]: sw(pid) = pid * ncls rounded up to a power of two, mod
    16, puts the entries of up to 16 (piece, class) pairs on distinct
    8-byte banks of shared memory.  The entry of (pid, c), for every code
    below 2**bits, is the pair (add, y) of the entry the plain version
    reads, e = fused[idx] with idx = pid * ncls + c, or idx & 127 past
    the table: add = val - OFF (int32 wrap) where e is relative, else
    val; y = rel << 31 | match.  A step from s is then s * (y >> 31) +
    add, equal to the plain version's under int32 wrap."""
    bp = tuple(int(b) for b in bp)
    if list(bp) != sorted(bp):
        raise ValueError("the breakpoints must be sorted")
    f = np.asarray(fused).astype(np.int64) & 0xFFFFFFFF
    P, n = len(bp) + 1, 1 << bits
    blk = 1 << (ncls - 1).bit_length()
    sw = [(p * blk) % 16 if blk < 16 else 0 for p in range(P)]
    idx = np.arange(P)[:, None] * ncls + np.arange(n)[None, :]
    e = f[np.where(idx < len(f), idx, idx & 127)]
    val = e & _VAL_MASK
    rel = (e >> _MODE_BIT) & 1
    pair = np.stack([np.where(rel == 1, val - int(off), val),
                     rel << 31 | (e >> _MATCH_BIT) & 1], -1)
    out = np.zeros((P, n, 2), np.int64)
    at = np.arange(n)[None, :] ^ np.asarray(sw)[:, None]
    out[np.arange(P)[:, None], at] = pair
    table = (out & 0xFFFFFFFF).astype(np.uint32).view(np.int32).reshape(-1)
    offsets = tuple(p << (bits + 3) | sw[p] << 3 for p in range(P))
    pieces = bp + offsets
    return Relaid(bp, offsets, torch.from_numpy(table).to(device),
                  torch.tensor(pieces, dtype=torch.int32, device=device),
                  (ctypes.c_int32 * len(pieces))(*pieces))


def affine_scan(data, state0, j0, table, bp, *, W, CPW, BITS, NCLS, OFF,
                COUNT, relaid, generic=False):
    """Run the piecewise-affine scan kernel.  data int32 [B, Jw, G, 8,
    128] (CPW BITS-bit classes per word, BITS 4 or 8); state0/j0 int32
    [B, G, 8, 128]; table int32 [R*128]; bp int32 [P-1] sorted
    premultiplied breakpoints; NCLS the class count; OFF = S * NCLS; W
    the warmup in bytes; ``relaid`` the kernel's table of these, from
    relay_table (SpecTablesAffine.relaid); the plain version on the CPU
    does not read it.  Returns (phi, fm, swarm), each int32
    [B, G, 8, 128]; fm is the match count (COUNT) or the 0/1 OR.

    CUDA tensors launch csrc/affine_scan.cu on the current stream (no
    synchronisation) or raise: the kernel templated on P for P <= 8,
    the generic one past it or with ``generic`` (to time it).  CPU
    tensors take affine_scan_ref."""
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
    rt, pc = relaid.table, relaid.pieces
    if len(relaid.bp) != bp.numel() or rt.device != data.device \
            or pc.device != data.device \
            or rt.numel() != 2 * (bp.numel() + 1) << BITS:
        raise ValueError("relaid must be relay_table's Relaid of these "
                         "breakpoints at BITS=%d on the data's device"
                         % BITS)
    planes = launch_planes("sre_affine_scan", data, state0, j0, rt,
                           (W, CPW, BITS, int(bool(COUNT)), pc.data_ptr(),
                            ctypes.addressof(relaid.host), bp.numel(),
                            int(bool(generic))))
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


def _wrap32(x):
    """int64 values as the int32 two's complement wrap of their low
    32 bits, in an int64 tensor."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def affine_relaid_ref(data, state0, j0, relaid, *, W, CPW, BITS, COUNT):
    """A plain torch model of the kernel's walk over its re-laid table
    ``relaid`` (relay_table), on any device: the piece's row offset is
    offsets[pid], pid the count of breakpoints at or below s; the entry
    (add, y) lies at byte (code << 3) ^ offset; s' = s * (y >> 31) + add
    with int32 wrap, and the match is y's bit 0.  Equal to
    affine_scan_ref wherever relay_table was given that function's
    table, breakpoints and OFF (tests/test_torch_affine.py)."""
    cmask = (1 << BITS) - 1
    tab = relaid.table.to(data.device).long().view(-1, 2) & 0xFFFFFFFF
    add, y = _wrap32(tab[:, 0]), tab[:, 1]
    offs = torch.tensor(relaid.offsets, device=data.device)

    def step(s, word, k):
        pid = torch.zeros_like(s)
        for b in relaid.bp:
            pid += (s >= b).long()
        idx = (((word >> (BITS * k)) & cmask) << 3 ^ offs[pid]) >> 3
        yy = y[idx]
        return _wrap32(s * (yy >> 31) + add[idx]), yy & 1

    s = state0.long()
    j0 = j0.long()
    data = data.long()
    for w in range(W // CPW):
        for k in range(CPW):
            nxt, _ = step(s, data[:, w], k)
            s = torch.where(w * CPW + k >= j0, nxt, s)
    swarm = s
    acc = torch.zeros_like(s)
    for w in range(W // CPW, data.shape[1]):
        for k in range(CPW):
            s, m = step(s, data[:, w], k)
            acc = acc + m if COUNT else acc | m
    return tuple(x.to(torch.int32) for x in (s, acc, swarm))
