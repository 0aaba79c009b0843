"""Exact transfer-composition tier (phi): no speculation, no host repair.

Counterpart of the JAX package's ops/pallas_phi.py.  The speculative
tiers bet that a chunk's entry state is settled by its warmup window.
Machines whose state depends on history with no bound (the parity of a
run, b(?:aa)*b; a residue mod n, b(?:a{499})*b) lose that bet on most
chunks whatever the window, and the speculative folds then repair those
chunks one by one on the host.  This tier computes, per chunk, the whole
transfer function instead: the exit state and the match count (COUNT)
or the first match offset (scan) from EVERY entry state.  The chunks'
transfers then compose associatively on the device, and only a small
summary comes back.  Exact by construction: nothing to validate and
nothing to repair.

Two layouts, as in the JAX package, both [B, P, G, 8, 128] int32 words
with chunk c covering exactly bytes [c*K, (c+1)*K) (no warmup, no
overlap; the ragged tail finishes on the host from the composed exit):

  - lane-packed (PhiTables, S <= 128): a tile's 128 lanes hold nseg =
    128 // S chunk segments of S entry states each, so each sublane of
    a tile carries nseg chunks.  Word w of segment seg lies at
    [plane w // WL, lane (w % WL) * nseg + seg] (WL = 128 // nseg), so
    neighbouring segments read neighbouring words.  K is a multiple of
    64 bytes.
  - sublane-group (PhiTablesBig, 128 < S <= 1024): a chunk's entry
    states are striped over SB = pow2(ceil(S / 128)) sublanes, CPT =
    8 // SB chunks per tile; the chunk's word w lies at [plane w // 128,
    lane w % 128], copied into each of its SB sublanes.  K is a
    multiple of 128 bytes.

The kernels (csrc/phi_scan.cu) replace pallas_phi.py::_phi_kernel and
::_phi_kernel_big; phi_scan_ref and phi_big_scan_ref are their plain
versions.  Both kernels walk KS classes a lookup through a k-gram table
built here from the fused table (stride_table, cached by the tables'
stride()); phi_stride_ref and phi_big_stride_ref are plain models of
those walks, held against the plain versions by the CPU tests.  The
composition (the JAX package's _compose, jnp there) is torch ops: a
binary tree of gathers for COUNT, and for scan the same tree kept level
by level (up-sweep) and walked down along the one path the true entry
state takes (down-sweep), which gives every chunk's entry state and so
the first firing chunk.
"""

import ctypes
import os

import numpy as np
import torch

from .. import diag
from .layout import _MATCH_SHIFT, _STATE_MASK, DEFAULT_K, GROUPS, \
    SMEM_TABLE_MAX, TILE
from .prep import _class_ids, _host_u8
from .spec_scan import _CPW, _host_bytes, fused_table, resolve_device

_SENT = 1 << 30          # "no match" in the scan-mode acc plane
_PACK_CHUNKS = 1 << 16   # chunks class-packed per step of the prep
# int32 entries a stride kernel may stage in a block's shared memory
# (227 KB): the k-gram table, the fused table and its padding
STRIDE_SMEM_ENTRIES = 232448 // 4
# a k-gram entry: the next row's byte offset at bit 14, below it the
# k steps' match count or first match (csrc/phi_scan.cu, kOffShift)
_OFF_SHIFT = 14

# kernel launches since the last reset (the CUDA path only)
phi_scan_launches = 0
phi_big_scan_launches = 0


class _PhiTables:
    """What both layouts carry: dfa, nstates, ncls, rows, the flat fused
    table ``fused`` (int32 [rows*128], next*ncls | match << 20) on
    ``device``, bits/cpw (4-bit classes when ncls <= 16, else 8-bit),
    class_map, match_eof and last_repair (Scanner.stats(); a completed
    phi scan never repairs, so it records (0, C)); the kernel's k-gram
    tables (stride)."""

    last_repair = None
    STRIDE_KS = (4, 2)       # the k stride_k may choose, largest first

    def _finish(self, dfa):
        S, ncls = dfa.nstates, dfa.nclasses
        self.dfa = dfa
        self.nstates = S
        self.ncls = ncls
        self.fused = torch.from_numpy(fused_table(dfa, self.rows)).to(
            self.device)
        self.class_map = dfa.class_map.astype(np.uint8)
        self.bits = 4 if ncls <= 16 else 8
        self.cpw = _CPW[self.bits]
        self.match_eof = dfa.match_eof
        self._strides = {}

    def stride(self, count, k=None):
        """(k, the k-gram table on the tables' device) for the kernel in
        COUNT mode ``count``; k defaults to stride_k's choice.  Built once
        per (k, mode)."""
        k = stride_k(self.nstates, self.ncls, self.cpw, self.fused.numel(),
                     self.STRIDE_KS) if k is None else k
        hit = self._strides.get((k, bool(count)))
        if hit is None:
            hit = torch.from_numpy(stride_table(
                self.fused.cpu().numpy(), self.nstates, self.ncls, k,
                count)).to(self.device)
            self._strides[(k, bool(count))] = hit
        return k, hit


class PhiTables(_PhiTables):
    """Lane-packed phi tables: S <= 128 plain states, S * ncls <= 1024
    entries (the never-converging machines this tier exists for are
    small), nseg = 128 // S chunk segments per lane row."""

    MAX_STATES = 128
    MAX_ENTRIES = 1024
    STRIDE_KS = (8, 4, 2)

    def __init__(self, dfa, device):
        S, ncls = dfa.nstates, dfa.nclasses
        if S > self.MAX_STATES:
            raise ValueError("more than 128 plain states (%d)" % S)
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        if S * ncls > self.MAX_ENTRIES:
            raise ValueError("S*ncls = %d exceeds the phi budget"
                             % (S * ncls))
        self.device = resolve_device(device)
        self.rows = -(-(S * ncls) // 128)
        self.nseg = max(1, 128 // S)
        self._finish(dfa)


class PhiTablesBig(_PhiTables):
    """Sublane-group phi tables for 128 < S <= 1024 plain states.  The
    table may hold at most _row_cap() rows of 128 entries: 64 on the
    card, 32 on the CPU (the JAX package's caps on the TPU and in
    interpret mode, so both packages accept the same machines), or
    SREGEX_PHI_MAX_ROWS.  Per byte the work is O(S) by construction: a
    dense transfer follows S trajectories."""

    MAX_STATES = 1024

    def _row_cap(self):
        env = os.environ.get("SREGEX_PHI_MAX_ROWS")
        if env is not None:
            return int(env)
        return 64 if self.device.type != "cpu" else 32

    def __init__(self, dfa, device):
        S, ncls = dfa.nstates, dfa.nclasses
        if S <= 128:
            raise ValueError("S <= 128 rides PhiTables")
        if S > self.MAX_STATES:
            raise ValueError("more than %d plain states (%d)"
                             % (self.MAX_STATES, S))
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        self.device = resolve_device(device)
        self.rows = -(-(S * ncls) // 128)
        if self.rows > self._row_cap():
            raise ValueError("S*ncls = %d exceeds the big-phi row "
                             "budget" % (S * ncls))
        sb = -(-S // 128)
        self.SB = 1 << (sb - 1).bit_length()     # power-of-two group
        self.CPT = 8 // self.SB                  # chunks per tile
        self._finish(dfa)


def stride_k(S, ncls, cpw, table_len, ks=(4, 2)):
    """The classes a lookup of a phi kernel: the largest k in ``ks`` (the
    sublane-group kernel's (4, 2), the lane-packed one's (8, 4, 2)), or
    1, dividing ``cpw`` whose k-gram table (S * ncls**k entries) fits
    shared memory beside the padded fused table (on the card the
    kernels' time falls with k: PERF.md)."""
    for k in ks:
        if cpw % k == 0 and S * ncls ** k + table_len + 256 \
                <= STRIDE_SMEM_ENTRIES:
            return k
    return 1


def stride_table(fused, S, ncls, k, count):
    """The k-gram table of a fused table (int32 [rows*128], entry
    q*ncls + c = next*ncls | match << 20) over S states: int32
    [S * ncls**k], entry q * ncls**k + g for the classes c_0 .. c_{k-1}
    of g = sum(c_t * ncls**t), each below ncls, holds the state after
    the k steps from q as the byte offset q' * ncls**k * 4 of its row,
    shifted to bit 14, and below it the sum of the steps' match fields
    (``count``) or 1 + the first step whose match field is nonzero (0:
    none).  Raises
    ValueError unless every entry of the fused table holds a
    premultiplied state below S * ncls and a match field in [0, 127]:
    the kernel's slow path reads any entry, and its result must land on
    a row of this table."""
    f = np.asarray(fused, dtype=np.int64)
    st, m = f & _STATE_MASK, f >> _MATCH_SHIFT
    if (st % ncls).any() or (st >= S * ncls).any() \
            or (m < 0).any() or (m > 127).any():
        raise ValueError("the fused table holds an entry the k-gram walk "
                         "cannot take")
    M = ncls ** k
    if 4 * S * M >= 1 << (32 - _OFF_SHIFT):
        raise ValueError("S * ncls**k = %d is past the k-gram budget"
                         % (S * M))
    g = np.arange(M, dtype=np.int64)[None, :]
    cur = np.arange(S, dtype=np.int64)[:, None] * ncls + 0 * g
    acc = np.zeros_like(cur)
    for t in range(k):
        e = f[cur + (g // ncls ** t) % ncls]
        mt = e >> _MATCH_SHIFT
        if count:
            acc += mt
        else:
            acc = np.where((acc == 0) & (mt > 0), t + 1, acc)
        cur = e & _STATE_MASK
    out = (cur // ncls) * (M * 4) << _OFF_SHIFT | acc
    return out.reshape(-1).astype(np.uint32).view(np.int32)


# --- prep --------------------------------------------------------------------

def _chunk_words(tables, cls, lo, hi, K):
    """int32 [hi - lo, K // cpw]: chunks lo..hi-1 of the class ids
    ``cls``, cpw classes per word, class k in bits [bits*k, bits*(k+1))
    (8-bit packing wraps into the sign bit, as the JAX prep does)."""
    cpw, bits = tables.cpw, tables.bits
    c = cls[lo * K:hi * K].view(hi - lo, K // cpw, cpw)
    words = c[..., 0].to(torch.int32)
    for k in range(1, cpw):
        words |= c[..., k].to(torch.int32) << (bits * k)
    return words


def _class_chunks(tables, data, C, K, Cp):
    """uint8 [Cp*K] on tables.device: the class ids of the C full chunks,
    then zeros.  ``data`` is bytes, a uint8 ndarray or a uint8 tensor
    (on the device already: then nothing crosses)."""
    if not isinstance(data, torch.Tensor):
        data = _host_u8(data)
    return _class_ids(tables, data, C * K, Cp * K, 0, None)


def _phi_prepare(tables, data, chunk_len):
    """Pack the full chunks into the lane-packed layout.  Returns
    (data int32 [B, P, G, 8, 128] on tables.device, C, K, WL, P, B),
    bit-identical to the JAX package's _phi_prepare."""
    K = max(64, (chunk_len // 64) * 64)
    C = len(data) // K              # full chunks only (the tail on host)
    nseg = tables.nseg
    G = GROUPS
    per_blk = G * 8 * nseg
    B = max(1, -(-C // per_blk))
    Kw = K // tables.cpw
    WL = 128 // nseg                # words per plane per segment
    P = -(-Kw // WL)
    cls = _class_chunks(tables, data, C, K, B * per_blk)
    out = torch.zeros((B, P, G, 8, 128), dtype=torch.int32,
                      device=tables.device)
    step = max(1, _PACK_CHUNKS // per_blk)
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        words = _chunk_words(tables, cls, b0 * per_blk, b1 * per_blk, K)
        words = torch.nn.functional.pad(words, (0, P * WL - Kw))
        # [b, g, s, seg, p, o] -> [b, p, g, s, o, seg]: lane o*nseg + seg
        words = words.view(b1 - b0, G, 8, nseg, P, WL) \
            .permute(0, 4, 1, 2, 5, 3)
        out[b0:b1, ..., :WL * nseg] = words.reshape(
            b1 - b0, P, G, 8, WL * nseg)
    return out, C, K, WL, P, B


def _phi_prepare_big(tables, data, chunk_len):
    """Pack the full chunks into the sublane-group layout.  Returns
    (data int32 [B, P, G, 8, 128], C, K, None, P, B), bit-identical to
    the JAX package's _phi_prepare_big: word w of the chunk owning
    sublane group t lies at [b, w // 128, g, t*SB + i, w % 128] for each
    i < SB."""
    K = max(128, (chunk_len // 128) * 128)
    C = len(data) // K
    G = GROUPS
    SB, CPT = tables.SB, tables.CPT
    per_blk = G * CPT
    B = max(1, -(-C // per_blk))
    Kw = K // tables.cpw
    P = -(-Kw // 128)
    cls = _class_chunks(tables, data, C, K, B * per_blk)
    out = torch.empty((B, P, G, 8, 128), dtype=torch.int32,
                      device=tables.device)
    step = max(1, _PACK_CHUNKS // per_blk)
    for b0 in range(0, B, step):
        b1 = min(B, b0 + step)
        words = _chunk_words(tables, cls, b0 * per_blk, b1 * per_blk, K)
        words = torch.nn.functional.pad(words, (0, P * 128 - Kw))
        words = words.view(b1 - b0, G, CPT, 1, P, 128) \
            .expand(b1 - b0, G, CPT, SB, P, 128)
        out[b0:b1] = words.permute(0, 4, 1, 2, 3, 5).reshape(
            b1 - b0, P, G, 8, 128)
    return out, C, K, None, P, B


def phi_prepare(tables, data, chunk_len=DEFAULT_K):
    """The layout's prep: lane-packed for PhiTables, sublane-group for
    PhiTablesBig; a sregex.prep span (diag)."""
    with diag.span("sregex.prep", len(data)):
        if isinstance(tables, PhiTablesBig):
            return _phi_prepare_big(tables, data, chunk_len)
        return _phi_prepare(tables, data, chunk_len)


# --- the kernels' wrappers and plain versions -------------------------------

def _check_phi_args(data, table, Kw, CPW, BITS, words_per_plane):
    for t in (data, table):
        if not isinstance(t, torch.Tensor):
            raise TypeError("phi scans take tensors, got %r" % type(t))
        if t.dtype != torch.int32:
            raise TypeError("phi scans take int32 tensors, got %s"
                            % t.dtype)
        if not t.is_contiguous():
            raise ValueError("phi scans take contiguous tensors")
    if table.device != data.device:
        raise ValueError("phi scan tensors lie on different devices "
                         "(%s, %s)" % (data.device, table.device))
    if data.dim() != 5 or tuple(data.shape[3:]) != (8, TILE // 8):
        raise ValueError("data must be [B, P, G, 8, 128], got %s"
                         % (tuple(data.shape),))
    n = table.numel()
    if table.dim() != 1 or n == 0 or n % 128 or n > SMEM_TABLE_MAX:
        raise ValueError("table must be int32 [R*128] with at most %d "
                         "entries, got %s" % (SMEM_TABLE_MAX,
                                              tuple(table.shape)))
    if BITS not in (4, 8) or _CPW[BITS] != CPW:
        raise ValueError("phi scans pack 4 or 8 bits (CPW 8 or 4), got "
                         "BITS=%r CPW=%r" % (BITS, CPW))
    if not 0 < Kw <= data.shape[1] * words_per_plane:
        raise ValueError("Kw=%d words do not fit %d planes of %d"
                         % (Kw, data.shape[1], words_per_plane))


def _launch(entry, data, table, extra):
    """Launch the C entry point ``entry`` of the kernel library on the
    current stream, without synchronising: (data, table, table_len, phi,
    acc, B, P, G, *extra, stream).  Returns the (phi, acc) planes, int32
    [B, G, 8, 128], allocated here.  Raises when the launch fails."""
    from . import _build
    fn = getattr(_build.load(), entry)
    B, P, G = data.shape[:3]
    phi = torch.empty((B, G, 8, 128), dtype=torch.int32, device=data.device)
    acc = torch.empty_like(phi)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(data.data_ptr(), table.data_ptr(), table.numel(),
                phi.data_ptr(), acc.data_ptr(), B, P, G, *extra,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (entry, rc))
    return phi, acc


def _check_stride(stride, data, S, NCLS, CPW):
    """(k, the k-gram table) checked against the kernel's shapes."""
    k, ktab = stride
    if ktab.dtype != torch.int32 or ktab.device != data.device \
            or ktab.numel() != S * NCLS ** k or CPW % k:
        raise ValueError("stride must be (k, int32 [S*NCLS**k]) on the "
                         "data's device with k dividing CPW")
    return k, ktab


def phi_scan(data, table, *, Kw, WL, CPW, BITS, S, NSEG, NCLS, COUNT,
             stride):
    """Run the lane-packed phi kernel.  data int32 [B, P, G, 8, 128] in
    the lane-packed layout (Kw words per chunk, WL per plane, NSEG
    segments of S lanes); table int32 [R*128], the fused table of a
    machine with NCLS classes, every entry a premultiplied state below
    S*NCLS.  Returns (phi, acc), int32 [B, G, 8, 128]: per lane the
    premultiplied exit state and the match count (COUNT) or the first
    match offset in the chunk (_SENT when none).  Lanes >= NSEG*S are
    padding (the kernel leaves them unwritten).  ``stride`` = (k, the
    k-gram table of ``table`` for this COUNT mode on the same device,
    from stride_table), e.g. PhiTables.stride(COUNT); the plain version
    on the CPU does not read it.

    CUDA tensors launch sre_phi_scan (csrc/phi_scan.cu) on the current
    stream or raise; CPU tensors take phi_scan_ref."""
    global phi_scan_launches
    _check_phi_args(data, table, Kw, CPW, BITS, WL)
    if not (0 < S <= 128 and NSEG == max(1, 128 // S)
            and WL == 128 // NSEG):
        raise ValueError("S=%r, NSEG=%r, WL=%r is not a lane-packed layout"
                         % (S, NSEG, WL))
    if data.device.type == "cpu":
        return phi_scan_ref(data, table, Kw=Kw, WL=WL, CPW=CPW, BITS=BITS,
                            S=S, NSEG=NSEG, NCLS=NCLS, COUNT=COUNT)
    if data.device.type != "cuda":
        raise ValueError("phi_scan runs on cuda or cpu tensors, got %s"
                         % data.device)
    k, ktab = _check_stride(stride, data, S, NCLS, CPW)
    out = _launch("sre_phi_scan", data, table,
                  (Kw, WL, BITS, S, NSEG, NCLS, int(bool(COUNT)),
                   ktab.data_ptr(), ktab.numel(), k))
    phi_scan_launches += 1
    return out


def phi_big_scan(data, table, *, Kw, CPW, BITS, S, SB, NCLS, COUNT,
                 stride):
    """Run the sublane-group phi kernel.  data int32 [B, P, G, 8, 128]
    in the sublane-group layout (Kw words per chunk, 128 per plane; the
    S entry states of a chunk striped over SB sublanes);
    table and the result as phi_scan, every table entry a premultiplied
    state below S*NCLS.  Slots whose entry state would be >= S are
    padding (they run from state S - 1).  ``stride`` = (k, the k-gram
    table of ``table`` for this COUNT mode on the same device, from
    stride_table), e.g. PhiTablesBig.stride(COUNT); the plain version
    on the CPU does not read it.

    CUDA tensors launch sre_phi_big_scan (csrc/phi_scan.cu) on the
    current stream or raise; CPU tensors take phi_big_scan_ref."""
    global phi_big_scan_launches
    _check_phi_args(data, table, Kw, CPW, BITS, 128)
    if SB not in (1, 2, 4, 8) or not 0 < S <= SB * 128:
        raise ValueError("S=%r does not fit SB=%r sublanes" % (S, SB))
    if data.device.type == "cpu":
        return phi_big_scan_ref(data, table, Kw=Kw, CPW=CPW, BITS=BITS,
                                S=S, SB=SB, NCLS=NCLS, COUNT=COUNT)
    if data.device.type != "cuda":
        raise ValueError("phi_big_scan runs on cuda or cpu tensors, got %s"
                         % data.device)
    k, ktab = _check_stride(stride, data, S, NCLS, CPW)
    out = _launch("sre_phi_big_scan", data, table,
                  (Kw, BITS, S, SB, NCLS, int(bool(COUNT)),
                   ktab.data_ptr(), ktab.numel(), k))
    phi_big_scan_launches += 1
    return out


def _phi_walk(data, table, entry, word_at, Kw, CPW, BITS, COUNT):
    """The plain loop both plain versions share: Kw words of CPW classes,
    vectorised over every slot.  ``entry`` int32 [8, 128] premultiplied
    entry states; ``word_at(w)`` the slots' word w.  An index outside
    the table reads entry (index & 127), as the kernels do.

    Each word's codes are taken out of it once and the out-of-table
    rule is folded into padded tables of the next state and the match
    field, so a step is two gathers; scan mode keeps the least position
    of a match (a gather of 0 or _SENT, plus the position)."""
    B, _, G = data.shape[:3]
    dev = data.device
    cmask = (1 << BITS) - 1
    t = table.reshape(-1).long()
    n = t.numel()
    ent = entry.expand(B, G, 8, 128).reshape(-1).long()
    hi = max(n, int((t & _STATE_MASK).max()) + 1, int(ent.max()) + 1)
    i = torch.arange(hi + cmask + 1, device=dev)
    e = t[torch.where(i < n, i, i & 127)]
    # int32 throughout: half the bytes of int64 a step on the card
    nxt = (e & _STATE_MASK).to(torch.int32)
    m = (e >> _MATCH_SHIFT).to(torch.int32)
    pen = torch.where(m > 0, 0, _SENT).to(torch.int32)
    shifts = torch.arange(0, BITS * CPW, BITS, dtype=torch.int32,
                          device=dev).view(CPW, 1)
    sel = torch.index_select
    shape = (B, G, 8, 128)
    state = ent.to(torch.int32)
    acc = torch.full_like(state, 0 if COUNT else _SENT)
    for w in range(Kw):
        word = word_at(w).expand(shape).reshape(1, -1).to(torch.int32)
        cw = (word >> shifts) & cmask
        for k in range(CPW):
            idx = state + cw[k]
            if COUNT:
                acc += sel(m, 0, idx)
            else:
                acc = torch.minimum(acc, sel(pen, 0, idx) + (w * CPW + k))
            state = sel(nxt, 0, idx)
    return state.reshape(shape), acc.reshape(shape)


def phi_scan_ref(data, table, *, Kw, WL, CPW, BITS, S, NSEG, NCLS, COUNT):
    """The plain torch version of phi_scan, on any device.  A padding
    lane (>= NSEG*S) reads data lane min(seg + o*NSEG, 127), as the
    kernel does."""
    lanes = torch.arange(128, dtype=torch.int32, device=data.device)
    seg = lanes // S
    entry = ((lanes - seg * S) * NCLS).expand(8, 128)
    didx = [(seg + o * NSEG).clamp(max=127).long() for o in range(WL)]

    def word_at(w):
        return data[:, w // WL].index_select(-1, didx[w % WL])

    return _phi_walk(data, table, entry, word_at, Kw, CPW, BITS, COUNT)


def phi_big_scan_ref(data, table, *, Kw, CPW, BITS, S, SB, NCLS, COUNT):
    """The plain torch version of phi_big_scan, on any device."""
    subl = torch.arange(8, dtype=torch.int32, device=data.device)[:, None]
    lanes = torch.arange(128, dtype=torch.int32, device=data.device)
    entry = (((subl % SB) * 128 + lanes).clamp(max=S - 1) * NCLS)

    def word_at(w):
        o = w % 128
        return data[:, w // 128, ..., o:o + 1]

    return _phi_walk(data, table, entry, word_at, Kw, CPW, BITS, COUNT)


def _stride_walk(data, table, stride, q0, word_at, Kw, CPW, BITS, NCLS,
                 COUNT):
    """The plain loop of both kernels' k-gram walks: slots hold their
    k-gram row as a byte offset (the entry's high bits); a word whose
    classes are all below NCLS takes k classes a lookup in the k-gram
    table ``stride`` = (k, int32 [S*NCLS**k]); any other word steps its
    classes one at a time through the fused table padded with entry
    (index & 127) past its end.  ``q0`` int64 [8, 128] the slots' plain
    entry states; ``word_at(w)`` the slots' word w."""
    k, ktab = stride
    ktab = ktab.to(data.device).long() & 0xFFFFFFFF
    fmask = (1 << _OFF_SHIFT) - 1
    n = table.numel()
    pad = torch.cat([table, table[torch.arange(n, n + (1 << BITS),
                                               device=data.device) & 127]])
    M = NCLS ** k
    unit = 4 * M // NCLS
    cmask = (1 << BITS) - 1
    B, _, G = data.shape[:3]
    s = (q0 * (M * 4)).expand(B, G, 8, 128).long()
    acc = torch.full_like(s, 0 if COUNT else _SENT)
    for w in range(Kw):
        word = word_at(w).long() & 0xFFFFFFFF
        cls = [(word >> (BITS * j)) & cmask for j in range(CPW)]
        fast = torch.stack([c < NCLS for c in cls]).all(0)
        s_f, acc_f = s.clone(), acc.clone()
        for gi in range(CPW // k):
            g = sum(torch.where(fast, cls[gi * k + t], 0) * NCLS ** t
                    for t in range(k))
            e = ktab[s_f // 4 + g]
            f = e & fmask
            if COUNT:
                acc_f = acc_f + f
            else:
                acc_f = torch.where((f != 0) & (acc_f == _SENT),
                                    w * CPW + gi * k + f - 1, acc_f)
            s_f = e >> _OFF_SHIFT
        s1 = s // unit
        acc_s = acc.clone()
        for j in range(CPW):
            e = pad[s1 + cls[j]].long()
            if COUNT:
                acc_s = acc_s + (e >> _MATCH_SHIFT)
            else:
                acc_s = torch.where(((e >> _MATCH_SHIFT) > 0)
                                    & (acc_s == _SENT), w * CPW + j, acc_s)
            s1 = e & _STATE_MASK
        s = torch.where(fast, s_f, s1 * unit)
        acc = torch.where(fast, acc_f, acc_s)
    return (s // unit).to(torch.int32), acc.to(torch.int32)


def phi_stride_ref(data, table, stride, *, Kw, WL, CPW, BITS, S, NSEG,
                   NCLS, COUNT):
    """A plain torch model of the lane-packed kernel's k-gram walk
    (_stride_walk), on any device.  Equal to phi_scan_ref on the slots
    below NSEG*S wherever stride_table accepts the table
    (tests/test_torch_phi.py)."""
    lanes = torch.arange(128, device=data.device)
    seg = lanes // S
    q0 = (lanes - seg * S).expand(8, 128)
    didx = [(seg + o * NSEG).clamp(max=127) for o in range(WL)]

    def word_at(w):
        return data[:, w // WL].index_select(-1, didx[w % WL])

    return _stride_walk(data, table, stride, q0, word_at, Kw, CPW, BITS,
                        NCLS, COUNT)


def phi_big_stride_ref(data, table, stride, *, Kw, CPW, BITS, S, SB, NCLS,
                       COUNT):
    """A plain torch model of the sublane-group kernel's k-gram walk
    (_stride_walk), on any device: every slot reads word w from its own
    sublane.  Equal to phi_big_scan_ref wherever stride_table accepts
    the table (tests/test_torch_phi.py)."""
    subl = torch.arange(8, device=data.device)[:, None]
    lanes = torch.arange(128, device=data.device)
    q0 = ((subl % SB) * 128 + lanes).clamp(max=S - 1)

    def word_at(w):
        o = w % 128
        return data[:, w // 128, ..., o:o + 1]

    return _stride_walk(data, table, stride, q0, word_at, Kw, CPW, BITS,
                        NCLS, COUNT)


# --- composition and the summary --------------------------------------------

def _compose(phi_cs, acc_cs, K, entry_state, COUNT):
    """Compose the chunks' transfers in order; phi_cs/acc_cs int32
    [N, S] with N a power of two (plain exit states; counts or in-chunk
    first offsets).  Returns the summary as an int64 CPU tensor:

    COUNT: [exit_plain, total_count]
    scan : [exit_plain, first_abs or -1, fire_chunk or -1,
            fire_entry_plain]

    COUNT is a binary tree of gathers over ordered pairs (the JAX
    package's tree reduce).  Scan keeps the tree's levels (the
    up-sweep) and walks down along the path of the true entry state
    only: a left child enters where its parent enters, a right child
    where the left child leaves.  That gives every chunk's entry; the
    first chunk whose offset from its entry is not _SENT fires, and
    fire_chunk * K + offset is the first match (the JAX package's
    associative scan over (phi, fm_abs) gives the same)."""
    dev = phi_cs.device
    e0 = int(entry_state)
    if COUNT:
        p, c = phi_cs, acc_cs
        while p.shape[0] > 1:
            idx = p[0::2].long()       # ordered adjacent pairs
            c = c[0::2] + torch.gather(c[1::2], 1, idx)
            p = torch.gather(p[1::2], 1, idx)
            del idx
        return diag.read_back(torch.stack([p[0, e0], c[0, e0]])).long()
    levels = [phi_cs]
    while levels[-1].shape[0] > 1:
        p = levels[-1]
        levels.append(torch.gather(p[1::2], 1, p[0::2].long()))
    ent = torch.full((1,), e0, dtype=torch.int64, device=dev)
    for p in reversed(levels[:-1]):
        right = p[0::2].gather(1, ent[:, None])[:, 0].long()
        ent = torch.stack([ent, right], 1).reshape(-1)
    exit_plain = levels[-1][0, e0].long()
    del levels
    fm = acc_cs.gather(1, ent[:, None])[:, 0]
    hit = fm != _SENT
    fc = hit.to(torch.int8).argmax()       # first firing chunk (0: none)
    fired = hit[fc]
    first = torch.where(fired, fc * K + fm[fc].long(), -1)
    return diag.read_back(torch.stack([
        exit_plain, first, torch.where(fired, fc, -1),
        torch.where(fired, ent[fc], e0)]))


def chunk_slots(tables, x):
    """A kernel plane [B, G, 8, 128] as [chunks, S]: row c holds chunk
    c's slots in entry-state order (chunk c = (b, g, sublane, segment)
    lane-packed, (b, g, sublane group) sublane-group)."""
    S = tables.nstates
    if isinstance(tables, PhiTablesBig):
        return x.reshape(-1, tables.SB * 128)[:, :S]
    return x[..., :tables.nseg * S].reshape(-1, S)


def _summary(tables, phi, acc, C, K, entry_state, COUNT):
    """The kernel planes -> the composed summary.  Chunks >= C (and the
    padding up to a power of two) compose as identities."""
    phi_c, acc_c = chunk_slots(tables, phi), chunk_slots(tables, acc)
    S = tables.nstates
    n2 = 1 << max(0, C - 1).bit_length()
    dev = phi.device
    phi_cs = torch.arange(S, dtype=torch.int32, device=dev).repeat(n2, 1)
    phi_cs[:C] = phi_c[:C] // tables.ncls
    acc_cs = torch.full((n2, S), 0 if COUNT else _SENT, dtype=torch.int32,
                        device=dev)
    acc_cs[:C] = acc_c[:C]
    del phi_c, acc_c
    return _compose(phi_cs, acc_cs, K, entry_state, COUNT)


def _phi_dispatch(tables, prepared, C, entry_state, COUNT):
    """Kernel and composition over a prepared corpus of C >= 1 full
    chunks.  Returns the summary (int64 numpy, see _compose); one small
    readback."""
    diag.phase("sregex.launch")
    data, _, K, WL, _, _ = prepared
    kw = dict(Kw=K // tables.cpw, CPW=tables.cpw, BITS=tables.bits,
              S=tables.nstates, NCLS=tables.ncls, COUNT=COUNT)
    if isinstance(tables, PhiTablesBig):
        phi, acc = phi_big_scan(data, tables.fused, SB=tables.SB,
                                stride=tables.stride(COUNT), **kw)
    else:
        phi, acc = phi_scan(data, tables.fused, WL=WL, NSEG=tables.nseg,
                            stride=tables.stride(COUNT), **kw)
    diag.phase("sregex.summary")
    return _summary(tables, phi, acc, C, K, entry_state, COUNT).numpy()


def phi_count_bytes(tables, data_np, chunk_len=DEFAULT_K, entry_state=0,
                    prepared=None):
    """Count every match boundary 0..n-1; returns (final_state, count).
    The EOF boundary is the caller's (tables.match_eof).  Exact with no
    speculation and no repair; the ragged tail and a corpus of no full
    chunk run on the native engine."""
    from ..native import NativeDfa
    n = len(data_np)
    if n == 0:
        return entry_state, 0
    if prepared is None:
        prepared = phi_prepare(tables, data_np, chunk_len)
    _, C, K, _, _, _ = prepared
    native = NativeDfa(tables.dfa)
    if C == 0:
        return native.count(bytes(data_np), entry_state)[::-1]
    summ = _phi_dispatch(tables, prepared, C, entry_state, True)
    state, total = int(summ[0]), int(summ[1])
    if C * K < n:                    # the ragged tail, natively
        k, state = native.count(_host_bytes(data_np)[C * K:].tobytes(),
                                state)
        total += k
    tables.last_repair = (0, C)
    return state, total


def phi_scan_bytes(tables, data_np, chunk_len=DEFAULT_K, entry_state=0,
                   prepared=None):
    """First match boundary, with spec_scan_bytes' contract: (state,
    boundary or -1), the state AT the boundary on a match.  One native
    scan of the firing chunk from its exact entry pins the boundary."""
    from ..native import NativeDfa
    n = len(data_np)
    if n == 0:
        return entry_state, -1
    if prepared is None:
        prepared = phi_prepare(tables, data_np, chunk_len)
    _, C, K, _, _, _ = prepared
    native = NativeDfa(tables.dfa)
    raw = _host_bytes(data_np)
    state = entry_state
    tables.last_repair = None     # set on completed no-match scans
    if C > 0:
        summ = _phi_dispatch(tables, prepared, C, entry_state, False)
        state, first, fch, fentry = (int(v) for v in summ)
        if first >= 0:
            lo = fch * K
            f, st = native.scan_first(raw[lo:lo + K].tobytes(), fentry)
            return st, lo + f
    if C * K < n:
        f, st = native.scan_first(raw[C * K:].tobytes(), state)
        if f >= 0:
            return st, C * K + f
        state = st
    tables.last_repair = (0, C)
    return state, -1
