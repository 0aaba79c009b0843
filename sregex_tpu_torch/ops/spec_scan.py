"""Speculative chunked DFA scan: tables, the scan kernel's wrapper and
its plain version, the on-device validation summary and the host folds.

Counterpart of the JAX package's ops/pallas_scan.py.  The input is
class-mapped, cut into C chunks of K bytes with W warmup bytes from
the preceding chunk, and packed CPW classes per int32 word (ops/prep.py).
Every chunk but the first speculates from state 0 through its warmup;
the summary checks each speculative entry (swarm) against the exit of
the chunk before it (phi), and the host fold repairs what failed with
the native C++ engine, so results are exact whatever the speculation
did.

The kernels replace pallas_scan.py::_kernel, ::_kernel_wide and
::_dispatch_kernel.  csrc/spec_scan.cu is one lookup a class code with
the whole table in shared memory, one stream a thread; the wide tier
runs it.  What bounds it on the card is the integer pipe, not the
lookups' latency or bank conflicts: a step runs ~9.6 instructions,
~6.9 on the integer pipe (the class extract, the index add, a
three-instruction guard against the table's end, the address, the
match fold, the state mask), which set most of the narrow table's 1.03
ms at [120, 260, 8, 8, 128], against 0.31 ms to read its words.  The
narrow tier (and the pair tier's 4-bit tables) therefore run
csrc/pair_scan.cu wherever pair_table holds the table: one lookup per
two class codes in a host-built table that composes the exact one-step
function, guard included, so a code pair costs a byte permute, one
multiply-add for the address, the row mask and the match fold, and the
kernel reads its words at 81% of the card's bandwidth (0.38 ms);
spec_pair_ref is a plain model of its walk.
"""

import copy
import ctypes
import os
from collections import namedtuple

import numpy as np
import torch

from ..native import NativeDfa
from .mesh import fits, shard_planes
from .layout import (_MATCH_SHIFT, _STATE_MASK, DEFAULT_K, GROUPS,
                     SMEM_BYTES, SMEM_TABLE_MAX, TILE, WORDS_PER_ITER,
                     effective_chunk, max_chunk_bytes)

# kernel launches since the last reset (the CUDA path only): the
# one-lookup kernel (sre_spec_scan) and the two-code kernel
# (sre_spec_scan_pair)
spec_scan_launches = 0
pair_scan_launches = 0

_CPW = {3: 10, 4: 8, 8: 4}


def resolve_device(device):
    """torch.device for a tables object or a Scanner.  A CUDA device
    must be usable: there is no silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device %r was asked for, but torch.cuda.is_available() "
                "is False" % str(device))
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r" % str(device))
    return dev


def fused_table(dfa, rows):
    """Flat int32 [rows*128]: entry s*ncls + c = (next*ncls) |
    (match << 20), zero padded (the JAX package's fused encoding)."""
    S, ncls = dfa.nstates, dfa.nclasses
    nxt = np.asarray(dfa.trans, dtype=np.int64) * ncls
    m = np.asarray(dfa.match, dtype=np.int64) << _MATCH_SHIFT
    flat = np.zeros(rows * 128, dtype=np.int32)
    flat[:S * ncls] = (nxt | m).reshape(-1)
    return flat


class _Tables:
    """What the scan folds read from every tier: dfa, ncls (the
    premultiplier), cpw, bits, warmup (bytes), max_chunk, class_map,
    match_eof, rows, the flat fused table on ``device``, ``wide``
    (True: the repair planes come back as 3 int32 planes, else as 4
    uint8 planes, as in the JAX package), and ``pair``, the two-code
    kernel's table (pair_table) where the tier takes that kernel and
    the table holds, else None."""

    # (natively repaired chunks, total chunks) of the last completed
    # no-match scan; None after a matched scan.  Feeds Scanner.stats().
    last_repair = None
    wide = False
    pair = None
    two_code = False     # the tier takes the two-code kernel where it can

    def _finish(self, dfa, fused, device):
        self.dfa = dfa
        self.device = resolve_device(device)
        self.fused = torch.from_numpy(fused).to(self.device)
        self.class_map = dfa.class_map.astype(np.uint8)
        self.match_eof = dfa.match_eof
        if self.two_code:
            self.pair = pair_table(fused, self.ncls, self.nstates,
                                   self.bits, self.device)

    def _kernel(self, data, state0, j0, W, COUNT):
        """One launch of the tier's kernel over ``data`` with this
        object's tables (which lie on data's device)."""
        return spec_scan(data, state0, j0, self.fused, W=W, CPW=self.cpw,
                         BITS=self.bits, COUNT=COUNT, pair=self.pair)

    def _planes(self, data, state0, j0, W, COUNT, mesh=None):
        """The kernel's (phi, fm, swarm) over the whole prep: one launch,
        or one a shard of ``mesh`` (ops/mesh.shard_planes)."""
        return shard_planes(
            self, data, state0, j0, mesh,
            lambda t, d, s, j: t._kernel(d, s, j, W, COUNT))

    def _scan(self, data, state0, j0, C, bad_tail, W, COUNT=False,
              esc=None, summary=True, mesh=None):
        """Kernel + summary (or none, summary=False): (summary int32
        [10] or None, packed planes), both on the lead device."""
        return _summary_and_planes(
            self._planes(data, state0, j0, W, COUNT, mesh), state0, C,
            bad_tail, COUNT, self.wide, esc, summary)


class SpecTables(_Tables):
    """The narrow tier: S * ncls <= 128 (one 128-entry table).  On the
    card its 3- and 4-bit tables take the two-code kernel."""

    two_code = True

    def __init__(self, dfa, device):
        S, ncls = dfa.nstates, dfa.nclasses
        if S * ncls > 128:
            raise ValueError("automaton too large for the 128-entry "
                             "table (S*ncls = %d)" % (S * ncls))
        self.nstates = S
        self.ncls = ncls
        # 4-bit classes (8 per word) by default, 3-bit (10 per word)
        # under SREGEX_PACK_BITS=3 when ncls <= 8, 8-bit when ncls > 16
        want = int(os.environ.get("SREGEX_PACK_BITS", "4"))
        if ncls > 16:
            self.bits = 8
        else:
            self.bits = 3 if (want == 3 and ncls <= 8) else 4
        self.cpw = _CPW[self.bits]
        self.warmup = 4 * self.cpw
        self.rows = 1
        self.max_chunk = max_chunk_bytes(self.cpw)
        self._finish(dfa, fused_table(dfa, 1), device)


class SpecTablesWide(_Tables):
    """Tables of up to MAX_ENTRIES entries (R rows of 128).  On the
    TPU each extra row cost a gather and a select per byte; here the
    whole table sits in shared memory and costs one lookup, so the
    cap is the TPU's hardware cap (16384 entries, 64 KB)."""

    MAX_ENTRIES = 16384
    wide = True

    def __init__(self, dfa, device):
        S, ncls = dfa.nstates, dfa.nclasses
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        if S * ncls > self.MAX_ENTRIES:
            raise ValueError("automaton too large for the wide fused "
                             "table (S*ncls = %d)" % (S * ncls))
        self.nstates = S
        self.ncls = ncls
        self.bits = 4 if ncls <= 16 else 8
        self.cpw = _CPW[self.bits]
        self.warmup = 4 * self.cpw
        self.rows = -(-(S * ncls) // 128)
        self.max_chunk = max_chunk_bytes(self.cpw)
        self._finish(dfa, fused_table(dfa, self.rows), device)


def _check_scan_args(data, state0, j0, table, W, CPW, BITS,
                     max_table=SMEM_TABLE_MAX, extra=(), rows=None):
    """The checks every scan wrapper makes before it launches: int32,
    contiguous, one device, the [B, Jw, G, 8, 128] layout, a table of
    whole 128-entry rows of at most ``max_table`` entries, a packing
    and a warmup that fit.  ``extra`` are further tensors to check;
    ``rows`` the planes' block rows where they are not data's B."""
    tensors = (data, state0, j0, table, *extra)
    for t in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError("spec_scan takes tensors, got %r" % type(t))
        if t.dtype != torch.int32:
            raise TypeError("spec_scan takes int32 tensors, got %s"
                            % t.dtype)
        if not t.is_contiguous():
            raise ValueError("spec_scan takes contiguous tensors")
        if t.device != data.device:
            raise ValueError("spec_scan tensors lie on different devices "
                             "(%s, %s)" % (data.device, t.device))
    if data.dim() != 5 or tuple(data.shape[3:]) != (8, TILE // 8):
        raise ValueError("data must be [B, Jw, G, 8, 128], got %s"
                         % (tuple(data.shape),))
    B, Jw, G = data.shape[:3]
    B = B if rows is None else rows
    for name, t in (("state0", state0), ("j0", j0)):
        if tuple(t.shape) != (B, G, 8, TILE // 8):
            raise ValueError("%s must be %s, got %s"
                             % (name, (B, G, 8, 128), tuple(t.shape)))
    n = table.numel()
    if table.dim() != 1 or n == 0 or n % 128 or n > max_table:
        raise ValueError("table must be int32 [R*128] with at most %d "
                         "entries, got %s" % (max_table,
                                              tuple(table.shape)))
    if _CPW.get(BITS) != CPW:
        raise ValueError("BITS=%r does not pack CPW=%r classes per word"
                         % (BITS, CPW))
    if W < 0 or W % CPW or W > Jw * CPW \
            or (Jw * CPW - W) % (CPW * WORDS_PER_ITER):
        raise ValueError("W=%d units does not fit %d words of %d units"
                         % (W, Jw, CPW))


def spec_scan(data, state0, j0, table, *, W, CPW, BITS, COUNT,
              pair=None):
    """Run the speculative scan kernel.  data int32 [B, Jw, G, 8, 128]
    (CPW BITS-bit classes per word); state0/j0 int32 [B, G, 8, 128];
    table int32 [R*128]; W the warmup in kernel units; ``pair`` None or
    the two-code table pair_table built from ``table`` (the tables'
    ``pair``).  Returns (phi, fm, swarm), each int32 [B, G, 8, 128].

    CUDA tensors launch csrc/pair_scan.cu where ``pair`` is given, else
    csrc/spec_scan.cu, on the current stream (no synchronisation), or
    raise.  CPU tensors take spec_scan_ref (which does not read
    ``pair``)."""
    global spec_scan_launches, pair_scan_launches
    _check_scan_args(data, state0, j0, table, W, CPW, BITS)
    if data.device.type == "cpu":
        return spec_scan_ref(data, state0, j0, table, W=W, CPW=CPW,
                             BITS=BITS, COUNT=COUNT)
    if data.device.type != "cuda":
        raise ValueError("spec_scan runs on cuda or cpu tensors, got %s"
                         % data.device)
    if pair is None:
        planes = launch_planes("sre_spec_scan", data, state0, j0, table,
                               (W, CPW, BITS, int(bool(COUNT))))
        spec_scan_launches += 1
        return planes
    pt, rm = pair.table, pair.rowmap
    if BITS not in (3, 4) or pt.device != data.device \
            or rm.device != data.device \
            or pt.numel() != pair.rows * ((1 << 2 * BITS) + 1) \
            or (pt.numel() + table.numel()) * 4 > SMEM_BYTES:
        raise ValueError("pair must be pair_table's PairTable at BITS=%d "
                         "on the data's device" % BITS)
    planes = launch_planes("sre_spec_scan_pair", data, state0, j0, table,
                           (W, CPW, BITS, int(bool(COUNT)), pt.data_ptr(),
                            pt.numel(), rm.data_ptr(), rm.numel()))
    pair_scan_launches += 1
    return planes


def launch_planes(entry, data, state0, j0, table, extra, out=None):
    """Launch the C entry point ``entry`` of the kernel library
    (ops/_build.py) on the current stream, without synchronising.
    Every scan entry takes (data, state0, j0, table, table_len, phi,
    fm, swarm, B, Jw, G, *extra, stream), B the planes' block rows; the
    three int32 [B, G, 8, 128] output planes are ``out`` or allocated
    here, and returned.  Raises when the launch fails."""
    from . import _build
    fn = getattr(_build.load(), entry)
    phi, fm, swarm = out if out is not None else (
        torch.empty_like(state0) for _ in range(3))
    B, (Jw, G) = state0.shape[0], data.shape[1:3]
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(data.data_ptr(), state0.data_ptr(), j0.data_ptr(),
                table.data_ptr(), table.numel(), phi.data_ptr(),
                fm.data_ptr(), swarm.data_ptr(), B, Jw, G, *extra,
                ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("%s launch failed: cudaError %d" % (entry, rc))
    return phi, fm, swarm


def spec_scan_ref(data, state0, j0, table, *, W, CPW, BITS, COUNT):
    """The plain torch version of spec_scan, on any device: a loop over
    the J units, vectorised over all streams.  An index outside the
    table reads entry (index & 127), as the kernel does."""
    cmask = (1 << BITS) - 1
    n = table.numel()

    def lookup(s, word, k):
        idx = s + ((word >> (BITS * k)) & cmask)
        idx = torch.where((idx >= 0) & (idx < n), idx, idx & 127)
        return table[idx.long()]

    s = state0
    for w in range(W // CPW):
        word = data[:, w]
        for k in range(CPW):
            e = lookup(s, word, k)
            s = torch.where(w * CPW + k >= j0, e & _STATE_MASK, s)
    swarm = s
    acc = torch.zeros_like(s)
    for w in range(W // CPW, data.shape[1]):
        word = data[:, w]
        for k in range(CPW):
            e = lookup(s, word, k)
            acc = acc + (e >> _MATCH_SHIFT) if COUNT else acc | e
            s = e & _STATE_MASK
    return s, (acc if COUNT else acc >> _MATCH_SHIFT), swarm


# The two-code kernel's table: ``table`` int32 [rows * (2**(2 BITS) + 1)]
# and ``rowmap`` int32 [max row state + 1] on the device, ``rows``.
PairTable = namedtuple("PairTable", "table rowmap rows")

_PAIR_ROW_BITS = 24          # an entry's next row offset (bytes)
_PAIR_MATCH_MAX = 7          # the sum of two match fields rides 4 bits
_PAIR_STATE_MAX = 1 << 16    # premultiplied row states below this


def pair_table(fused, ncls, nstates, bits, device):
    """The two-code kernel's table (csrc/pair_scan.cu) for the fused
    table ``fused`` (int32 numpy [R*128]) of a machine of ``nstates``
    states and ``ncls`` classes at BITS-bit codes: a PairTable, or None
    where the kernel cannot hold the table exactly (8-bit codes, a match
    field outside [0, 7], a row state at or past 2**16, or the tables
    past one block's shared memory).

    A row for every premultiplied state the table produces (entry &
    (2**20 - 1)) and every multiple of ncls below nstates * ncls; entry
    (row, c0 | c1 << BITS) of a row holds, after the two one-code steps
    the plain version takes from the row's state on codes c0 then c1
    (an index past the table reads entry index & 127): the next row's
    byte offset (row * (2**(2 BITS) + 1) * 4), the OR of the two match
    fields at bit 24 and their sum at bit 28.  The row's last entry is
    its premultiplied state.  ``rowmap`` maps each premultiplied state
    below its length to its row's byte offset, or -1."""
    if bits not in (3, 4):
        return None
    f = np.asarray(fused, dtype=np.int64)
    m = f >> _MATCH_SHIFT
    if m.min() < 0 or m.max() > _PAIR_MATCH_MAX:
        return None
    n = f.size
    vals = np.union1d(f & _STATE_MASK,
                      np.arange(0, int(nstates) * int(ncls), int(ncls)))
    cp = 1 << (2 * bits)
    rows = vals.size
    if vals[-1] >= _PAIR_STATE_MAX \
            or (n + rows * (cp + 1)) * 4 > SMEM_BYTES:
        return None

    def step(s, c):
        idx = s + c
        return f[np.where(idx < n, idx, idx & 127)]

    code = np.arange(cp)
    e1 = step(vals[:, None], code & ((1 << bits) - 1))
    e2 = step(e1 & _STATE_MASK, code >> bits)
    rowmap = np.full(int(vals[-1]) + 1, -1, np.int64)
    rowmap[vals] = np.arange(rows) * (cp + 1) * 4
    m1, m2 = e1 >> _MATCH_SHIFT, e2 >> _MATCH_SHIFT
    ent = rowmap[e2 & _STATE_MASK] | (m1 | m2) << _PAIR_ROW_BITS \
        | (m1 + m2) << (_PAIR_ROW_BITS + 4)
    table = np.concatenate([ent, vals[:, None]], axis=1).reshape(-1)
    return PairTable(
        torch.from_numpy(table.astype(np.uint32).view(np.int32)).to(device),
        torch.from_numpy(rowmap.astype(np.int32)).to(device), rows)


def spec_pair_ref(data, state0, j0, table, pair, *, W, CPW, BITS, COUNT):
    """A plain torch model of the two-code kernel's walk over ``pair``
    (pair_table of ``table``), on any device.  A stream entered at a
    row with no freeze (j0 <= 0) walks its warmup in code pairs; the
    others take spec_scan_ref's one-code warmup.  A stream at a row
    after the warmup walks the rest in code pairs, one entry a pair
    (the next row at its byte offset, bits 0-23; the match OR at bit
    24, the sum at bit 28), and its exit is the final row's last entry;
    one with no row takes spec_scan_ref's walk.  Equal to spec_scan_ref
    wherever pair_table was given its table (tests/test_torch_spec_scan.py)."""
    ref = spec_scan_ref(data, state0, j0, table, W=W, CPW=CPW, BITS=BITS,
                        COUNT=COUNT)
    cp = 1 << (2 * BITS)
    ptab = pair.table.to(data.device).long() & 0xFFFFFFFF
    rowmap = pair.rowmap.to(data.device).long()
    data = data.long()

    def row_of(s):          # entry index of s's row, -1 when none
        s = s.long()
        ok = (s >= 0) & (s < rowmap.numel())
        r = rowmap[torch.where(ok, s, 0)]
        return torch.where(ok & (r >= 0), r >> 2, -1)

    def walk(nb, w0, w1, acc=None):
        for w in range(w0, w1):
            for k in range(CPW // 2):
                e = ptab[nb + ((data[:, w] >> (2 * BITS * k)) & (cp - 1))]
                nb = (e & ((1 << _PAIR_ROW_BITS) - 1)) >> 2
                if acc is not None:
                    acc = acc + (e >> 28) if COUNT else acc | e
        return nb, acc

    warm = W // CPW
    nb0 = row_of(state0)
    warm_pairs = (j0 <= 0) & (nb0 >= 0)
    nbw, _ = walk(nb0.clamp(min=0), 0, warm)
    swarm = torch.where(warm_pairs, ptab[nbw + cp].to(torch.int32), ref[2])
    nb = torch.where(warm_pairs, nbw, row_of(ref[2]))
    fast = nb >= 0
    nb, acc = walk(nb.clamp(min=0), warm, data.shape[1],
                   torch.zeros_like(nb))
    if not COUNT:
        acc = (acc >> 24) & 15
    phi = torch.where(fast, ptab[nb + cp].to(torch.int32), ref[0])
    return phi, torch.where(fast, acc.to(torch.int32), ref[1]), swarm


def _summarize(phi, fm, swarm, state0, C, bad_tail, COUNT, ESC=None):
    """The on-device validation of the speculation chain: int32 [10]
      [0] all_ok  [1] first_bad  [2] entry@first_bad  [3] phi@first_bad
      [4] swarm@first_bad  [5] fm@first_bad  [6] phi@C-1
      [7] sum(fm[0:first_bad])  (the valid-prefix count, COUNT mode)
      [8] last firing chunk in the validated prefix (-1 none)
      [9] entry @ that chunk
    and the narrow repair planes, uint8 [4, B, G, 8, 128]
    (phi, fm & 0xFF, swarm, fm >> 8 & 0xFF).  first_bad is 0 when
    every chunk validated, as in the JAX package.

    ESC (the core tiers, ops/core.py): the premultiplied id of the core
    machine's sticky escape state.  A chunk that left the core exits in
    ESC, and its counts past that byte are the core's, not the full
    machine's, so it fails validation and the host repairs it."""
    Cp = phi.numel()
    phi_f, fm_f, swarm_f = (t.reshape(Cp) for t in (phi, fm, swarm))
    entries = torch.cat([state0.reshape(Cp)[:1], phi_f[:-1]])
    idx = torch.arange(Cp, dtype=torch.int32, device=phi.device)
    okv = swarm_f == entries
    if ESC is not None:
        okv &= phi_f != ESC
    if not COUNT:
        okv &= fm_f == 0
    okv = (okv | (idx >= C)) & (idx != bad_tail)
    all_ok = okv.all()
    fb = torch.where(all_ok, 0, torch.where(okv, Cp, idx).min())
    fb_eff = torch.where(all_ok, C, fb)
    live = (idx < fb_eff) & (idx < C)
    prefix_cnt = torch.where(live, fm_f, 0).sum().to(torch.int32)
    last_fire = torch.where((fm_f != 0) & live, idx, -1).max()
    lf = last_fire.clamp(min=0)

    def at(v, i):
        return v.index_select(0, i.reshape(1).long())

    summary = torch.cat([
        all_ok.to(torch.int32).reshape(1), fb.reshape(1), at(entries, fb),
        at(phi_f, fb), at(swarm_f, fb), at(fm_f, fb), phi_f[C - 1:C],
        prefix_cnt.reshape(1), last_fire.reshape(1), at(entries, lf)])
    return summary, _pack_planes(phi, fm, swarm, False)


def _pack_planes(phi, fm, swarm, wide):
    """The repair planes as the host reads them back: for wide tables
    (states past 255) int32 [3, ...] (phi, fm, swarm), else uint8
    [4, ...] (phi, fm & 0xFF, swarm, fm >> 8 & 0xFF)."""
    if wide:
        return torch.stack([phi, fm, swarm])
    u8 = torch.uint8
    return torch.stack([phi.to(u8), (fm & 0xFF).to(u8), swarm.to(u8),
                        ((fm >> 8) & 0xFF).to(u8)])


def _summary_and_planes(planes, state0, C, bad_tail, COUNT, wide,
                        ESC=None, summary=True):
    """A scan kernel's (phi, fm, swarm) -> (summary int32 [10], packed),
    packed as _pack_planes packs it.  summary=False skips the summary
    (None in its place): the pipeline folds every segment from its
    planes."""
    phi, fm, swarm = planes
    if not summary:
        return None, _pack_planes(phi, fm, swarm, wide)
    summ, packed = _summarize(phi, fm, swarm, state0, C, bad_tail, COUNT,
                              ESC)
    if wide:
        packed = _pack_planes(phi, fm, swarm, True)
    return summ, packed


def _unpack(outs, C):
    """Host unpack of the repair planes of either format."""
    outs = np.asarray(outs.cpu() if isinstance(outs, torch.Tensor)
                      else outs).astype(np.int64)
    total = outs[0].size
    phi = outs[0].reshape(total)[:C]
    swarm = outs[2].reshape(total)[:C]
    if outs.shape[0] == 4:
        fmcnt = (outs[1] | (outs[3] << 8)).reshape(total)[:C]
    else:
        fmcnt = outs[1].reshape(total)[:C]
    return phi, fmcnt, swarm


def _entry_planes(entry_premult, w, B, device):
    """state0/j0 planes: every stream speculates from state 0 except
    stream 0, which starts at the true entry with its warmup frozen
    (j0 = W)."""
    s0 = torch.zeros((B, GROUPS, 8, TILE // 8), dtype=torch.int32,
                     device=device)
    j0 = torch.zeros_like(s0)
    # fill_ takes the value as a kernel argument: no host copy, so the
    # pipeline's dispatch never waits on the device here
    s0.view(-1)[:1].fill_(int(entry_premult))
    j0.view(-1)[:1].fill_(int(w))
    return s0, j0


def _launch(tables, data_np, chunk_len, entry_state, prepared, COUNT,
            mesh=None):
    """Prep (unless given and fit for ``mesh``: ops/mesh.fits), entry
    planes, kernel (sharded over ``mesh``) and summary.  Returns (summary
    as int64 numpy, packed planes on the device, C, K)."""
    n = len(data_np)
    W = tables.warmup
    if prepared is None or not fits(prepared, mesh):
        from .prep import prepare_auto
        prepared = prepare_auto(tables, data_np, chunk_len, mesh=mesh)
    data, C, K, _J, B = prepared
    topm = getattr(tables, "to_premult", None) or (
        lambda v: v * tables.ncls)
    s0p, j0p = _entry_planes(topm(entry_state), W, B, data.device)
    bad_tail = (C - 1) if C * K > n and (n - (C - 1) * K) != K else -1
    summary, packed = tables._scan(data, s0p, j0p, C, bad_tail, W,
                                   COUNT=COUNT, mesh=mesh)
    # common case: a 40-byte readback; the planes stay on the device
    # and are read only on the repair path
    return summary.cpu().numpy().astype(np.int64), packed, C, K


def with_warmup(tables, W):
    """A copy of ``tables`` with a longer speculation warmup of W bytes,
    or None when the tables cannot host it (the JAX package's
    with_warmup, with the same eligibility).

    Bounded-history automata (counted repetitions: the run counter
    saturates at the bound) converge through a warmup past their
    history bound on any corpus, so a corpus whose runs defeat the
    default window scans clean once W exceeds the bound.  The copy
    shares the table; only the window, and so the prep layout, changes.
    Byte-unit tiers with 4- or 8-bit packing only.  max_chunk is
    re-derived for the new window; on the card it does not depend on
    the window, so K stays 2048."""
    if getattr(tables, "bpu", 1) != 1 or tables.bits not in (4, 8):
        return None
    if W % tables.cpw or not (tables.warmup < W <= 2048):
        return None
    t = copy.copy(tables)
    t.__dict__.pop("_replicas", None)   # mesh copies hold the old window
    t.warmup = int(W)
    t.max_chunk = max_chunk_bytes(tables.cpw)
    if effective_chunk(t, DEFAULT_K) < t.warmup // 2:
        return None     # the window would dwarf the chunk: no gain
    t.last_repair = None
    return t


def _host_bytes(data_np):
    return np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np


def spec_scan_bytes(tables, data_np, chunk_len=DEFAULT_K, entry_state=0,
                    prepared=None, mesh=None):
    """Whole-buffer scan.  Returns (final_state, first_match_boundary
    or -1); boundaries 0..n-1 only, the EOF boundary is the caller's
    (tables.match_eof).  On a match the state is the state AT the
    boundary.  Exact: speculation misses and the firing chunk are
    re-scanned with the native engine.  ``prepared`` is a prior
    prepare_* result over the same bytes; ``mesh`` (ops/mesh.Mesh)
    shards the kernel over its devices (the fold is mesh-agnostic)."""
    n = len(data_np)
    if n == 0:
        return entry_state, -1
    summ, packed, C, K = _launch(tables, data_np, chunk_len, entry_state,
                                 prepared, COUNT=False, mesh=mesh)
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    all_ok, fb = bool(summ[0]), int(summ[1])
    tables.last_repair = None   # set on completed (no-match) scans
    if all_ok:
        tables.last_repair = (0, C)
        return frpm(int(summ[6])), -1

    raw = _host_bytes(data_np)
    native = NativeDfa(tables.dfa)
    entry_fb, swarm_fb, many_fb = int(summ[2]), int(summ[4]), int(summ[5])
    lo = fb * K
    hi = min(lo + K, n)
    if swarm_fb == entry_fb and hi - lo == K and many_fb:
        # validated chunk fired a match: one native re-scan pins it
        f, st = native.scan_first(raw[lo:hi].tobytes(), frpm(entry_fb))
        return st, lo + f

    # general repair (speculation miss / ragged tail): pull the
    # per-chunk planes and walk sequentially from the discrepancy
    phi, many, swarm = _unpack(packed, C)
    e = entry_fb
    c = fb
    nat = 0
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        if swarm[c] == e and hi - lo == K and many[c] == 0:
            e = int(phi[c])
            c += 1
            continue
        f, st = native.scan_first(raw[lo:hi].tobytes(), frpm(e))
        if f >= 0:
            return st, lo + f
        e = topm(st)
        c += 1
        nat += 1
    tables.last_repair = (nat, C)
    return frpm(e), -1


def spec_count_bytes(tables, data_np, chunk_len=DEFAULT_K, entry_state=0,
                     prepared=None, mesh=None):
    """Count every boundary (0..n-1) at which a match ends.  Returns
    (final_state, count); the EOF boundary is the caller's.  Exact:
    chunks whose speculation missed are re-counted natively.  ``mesh``
    as for spec_scan_bytes."""
    n = len(data_np)
    if n == 0:
        return entry_state, 0
    summ, packed, C, K = _launch(tables, data_np, chunk_len, entry_state,
                                 prepared, COUNT=True, mesh=mesh)
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    if bool(summ[0]):
        # every chunk validated: the prefix sum covers the corpus.  It
        # is int32 on the device; past 2**31-1 possible boundaries the
        # total is re-summed on the host from the per-chunk counts
        tables.last_repair = (0, C)
        if n < 2 ** 31:
            return frpm(int(summ[6])), int(summ[7])
        _, cnt, _ = _unpack(packed, C)
        return frpm(int(summ[6])), int(np.sum(cnt, dtype=np.int64))

    # repair from the first speculation miss (or ragged tail)
    raw = _host_bytes(data_np)
    fb = int(summ[1])
    total = int(summ[7])          # counts of the validated prefix
    native = NativeDfa(tables.dfa)
    phi, cnt, swarm = _unpack(packed, C)
    e = int(summ[2])
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
    tables.last_repair = (nat, C)
    return frpm(e), total


def spec_scan_last_bytes(tables, data_np, chunk_len=DEFAULT_K,
                         entry_state=0, prepared=None, mesh=None):
    """Find the LAST boundary (0..n-1) at which a match ends (the
    reverse-scan start locator of Scanner.find).  Returns (final_state,
    last_boundary or -1).  One COUNT-mode scan: the summary's last
    firing chunk of the validated prefix ([8], entered at [9]) is
    re-scanned natively; chunks past a speculation miss are walked as
    in spec_count_bytes.  Exact.  ``mesh`` as for spec_scan_bytes."""
    n = len(data_np)
    if n == 0:
        return entry_state, -1
    summ, packed, C, K = _launch(tables, data_np, chunk_len, entry_state,
                                 prepared, COUNT=True, mesh=mesh)
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    raw = _host_bytes(data_np)
    native = NativeDfa(tables.dfa)

    best = -1
    if int(summ[8]) >= 0:
        lo = int(summ[8]) * K
        r, _ = native.scan_last(raw[lo:lo + K].tobytes(),
                                frpm(int(summ[9])))
        best = lo + r
    if bool(summ[0]):
        return frpm(int(summ[6])), best

    # repair path: walk from the first discrepancy, tracking the last
    # fire exactly; the summary covered the validated prefix
    phi, cnt, swarm = _unpack(packed, C)
    e = int(summ[2])
    c = int(summ[1])
    while c < C:
        lo = c * K
        hi = min(lo + K, n)
        if swarm[c] == e and hi - lo == K:
            if cnt[c]:
                r, _ = native.scan_last(raw[lo:hi].tobytes(), frpm(e))
                best = lo + r
            e = int(phi[c])
        else:
            r, st = native.scan_last(raw[lo:hi].tobytes(), frpm(e))
            if r >= 0:
                best = lo + r
            e = topm(st)
        c += 1
    return frpm(e), best


def _chain_ends(phi, swarm, ok):
    """The last chunk of every chained run of a scan's planes: chunk c
    ends one where chunk c+1 is not ok or did not speculate chunk c's
    exit (C-1 always does)."""
    C = len(phi)
    cont = np.zeros(C, dtype=bool)
    cont[:C - 1] = ok[1:] & (swarm[1:] == phi[:C - 1])
    return np.flatnonzero(~cont)


def _chain_map(phi, swarm, ok, e, entries, counts, key, plain, recount):
    """The chunk maps' fold: per-chunk entries (plain states) and counts
    of a scan's planes, written in place from chunk 0 entered in plain
    state ``e``.

    Chunk c is trusted where ok[c] (its planes are exact for a full
    chunk) and its speculated entry swarm[c] is key(e), the plane code
    of its exact entry (key: -1 where e has none).  Its chained run
    (_chain_ends) is then exact and maps in one vector op (``plain``:
    plane codes to plain states, over an array).  Every other chunk is
    re-counted by recount(c, e) -> (count, exit plain state); no
    unconfirmed speculation is trusted.  ``counts`` holds the planes'
    counts on entry.  Returns (the final plain state, the chunks
    re-counted)."""
    ends = _chain_ends(phi, swarm, ok)
    c = nat = 0
    while c < len(phi):
        entries[c] = e
        k = key(e)
        if k >= 0 and ok[c] and swarm[c] == k:
            b = int(ends[np.searchsorted(ends, c)])
            entries[c + 1:b + 1] = plain(phi[c:b])
            e = int(plain(phi[b:b + 1])[0])
            c = b + 1
            continue
        counts[c], e = recount(c, e)
        c += 1
        nat += 1
    return e, nat


def spec_chunk_map(tables, data_np, chunk_len=DEFAULT_K, entry_state=0,
                   prepared=None, mesh=None):
    """Validated per-chunk scan map: (entries [C], counts [C],
    final_state), all exact (the finditer start locator's building
    block).

    entries[c] is the state entering chunk c (plain ids), counts[c] the
    number of match-ending boundaries inside chunk c.  One COUNT-mode
    launch, then _chain_map: each chained run whose entry is confirmed
    (the validated prefix among them) maps in one vector op, so the
    host work is one native re-count per missed chunk (and the ragged
    tail), not one step per chunk.  Counts ride 16 bits in the packed
    planes (effective_chunk keeps K below 65536).  ``data_np`` may be a
    reversed view of a corpus (the fold only slices it); ``prepared``
    then gives the prep.  ``mesh`` as for spec_scan_bytes."""
    n = len(data_np)
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64),
                entry_state)
    _, packed, C, K = _launch(tables, data_np, chunk_len, entry_state,
                              prepared, COUNT=True, mesh=mesh)
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frv = getattr(tables, "from_premult_vec", None) or (lambda a: a // ncls)
    phi, cnt, swarm = _unpack(packed, C)
    full = np.ones(C, dtype=bool)
    if C * K > n and n - (C - 1) * K != K:
        full[C - 1] = False
    raw = _host_bytes(data_np)
    native = NativeDfa(tables.dfa)

    def recount(c, e):
        return native.count(raw[c * K:(c + 1) * K].tobytes(), e)

    entries = np.empty(C, dtype=np.int64)
    counts = cnt.copy()
    final, nat = _chain_map(phi, swarm, full, entry_state, entries, counts,
                            topm, frv, recount)
    tables.last_repair = (nat, C)
    return entries, counts, final
