"""Big-table tier: the speculative scan over automata of up to 2**17
table entries.

Counterpart of the JAX package's ops/pallas_big.py.  The tables are the
fused table of the narrow and wide tiers (next*ncls | match << 20), too
large for a block's shared memory at 32 bits: up to 512 KB.  Two
kernels compute exactly what the narrow kernel computes, so the plain
version of both is spec_scan_ref.  sre_big_scan (csrc/spec_scan.cu)
reads the fused table from global memory; what bounds it is that chain
of dependent loads through L1 and L2 (2.07 ms for the 500-keyword
dictionary at [120, 520, 8, 8, 128], where the wide kernel takes 1.18
for as many steps from shared memory).  sre_big_scan_smem
(csrc/big_scan.cu) serves the tables big16_table holds: 16 bits an
entry (the next state's id and the match field), so the dictionary's
103,788 entries and their wrap padding fit one block's shared memory;
the state is the state id, a step's address two multiply-adds, and each
lane walks two streams (1.07 ms).  What bounds it now is shared-memory
bank conflicts: lanes in different states read ~27 distinct words a
load, ~3.4 wavefronts (tools/bank_conflicts.py).  big16_ref is a plain
model of its walk.  The TPU's min/max-bounded row loop (_lookup_rows)
and its SREGEX_BIG_FAST knob have no counterpart: on the card a lookup
is one load whatever the table's size.
"""

from collections import namedtuple

import numpy as np
import torch

from .layout import _MATCH_SHIFT, _STATE_MASK, SMEM_BYTES, max_chunk_bytes
from .spec_scan import (_CPW, _Tables, _check_scan_args,
                        _summary_and_planes, fused_table, launch_planes,
                        spec_scan_ref)

MAX_ENTRIES = 1 << 17      # S*ncls cap, as in the JAX package

# kernel launches since the last reset (the CUDA path only): the
# global-memory kernel (sre_big_scan) and the 16-bit shared-memory one
# (sre_big_scan_smem)
big_scan_launches = 0
big_smem_launches = 0

# The 16-bit kernel's table: ``table`` int16 [len, a multiple of 8] on the
# device, ``rows`` state ids, ``ncls`` the premultiplier.
Big16 = namedtuple("Big16", "table rows ncls")

_SID_BITS = 14             # a 16-bit entry's next state id


class SpecTablesBig(_Tables):
    """Fused tables of up to MAX_ENTRIES entries, read from global
    memory.  4-bit class packing when the classes fit a nibble, else
    8-bit; the warmup is 32 bytes whatever the packing (big automata do
    not converge faster than small ones)."""

    MAX_ENTRIES = MAX_ENTRIES
    wide = True

    def __init__(self, dfa, device):
        S, ncls = dfa.nstates, dfa.nclasses
        if S * ncls > MAX_ENTRIES:
            raise ValueError("automaton too large for the big fused "
                             "table (S*ncls = %d)" % (S * ncls))
        if ncls > 256:
            raise ValueError("more than 256 byte classes (%d)" % ncls)
        self.nstates = S
        self.ncls = ncls
        self.bits = 4 if ncls <= 16 else 8
        self.cpw = _CPW[self.bits]
        self.warmup = 32
        self.rows = -(-(S * ncls) // 128)
        self.max_chunk = max_chunk_bytes(self.cpw)
        self._finish(dfa, fused_table(dfa, self.rows), device)

    def _finish(self, dfa, fused, device):
        super()._finish(dfa, fused, device)
        # the 16-bit table, or None: the global-memory kernel serves
        self.t16 = big16_table(fused, self.ncls, self.nstates, self.bits,
                               self.device)

    def _scan(self, data, state0, j0, C, bad_tail, W, COUNT=False,
              esc=None):
        planes = big_scan(data, state0, j0, self.fused, W=W, CPW=self.cpw,
                          BITS=self.bits, COUNT=COUNT, t16=self.t16)
        return _summary_and_planes(planes, state0, C, bad_tail, COUNT,
                                   wide=True, ESC=esc)


def big16_table(fused, ncls, nstates, bits, device):
    """The 16-bit kernel's table (csrc/big_scan.cu) for the fused table
    ``fused`` (int32 numpy [R*128]) of a machine of ``nstates`` states
    and ``ncls`` classes at BITS-bit codes: a Big16, or None where the
    kernel cannot hold it (a next state that is not a multiple of ncls,
    more than 2**14 state ids, a match field outside [0, 3], or more
    entries than one block's shared memory holds at 16 bits).

    rows = max(nstates, the largest next state id + 1); entry i, for i
    up to the last index a row and a code can form ((rows - 1) * ncls +
    2**bits - 1), is the fused entry the plain version reads at index i
    (entry i & 127 past the fused table) as next id | match << 14;
    zero padded to a multiple of 8 entries."""
    f = np.asarray(fused, dtype=np.int64)
    m = f >> _MATCH_SHIFT
    nxt = f & _STATE_MASK
    if m.min() < 0 or m.max() > 3 or (nxt % ncls).any():
        return None
    sid = nxt // ncls
    rows = max(int(nstates), int(sid.max()) + 1)
    size = (rows - 1) * ncls + (1 << bits)
    size8 = -(-size // 8) * 8
    if rows > 1 << _SID_BITS or size8 * 2 > SMEM_BYTES:
        return None
    idx = np.arange(size)
    src = np.where(idx < f.size, idx, idx & 127)
    table = np.zeros(size8, np.int64)
    table[:size] = sid[src] | m[src] << _SID_BITS
    return Big16(torch.from_numpy(table.astype(np.uint16).view(np.int16))
                 .to(device), rows, int(ncls))


def big_scan(data, state0, j0, table, *, W, CPW, BITS, COUNT, t16=None):
    """The speculative scan over a table of up to MAX_ENTRIES entries.
    Same arguments and result as spec_scan (ops/spec_scan.py); BITS is 4
    or 8; ``t16`` None or the 16-bit table big16_table built from
    ``table`` (the tables' ``t16``).  CUDA tensors launch
    sre_big_scan_smem (csrc/big_scan.cu) where ``t16`` is given, else
    sre_big_scan (csrc/spec_scan.cu, the table in global memory), on the
    current stream, or raise; CPU tensors take big_scan_ref (which does
    not read ``t16``)."""
    global big_scan_launches, big_smem_launches
    _check_scan_args(data, state0, j0, table, W, CPW, BITS,
                     max_table=MAX_ENTRIES)
    if BITS not in (4, 8):
        raise ValueError("the big tier packs 4 or 8 bits, got %r" % BITS)
    if data.device.type == "cpu":
        return big_scan_ref(data, state0, j0, table, W=W, CPW=CPW,
                            BITS=BITS, COUNT=COUNT)
    if data.device.type != "cuda":
        raise ValueError("big_scan runs on cuda or cpu tensors, got %s"
                         % data.device)
    if t16 is None:
        planes = launch_planes("sre_big_scan", data, state0, j0, table,
                               (W, CPW, BITS, int(bool(COUNT))))
        big_scan_launches += 1
        return planes
    tt = check_t16(t16, data, BITS)
    planes = launch_planes("sre_big_scan_smem", data, state0, j0, table,
                           (W, CPW, BITS, int(bool(COUNT)), tt.data_ptr(),
                            tt.numel(), t16.ncls, t16.rows))
    big_smem_launches += 1
    return planes


def check_t16(t16, data, BITS):
    """t16's table, or raise where it is not big16_table's Big16 at BITS
    on the data's device, whole 16-byte units that fit shared memory."""
    tt = t16.table
    if tt.device != data.device or tt.dtype != torch.int16 \
            or tt.numel() % 8 or tt.numel() * 2 > SMEM_BYTES \
            or tt.numel() < (t16.rows - 1) * t16.ncls + (1 << BITS):
        raise ValueError("t16 must be big16_table's Big16 at BITS=%d on "
                         "the data's device" % BITS)
    return tt


def big_scan_ref(data, state0, j0, table, *, W, CPW, BITS, COUNT):
    """The plain torch version of big_scan: the big kernel computes the
    speculative scan's function, so this is spec_scan_ref (an index
    outside the table reads entry index & 127)."""
    return spec_scan_ref(data, state0, j0, table, W=W, CPW=CPW, BITS=BITS,
                         COUNT=COUNT)


def big16_ref(data, state0, j0, table, t16, *, W, CPW, BITS, COUNT):
    """A plain torch model of the 16-bit kernel's walk over ``t16``
    (big16_table of ``table``), on any device.  A stream entered at a
    row (a multiple of ncls below rows * ncls) walks the 16-bit table
    by state id, entry (sid * ncls + code): the next id in bits 0-13,
    the match field in bits 14-15; the others take spec_scan_ref's
    warmup and go on by state id if the state they reach is a row, else
    take spec_scan_ref's walk.  Equal to big_scan_ref wherever
    big16_table was given its table (tests/test_torch_big.py)."""
    ref = spec_scan_ref(data, state0, j0, table, W=W, CPW=CPW, BITS=BITS,
                        COUNT=COUNT)
    ncls, rows = t16.ncls, t16.rows
    tab = t16.table.to(data.device).long() & 0xFFFF
    cmask = (1 << BITS) - 1
    data, j0 = data.long(), j0.long()

    def row(s):
        s = s.long()
        ok = (s >= 0) & (s % ncls == 0) & (s < rows * ncls)
        return ok, torch.where(ok, s // ncls, 0)

    def step(sid, w, k):
        return tab[sid * ncls + ((data[:, w] >> (BITS * k)) & cmask)]

    warm = W // CPW
    fast0, sid = row(state0)
    for w in range(warm):
        for k in range(CPW):
            nxt = step(sid, w, k) & ((1 << _SID_BITS) - 1)
            sid = torch.where(w * CPW + k >= j0, nxt, sid)
    swarm = torch.where(fast0, (sid * ncls).to(torch.int32), ref[2])
    fast, sid = row(swarm)
    acc = torch.zeros_like(sid)
    for w in range(warm, data.shape[1]):
        for k in range(CPW):
            e = step(sid, w, k)
            sid = e & ((1 << _SID_BITS) - 1)
            acc = acc + (e >> _SID_BITS) if COUNT else acc | e
    if not COUNT:
        acc = acc >> _SID_BITS
    phi = torch.where(fast, (sid * ncls).to(torch.int32), ref[0])
    return phi, torch.where(fast, acc.to(torch.int32), ref[1]), swarm
