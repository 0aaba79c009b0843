"""Big-table tier: the speculative scan over automata of up to 2**17
table entries.

Counterpart of the JAX package's ops/pallas_big.py.  The tables are the
fused table of the narrow and wide tiers (next*ncls | match << 20), too
large for a block's shared memory: up to 512 KB.  The kernel is the
speculative scan of csrc/spec_scan.cu with the table left in global
memory (sre_big_scan), so it computes exactly what the narrow kernel
computes and its plain version is spec_scan_ref.  The TPU's
min/max-bounded row loop (_lookup_rows) and its SREGEX_BIG_FAST knob
have no counterpart: on the card a lookup is one load whatever the
table's size.
"""

from .layout import max_chunk_bytes
from .spec_scan import (_CPW, _Tables, _check_scan_args,
                        _summary_and_planes, fused_table, launch_planes,
                        spec_scan_ref)

MAX_ENTRIES = 1 << 17      # S*ncls cap, as in the JAX package

# kernel launches since the last reset (the CUDA path only)
big_scan_launches = 0


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

    def _scan(self, data, state0, j0, C, bad_tail, W, COUNT=False,
              esc=None):
        planes = big_scan(data, state0, j0, self.fused, W=W, CPW=self.cpw,
                          BITS=self.bits, COUNT=COUNT)
        return _summary_and_planes(planes, state0, C, bad_tail, COUNT,
                                   wide=True, ESC=esc)


def big_scan(data, state0, j0, table, *, W, CPW, BITS, COUNT):
    """The speculative scan over a table of up to MAX_ENTRIES entries.
    Same arguments and result as spec_scan (ops/spec_scan.py); BITS is 4
    or 8.  CUDA tensors launch sre_big_scan (csrc/spec_scan.cu, table in
    global memory) on the current stream or raise; CPU tensors take
    big_scan_ref."""
    global big_scan_launches
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
    planes = launch_planes("sre_big_scan", data, state0, j0, table,
                           (W, CPW, BITS, int(bool(COUNT))))
    big_scan_launches += 1
    return planes


def big_scan_ref(data, state0, j0, table, *, W, CPW, BITS, COUNT):
    """The plain torch version of big_scan: the big kernel computes the
    speculative scan's function, so this is spec_scan_ref (an index
    outside the table reads entry index & 127)."""
    return spec_scan_ref(data, state0, j0, table, W=W, CPW=CPW, BITS=BITS,
                         COUNT=COUNT)
