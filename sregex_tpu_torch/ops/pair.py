"""Pair-step tables: one lookup advances a stream by two input bytes.

Counterpart of the JAX package's ops/pallas_pair.py.  The transition function
is composed over byte pairs,

    fused2[s*npair + (c1*ncls + c2)] =
        (trans[trans[s,c1],c2] * npair) | (cnt << 20)
    cnt = match[s,c1] + match[trans[s,c1],c2]    (0..2)

so the chain of dependent lookups per chunk halves.  The 2-bit count
field keeps COUNT mode exact.  The scan kernel is the byte tiers' own:
J, W and j0 arrive in bytes and are halved into pair units here.
"""

import numpy as np

from .layout import _MATCH_SHIFT, max_chunk_bytes
from .spec_scan import _CPW, _spec_scan, _Tables


class SpecTablesPair(_Tables):
    """Pair-composed tables; a drop-in for SpecTables in the scan folds
    (ncls is the PAIR alphabet size, so premultiplied states and the
    repair path's conversions stay consistent).  On the card its 4-bit
    tables take the two-code kernel, one lookup per two pair codes."""

    MAX_ENTRIES = 1024
    two_code = True

    def __init__(self, dfa, device, narrow_only=False):
        S, cb = dfa.nstates, dfa.nclasses
        npair = cb * cb
        limit = 128 if narrow_only else self.MAX_ENTRIES
        if S * npair > limit:
            raise ValueError("automaton too large for the pair table "
                             "(S*ncls^2 = %d > %d)" % (S * npair, limit))
        if npair > 256:
            raise ValueError("pair alphabet exceeds uint8 (%d)" % npair)
        self.nstates = S
        self.byte_ncls = cb
        self.ncls = npair            # pair alphabet (premultiplier)
        self.bpu = 2                 # bytes per kernel unit
        self.bits = 4 if npair <= 16 else 8
        self.cpw = _CPW[self.bits]   # pairs per word
        self.warmup = 4 * self.cpw * 2   # bytes
        trans = np.asarray(dfa.trans, dtype=np.int64)    # [S, cb]
        match = np.asarray(dfa.match, dtype=np.int64)
        next2 = trans[trans]                             # [S, cb, cb]
        cnt2 = match[:, :, None] + match[trans]
        total = S * npair
        self.rows = -(-total // 128)
        self.wide = total > 128      # int32 repair planes, as in JAX
        fused = np.zeros(self.rows * 128, dtype=np.int32)
        fused[:total] = ((next2 * npair) | (cnt2 << _MATCH_SHIFT)) \
            .astype(np.int32).reshape(-1)
        self.max_chunk = max_chunk_bytes(self.cpw, bpu=2)
        self._finish(dfa, fused, device)

    def _scan(self, data, state0, j0, C, bad_tail, W, COUNT=False,
              esc=None):
        # W and j0 arrive in bytes; the kernel steps in pairs
        return _spec_scan(data, state0, j0 // 2, self.fused, C, bad_tail,
                          W=W // 2, CPW=self.cpw, BITS=self.bits,
                          COUNT=COUNT, wide=self.wide, ESC=esc,
                          pair=self.pair)
