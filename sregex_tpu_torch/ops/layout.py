"""Layout constants and chunk sizing shared by the prep, the scan
kernel and the host folds.

These mirror the JAX package's ops/pallas_scan.py so that both packages cut a
corpus into the same chunks and tile them into the same
[B, Jw, G, 8, 128] int32 words: chunk c = ((b*G + g)*TILE + t), with
t = sublane*128 + lane.  On the GPU one (b, g) tile is one thread
block and t is the thread index, so neighbouring threads read
neighbouring words.
"""

import os

_MATCH_SHIFT = 20
_STATE_MASK = (1 << _MATCH_SHIFT) - 1

WORDS_PER_ITER = 2   # chunk lengths are whole multiples of this many words
# Tiles per block row of the layout.  Read exactly as the JAX package
# reads it, so the two layouts agree (the CPU tests pin 4).
GROUPS = int(os.environ.get("SREGEX_GROUPS", "8"))
TILE = 1024          # streams per tile (8 sublanes x 128 lanes)
DEFAULT_K = 2048     # nominal chunk length (rounded to the packing)

# Shared memory one Hopper block can hold (227 KB); the fused table is
# copied into it whole, so this caps the table a tier may build.
SMEM_BYTES = 232448
SMEM_TABLE_MAX = SMEM_BYTES // 4


def max_chunk_bytes(cpw, bpu=1):
    """The largest chunk length K (bytes) the kernel may be given.

    On the TPU the chunk was also clamped by the VMEM footprint of the
    data block; on the card a thread streams its words from global
    memory, so the only limit left is the 16-bit per-chunk match count
    of the narrow packed planes."""
    quantum = cpw * WORDS_PER_ITER * bpu
    return ((1 << 16) - 1) // quantum * quantum


def effective_chunk(tables, chunk_len):
    """The chunk length the prep actually uses: rounded down to the
    packing quantum and clamped to the tables' max_chunk (same rule as
    the JAX package's effective_chunk)."""
    CPW = tables.cpw
    bpu = getattr(tables, "bpu", 1)    # bytes per kernel unit
    quantum = CPW * WORDS_PER_ITER * bpu
    chunk_len = min(int(chunk_len),
                    getattr(tables, "max_chunk", 1 << 15))
    K = max(quantum, chunk_len // quantum * quantum)
    if K >= 1 << 16:
        # per-chunk match counts ride 16 bits in the packed planes
        raise ValueError("chunk_len must be < 65536 (got %d)" % K)
    return K
