"""Enumerative DFA scan: every chunk's transfer function over all S
entry states, composed associatively.

Counterpart of the JAX package's ops/scan.py, as torch ops on the
tables' device (the JAX package has no Pallas kernel for it either).
The input is cut into C chunks; chunk c's transfer function holds, for
every entry state s, the state after the chunk (phi), the offset of its
earliest match boundary (fm) and the id of the pattern that matched
there (fid).  Chunk functions compose associatively, so a corpus reduces
to one S-vector summary in log depth, and across devices the same
composition stitches the shards' summaries (parallel/sharded_scan.py).
It is not on the Scanner's path: the speculative tiers scan one entry
state a stream, S times less work.

Boundary semantics are the host engine's: match[s][byte] is checked at
boundary i before byte i is consumed, and EOF acceptance is the caller's
(match_eof).  Chunk-relative offsets are int32 with the _NO_MATCH
sentinel; the moment offsets become absolute (reduce_summaries, the
sharded composition) they are int64 with _NO_MATCH_ABS, so a corpus
past 2 GiB keeps exact offsets.
"""

import numpy as np
import torch

_MATCH_SHIFT = 20
_ID_SHIFT = 21
_MAX_DEV_ID = (1 << (31 - _ID_SHIFT)) - 1   # 1023 ids in device tables
_STATE_MASK = (1 << _MATCH_SHIFT) - 1
_NO_MATCH = 2 ** 30           # +inf sentinel, chunk-relative offsets
_NO_MATCH_ABS = 2 ** 62       # +inf sentinel, absolute offsets


def dfa_device_tables(dfa, device="cuda"):
    """The enumerative scan's tables of a host Dfa, on ``device``: a dict
    with fused_bm (int32 [256, S] byte-major: next | match << 20 |
    regex_id << 21, the id 0 where there is no match and clamped at
    1023), match_eof (int32 [S]), match_eof_id (int32 [S], -1 none),
    nstates and nstates_padded.  S is padded to a multiple of 128 with
    dead self-looping states, as in the JAX package."""
    S = dfa.nstates
    Sp = max(128, -(-S // 128) * 128)
    trans = dfa.trans_bytes.astype(np.int32)
    match = dfa.match_bytes.astype(np.int32)
    mid = np.clip(dfa.match_id_bytes, 0, _MAX_DEV_ID).astype(np.int32)
    fused = trans | (match << _MATCH_SHIFT) | (mid << _ID_SHIFT)
    fused_bm = np.zeros((256, Sp), dtype=np.int32)
    fused_bm[:, :S] = fused.T
    fused_bm[:, S:] = np.arange(S, Sp, dtype=np.int32)
    match_eof = np.zeros(Sp, dtype=np.int32)
    match_eof[:S] = dfa.match_eof.astype(np.int32)
    match_eof_id = np.full(Sp, -1, dtype=np.int32)
    match_eof_id[:S] = dfa.match_eof_id.astype(np.int32)

    def dev(a):
        return torch.from_numpy(a).to(device)

    return {"fused_bm": dev(fused_bm), "match_eof": dev(match_eof),
            "match_eof_id": dev(match_eof_id), "nstates": S,
            "nstates_padded": Sp}


def chunk_transfer(fused_bm, data, valid_len, *, chunk_len):
    """Per-chunk transfer functions.  fused_bm int32 [256, S]; data
    uint8 [C, K] (K == chunk_len, padded); valid_len int32 [C], the
    valid bytes of each chunk.  Returns (phi, fm, fid), each int32
    [C, S]: the state after chunk c entered in state s, the offset in
    chunk c of its earliest match boundary (_NO_MATCH none) and the
    regex id there (-1 none).  The boundary at a chunk's end belongs to
    the next chunk."""
    C, K = data.shape
    if K != chunk_len:
        raise ValueError("data is [C, %d], chunk_len %d" % (K, chunk_len))
    S = fused_bm.shape[1]
    dev = fused_bm.device
    state = torch.arange(S, device=dev).expand(C, S).contiguous()
    fm = torch.full((C, S), _NO_MATCH, dtype=torch.int32, device=dev)
    fid = torch.full((C, S), -1, dtype=torch.int32, device=dev)
    valid_len = valid_len.to(dev)
    for j in range(K):
        rows = fused_bm.index_select(0, data[:, j].to(dev).long())
        e = torch.gather(rows, 1, state)
        valid = (j < valid_len)[:, None]
        fire = valid & ((e >> _MATCH_SHIFT) > 0)
        # j rises, so the first fire wins and later ones never touch
        # fm / fid again
        fid = torch.where(fire & (fm == _NO_MATCH), e >> _ID_SHIFT, fid)
        fm = torch.where(fire, torch.clamp(fm, max=j), fm)
        state = torch.where(valid, (e & _STATE_MASK).long(), state)
    return state.to(torch.int32), fm, fid


def compose(a, b):
    """The transfer summary of a then b.  Each is (phi, fm, fid) over
    [..., S], fm int64 in absolute offsets (_NO_MATCH_ABS none)."""
    phi_a, fm_a, fid_a = a
    phi_b, fm_b, fid_b = b
    ia = phi_a.long()
    fm_bc = torch.gather(fm_b, -1, ia)
    use_a = fm_a <= fm_bc
    return (torch.gather(phi_b, -1, ia), torch.where(use_a, fm_a, fm_bc),
            torch.where(use_a, fid_a, torch.gather(fid_b, -1, ia)))


def absolute(fm, valid_len):
    """Chunk-relative int32 offsets [C, S] -> int64 offsets from the
    first chunk's start (the sentinel -> _NO_MATCH_ABS)."""
    v = valid_len.to(fm.device).long()
    base = torch.cumsum(v, 0) - v
    return torch.where(fm >= _NO_MATCH, _NO_MATCH_ABS,
                       fm.long() + base[:, None])


def reduce_summaries(phi, fm, fid, valid_len):
    """Log-depth composition of per-chunk summaries (chunk_transfer's)
    into one summary (phi [S], fm [S] int64 absolute, fid [S])."""
    C, S = phi.shape
    fm = absolute(fm, valid_len)
    n = 1
    while n < C:
        n *= 2
    if n != C:
        dev = phi.device
        pad = n - C
        phi = torch.cat([phi, torch.arange(S, dtype=phi.dtype, device=dev)
                         .expand(pad, S)])
        fm = torch.cat([fm, torch.full((pad, S), _NO_MATCH_ABS,
                                       dtype=torch.int64, device=dev)])
        fid = torch.cat([fid, torch.full((pad, S), -1, dtype=fid.dtype,
                                         device=dev)])
    while n > 1:
        phi, fm, fid = compose((phi[0::2], fm[0::2], fid[0::2]),
                               (phi[1::2], fm[1::2], fid[1::2]))
        n //= 2
    return phi[0], fm[0], fid[0]


def scan_block(fused_bm, data, valid_len, *, chunk_len):
    """The summary of a [C, K] block: chunk_transfer, then
    reduce_summaries."""
    phi, fm, fid = chunk_transfer(fused_bm, data, valid_len,
                                  chunk_len=chunk_len)
    return reduce_summaries(phi, fm, fid, valid_len)


def chunked(data_np, K, multiple=1):
    """A corpus cut into C chunks of K bytes, C a multiple of
    ``multiple``: (uint8 [C, K] zero padded, int32 [C] valid bytes)."""
    n = len(data_np)
    C = -(-max(n, 1) // K)
    C = -(-C // multiple) * multiple
    padded = np.zeros(C * K, dtype=np.uint8)
    padded[:n] = np.frombuffer(data_np, dtype=np.uint8)
    valid = np.clip(n - np.arange(C, dtype=np.int64) * K, 0, K)
    return (torch.from_numpy(padded.reshape(C, K)),
            torch.from_numpy(valid.astype(np.int32)))


def result(summary, entry_state):
    """(final state, first match boundary or -1, regex id or -1) of a
    summary entered in ``entry_state``."""
    phi, fm, fid = summary
    final = int(phi[entry_state])
    first = int(fm[entry_state])
    if first >= _NO_MATCH_ABS:
        return final, -1, -1
    return final, first, int(fid[entry_state])


def scan_bytes(tables, data_np, chunk_len=2048, entry_state=0):
    """Whole-buffer enumerative scan: (final state, first match boundary
    or -1, regex id or -1) from ``entry_state``.  Boundaries 0..n-1; the
    EOF boundary is the caller's (tables["match_eof"][final])."""
    if len(data_np) == 0:
        return entry_state, -1, -1
    K = int(chunk_len)
    data, valid = chunked(data_np, K)
    return result(scan_block(tables["fused_bm"], data, valid, chunk_len=K),
                  entry_state)
