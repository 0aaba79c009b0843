"""Data-parallel enumerative scan over a device mesh.

Counterpart of the JAX package's parallel/sharded_scan.py.  The corpus's
chunks are cut into one contiguous range a shard; each shard computes
its chunks' transfer functions on its device (ops/scan.chunk_transfer)
and reduces them to one S-vector summary in log depth; the summaries
(S * 16 bytes a shard) are gathered to the lead device and composed in
shard order, each shard's offsets moved by the bytes before it.  The
table (256 x S int32) goes to each other device at each call, as the JAX
package's shard_map takes it replicated (P()) at each call.  The chunk carry across shards
is exactly the DFA state, as the reference's resumable exec carries it.
"""

import torch

from ..ops.mesh import make_mesh
from ..ops.scan import (_NO_MATCH_ABS, absolute, chunk_transfer, chunked,
                        compose, result)


def _shard_summary(fused_bm, data, valid, K):
    """One shard's summary: its chunks' transfer functions composed in
    pairs, an odd one carried, until one is left; offsets int64 from the
    shard's first byte."""
    phi, fm, fid = chunk_transfer(fused_bm, data, valid, chunk_len=K)
    fm = absolute(fm, valid)
    while phi.shape[0] > 1:
        h = phi.shape[0] // 2
        new = compose((phi[0:2 * h:2], fm[0:2 * h:2], fid[0:2 * h:2]),
                      (phi[1:2 * h:2], fm[1:2 * h:2], fid[1:2 * h:2]))
        if phi.shape[0] % 2:
            new = tuple(torch.cat([x, y[-1:]]) for x, y in
                        zip(new, (phi, fm, fid)))
        phi, fm, fid = new
    return phi[0], fm[0], fid[0]


def sharded_scan_bytes(tables, data_np, mesh=None, chunk_len=8192,
                       axis="data", entry_state=0):
    """Whole-corpus enumerative scan across ``mesh`` (every CUDA device
    by default).  Returns (final_state, first_match_end or -1, regex_id
    or -1): the earliest match end over all shards and the pattern that
    matched there.  EOF acceptance is the caller's
    (tables["match_eof_id"][final_state])."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    D = mesh.size
    K = int(chunk_len)
    data, valid = chunked(data_np, K, multiple=D)
    Cs = data.shape[0] // D
    # every shard's work is enqueued before any summary is gathered
    parts = []
    for i, dev in enumerate(mesh.devices):
        cut = slice(i * Cs, (i + 1) * Cs)
        v = valid[cut].to(dev)
        parts.append((_shard_summary(tables["fused_bm"].to(dev),
                                     data[cut].to(dev), v, K),
                      v.long().sum()))
    lead = mesh.lead
    phi_all = torch.stack([p[0][0].to(lead) for p in parts])
    fm_all = torch.stack([p[0][1].to(lead) for p in parts])
    fid_all = torch.stack([p[0][2].to(lead) for p in parts])
    nb_all = torch.stack([p[1].to(lead) for p in parts])
    base_all = torch.cumsum(nb_all, 0) - nb_all
    fm_all = torch.where(fm_all >= _NO_MATCH_ABS, _NO_MATCH_ABS,
                         fm_all + base_all[:, None])
    acc = (phi_all[0], fm_all[0], fid_all[0])
    for d in range(1, D):
        acc = compose(acc, (phi_all[d], fm_all[d], fid_all[d]))
    return result(acc, entry_state)
