"""Multi-process sharded scan: each process holds only its slice of the
corpus.

Counterpart of the JAX package's parallel/multihost.py.  There one
kernel runs collectively over a mesh that spans the processes; here
each process prepares its slice and scans it on its own local mesh
(ops/mesh.py), and what crosses processes is host data for the host
fold, moved by torch.distributed collectives (gloo by default:
parallel/distributed.py).  Every process walks the same fold over the
same gathered data, so their collectives stay in lockstep and they all
return the same result, which is that of one process scanning the whole
corpus.

What crosses processes:

  - before the prep, each process's byte count and last W bytes: a
    process's chunk 0 then speculates over the real bytes before it,
    as an interior chunk does (the JAX package gives it class-0 padding);
  - after the scan, each process's 10-int summary of its chunk chain
    (its chunk 0 trusted locally; the host checks its speculated entry
    against the exit of the process before it) and that entry;
  - where that does not settle the answer, every process's per-chunk
    planes (O(C) bytes), and for each chunk the fold cannot trust, the
    result of its owner's native re-scan (the only process holding its
    bytes), broadcast from the owner.

Two slice layouts, as in the JAX package:

  - ALIGNED: every slice but the last a whole number of chunks
    (host_slices' ranges are whole blocks).  The processes' chunks are
    then the corpus's chunks, and a scan whose chains all validate
    (every summary's all_ok and every stitch) needs no planes at all;
  - RAGGED: any non-empty byte ranges.  A process's last chunk is then
    short, so it is never trusted: its owner re-scans it and broadcasts
    the result, and the planes are gathered on every scan.  Exactness is
    the same; the cost is the planes' gather.

The pair tier is excluded (its prep pairs bytes across a slice's edge),
as the JAX package asserts.
"""

from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as tdist

from ..native import NativeDfa
from ..ops.layout import GROUPS, TILE, effective_chunk
from ..ops.prep import prepare_auto
from ..ops.spec_scan import _entry_planes, _summary_and_planes, _unpack
from .distributed import process_count, process_index

LANES = GROUPS * TILE      # chunks (streams) per block


def block_bytes(chunk_len):
    """Bytes covered by one block of the prep."""
    return LANES * chunk_len


def host_slices(nbytes, nprocs, chunk_len, ndevices):
    """Aligned [lo, hi) corpus ranges, one a process: every process
    takes the same number of blocks (nprocs * blocks a multiple of
    ``ndevices``, the devices of all processes' meshes together), and
    every range but the last is whole blocks.  count_multihost and
    scan_multihost take any non-empty ranges as well (module
    docstring)."""
    bb = block_bytes(chunk_len)
    bpp = max(1, -(-nbytes // (bb * nprocs)))
    while (nprocs * bpp) % ndevices:
        bpp += 1
    per = bpp * bb
    if nbytes <= (nprocs - 1) * per + (bpp - 1) * bb:
        raise ValueError("corpus too small for %d procs x %d blocks of %d "
                         "bytes" % (nprocs, bpp, bb))
    return [(p * per, (p + 1) * per if p < nprocs - 1 else nbytes)
            for p in range(nprocs)]


def _allgather(row):
    """[nproc, len] int64 numpy of every process's ``row`` (one int64
    vector a process, all of one length)."""
    t = torch.as_tensor(np.asarray(row, dtype=np.int64))
    if process_count() == 1:
        return t.numpy()[None]
    out = [torch.empty_like(t) for _ in range(process_count())]
    tdist.all_gather(out, t)
    return torch.stack(out).numpy()


def _from_owner(row, owner):
    """``row`` (int64) as the process ``owner`` holds it, on every
    process."""
    t = torch.as_tensor(np.asarray(row, dtype=np.int64))
    if process_count() > 1:
        tdist.broadcast(t, src=owner)
    return [int(v) for v in t]


def _launch(tables, local_bytes, mesh, chunk_len, full_len, entry_state,
            COUNT):
    """This process's prep and scan, and the collectives of the fast
    path.  Returns a namespace with the gathered summaries, this
    process's packed planes, and the slice geometry of every process."""
    if getattr(tables, "bpu", 1) != 1:
        raise ValueError("byte-alphabet tiers only (the pair tier pairs "
                         "bytes across slices)")
    pid, nproc = process_index(), process_count()
    K = effective_chunk(tables, chunk_len)
    if K != chunk_len:
        raise ValueError("chunk_len %d is not prep-exact for these tables "
                         "(use %d; the slices must be computed with the same "
                         "value)" % (chunk_len, K))
    W = tables.warmup
    raw = local_bytes if isinstance(local_bytes, np.ndarray) \
        else np.frombuffer(local_bytes, dtype=np.uint8)
    n_loc = len(raw)
    if n_loc == 0:
        raise ValueError("every process must hold a non-empty slice")
    tail = raw[-W:] if W else raw[:0]
    meta = _allgather(np.concatenate(
        [[n_loc, len(tail)], np.pad(tail, (0, W - len(tail)))]))
    Ns = meta[:, 0]
    if int(Ns.sum()) != full_len:
        raise ValueError("slices cover %d bytes, corpus is %d"
                         % (int(Ns.sum()), full_len))
    # chunk 0's warmup: the last W corpus bytes before this slice
    before = b"".join(meta[q, 2:2 + meta[q, 1]].astype(np.uint8).tobytes()
                      for q in range(pid))[-W:] if W else b""
    tail_cls = None
    if pid > 0:
        tail_cls = np.zeros(W, dtype=np.uint8)
        mapped = np.frombuffer(before.translate(tables.class_map.tobytes()),
                               dtype=np.uint8)
        if len(mapped):
            tail_cls[W - len(mapped):] = mapped
    data, C_loc, _, _, B = prepare_auto(tables, raw, K, mesh=mesh,
                                        prev_tail_cls=tail_cls)
    topm = getattr(tables, "to_premult", None) or (
        lambda v: v * tables.ncls)
    s0, j0 = _entry_planes(topm(entry_state) if pid == 0 else 0,
                           W if pid == 0 else 0, B, data.device)
    bad_tail = (C_loc - 1) if C_loc * K > n_loc else -1
    planes = tables._planes(data, s0, j0, W, COUNT, mesh)
    swarm0 = planes[2].reshape(-1)[:1]
    if pid > 0:
        # chunk 0 is checked on the host against the previous exit
        s0 = s0.clone()
        s0.view(-1)[:1] = swarm0
    summ, packed = _summary_and_planes(planes, s0, C_loc, bad_tail, COUNT,
                                       tables.wide)
    S = _allgather(np.concatenate([summ.cpu().numpy().astype(np.int64),
                                   swarm0.cpu().numpy().astype(np.int64)]))
    Cs = np.maximum(1, -(-Ns // K))
    return SimpleNamespace(
        pid=pid, nproc=nproc, K=K, n=full_len, S=S, packed=packed,
        C_loc=C_loc, raw=raw, Ns=Ns, Cs=Cs, C=int(Cs.sum()),
        aligned=all(int(Ns[q]) % K == 0 for q in range(nproc - 1)),
        first_chunk=np.concatenate(([0], np.cumsum(Cs))),
        slice_off=np.concatenate(([0], np.cumsum(Ns))))


def _chains_validate(mh):
    """The fast path's test: aligned slices, every process's chain
    validated, every process's chunk 0 speculated the exit of the one
    before, and every local count exact in int32."""
    S = mh.S
    return mh.aligned and bool(S[:, 0].all()) \
        and all(S[q, 10] == S[q - 1, 6] for q in range(1, mh.nproc)) \
        and int(mh.Ns.max()) < 2 ** 31


def _planes(mh):
    """Every process's per-chunk planes (phi, count or fire, swarm) as
    int64 numpy over the corpus's chunks in order, and ``full`` (chunk c
    holds K corpus bytes: each process's last chunk is short where its
    slice is not whole chunks)."""
    mine = np.zeros((3, int(mh.Cs.max())), dtype=np.int64)
    mine[:, :mh.C_loc] = _unpack(mh.packed, mh.C_loc)
    every = _allgather(mine.reshape(-1)).reshape(mh.nproc, 3, -1)
    phi, cnt, swarm = (np.concatenate([every[q, k, :int(mh.Cs[q])]
                                       for q in range(mh.nproc)])
                       for k in range(3))
    full = np.ones(mh.C, dtype=bool)
    for q in range(mh.nproc):
        if int(mh.Ns[q]) % mh.K:
            full[int(mh.first_chunk[q + 1]) - 1] = False
    return phi, cnt, swarm, full


def _owner_of(mh, c):
    """(owning process, lo, hi) of corpus chunk c within its slice."""
    p = int(np.searchsorted(mh.first_chunk, c, side="right")) - 1
    lo = (c - int(mh.first_chunk[p])) * mh.K
    return p, lo, min(lo + mh.K, int(mh.Ns[p]))


def _breaks(phi, swarm, ok):
    cont = np.zeros(len(phi), dtype=bool)
    cont[:-1] = ok[1:] & (swarm[1:] == phi[:-1])
    return np.flatnonzero(~cont)


def count_multihost(tables, local_bytes, mesh, chunk_len, full_len,
                    entry_state=0):
    """Count the match-ending boundaries (0..full_len-1) of the corpus
    of which this process holds ``local_bytes`` (a host_slices range, or
    any non-empty range in corpus order), scanned on ``mesh`` (this
    process's devices; None: the tables' device).  Returns (final_state,
    count), the same on every process; the EOF boundary is the
    caller's."""
    mh = _launch(tables, local_bytes, mesh, chunk_len, full_len,
                 entry_state, True)
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    if _chains_validate(mh):
        return frpm(int(mh.S[-1, 6])), int(mh.S[:, 7].sum())
    phi, cnt, swarm, full = _planes(mh)
    breaks = _breaks(phi, swarm, full)
    cum = np.cumsum(cnt)
    native = NativeDfa(tables.dfa)
    e, c, total = topm(entry_state), 0, 0
    while c < mh.C:
        if full[c] and swarm[c] == e:
            b = int(breaks[np.searchsorted(breaks, c)])
            total += int(cum[b] - (cum[c - 1] if c else 0))
            e = int(phi[b])
            c = b + 1
            continue
        owner, lo, hi = _owner_of(mh, c)
        mine = [0, 0]
        if mh.pid == owner:
            k, st = native.count(mh.raw[lo:hi].tobytes(), frpm(e))
            mine = [k, topm(st)]
        k, e = _from_owner(mine, owner)
        total += k
        c += 1
    return frpm(e), total


def scan_multihost(tables, local_bytes, mesh, chunk_len, full_len,
                   entry_state=0):
    """The earliest match end over the corpus of which this process
    holds ``local_bytes`` (as for count_multihost).  Returns
    (final_or_boundary_state, end, regex_id), the same on every process:
    end -1 where no boundary 0..full_len-1 ends a match (EOF is the
    caller's); on a match the state AT the boundary and the id resolved
    by the process holding the byte there."""
    mh = _launch(tables, local_bytes, mesh, chunk_len, full_len,
                 entry_state, False)
    ncls = tables.ncls
    topm = getattr(tables, "to_premult", None) or (lambda v: v * ncls)
    frpm = getattr(tables, "from_premult", None) or (lambda v: v // ncls)
    if _chains_validate(mh):
        # every chunk validated fire-free: no interior match
        return frpm(int(mh.S[-1, 6])), -1, -1
    phi, fm, swarm, full = _planes(mh)
    quiet = full & (fm == 0)
    breaks = _breaks(phi, swarm, quiet)
    native = NativeDfa(tables.dfa)
    e, c = topm(entry_state), 0
    while c < mh.C:
        if quiet[c] and swarm[c] == e:
            b = int(breaks[np.searchsorted(breaks, c)])
            e = int(phi[b])
            c = b + 1
            continue
        owner, lo, hi = _owner_of(mh, c)
        mine = [0, 0, 0]
        if mh.pid == owner:
            f, st = native.scan_first(mh.raw[lo:hi].tobytes(), frpm(e))
            rid = tables.dfa.id_at(st, mh.raw[lo + f]) if f >= 0 else -1
            mine = [f, topm(st), rid]
        f, st, rid = _from_owner(mine, owner)
        if f >= 0:
            return frpm(st), int(mh.slice_off[owner]) + lo + f, rid
        e = st
        c += 1
    return frpm(e), -1, -1
