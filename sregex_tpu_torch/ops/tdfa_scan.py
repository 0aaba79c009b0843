"""Device tagged-DFA scan: capture registers and the match bank updated
per byte inside the kernel, so Scanner.find gets the leftmost-first
match WITH its captures in one pass.

Counterpart of the JAX package's ops/tdfa_scan.py (TdfaSpecTables,
the kernel _tdfa_kernel with _resolve, the device summary of
_tdfa_scan, the host folds _host_walk/_walk_chunk/_chunk_repair,
tdfa_spec_find and the batched tdfa_find_many).  The host TDFA
(tdfa.py) determinizes one Pike step into, per (state, byte class):

  - a next state,
  - a register rebuild: new_reg[k] = one of {old reg j, UNSET,
    CURRENT position, NEXT position},
  - at most one commit: bank[t] = resolved source per tag, plus the
    regex id.

Those source codes are packed CODE bits per slot (4, 8 or 16) into
int32 code planes indexed by state + class, flat [rows*128] each (the
TPU's copy of every row over 8 sublanes was a Mosaic gather artefact).
The kernel (csrc/tdfa_scan.cu) advances one chunk stream per thread.

Chunk speculation as in ops/spec_scan.py: the STATE converges through
the warmup window; REGISTERS are not speculated.  They start every
chunk BAD, the warmup advances the state only, and any value that
traces to the entry or the warmup stays BAD.  A bank whose positions
are all real (>= 0) was committed entirely from bytes the chunk saw
and is exact once the state chain validates.  Anything else
(speculation miss, ragged tail, BAD positions, i.e. a match longer
than the chunk+warmup window) folds through the host chunk repair or
returns "fallback", and the caller runs the exact multi-pass path.

Budget: S * ncls table entries.  On the CPU 512 (4 rows), so the CPU
tests decline exactly what the JAX package declines in interpret mode;
on the card 2048 (16 rows), the TPU's budget, so both packages give
the one-pass path to the same machines.  At that budget the planes of
every 4- and 8-bit-code machine fit a block's shared memory (at most
14 planes, 112 KB); 16-bit-code machines past 227 KB of planes read
them from global memory (csrc/tdfa_scan.cu).  SREGEX_TDFA_MAX
overrides, in table entries, as in the JAX package.
"""

import ctypes
import os
import time

import numpy as np
import torch

from ..tdfa import (CTX_BOS, SRC_CUR, SRC_NEXT, SRC_UNSET, Tdfa,
                    TdfaTooLarge)
from . import batch
from .batch import _batch_entry_planes, _fits, batch_prepare
from .layout import DEFAULT_K, GROUPS, TILE, max_chunk_bytes
from .spec_scan import resolve_device

BAD = -(2 ** 30)

# register/tag budgets per code width: 4-bit codes up to 13 (8 slots a
# plane), byte codes up to 24, 16-bit codes up to 48 (2 slots a plane)
R_MAX = 13
T_MAX = 13
R_MAX8 = 24
T_MAX8 = 24
R_MAX16 = 48
T_MAX16 = 48
_SLOT_MAX = {4: R_MAX, 8: R_MAX8, 16: R_MAX16}   # registers or tags
MAX_ENTRIES = 512          # the CPU (the JAX package's interpret-mode cap)
MAX_ENTRIES_CUDA = 2048    # the card (the TPU's cap)

# kernel launches since the last reset (the CUDA path only)
tdfa_scan_launches = 0


def _tdfa_max(device):
    env = os.environ.get("SREGEX_TDFA_MAX")
    if env is not None:
        return int(env)
    return MAX_ENTRIES_CUDA if device.type == "cuda" else MAX_ENTRIES


def _specials(code_bits):
    """(UNSET, CUR, NEXT) codes: the top three of the code space, so
    register ids run 0 .. 2^bits - 4."""
    top = (1 << code_bits) - 1
    return top - 2, top - 1, top


def _src_code(src, code_bits):
    c_unset, c_cur, c_next = _specials(code_bits)
    if src == SRC_UNSET:
        return c_unset
    if src == SRC_CUR:
        return c_cur
    if src == SRC_NEXT:
        return c_next
    if src >= c_unset:
        raise TdfaTooLarge("register id %d exceeds the %d-bit code "
                           "space" % (src, code_bits))
    return src              # old register id


def _pack_planes(t, S, ncls, R, T, code_bits):
    """Pack the kernel's planes for the S materialized states of tagged
    DFA t.  Returns (rows, planes) with planes = (t_next [rows*128],
    t_regsrc [PR, rows*128], t_csrc [PT, rows*128], t_cmeta
    [rows*128]), int32 numpy; PR/PT = ceil(R/slots-per-plane) stacked
    code planes (slot k lives in plane k//spp at bit
    code_bits*(k%spp))."""
    rows = -(-(S * ncls) // 128)
    spp = 32 // code_bits
    c_unset, _, _ = _specials(code_bits)
    t_next = np.zeros(rows * 128, dtype=np.int32)
    # per-slot code arrays, packed into int32 planes at the end (codes
    # landing in the sign bit are masked after the shift)
    reg_codes = np.full((rows * 128, max(1, R)), c_unset,
                        dtype=np.uint32)
    bank_codes = np.zeros((rows * 128, max(1, T)), dtype=np.uint32)
    t_cmeta = np.zeros(rows * 128, dtype=np.int32)
    for s in range(S):
        for c in range(ncls):
            nsid, ops, commit = t.step(s, c)
            idx = s * ncls + c
            t_next[idx] = nsid * ncls
            for d, src in ops:
                if d >= R:
                    raise TdfaTooLarge("register slot %d exceeds the "
                                       "packing (R=%d)" % (d, R))
                reg_codes[idx, d] = _src_code(src, code_bits)
            if commit is not None:
                srcs, rid = commit
                for ti, src in enumerate(srcs):
                    bank_codes[idx, ti] = _src_code(src, code_bits)
                t_cmeta[idx] = 1 | (rid << 1)

    def pack(codes, n):
        P = max(1, -(-n // spp))
        out = np.zeros((P, rows * 128), dtype=np.uint32)
        for k in range(codes.shape[1]):
            out[k // spp] |= codes[:, k] << np.uint32(
                code_bits * (k % spp))
        return out.view(np.int32)

    return rows, (t_next, pack(reg_codes, R), pack(bank_codes, T),
                  t_cmeta)


def _default_tags(prog):
    """Every capture slot when they fit the 16-bit codes, else the $0
    pair of each regex."""
    if prog.ovecsize <= T_MAX16:
        return tuple(range(prog.ovecsize))
    tags = []
    ofs = 0
    for i in range(prog.nregexes):
        tags += [ofs, ofs + 1]
        ofs += 2 * (prog.multi_ncaps[i] + 1)
    return tuple(tags)


class TdfaSpecTables:
    """Host compilation of a (lazy) Tdfa into dense code planes for the
    kernel, on ``device``.  Materializes every reachable state by BFS
    over byte classes; raises TdfaTooLarge past the budget
    (_tdfa_max) or the code space.

    What the prep and the folds read: device, class_map, bits, cpw,
    warmup (4 * cpw bytes), max_chunk, ncls; nregs (R), ntags (T),
    code_bits, rows, seed_premult, dead_premult (-1: no dead state),
    the flat planes t_next, t_regsrc, t_csrc, t_cmeta, and last_repair
    ((host-walked chunks, covered chunks) of the last device find)."""

    last_repair = None

    def __init__(self, prog, device, tags=None):
        self.device = resolve_device(device)
        if tags is None:
            tags = _default_tags(prog)
        if len(tags) > T_MAX16:
            raise TdfaTooLarge("too many tracked tags (%d)" % len(tags))
        if prog.nregexes > 127:
            raise TdfaTooLarge("too many regexes (%d)" % prog.nregexes)
        budget = _tdfa_max(self.device)
        t = Tdfa(prog, tags=tags, max_states=max(256, budget // 2),
                 max_regs=R_MAX16)
        self.tdfa = t
        self.tags = tuple(tags)
        self.ncls = t.nclasses
        if t.nclasses > 256:
            raise TdfaTooLarge("more than 256 byte classes (%d): "
                               "class ids must fit the 8-bit data "
                               "words" % t.nclasses)

        # materialize (transitions build states lazily)
        frontier = list(range(t.nstates))
        seen = set(frontier)
        i = 0
        while i < len(frontier):
            sid = frontier[i]
            i += 1
            for c in range(t.nclasses):
                nsid, _, _ = t.step(sid, c)
                if t.nstates * t.nclasses > budget:
                    raise TdfaTooLarge(
                        "TDFA too large for the device kernel "
                        "(S*ncls=%d > %d)"
                        % (t.nstates * t.nclasses, budget))
                if nsid not in seen:
                    seen.add(nsid)
                    frontier.append(nsid)
        S = t.nstates
        if S * t.nclasses > budget:
            raise TdfaTooLarge("S*ncls=%d" % (S * t.nclasses))

        self.nstates = S
        self.nregs = max(t.nregs(s) for s in range(S))
        self.ntags = len(tags)
        ncls = t.nclasses
        dead = -1
        for s in range(S):
            if t.is_dead(s):
                dead = s * ncls
        self.dead_premult = dead
        self.seed_premult = t.seed_state(CTX_BOS) * ncls

        # 4-bit codes when regs AND tags fit 13, byte codes up to 24,
        # 16-bit codes up to 48
        self.code_bits = (
            4 if (self.nregs <= R_MAX and self.ntags <= T_MAX)
            else 8 if (self.nregs <= R_MAX8 and self.ntags <= T_MAX8)
            else 16)
        self.rows, planes = _pack_planes(t, S, ncls, self.nregs,
                                         self.ntags, self.code_bits)
        (self.t_next, self.t_regsrc, self.t_csrc, self.t_cmeta) = (
            torch.from_numpy(p).to(self.device) for p in planes)

        # the untagged tiers' data prep: 4-bit class words, 8-bit past
        # 16 classes; K stays 2048 (no VMEM clamp on the card)
        self.bits = 8 if ncls > 16 else 4
        self.cpw = 32 // self.bits
        self.warmup = 4 * self.cpw
        self.max_chunk = max_chunk_bytes(self.cpw)
        self.class_map = t.class_map.astype(np.uint8)

    def planes(self):
        """The kernel's table arguments (t_next, t_regsrc, t_csrc,
        t_cmeta) and its static arguments."""
        return ((self.t_next, self.t_regsrc, self.t_csrc, self.t_cmeta),
                dict(W=self.warmup, CPW=self.cpw, BITS=self.bits,
                     CODE=self.code_bits, R=self.nregs, T=self.ntags))

    # kernel <-> full state id mapping (identity for the full tables; a
    # hot-core projection would override both)
    def to_kernel_premult(self, sid):
        return sid * self.ncls

    def from_kernel_premult(self, premult):
        return premult // self.ncls


def _check_tdfa_args(data, state0, j0, tabs, W, CPW, BITS, CODE, R, T):
    """The checks the wrapper makes before it launches."""
    t_next, t_regsrc, t_csrc, t_cmeta = tabs
    for t in (data, state0, j0, *tabs):
        if not isinstance(t, torch.Tensor):
            raise TypeError("tdfa_scan takes tensors, got %r" % type(t))
        if t.dtype != torch.int32:
            raise TypeError("tdfa_scan takes int32 tensors, got %s"
                            % t.dtype)
        if not t.is_contiguous():
            raise ValueError("tdfa_scan takes contiguous tensors")
        if t.device != data.device:
            raise ValueError("tdfa_scan tensors lie on different devices "
                             "(%s, %s)" % (data.device, t.device))
    if data.dim() != 5 or tuple(data.shape[3:]) != (8, TILE // 8):
        raise ValueError("data must be [B, Jw, G, 8, 128], got %s"
                         % (tuple(data.shape),))
    B, Jw, G = data.shape[:3]
    for name, t in (("state0", state0), ("j0", j0)):
        if tuple(t.shape) != (B, G, 8, TILE // 8):
            raise ValueError("%s must be %s, got %s"
                             % (name, (B, G, 8, 128), tuple(t.shape)))
    n = t_next.numel()
    if t_next.dim() != 1 or n == 0 or n % 128 \
            or tuple(t_cmeta.shape) != (n,):
        raise ValueError("t_next and t_cmeta must be int32 [rows*128], "
                         "got %s, %s" % (tuple(t_next.shape),
                                         tuple(t_cmeta.shape)))
    if CODE not in _SLOT_MAX:
        raise ValueError("CODE must be 4, 8 or 16, got %r" % (CODE,))
    spp = 32 // CODE
    for name, planes, k in (("t_regsrc", t_regsrc, R),
                            ("t_csrc", t_csrc, T)):
        if not 0 <= k <= _SLOT_MAX[CODE]:
            raise ValueError("%d %s slots exceed the %d-bit codes"
                             % (k, name, CODE))
        if planes.dim() != 2 or planes.shape[1] != n \
                or planes.shape[0] < max(1, -(-k // spp)):
            raise ValueError("%s must be [>= %d, %d], got %s" % (
                name, max(1, -(-k // spp)), n, tuple(planes.shape)))
    if (BITS, CPW) not in ((4, 8), (8, 4)):
        raise ValueError("BITS=%r, CPW=%r: the tagged scan packs 8 4-bit "
                         "or 4 8-bit classes per word" % (BITS, CPW))
    if W < 0 or W % CPW or W > Jw * CPW:
        raise ValueError("W=%d units does not fit %d words of %d units"
                         % (W, Jw, CPW))


def tdfa_scan(data, state0, j0, t_next, t_regsrc, t_csrc, t_cmeta, *,
              W, CPW, BITS, CODE, R, T):
    """Run the tagged-DFA scan kernel.  data int32 [B, Jw, G, 8, 128]
    (CPW BITS-bit classes per word); state0/j0 int32 [B, G, 8, 128];
    t_next/t_cmeta int32 [rows*128]; t_regsrc/t_csrc int32
    [P, rows*128] code planes (CODE bits per slot); W the warmup in
    bytes; R registers, T tracked tags.  Returns (phi, swarm, bank,
    regs): int32 [B, G, 8, 128] twice, [T+1, B, G, 8, 128] (the last
    plane the regex id, -1 for none) and [R, B, G, 8, 128], positions
    in window coordinates (BAD = -2**30 for a value that predates the
    window).

    CUDA tensors launch csrc/tdfa_scan.cu on the current stream (no
    synchronisation) or raise.  CPU tensors take tdfa_scan_ref."""
    global tdfa_scan_launches
    tabs = (t_next, t_regsrc, t_csrc, t_cmeta)
    _check_tdfa_args(data, state0, j0, tabs, W, CPW, BITS, CODE, R, T)
    kw = dict(W=W, CPW=CPW, BITS=BITS, CODE=CODE, R=R, T=T)
    if data.device.type == "cpu":
        return tdfa_scan_ref(data, state0, j0, *tabs, **kw)
    if data.device.type != "cuda":
        raise ValueError("tdfa_scan runs on cuda or cpu tensors, got %s"
                         % data.device)
    from . import _build
    lib = _build.load()
    phi, swarm = torch.empty_like(state0), torch.empty_like(state0)
    bank = torch.empty((T + 1,) + tuple(state0.shape), dtype=torch.int32,
                       device=data.device)
    regs = torch.empty((R,) + tuple(state0.shape), dtype=torch.int32,
                       device=data.device)
    B, Jw, G = data.shape[:3]
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.sre_tdfa_scan(
            data.data_ptr(), state0.data_ptr(), j0.data_ptr(),
            t_next.data_ptr(), t_regsrc.data_ptr(), t_csrc.data_ptr(),
            t_cmeta.data_ptr(), t_next.numel(), t_regsrc.shape[0],
            t_csrc.shape[0], phi.data_ptr(), swarm.data_ptr(),
            bank.data_ptr(), regs.data_ptr(), B, Jw, G, W, CPW, BITS,
            CODE, R, T, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError("sre_tdfa_scan launch failed: cudaError %d"
                           % rc)
    tdfa_scan_launches += 1
    return phi, swarm, bank, regs


def _resolve_ref(codes, regs, j, CODE):
    """Source codes [K, ...] -> values: old register, -1 (UNSET), j
    (CUR), j + 1 (NEXT); a register id past R resolves to BAD."""
    c_unset, c_cur, c_next = _specials(CODE)
    R = regs.shape[0]
    if R:
        v = regs.gather(0, codes.clamp(max=R - 1).long())
        v = torch.where(codes < R, v, BAD)
    else:
        v = torch.full_like(codes, BAD)
    v = torch.where(codes == c_unset, -1, v)
    v = torch.where(codes == c_cur, j, v)
    return torch.where(codes == c_next, j + 1, v)


def tdfa_scan_ref(data, state0, j0, t_next, t_regsrc, t_csrc, t_cmeta, *,
                  W, CPW, BITS, CODE, R, T):
    """The plain torch version of tdfa_scan, on any device: a loop over
    the J window positions, vectorised over all streams.  An index
    outside the tables reads entry (index & 127), as the kernel and the
    TPU kernel's row-select chain do."""
    n = t_next.numel()
    spp = 32 // CODE
    cmask = (1 << BITS) - 1
    kmask = (1 << CODE) - 1
    shape = tuple(state0.shape)
    rplane = torch.tensor([k // spp for k in range(R)], dtype=torch.long,
                          device=data.device)
    rshift = torch.tensor([CODE * (k % spp) for k in range(R)],
                          dtype=torch.int32, device=data.device)
    tplane = torch.tensor([k // spp for k in range(T)], dtype=torch.long,
                          device=data.device)
    tshift = torch.tensor([CODE * (k % spp) for k in range(T)],
                          dtype=torch.int32, device=data.device)
    bcast = (-1,) + (1,) * len(shape)

    def codes(planes, idx, plane, shift):
        words = planes[:, idx][plane]                 # [K, ...]
        return (words >> shift.view(bcast)) & kmask

    def index(s, j):
        idx = s + ((data[:, j // CPW] >> (BITS * (j % CPW))) & cmask)
        return torch.where((idx >= 0) & (idx < n), idx, idx & 127).long()

    # the warmup advances the state only, frozen below j0
    s = state0
    for j in range(W):
        s = torch.where(j >= j0, t_next[index(s, j)], s)
    swarm = s
    # registers start at the entry position on the true-entry stream
    # (j0 > 0), BAD elsewhere; the bank starts BAD with no regex id
    regs = torch.where(j0 > 0, j0, BAD).expand((R,) + shape).clone()
    bank = torch.full((T + 1,) + shape, BAD, dtype=torch.int32,
                      device=data.device)
    bank[T] = -1
    for j in range(W, data.shape[1] * CPW):
        idx = index(s, j)
        e = t_next[idx]
        cm = t_cmeta[idx]
        has = (cm & 1) == 1
        if T:
            nb = _resolve_ref(codes(t_csrc, idx, tplane, tshift), regs,
                              j, CODE)
            bank[:T] = torch.where(has, nb, bank[:T])
        bank[T] = torch.where(has, cm >> 1, bank[T])
        regs = _resolve_ref(codes(t_regsrc, idx, rplane, rshift), regs,
                            j, CODE)
        s = e
    return s, swarm, bank, regs


def _summarize(phi, swarm, bank, regs, state0, C, dead_val):
    """The device summary of the tagged scan, as torch ops on the
    planes' device (the JAX package's _tdfa_scan).  Returns (summary
    int32 [10 + T+1 + R], phi_f, swarm_f, bank_f [T+1, Cp], regs_f
    [R, Cp]):
      [0] ok (chain valid through the covered chunks, or the scan
          ended at a dead exit before the first break)
      [1] fb: first broken chunk (C if none)
      [2] first chunk (in the valid prefix) whose exit state is dead
          (C if none)
      [3] lc: last chunk before the scan's end with a committed bank
          (-1 none)
      [4] phi at the end of the covered region  [5] entries@fb
      [6] swarm@fb  [7] phi@fb  [8] C  [9] 0
      [10 .. 10+T] bank values + rid @ lc
      [10+T+1 ..]  exit registers @ the last covered chunk"""
    Cp = phi.numel()
    T1, R = bank.shape[0], regs.shape[0]
    phi_f, swarm_f = phi.reshape(Cp), swarm.reshape(Cp)
    bank_f, regs_f = bank.reshape(T1, Cp), regs.reshape(R, Cp)
    entries = torch.cat([state0.reshape(Cp)[:1], phi_f[:-1]])
    idx = torch.arange(Cp, dtype=torch.int32, device=phi.device)
    okv = (swarm_f == entries) | (idx >= C)
    all_ok = okv.all()
    fb = torch.where(all_ok, C, torch.where(okv, Cp, idx).min())
    # the scan ENDS at the first dead exit; chunks after it never
    # converge to dead (speculation wanders live states), so the chain
    # only needs to validate up to and including the death chunk
    deadv = (phi_f == dead_val) & (idx < C)
    first_dead = torch.where(deadv, idx, C).min()
    ended = first_dead < fb
    ok = all_ok | ended
    scan_end = torch.where(ended, first_dead + 1, C)
    hasc = (bank_f[T1 - 1] >= 0) & (idx < scan_end)
    lc = torch.where(hasc, idx, -1).max()
    last_cov = (scan_end - 1).clamp(min=0)
    fbc = fb.clamp(max=Cp - 1)

    def at(v, i):
        return v.index_select(-1, i.reshape(1).long()).reshape(-1)

    head = torch.stack([
        ok.to(torch.int32), fb.to(torch.int32),
        first_dead.to(torch.int32), lc.to(torch.int32)])
    summary = torch.cat([
        head, at(phi_f, last_cov), at(entries, fbc), at(swarm_f, fbc),
        at(phi_f, fbc),
        torch.tensor([C, 0], dtype=torch.int32, device=phi.device),
        at(bank_f, lc.clamp(min=0)), at(regs_f, last_cov)])
    return summary, phi_f, swarm_f, bank_f, regs_f


def _tdfa_scan(tables, data, state0, j0, C):
    """Kernel + device summary over ``tables``."""
    tabs, kw = tables.planes()
    planes = tdfa_scan(data, state0, j0, *tabs, **kw)
    return _summarize(*planes, state0, C, tables.dead_premult)


def _host_walk(tables, sid, regs, bank, rid, data_np, pos, n):
    """Sequential table walk over data_np[pos:n] + the EOF boundary,
    continuing from (sid, regs, bank, rid).  regs entries may be None
    (BAD: value predates the known window) — touching one forces a
    fallback.  Returns (rid, bank) | None | "fallback"."""
    t = tables.tdfa
    if pos < n:
        cmap = t.class_map
        raw = np.frombuffer(data_np, dtype=np.uint8) \
            if not isinstance(data_np, np.ndarray) else data_np
        arr = cmap[raw[pos:n]]
        for i_ in range(n - pos):
            nsid, ops, commit = t.step(sid, int(arr[i_]))
            cur = pos + i_
            nxt = cur + 1

            def res(s):
                if s == SRC_UNSET:
                    return -1
                if s == SRC_CUR:
                    return cur
                if s == SRC_NEXT:
                    return nxt
                return regs[s]
            if commit is not None:
                bank = [res(s) for s in commit[0]]
                rid = commit[1]
            if ops:
                regs = [res(s) for _d, s in ops]
            else:
                regs = []
            sid = nsid
            if t.is_dead(sid):
                break
    if t.is_dead(sid):
        if bank is None:
            return None
        if any(b is None for b in bank):
            return "fallback"
        return rid, bank

    commit = t.eof_step(sid)
    if commit is not None:
        def res_eof(s):
            if s == SRC_UNSET:
                return -1
            if s == SRC_CUR or s == SRC_NEXT:
                return n
            return regs[s]
        bank = [res_eof(s) for s in commit[0]]
        rid = commit[1]
    if bank is None:
        return None
    if any(b is None for b in bank):
        return "fallback"
    return rid, bank


def _walk_chunk(t, sid, regs, bank, rid, raw, lo, hi):
    """Host TDFA walk over raw[lo:hi] from (sid, regs); returns the
    carried (sid, regs, bank, rid).  Positions are absolute."""
    cmap = t.class_map
    arr = cmap[raw[lo:hi]]
    for i_ in range(hi - lo):
        nsid, ops, commit = t.step(sid, int(arr[i_]))
        cur = lo + i_
        nxt = cur + 1

        def res(s):
            if s == SRC_UNSET:
                return -1
            if s == SRC_CUR:
                return cur
            if s == SRC_NEXT:
                return nxt
            return regs[s]
        if commit is not None:
            bank = [res(s) for s in commit[0]]
            rid = commit[1]
        regs = [res(s) for _d, s in ops] if ops else []
        sid = nsid
        if t.is_dead(sid):
            break
    return sid, regs, bank, rid


def _chunk_repair(tables, phi_f, swarm_f, bank_f, regs_f, data_np,
                  full_C, K, W, n):
    """Per-chunk repair of a speculation-missed TDFA scan: walk the
    chunk chain exactly on the host, decoding TRUSTED chunks
    (speculated entry == true entry) from the kernel's per-chunk planes
    — their post-warmup register rebuilds are provably the true
    machine's — and re-walking on the host TDFA any chunk whose values
    are still BAD-tainted (trace to the entry or the warmup).  Records
    (host-walked chunks, full_C) in tables.last_repair.  Returns
    (rid, bank) | None (certified no-match) | "fallback" when more than
    ~6% of the chunks need host walks (the caller then prefers the
    multi-pass device path)."""
    t = tables.tdfa
    T = tables.ntags
    raw = np.frombuffer(data_np, dtype=np.uint8) \
        if not isinstance(data_np, np.ndarray) else data_np
    budget = max(32, full_C // 16)
    walked = 0
    sid = t.seed_state(CTX_BOS)
    regs = [0] * t.nregs(sid)
    bank = None
    rid = -1
    c = 0
    while c < full_C:
        kp = tables.to_kernel_premult(sid)
        # trusted only when the kernel's converged entry state equals
        # the true one
        exit_sid = tables.from_kernel_premult(int(phi_f[c])) \
            if int(swarm_f[c]) == kp else None
        if exit_sid is not None:
            nk = t.nregs(exit_sid)
            vals = [int(regs_f[k, c]) for k in range(nk)]
            crid = int(bank_f[T, c])
            bvals = [int(bank_f[ti, c]) for ti in range(T)] \
                if crid >= 0 else []
            if all(v >= -1 for v in vals) \
                    and all(v >= -1 for v in bvals):
                base = c * K - W
                regs = [v + base if v >= 0 else -1 for v in vals]
                if crid >= 0:
                    bank = [v + base if v >= 0 else -1 for v in bvals]
                    rid = crid
                sid = exit_sid
                c += 1
                if t.is_dead(sid):
                    break
                continue
        walked += 1
        if walked > budget:
            tables.last_repair = (walked, full_C)
            return "fallback"       # too many misses (None = no-match)
        sid, regs, bank, rid = _walk_chunk(
            t, sid, regs, bank, rid, raw, c * K, min((c + 1) * K, n))
        c += 1
        if t.is_dead(sid):
            break
    tables.last_repair = (walked, full_C)
    # finish: ragged tail (+ EOF boundary), or just the dead/EOF
    # resolution when the covered region completed
    return _host_walk(tables, sid, regs, bank, rid, data_np,
                      min(c * K, n), n)


def tdfa_find_many(tables, docs, chunk_len=DEFAULT_K, prepared=None):
    """Batched one-pass tagged find over a document set: one kernel
    launch, per-document results; the capture analogue of ops/batch.py.
    Document starts enter at the seed with the warmup frozen (j0 = W),
    as chunk 0 does, and every document folds on its own through
    _chunk_repair, whose positions are document-local by construction
    (the whole-stream summary cannot serve per-document results).
    ``prepared``: a PreparedBatch of these documents for ``tables``
    (Scanner.prepare_many(docs, for_find=True)); any other is re-prepped.
    Returns a list of (rid, bank) | None (certified no-match) |
    "fallback" per document, and sets tables.last_repair to (chunks
    walked on the host in all documents, chunks).  Raises
    BatchUnsupported where no byte maps to class 0."""
    t0 = time.perf_counter()
    docs = [d if isinstance(d, (bytes, bytearray)) else bytes(d)
            for d in docs]
    t = tables.tdfa
    W = tables.warmup

    def seed_entry():
        sid = t.seed_state(CTX_BOS)
        return sid, [0] * t.nregs(sid)

    if not _fits(prepared, tables, docs):
        prepared = batch_prepare(tables, docs, chunk_len)
    K, spans = prepared.K, prepared.spans
    data, C, _, _, B = prepared.prepared
    state0, j0 = _batch_entry_planes(W, prepared.starts,
                                     tables.seed_premult, B)
    _, *planes = _tdfa_scan(tables, data, state0, j0, C)
    t1 = time.perf_counter()
    phi, swarm, bank, regs = (p.cpu().numpy() for p in planes)
    t2 = time.perf_counter()
    out = []
    walked = 0
    for (c0, cd, n), doc in zip(spans, docs):
        full_C = cd if cd * K == n else cd - 1
        if full_C <= 0:
            # empty, or shorter than one chunk: the host walks it all
            sid, rg = seed_entry()
            out.append(_host_walk(tables, sid, rg, None, -1, doc, 0, n))
            continue
        try:
            r = _chunk_repair(tables, phi[c0:c0 + cd], swarm[c0:c0 + cd],
                              bank[:, c0:c0 + cd], regs[:, c0:c0 + cd],
                              doc, full_C, K, W, n)
            walked += tables.last_repair[0]
        except TdfaTooLarge:
            r = "fallback"
        out.append(r)
    tables.last_repair = (walked, C)
    batch.last_timing = {"dispatch_s": t1 - t0, "readback_s": t2 - t1,
                         "fold_s": time.perf_counter() - t2}
    return out


def tdfa_spec_find(tables, data_np, chunk_len=DEFAULT_K, prepared=None):
    """First final match over the whole buffer: (regex_id, bank) with
    bank the tracked-tag vector in absolute corpus positions, None for
    no-match, or the string "fallback" when the device result cannot
    be certified exact (speculation miss past the repair budget, or a
    match span exceeding the chunk window that the repair cannot
    resolve).  Callers treat "fallback" by running the exact
    multi-pass path.  Only the summary is read back on the certified
    path; the planes come back only for the chunk repair."""
    t = tables.tdfa
    n = len(data_np)
    W = tables.warmup
    tables.last_repair = None

    def seed_entry():
        sid = t.seed_state(CTX_BOS)
        return sid, [0] * t.nregs(sid)

    if n == 0:
        sid, regs = seed_entry()
        return _host_walk(tables, sid, regs, None, -1, data_np, 0, 0)
    if prepared is None:
        from .prep import prepare_auto
        prepared = prepare_auto(tables, data_np, chunk_len)
    data, C, K, _J, B = prepared
    # ragged tail: the device covers only full chunks; the tail is
    # finished on the host from the last covered exit state/registers
    full_C = C if C * K <= n else C - 1
    if full_C == 0:
        sid, regs = seed_entry()
        return _host_walk(tables, sid, regs, None, -1, data_np, 0, n)

    R, T = tables.nregs, tables.ntags
    state0 = torch.full((B, GROUPS, 8, TILE // 8), tables.seed_premult,
                        dtype=torch.int32, device=data.device)
    j0 = torch.zeros_like(state0)
    j0[0, 0, 0, 0] = W
    summary, *planes = _tdfa_scan(tables, data, state0, j0, full_C)
    summ = summary.cpu().numpy().astype(np.int64)

    def repair():
        phi_f, swarm_f, bank_f, regs_f = (p.cpu().numpy() for p in planes)
        try:
            return _chunk_repair(tables, phi_f, swarm_f, bank_f, regs_f,
                                 data_np, full_C, K, W, n)
        except TdfaTooLarge:
            # a lazy machine can exhaust max_states mid-walk
            return "fallback"

    if not bool(summ[0]):
        # chunk-wise repair: validate the chain on the host per chunk,
        # decoding trusted chunks from the per-chunk planes and
        # re-walking the rest on the host TDFA
        return repair()

    tables.last_repair = (0, full_C)
    dead_chunk, lc = int(summ[2]), int(summ[3])
    bank_vals = summ[10:10 + T + 1]
    exit_regs = summ[10 + T + 1:10 + T + 1 + R]

    def to_corpus(v, c):
        v = int(v)
        if v == -1:
            return -1
        if v < 0:
            return None          # BAD: span exceeded the window
        return v + c * K - W

    bank = None
    rid = -1
    if lc >= 0:
        rid = int(bank_vals[T])
        bank = [to_corpus(v, lc) for v in bank_vals[:T]]

    if dead_chunk < full_C:
        # the scan ended inside the covered region
        if bank is None:
            return None
        if any(b is None for b in bank):
            # the winning bank traces past the chunk window (e.g. the
            # match starts before it): chunk-wise repair resolves it
            # without abandoning the device pass
            return repair()
        return rid, bank

    # no death in the covered region: the host finishes the ragged tail
    # and the EOF boundary from the last covered exit state/registers
    sid = int(summ[4]) // tables.ncls
    base = (full_C - 1) * K - W
    regs = []
    for k in range(min(t.nregs(sid), R)):
        v = int(exit_regs[k])
        regs.append(v + base if v >= 0 else (-1 if v == -1 else None))
    if bank is not None and any(b is None for b in bank):
        return repair()
    r = _host_walk(tables, sid, regs, bank, rid, data_np, full_C * K, n)
    return repair() if r == "fallback" else r
