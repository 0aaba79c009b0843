"""NFA -> DFA table compiler: the TPU-native successor of the
reference's DynASM x86-64 JIT (reference src/sregex/
sre_vm_thompson_x64.dasc).

Where the JIT flattens per-state epsilon closures into native code at
compile time (get_next_states, sre_vm_thompson_x64.dasc:624-726), we go
one step further and run full ahead-of-time subset construction,
emitting dense transition tables an XLA/Pallas kernel can scan at one
lookup per byte.

Assertions are resolved by extending the alphabet with context:

  - a DFA state is (pending NFA set, prev-byte context), where the
    pending set holds NFA positions *after* consuming a byte and
    *before* epsilon closure, and the context records is_word/is_nl of
    the consumed byte (plus a BOS flag for the start state);
  - a transition on byte b first closes the pending set under
    epsilons+assertions using (prev ctx, ctx(b)) — exactly the
    seen_word/seen_newline carry of the Pike VM
    (sre_vm_pike.c:470-497,586-601) — then consumes b;
  - acceptance is a property of the *transition* (match can be
    detected at a boundary given the current byte) plus a separate
    EOF-acceptance vector.

The byte alphabet is first reduced to equivalence classes (bytes
indistinguishable by every CHAR/IN/NOTIN test and by is_word/is_nl),
so tables are [nstates x nclasses] with a 256-entry class map.

Boolean (Thompson-equivalent) semantics: match[s][c] says "some match
ends at this boundary".  This is exact for the reference's
yes/no engines; the tagged (capture-carrying) construction lives on
top of this module.
"""

import os

import numpy as np

from .consts import (
    OP_CHAR, OP_MATCH, OP_JMP, OP_SPLIT, OP_ANY, OP_SAVE, OP_IN,
    OP_NOTIN, OP_ASSERT,
    SRE_OK, SRE_AGAIN, SRE_DECLINED,
    SRE_REGEX_ASSERT_BIG_A, SRE_REGEX_ASSERT_CARET, SRE_REGEX_ASSERT_DOLLAR,
    SRE_REGEX_ASSERT_SMALL_Z, SRE_REGEX_ASSERT_BIG_B, SRE_REGEX_ASSERT_SMALL_B,
)


class DfaTooLarge(Exception):
    """Raised when subset construction exceeds the state budget."""


# prev-byte context encodings (BOS = absolute stream position 0)
_CTX_BOS = 0
_CTX_OTHER = 1
_CTX_WORD = 2
_CTX_NL = 3

_WORD_MASK = np.zeros(256, dtype=bool)
for _c in range(256):
    _WORD_MASK[_c] = (48 <= _c <= 57 or 65 <= _c <= 90
                      or 97 <= _c <= 122 or _c == 95)
_NL_MASK = np.zeros(256, dtype=bool)
_NL_MASK[10] = True


def _byte_classes(prog):
    """Partition 0..255 into equivalence classes: same behavior on
    every CHAR/IN/NOTIN instruction and same is_word/is_nl context.
    Returns (class_map[256] int32, nclasses, class_word, class_nl,
    accept[ninsts x nclasses] bool)."""
    insts = prog.insts
    # context refinement only where the program can observe it: \b/\B
    # read the word bit, ^/$ the newline bit.  Assertion-free programs
    # then get strictly coarser classes (e.g. a literal needs only
    # {its bytes, other}), which shrinks every downstream table
    # (narrower kernel tiers, denser packing) without changing any
    # observable result.
    need_word = False
    need_nl = False
    for ins in insts:
        if ins.opcode == OP_ASSERT:
            a = ins.assertion
            if a in (SRE_REGEX_ASSERT_SMALL_B, SRE_REGEX_ASSERT_BIG_B):
                need_word = True
            elif a in (SRE_REGEX_ASSERT_CARET, SRE_REGEX_ASSERT_DOLLAR):
                need_nl = True
    sigs = []
    if need_word:
        sigs.append(_WORD_MASK)
    if need_nl:
        sigs.append(_NL_MASK)
    accept_rows = {}
    for idx, ins in enumerate(insts):
        op = ins.opcode
        if op == OP_CHAR:
            m = np.zeros(256, dtype=bool)
            m[ins.ch] = True
        elif op == OP_ANY:
            m = np.ones(256, dtype=bool)
        elif op == OP_IN or op == OP_NOTIN:
            m = np.zeros(256, dtype=bool)
            for f, t in ins.ranges:
                m[f:t + 1] = True
            if op == OP_NOTIN:
                m = ~m
        else:
            continue
        accept_rows[idx] = m
        sigs.append(m)

    if not sigs:
        sigs.append(np.zeros(256, dtype=bool))
    sig = np.stack(sigs, axis=1)  # [256, nsigs]
    _, class_map, = np.unique(sig, axis=0, return_inverse=True)
    class_map = class_map.astype(np.int32)
    nclasses = int(class_map.max()) + 1
    # representative byte per class
    rep = np.zeros(nclasses, dtype=np.int32)
    for b in range(255, -1, -1):
        rep[class_map[b]] = b
    # unobservable context bits are pinned False so they never split
    # states (the ctx is part of the state identity downstream)
    class_word = _WORD_MASK[rep] if need_word \
        else np.zeros(nclasses, dtype=bool)
    class_nl = _NL_MASK[rep] if need_nl \
        else np.zeros(nclasses, dtype=bool)
    accept = {idx: m[rep] for idx, m in accept_rows.items()}
    return class_map, nclasses, class_word, class_nl, accept


def _closure(insts, pending, prev_ctx, cur_word, cur_nl, at_eof):
    """Epsilon+assertion closure of the pending set.  Returns
    (consuming instruction indices in priority order, match_id).

    match_id is the regex id of the FIRST ``match`` instruction reached
    in priority (DFS) order, or -1 when no match ends here.  For
    multi-regex programs the parse driver orders the top-level
    alternation by regex id (sre_yyparser.y:1871-1986), so
    first-in-priority is exactly the id the Pike VM reports when it
    cuts lower-priority threads on match (sre_vm_pike.c:607-658).

    prev_ctx is one of _CTX_*; cur_word/cur_nl describe the byte about
    to be consumed (both False when at_eof)."""
    seen = set()
    out = []
    matched = -1
    prev_word = prev_ctx == _CTX_WORD
    prev_nl = prev_ctx == _CTX_NL
    at_bos = prev_ctx == _CTX_BOS

    stack = list(reversed(pending))
    while stack:
        pc = stack.pop()
        if pc in seen or pc >= len(insts):
            continue
        seen.add(pc)
        ins = insts[pc]
        op = ins.opcode
        if op == OP_JMP:
            stack.append(ins.x)
        elif op == OP_SPLIT:
            stack.append(ins.y)
            stack.append(ins.x)
        elif op == OP_SAVE:
            stack.append(pc + 1)
        elif op == OP_ASSERT:
            a = ins.assertion
            if a == SRE_REGEX_ASSERT_BIG_A:
                if at_bos:
                    stack.append(pc + 1)
            elif a == SRE_REGEX_ASSERT_CARET:
                if at_bos or prev_nl:
                    stack.append(pc + 1)
            elif a == SRE_REGEX_ASSERT_DOLLAR:
                if at_eof or cur_nl:
                    stack.append(pc + 1)
            elif a == SRE_REGEX_ASSERT_SMALL_Z:
                if at_eof:
                    stack.append(pc + 1)
            elif a == SRE_REGEX_ASSERT_SMALL_B:
                if prev_word != bool(cur_word):
                    stack.append(pc + 1)
            elif a == SRE_REGEX_ASSERT_BIG_B:
                if prev_word == bool(cur_word):
                    stack.append(pc + 1)
        elif op == OP_MATCH:
            if matched < 0:
                matched = ins.regex_id
        else:
            out.append(pc)
    return out, matched


class Dfa:
    """Dense DFA tables.

    trans:        int32 [nstates, nclasses] — next state
    match_id:     int32 [nstates, nclasses] — regex id of the
                  highest-priority match ending at the current boundary
                  given this state and current byte class, or -1
    match:        bool  [nstates, nclasses] — match_id >= 0
    match_eof_id: int32 [nstates] — regex id of a match ending at EOF,
                  or -1
    match_eof:    bool  [nstates]
    class_map:    int32 [256]
    start = 0; the dead state (if any) self-loops with no matches.
    """

    def __init__(self, prog, trans, match_id, match_eof_id, class_map,
                 sterile=None):
        self.program = prog
        self.trans = trans
        self.match_id = match_id
        self.match = match_id >= 0
        self.match_eof_id = match_eof_id
        self.match_eof = match_eof_id >= 0
        self.class_map = class_map
        self.nstates = trans.shape[0]
        self.nclasses = trans.shape[1]
        # sterile[s]: every live NFA thread in state s is still inside
        # the unanchored `.*?` scan loop (no byte of any potential
        # match consumed, no capture committed) — so a FRESH Pike ctx
        # with the boundary carry is exactly equivalent to the true
        # engine there.  The streaming events engine teleports across
        # fire-free gaps only at sterile boundaries (unbounded
        # patterns) — see stream.py.  None = unknown (loaded tables):
        # no sterile teleports, still exact.
        self.sterile = sterile
        self._trans_bytes = None
        self._match_bytes = None
        self._match_id_bytes = None

    # expanded [nstates, 256] views for kernels
    @property
    def trans_bytes(self):
        if self._trans_bytes is None:
            self._trans_bytes = np.ascontiguousarray(
                self.trans[:, self.class_map])
        return self._trans_bytes

    @property
    def match_bytes(self):
        if self._match_bytes is None:
            self._match_bytes = np.ascontiguousarray(
                self.match[:, self.class_map])
        return self._match_bytes

    @property
    def match_id_bytes(self):
        if self._match_id_bytes is None:
            self._match_id_bytes = np.ascontiguousarray(
                self.match_id[:, self.class_map])
        return self._match_id_bytes

    def id_at(self, state, byte):
        """Regex id of the match ending at the boundary where the
        scanner, in ``state``, is about to consume ``byte`` (-1 none)."""
        return int(self.match_id[state, self.class_map[byte]])

    def create_ctx(self):
        return DfaCtx(self)


def minimize_dfa(dfa):
    """Moore minimization preserving every observable the engines and
    kernels read: the full match_id row (so id_at answers identically),
    match_eof_id, and transition behavior.  Subset construction keyed
    on (pending set, prev ctx) routinely produces behaviorally
    duplicate states (e.g. contexts the pattern never distinguishes);
    merging them shrinks every downstream table — more patterns fit the
    narrow kernel tiers (S*ncls <= 128 / 1024) and the wide/big tiers'
    row-select chains get shorter (R = ceil(S*ncls/128) rows).

    State 0 stays the start state; states are renumbered in first-seen
    order so the result is deterministic."""
    S = dfa.nstates
    # initial partition: per-state observable signature
    sig = np.concatenate(
        [dfa.match_id, dfa.match_eof_id[:, None]], axis=1)
    _, cls = np.unique(sig, axis=0, return_inverse=True)
    while True:
        key = np.concatenate([cls[:, None], cls[dfa.trans]], axis=1)
        _, new = np.unique(key, axis=0, return_inverse=True)
        if np.array_equal(new, cls):
            break
        cls = new
    n = int(cls.max()) + 1
    if n == S:
        return dfa
    # sterility must survive merging CONSERVATIVELY: behavioral (fire)
    # equivalence does NOT imply Pike-thread equivalence — a state
    # holding a progress thread can fire identically to the fresh
    # state (e.g. `(?:ab)*c` after "ab") yet yield a different chosen
    # match start.  A merged state is sterile only if EVERY member is.
    sterile_merged = None
    if dfa.sterile is not None:
        sterile_merged = np.ones(n, dtype=bool)
        np.logical_and.at(sterile_merged, cls, dfa.sterile)
    # renumber classes in first-seen state order (start -> 0)
    order = np.full(n, -1, dtype=np.int32)
    reps = np.zeros(n, dtype=np.int64)
    nxt = 0
    for s in range(S):
        c = cls[s]
        if order[c] < 0:
            order[c] = nxt
            reps[nxt] = s
            nxt += 1
    newid = order[cls].astype(np.int32)
    trans = np.ascontiguousarray(newid[dfa.trans[reps]])
    match_id = np.ascontiguousarray(dfa.match_id[reps])
    match_eof_id = np.ascontiguousarray(dfa.match_eof_id[reps])
    sterile = None
    if sterile_merged is not None:
        sterile = np.ascontiguousarray(sterile_merged[cls[reps]])
    return Dfa(dfa.program, trans, match_id, match_eof_id,
               dfa.class_map, sterile=sterile)


def build_core_dfa(dfa, hot_states):
    """Synthesize the HOT-CORE machine for the adaptive core kernel
    tier (ops/pallas_core.py): a small DFA over only the states a data
    sample actually visits, plus one sticky ESC state.

      - core ids 0..H-1 = ``hot_states`` in the given order (the
        caller puts the entry state first); ESC = H;
      - transitions leaving the hot set are redirected to ESC; every
        ESC transition carries the match bit, so a chunk that escapes
        can never validate silently (fm != 0 in scan mode, and the
        sticky exit state phi == ESC fails the ESC check _summarize
        applies in both modes);
      - byte classes are re-merged over the hot rows only: classes the
        core cannot distinguish collapse, shrinking S*ncls toward the
        fast kernel tiers (the whole point — a 4,818-state automaton
        whose scans visit 9 states becomes a 10-state narrow-tier
        machine).

    The core answers only "did a match end at this boundary" —
    match_id is boolean-degraded to 0/-1 and WHICH regex matched is
    always resolved on the full machine.  Returns
    (core_dfa, hot2full int64 [H], full2core int32 [S_full] with ESC
    for non-hot states).
    """
    S = dfa.nstates
    hot2full = np.asarray(hot_states, dtype=np.int64)
    H = len(hot2full)
    if H == 0 or len(np.unique(hot2full)) != H:
        raise ValueError("hot_states must be non-empty and unique")
    full2core = np.full(S, H, dtype=np.int32)
    full2core[hot2full] = np.arange(H, dtype=np.int32)

    ct = full2core[dfa.trans[hot2full]]          # [H, ncls] core targets
    m = dfa.match[hot2full]                      # [H, ncls] bool
    core = core_from_rows(dfa.program, dfa.class_map, ct, m,
                          dfa.match_eof[hot2full])
    return core, hot2full, full2core


def core_from_rows(program, class_map, ct, m, eof_hot):
    """Assemble the hot-core machine from per-hot-state rows: ct
    [H, ncls] core-id targets (ESC = H for out-of-core), m [H, ncls]
    match bools, eof_hot [H] bools.  Shared by the dense
    (build_core_dfa) and lazy (ops/pallas_core.LazyCoreTables)
    builders; semantics documented on build_core_dfa."""
    H = ct.shape[0]
    # merge byte classes indistinguishable over the hot rows
    sig = np.concatenate([ct, m.astype(np.int32)], axis=0).T  # [ncls, 2H]
    uniq, first_idx, inv = np.unique(sig, axis=0, return_index=True,
                                     return_inverse=True)
    # deterministic first-seen ordering of the merged classes
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    remap = rank[inv].astype(np.int32)           # full class -> core class
    nclsc = len(uniq)
    reps = np.sort(first_idx)                    # representative full cls

    trans_core = np.empty((H + 1, nclsc), dtype=np.int32)
    trans_core[:H] = ct[:, reps]
    trans_core[H] = H                            # ESC self-loops
    match_id_core = np.where(m[:, reps], 0, -1).astype(np.int32)
    match_id_core = np.concatenate(
        [match_id_core, np.zeros((1, nclsc), dtype=np.int32)])  # ESC fires
    eof_core = np.concatenate(
        [np.where(eof_hot, 0, -1).astype(np.int32),
         np.zeros(1, dtype=np.int32)])           # ESC eof never read
    class_map_core = remap[class_map].astype(np.int32)
    return Dfa(program, trans_core, match_id_core, eof_core,
               class_map_core)


def _sterile_pendings(insts):
    """Pending NFA positions a thread can hold WITHOUT having consumed
    a byte of any potential match: {pc+1 for consuming pc reachable
    from pc 0 through JMP/SPLIT only}.  The parse drivers wrap every
    pattern as `.*?(re)` and entering re always crosses its SAVE 0
    (sre_yyparser.y's `.*?` wrap; compiler.py emits split/any/jmp
    before the TOPLEVEL save), so stopping the walk at SAVE (and at
    assertions/match, conservatively) leaves exactly the scan-loop
    positions.  A pending set within this family means every live
    thread is indistinguishable from a freshly seeded one."""
    ok = {0}
    seen = set()
    stack = [0]
    while stack:
        pc = stack.pop()
        if pc in seen or pc >= len(insts):
            continue
        seen.add(pc)
        op = insts[pc].opcode
        if op == OP_JMP:
            stack.append(insts[pc].x)
        elif op == OP_SPLIT:
            stack.append(insts[pc].x)
            stack.append(insts[pc].y)
        elif op in (OP_CHAR, OP_ANY, OP_IN, OP_NOTIN):
            ok.add(pc + 1)
    return ok


def build_dfa(prog, max_states=8192):
    """Subset construction.  Raises DfaTooLarge beyond max_states.
    The result is Moore-minimized (SREGEX_MINIMIZE=0 disables)."""
    insts = prog.insts
    class_map, nclasses, class_word, class_nl, accept = _byte_classes(prog)

    # state key -> id
    start_key = ((0,), _CTX_BOS)
    ids = {start_key: 0}
    keys = [start_key]
    trans_rows = []
    match_rows = []
    match_eof = []
    closure_cache = {}

    i = 0
    while i < len(keys):
        pending, prev_ctx = keys[i]
        i += 1
        trow = np.zeros(nclasses, dtype=np.int32)
        mrow = np.full(nclasses, -1, dtype=np.int32)

        for c in range(nclasses):
            cw = bool(class_word[c])
            cn = bool(class_nl[c])
            ck = (pending, prev_ctx, cw, cn)
            res = closure_cache.get(ck)
            if res is None:
                res = _closure(insts, pending, prev_ctx, cw, cn, False)
                closure_cache[ck] = res
            consuming, matched = res
            mrow[c] = matched
            # canonical (sorted) pending set: boolean semantics are
            # order-independent
            nxt = tuple(sorted({pc + 1 for pc in consuming
                                if accept[pc][c]}))
            nctx = _CTX_WORD if cw else (_CTX_NL if cn else _CTX_OTHER)
            nkey = (nxt, nctx) if nxt else ((), _CTX_OTHER)
            sid = ids.get(nkey)
            if sid is None:
                sid = len(keys)
                if sid >= max_states:
                    raise DfaTooLarge(
                        "DFA exceeds %d states" % max_states)
                ids[nkey] = sid
                keys.append(nkey)
            trow[c] = sid

        _, eof_matched = _closure(insts, pending, prev_ctx, False, False,
                                  True)
        trans_rows.append(trow)
        match_rows.append(mrow)
        match_eof.append(eof_matched)

    trans = np.stack(trans_rows)
    match = np.stack(match_rows)
    st_ok = _sterile_pendings(insts)
    # empty pending = the dead state: NOT fresh-equivalent (a fresh
    # ctx would resurrect threads a dead anchored scan has lost)
    sterile = np.array([bool(k[0]) and all(pc in st_ok for pc in k[0])
                        for k in keys], dtype=bool)
    dfa = Dfa(prog, trans, match,
              np.array(match_eof, dtype=np.int32), class_map,
              sterile=sterile)
    if os.environ.get("SREGEX_MINIMIZE") != "0":
        dfa = minimize_dfa(dfa)
    return dfa


class LazyDfa:
    """On-demand subset construction: DFA states and transition-row
    entries materialize only as input bytes demand them (the classic
    production lazy-DFA approach).  Where eager build_dfa() would blow
    the state budget (DfaTooLarge) or the latency budget (the CLI must
    answer fast on pathological patterns), the lazy machine pays only
    for states the input actually visits — bounded by the input length.

    Covers the same universality contract as the reference's JIT, which
    compiles *every* program (sre_vm_thompson_jit.c:39): no pattern is
    ever rejected here.

    Streaming carry: the state id alone (assertion context is folded
    into states exactly as in build_dfa)."""

    def __init__(self, prog):
        self.program = prog
        (self.class_map, self.nclasses, self._class_word,
         self._class_nl, self._accept) = _byte_classes(prog)
        start_key = ((0,), _CTX_BOS)
        self._ids = {start_key: 0}
        self._keys = [start_key]
        self._trans = {}      # (sid, cls) -> (next_sid, match_bool)
        self._eof = {}        # sid -> match_eof bool
        self._closure_cache = {}
        # native-walk mirror (csrc/sre_host.cpp sre_lazy_*): a dense
        # int64 [cap, ncls] copy of materialized transitions, -1 =
        # not yet materialized; the C walker stops on -1 and Python
        # fills that one entry and resumes
        self._dense = None
        self._nat = None      # None = untried, False = unavailable
        self._cmap_u8 = None

    # past this many dense-table bytes the pattern is a true monster:
    # free the mirror and stay on the Python walk
    MAX_DENSE_BYTES = 128 << 20

    def _native(self):
        if self._nat is None:
            from .native import get_lib
            lib = get_lib()
            self._nat = lib if lib is not None else False
            if lib is not None:
                self._cmap_u8 = np.ascontiguousarray(
                    self.class_map.astype(np.uint8))
        return self._nat or None

    def _dense_row_cap(self):
        return 0 if self._dense is None else self._dense.shape[0]

    def _grow_dense(self, need):
        """Ensure the dense mirror covers >= need states; returns
        False (and disables the native walk) past the byte budget."""
        cap = max(64, self._dense_row_cap())
        while cap < need:
            cap *= 2
        if cap * self.nclasses * 8 > self.MAX_DENSE_BYTES:
            self._nat = False
            self._dense = None
            return False
        if self._dense is None or cap > self._dense.shape[0]:
            nd = np.full((cap, self.nclasses), -1, dtype=np.int64)
            if self._dense is not None:
                nd[:self._dense.shape[0]] = self._dense
            self._dense = nd
        return True

    def _fill_dense(self, sid, c):
        """Materialize one (sid, cls) entry into the mirror (the
        native walkers' miss handler)."""
        nxt, mid = self._step(sid, c)
        if not self._grow_dense(max(sid, nxt) + 1):
            return False
        self._dense[sid, c] = (nxt << 32) | np.int64(mid + 1)
        return True

    def _nat_loop(self, fn, data, state, mode):
        """Resumable driver for one native lazy walker.  mode:
        'count' -> (count, state); 'first' -> (boundary|-1, state AT
        boundary / after); 'last' -> (last boundary|-1, state after).
        Returns None when native is unavailable or the dense budget
        blows mid-walk (caller redoes the whole call in Python)."""
        import ctypes
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        buf = np.frombuffer(data, dtype=np.uint8)
        n = len(buf)
        if not self._grow_dense(self.nstates):
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        st = np.array([state], dtype=np.int32)
        out = np.array([0 if mode == "count" else -1], dtype=np.int64)
        i = 0
        last = -1
        while i < n:
            consumed = fn(
                self._dense.ctypes.data_as(i64p), self.nclasses,
                self._cmap_u8.ctypes.data_as(u8p),
                buf[i:].ctypes.data_as(u8p), n - i,
                st.ctypes.data_as(i32p), out.ctypes.data_as(i64p))
            if mode == "first" and out[0] >= 0:
                return int(out[0]) + i, int(st[0])
            if mode == "last":
                if out[0] >= 0:
                    last = int(out[0]) + i
                out[0] = -1
            i += consumed
            if i < n:
                # miss: materialize exactly this entry and resume
                c = int(self._cmap_u8[buf[i]])
                if not self._fill_dense(int(st[0]), c):
                    return None   # budget blown mid-walk: redo in py
        if mode == "count":
            return int(out[0]), int(st[0])
        if mode == "first":
            return -1, int(st[0])
        return last, int(st[0])

    @property
    def nstates(self):
        return len(self._keys)

    def _step(self, sid, c):
        """(next_sid, match_id) for one class step; match_id is the
        regex id of a match ending at the boundary, or -1."""
        key = (sid, c)
        hit = self._trans.get(key)
        if hit is not None:
            return hit
        pending, prev_ctx = self._keys[sid]
        insts = self.program.insts
        cw = bool(self._class_word[c])
        cn = bool(self._class_nl[c])
        ck = (pending, prev_ctx, cw, cn)
        res = self._closure_cache.get(ck)
        if res is None:
            res = _closure(insts, pending, prev_ctx, cw, cn, False)
            self._closure_cache[ck] = res
        consuming, matched = res
        accept = self._accept
        nxt = tuple(sorted({pc + 1 for pc in consuming if accept[pc][c]}))
        nctx = _CTX_WORD if cw else (_CTX_NL if cn else _CTX_OTHER)
        nkey = (nxt, nctx) if nxt else ((), _CTX_OTHER)
        nsid = self._ids.get(nkey)
        if nsid is None:
            nsid = len(self._keys)
            self._ids[nkey] = nsid
            self._keys.append(nkey)
        hit = (nsid, matched)
        self._trans[key] = hit
        return hit

    def match_eof_id(self, sid):
        """Regex id of a match ending at EOF in this state, or -1."""
        m = self._eof.get(sid)
        if m is None:
            pending, prev_ctx = self._keys[sid]
            _, m = _closure(self.program.insts, pending, prev_ctx,
                            False, False, True)
            self._eof[sid] = m
        return m

    def match_eof(self, sid):
        return self.match_eof_id(sid) >= 0

    def scan_first(self, data, state=0):
        """(first match boundary or -1, state after data); boundaries
        0..n-1 — EOF acceptance is match_eof(state), the caller's.
        On a match the returned state is the state AT the boundary
        (id_at-compatible: _step(state, cls)[1] is the regex id)."""
        nat = self._native()
        if nat is not None:
            r = self._nat_loop(nat.sre_lazy_scan_first, data, state,
                               "first")
            if r is not None:
                return r
        cmap = self.class_map
        step = self._step
        s = state
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        arr = cmap[np.frombuffer(data, dtype=np.uint8)]
        for i, c in enumerate(arr):
            nxt, m = step(s, int(c))
            if m >= 0:
                return i, s
            s = nxt
        return -1, s

    def id_at(self, state, byte):
        """Regex id of the match ending at the boundary where the
        scanner, in ``state``, is about to consume ``byte`` (-1 none)."""
        return self._step(state, int(self.class_map[byte]))[1]

    def count(self, data, state=0):
        """(number of match-ending boundaries in 0..n-1, state after)."""
        nat = self._native()
        if nat is not None:
            r = self._nat_loop(nat.sre_lazy_count, data, state,
                               "count")
            if r is not None:
                return r
        cmap = self.class_map
        step = self._step
        s = state
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        arr = cmap[np.frombuffer(data, dtype=np.uint8)]
        cnt = 0
        for c in arr:
            nxt, m = step(s, int(c))
            cnt += m >= 0
            s = nxt
        return cnt, s

    def scan_last(self, data, state=0):
        """(LAST match-ending boundary in 0..n-1 or -1, state after);
        the reverse-scan primitive, lazy flavor."""
        nat = self._native()
        if nat is not None:
            r = self._nat_loop(nat.sre_lazy_scan_last, data, state,
                               "last")
            if r is not None:
                return r
        cmap = self.class_map
        step = self._step
        s = state
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        arr = cmap[np.frombuffer(data, dtype=np.uint8)]
        last = -1
        for i, c in enumerate(arr):
            nxt, m = step(s, int(c))
            if m >= 0:
                last = i
            s = nxt
        return last, s

    def visits(self, data, state=0):
        """Per-state visit counts over one walk: ({sid: count}, state
        after).  The lazy analogue of NativeDfa.visits — feeds the
        adaptive hot-core sampler (ops/pallas_core.LazyCoreTables)."""
        cmap = self.class_map
        step = self._step
        s = state
        if not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        arr = cmap[np.frombuffer(data, dtype=np.uint8)]
        counts = {}
        for c in arr:
            counts[s] = counts.get(s, 0) + 1
            s, _ = step(s, int(c))
        return counts, s

    def create_ctx(self):
        return LazyDfaCtx(self)


class LazyDfaCtx:
    """Streaming ctx over a LazyDfa; same exec protocol as DfaCtx."""

    def __init__(self, lazy):
        self.lazy = lazy
        self.state = 0

    def exec(self, input_, eof):
        if input_ is None:
            input_ = b""
        if len(input_):
            first, s = self.lazy.scan_first(input_, self.state)
            if first >= 0:
                return SRE_OK
            self.state = s
        if eof:
            if self.lazy.match_eof(self.state):
                return SRE_OK
            return SRE_DECLINED
        return SRE_AGAIN


class DfaCtx:
    """Streaming DFA execution context: the resumable carry is just
    (state, matched_flag) — the dense-table analogue of the Thompson
    ctx (sre_vm_thompson.h:28-40)."""

    def __init__(self, dfa):
        self.dfa = dfa
        self.state = 0

    def exec(self, input_, eof):
        """Feed one chunk; SRE_OK on match, SRE_AGAIN to continue,
        SRE_DECLINED at EOF without a match."""
        if input_ is None:
            input_ = b""
        dfa = self.dfa
        cmap = dfa.class_map
        trans = dfa.trans
        match = dfa.match
        s = self.state

        if len(input_):
            arr = cmap[np.frombuffer(input_, dtype=np.uint8)]
            # sequential scan; the TPU kernels vectorize this via
            # per-chunk transfer functions (ops/scan.py)
            for c in arr:
                if match[s, c]:
                    self.state = s
                    return SRE_OK
                s = trans[s, c]
            self.state = s

        if eof:
            if dfa.match_eof[s]:
                return SRE_OK
            return SRE_DECLINED
        return SRE_AGAIN
