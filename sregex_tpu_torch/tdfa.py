"""Tagged DFA: capture groups and multi-regex IDs resolved by table
lookup — the determinized form of the Pike VM (docs/TDFA_DESIGN.md).

Where the boolean DFA (dfa.py) collapses the Pike clist into an
unordered position set (enough for yes/no), the TDFA keeps the list
ORDERED (thread priority) and attaches a register map per item (the
thread's capture vector, with positions abstracted into registers).
Determinism falls out because Pike's per-step behavior depends only on
(ordered items, which-registers-are-shared, dedup generation, prev-byte
context) — never on the concrete position values, which live in the
runtime carry.

The construction replays one FULL step of sre_vm_pike_exec per
transition, preserving its exact two-phase discipline:

  phase B (splices): deferred lookahead asserts ($ \\z \\b \\B,
    sre_vm_pike.c:450-528) resolve against the current byte; on hold
    their continuation closure is spliced at the FRONT of the worklist
    with the tag-DECREMENT trick (:506-528) — i.e. it dedups against
    the generation that built the current list (phase A of the
    previous step, ctx->tag-- => T_{i-1}).  SAVEs in splices record
    the CURRENT position; a MATCH reached here commits at the current
    position.  Spliced consuming items are tested against the current
    byte in the same step.

  phase A (advance): surviving consumers eat the byte; add_thread
    (:756-942) closes into the next list with a FRESH generation T_i,
    resolving SAVE -> next position, \\A (always false at pos>0) and
    ^ (next-pos: holds iff the consumed byte is \\n, :848-864)
    eagerly, deferring $ \\z \\b \\B with the seen_word latch
    (:866-880), and committing immediately on MATCH (SRE_DONE,
    :889-899) at the NEXT position.

Any commit kills the remaining worklist (lower priority) but the next
list built so far SURVIVES (:530-553) — higher-priority in-flight
items may later displace the committed match (:640-658).  The bank
(match snapshot) is overwritten by later commits; the scan is final
when the item list empties or at EOF (:607-635).

The dedup-generation sharing means phase-B splices can be BLOCKED from
re-reaching instructions (e.g. MATCH) that the previous step's phase-A
closure already visited — so a lower-priority eager match can beat a
higher-priority deferred-assert match.  That quirk is part of the
reference semantics and is replayed here by carrying the (canonicalized)
visited set V in the state identity.

Execution carry per stream: (state id, R register values, bank[T],
last_matched_pos, seen_word/seen_newline).  Registers hold absolute
positions; ops are pure select/copy — the form the device kernel
vectorizes (ops/tdfa_scan.py, csrc/tdfa_scan.cu).
"""

from collections import deque

import numpy as np

from .consts import (
    OP_CHAR, OP_MATCH, OP_JMP, OP_SPLIT, OP_ANY, OP_SAVE, OP_IN,
    OP_NOTIN, OP_ASSERT,
    SRE_OK, SRE_AGAIN, SRE_DECLINED, SRE_ERROR,
    SRE_REGEX_ASSERT_BIG_A, SRE_REGEX_ASSERT_CARET, SRE_REGEX_ASSERT_DOLLAR,
    SRE_REGEX_ASSERT_SMALL_Z, SRE_REGEX_ASSERT_BIG_B, SRE_REGEX_ASSERT_SMALL_B,
    sre_isword,
)
from .dfa import _byte_classes, DfaTooLarge, _WORD_MASK, _NL_MASK


class TdfaTooLarge(DfaTooLarge):
    """State or register budget exceeded; fall back to Pike."""


# register-op / srcmap sources
SRC_UNSET = -1    # stays/becomes -1 ("no value", like the cleared cap)
SRC_CUR = -2      # current position (phase-B splice SAVE, seed SAVE)
SRC_NEXT = -3     # position after the consumed byte (phase-A SAVE)

# item kinds
K_CONS = 0        # consuming instruction (CHAR/ANY/IN/NOTIN)
K_DEFER = 1       # deferred lookahead assert ($ \z \b \B)
K_MATCHI = 2      # a MATCH enqueued as a thread (seed closures only)

# 5-valued prev-byte context: BOS, then (word, nl) bit pairs.
# (1,1) arises only from the chunk-entry carry merge: the honest word
# latch ORed with ctx->seen_word plus ctx->seen_newline replacing the
# newline bit (sre_vm_pike.c:470-497 / :848-864 pos==0 branches).
CTX_BOS = 0


def _ctx(word, nl):
    return 1 + (1 if word else 0) + (2 if nl else 0)


def _ctx_word(ctx):
    return ctx != CTX_BOS and ((ctx - 1) & 1) != 0


def _ctx_nl(ctx):
    return ctx != CTX_BOS and ((ctx - 1) & 2) != 0


class Tdfa:
    """Lazy tagged DFA over a compiled program.

    Tags: one per capture slot, tag t == ovector slot t (group starts
    at even, ends at odd; already multi-regex renumbered by the
    parser).  ``tags`` may restrict tracking to a subset (e.g.
    (0, 1) for $0-only device tables); untracked SAVEs are no-ops,
    exactly like the Thompson VM treats SAVE
    (sre_vm_thompson.c:296-298).  Exact finditer re-arm needs tag 1
    tracked (the last_matched_pos quirk reads raw slot 1,
    sre_vm_pike.c:532,891).

    States materialize on demand (the production lazy-DFA discipline);
    ``max_states``/``max_regs`` bound the construction, raising
    TdfaTooLarge for the fallback chain.
    """

    def __init__(self, prog, tags=None, max_states=8192, max_regs=None):
        self.program = prog
        self.ntags = prog.ovecsize
        if tags is None:
            tags = tuple(range(self.ntags))
        self.tags = tuple(tags)
        self.tagidx = {t: i for i, t in enumerate(self.tags)}
        self.max_states = max_states
        self.max_regs = max_regs
        (self.class_map, self.nclasses, self._class_word,
         self._class_nl, self._accept) = _byte_classes(prog)
        # per-regex ovector slice offsets: regex r's $0 start/end live
        # at slots slice_ofs[r], slice_ofs[r]+1 (multi-regex layout of
        # sre_vm_pike_prepare_matched_captures, sre_vm_pike.c:945-989)
        self.slice_ofs = []
        ofs = 0
        for i in range(prog.nregexes):
            self.slice_ofs.append(ofs)
            ofs += 2 * (prog.multi_ncaps[i] + 1)

        self._reach_cache = {}
        # state key: (items, vkey, ctx); items = tuple of
        # (kind, pc, regmap) with regmap a tuple over self.tags of
        # register id (>=0) or SRC_UNSET; vkey = sorted tuple of the
        # canonicalized dedup generation (pcs tagged while building
        # the items, restricted to splice-reachable ones).
        self._ids = {}
        self._keys = []
        self._nregs = []        # per state: register count
        self._trans = {}        # (sid, cls) -> (nsid, ops, commit)
        self._eof = {}          # sid -> commit or None
        self._seed_ids = {}     # ctx -> sid
        self._seed_lmp = {}     # sid -> None | SRC_CUR | SRC_UNSET
        for ctx in range(5):
            self._build_seed(ctx)

    # -- state interning ------------------------------------------------

    def _intern(self, items, vkey, ctx):
        key = (items, vkey, ctx)
        sid = self._ids.get(key)
        if sid is None:
            sid = len(self._keys)
            if sid >= self.max_states:
                raise TdfaTooLarge("TDFA exceeds %d states"
                                   % self.max_states)
            self._ids[key] = sid
            self._keys.append(key)
            nregs = 0
            for _, _, regmap in items:
                for r in regmap:
                    if r >= nregs:
                        nregs = r + 1
            self._nregs.append(nregs)
        return sid

    @property
    def nstates(self):
        return len(self._keys)

    def nregs(self, sid):
        return self._nregs[sid]

    def is_dead(self, sid):
        return not self._keys[sid][0]

    # -- static reachability (for V canonicalization) -------------------

    def _splice_reach(self, pc0):
        """Pcs a splice closure rooted at pc0 could ever visit
        (through epsilon edges and nested deferred asserts)."""
        r = self._reach_cache.get(pc0)
        if r is not None:
            return r
        insts = self.program.insts
        seen = set()
        stack = [pc0]
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
                stack.append(ins.x)
                stack.append(ins.y)
            elif op == OP_SAVE:
                stack.append(pc + 1)
            elif op == OP_ASSERT:
                stack.append(pc + 1)
        r = frozenset(seen)
        self._reach_cache[pc0] = r
        return r

    def _canon_v(self, visited, items):
        reach = set()
        for kind, pc, _ in items:
            if kind == K_DEFER:
                reach |= self._splice_reach(pc + 1)
        return tuple(sorted(visited & reach))

    # -- seed states (sre_vm_pike_exec first_buf, :202-233) -------------

    def _build_seed(self, ctx):
        """Replay add_thread(clist, start, pos=p) for a seed at
        context ctx.  \\A holds only at BOS; ^ at BOS or when the nl
        bit is set; deferred asserts latch seen_word from the ctx.
        All SAVEs record the seed position (one shared register)."""
        insts = self.program.insts
        tagidx = self.tagidx
        at_bos = ctx == CTX_BOS
        prev_nl = _ctx_nl(ctx)

        unset = tuple(SRC_UNSET for _ in self.tags)
        visited = set()
        items = []
        seed_lmp = None

        stack = [(0, unset)]
        while stack:
            pc, srcs = stack.pop()
            ins = insts[pc]
            op = ins.opcode
            if pc in visited:
                if op == OP_SPLIT and ins.y not in visited:
                    stack.append((ins.y, srcs))
                continue
            visited.add(pc)

            if op == OP_JMP:
                stack.append((ins.x, srcs))
            elif op == OP_SPLIT:
                stack.append((ins.y, srcs))
                stack.append((ins.x, srcs))
            elif op == OP_SAVE:
                i = tagidx.get(ins.group)
                if i is not None:
                    srcs = srcs[:i] + (SRC_CUR,) + srcs[i + 1:]
                stack.append((pc + 1, srcs))
            elif op == OP_ASSERT:
                a = ins.assertion
                if a == SRE_REGEX_ASSERT_BIG_A:
                    if at_bos:
                        stack.append((pc + 1, srcs))
                elif a == SRE_REGEX_ASSERT_CARET:
                    if at_bos or prev_nl:
                        stack.append((pc + 1, srcs))
                else:
                    # $ \z \b \B deferred (latch == ctx word bit)
                    items.append((K_DEFER, pc, srcs))
            elif op == OP_MATCH:
                # appended as a thread; the add itself records
                # last_matched_pos = vector[1] (sre_vm_pike.c:891)
                i = tagidx.get(1)
                s = srcs[i] if i is not None else SRC_UNSET
                seed_lmp = SRC_CUR if s == SRC_CUR else SRC_UNSET
                items.append((K_MATCHI, pc, srcs))
            else:
                items.append((K_CONS, pc, srcs))

        # canonical register renumbering: every concrete source here
        # is the seed position, so at most one register exists
        new_items = []
        for kind, pc, srcs in items:
            regmap = tuple((SRC_UNSET if s == SRC_UNSET else 0)
                           for s in srcs)
            new_items.append((kind, pc, regmap))

        vkey = self._canon_v(visited, new_items)
        sid = self._intern(tuple(new_items), vkey, ctx)
        self._seed_ids[ctx] = sid
        self._seed_lmp[sid] = seed_lmp
        return sid

    def seed_state(self, ctx):
        return self._seed_ids[ctx]

    def seed_lmp(self, sid):
        """None if the seed closure never enqueues a MATCH; SRC_CUR if
        the enqueue records the seed position into last_matched_pos;
        SRC_UNSET if it records -1 (multi-regex slot-1 quirk)."""
        return self._seed_lmp.get(sid)

    # -- one full Pike step per transition ------------------------------

    def _run_step(self, sid, cls, at_eof):
        """Simulate sre_vm_pike_exec's per-byte step for state sid on
        byte class cls (ignored at EOF).  Returns (out_items_raw,
        visited_new, commit) where out_items_raw have srcmaps over
        {old reg, SRC_CUR, SRC_NEXT, SRC_UNSET} and commit is
        (srcmap, regex_id) or None."""
        items, vkey, pctx = self._keys[sid]
        insts = self.program.insts
        tagidx = self.tagidx
        accept = self._accept
        at_bos = pctx == CTX_BOS
        prev_word = _ctx_word(pctx)
        prev_nl = _ctx_nl(pctx)
        if at_eof:
            cur_word = False
            cur_nl = False
        else:
            cur_word = bool(self._class_word[cls])
            cur_nl = bool(self._class_nl[cls])

        v_splice = set(vkey)    # tag generation T_{i-1} (ctx->tag--)
        v_new = set()           # tag generation T_i (nlist builds)
        out = []
        commit = None

        work = deque(items)
        while work:
            kind, pc, srcs = work.popleft()

            if kind == K_MATCHI:
                # exec-loop MATCH case (sre_vm_pike.c:530-553):
                # commit at the current position, clear the rest of
                # the worklist; out (nlist) survives
                commit = (srcs, insts[pc].regex_id)
                break

            if kind == K_DEFER:
                a = insts[pc].assertion
                if a == SRE_REGEX_ASSERT_SMALL_Z:
                    hold = at_eof
                elif a == SRE_REGEX_ASSERT_DOLLAR:
                    hold = at_eof or cur_nl
                elif a == SRE_REGEX_ASSERT_SMALL_B:
                    hold = prev_word != cur_word
                else:   # \B
                    hold = prev_word == cur_word
                if not hold:
                    continue
                # assertion_hold splice (:506-528): closure of pc+1 at
                # the CURRENT position, dedup generation v_splice,
                # spliced at the FRONT of the remaining worklist
                spliced = []
                stack = [(pc + 1, srcs)]
                while stack:
                    spc, ssrcs = stack.pop()
                    ins = insts[spc]
                    op = ins.opcode
                    if spc in v_splice:
                        if op == OP_SPLIT and ins.y not in v_splice:
                            stack.append((ins.y, ssrcs))
                        continue
                    v_splice.add(spc)
                    if op == OP_JMP:
                        stack.append((ins.x, ssrcs))
                    elif op == OP_SPLIT:
                        stack.append((ins.y, ssrcs))
                        stack.append((ins.x, ssrcs))
                    elif op == OP_SAVE:
                        i = tagidx.get(ins.group)
                        if i is not None:
                            ssrcs = (ssrcs[:i] + (SRC_CUR,)
                                     + ssrcs[i + 1:])
                        stack.append((spc + 1, ssrcs))
                    elif op == OP_ASSERT:
                        sa = ins.assertion
                        if sa == SRE_REGEX_ASSERT_BIG_A:
                            # pos==0 only at BOS (first chunk, pb==0)
                            if at_bos:
                                stack.append((spc + 1, ssrcs))
                        elif sa == SRE_REGEX_ASSERT_CARET:
                            if at_bos or prev_nl:
                                stack.append((spc + 1, ssrcs))
                        else:
                            # re-deferred; tested later THIS step with
                            # the same latch context
                            spliced.append((K_DEFER, spc, ssrcs))
                    elif op == OP_MATCH:
                        spliced.append((K_MATCHI, spc, ssrcs))
                    else:
                        spliced.append((K_CONS, spc, ssrcs))
                work.extendleft(reversed(spliced))
                continue

            # K_CONS: test the current byte
            if at_eof or not accept[pc][cls]:
                continue
            # phase A: add_thread(nlist, pc+1, pos+1) (:756-942)
            stack = [(pc + 1, srcs)]
            done = False
            while stack:
                apc, asrcs = stack.pop()
                ins = insts[apc]
                op = ins.opcode
                if apc in v_new:
                    if op == OP_SPLIT and ins.y not in v_new:
                        stack.append((ins.y, asrcs))
                    continue
                v_new.add(apc)
                if op == OP_JMP:
                    stack.append((ins.x, asrcs))
                elif op == OP_SPLIT:
                    stack.append((ins.y, asrcs))
                    stack.append((ins.x, asrcs))
                elif op == OP_SAVE:
                    i = tagidx.get(ins.group)
                    if i is not None:
                        asrcs = (asrcs[:i] + (SRC_NEXT,)
                                 + asrcs[i + 1:])
                    stack.append((apc + 1, asrcs))
                elif op == OP_ASSERT:
                    aa = ins.assertion
                    if aa == SRE_REGEX_ASSERT_BIG_A:
                        pass        # pos >= 1: never holds (:841-846)
                    elif aa == SRE_REGEX_ASSERT_CARET:
                        # buffer[pos-1] is the byte just consumed
                        if cur_nl:
                            stack.append((apc + 1, asrcs))
                    else:
                        # defer with latch = isword(consumed byte)
                        out.append((K_DEFER, apc, asrcs))
                elif op == OP_MATCH:
                    # SRE_DONE (:889-899): commit at pos+1, abandon
                    # the closure AND the rest of the worklist; out
                    # (nlist built so far) survives
                    commit = (asrcs, ins.regex_id, True)
                    done = True
                    break
                else:
                    out.append((K_CONS, apc, asrcs))
            if done:
                break

        return out, v_new, commit

    def _build_transition(self, sid, cls):
        out, v_new, commit = self._run_step(sid, cls, False)

        # canonical register renumbering + op emission.  Sources
        # SRC_CUR / SRC_NEXT are distinct value producers; identical
        # sources share a register (COW collapse).
        ops = []                  # (dst, src)
        assign = {}               # source -> new reg id
        new_items = []
        for kind, pc, srcs in out:
            regmap = []
            for s in srcs:
                if s == SRC_UNSET:
                    regmap.append(SRC_UNSET)
                    continue
                d = assign.get(s)
                if d is None:
                    d = len(assign)
                    assign[s] = d
                    ops.append((d, s))
                regmap.append(d)
            new_items.append((kind, pc, tuple(regmap)))
        if self.max_regs is not None and len(assign) > self.max_regs:
            raise TdfaTooLarge("TDFA exceeds %d registers"
                               % self.max_regs)

        if new_items:
            cw = bool(self._class_word[cls])
            cn = bool(self._class_nl[cls])
            vkey = self._canon_v(v_new, new_items)
            nsid = self._intern(tuple(new_items), vkey, _ctx(cw, cn))
        else:
            nsid = self._intern((), (), _ctx(False, False))

        cm = None
        if commit is not None:
            srcs, rid = commit[0], commit[1]
            if len(commit) > 2:     # phase-A commit: positions are NEXT
                srcs = tuple(s for s in srcs)
            cm = (tuple(srcs), rid)
        t = (nsid, tuple(ops), cm)
        self._trans[(sid, cls)] = t
        return t

    def step(self, sid, cls):
        """(next_sid, ops, commit) for state sid on byte class cls.
        ops = ((dst_reg, src), ...) with src an OLD register id,
        SRC_CUR, or SRC_NEXT; commit = (srcmap over tags, regex_id)
        or None, srcmap entries over the same source space."""
        t = self._trans.get((sid, cls))
        if t is None:
            t = self._build_transition(sid, cls)
        return t

    def eof_step(self, sid):
        """Commit holding at the EOF iteration for this state
        (srcmap, regex_id) with positions SRC_CUR = EOF, or None."""
        if sid in self._eof:
            return self._eof[sid]
        _, _, commit = self._run_step(sid, 0, True)
        m = (tuple(commit[0]), commit[1]) if commit is not None else None
        self._eof[sid] = m
        return m

    def entry_ctx(self, at_bos, carry_word, carry_nl):
        """Seed context for a fresh scan (first_buf)."""
        if at_bos:
            return CTX_BOS
        return _ctx(carry_word, carry_nl)

    def merge_entry(self, sid, carry_word, carry_nl):
        """Chunk-entry carry merge for a CARRIED state: deferred \\b/\\B
        latches OR in ctx->seen_word (sre_vm_pike.c:470-497) and pos-0
        splice ^ consults ctx->seen_newline instead of the honest
        prev byte (:848-864).  Returns the state id with the merged
        context."""
        items, vkey, pctx = self._keys[sid]
        if pctx == CTX_BOS:
            return sid
        eff = _ctx(_ctx_word(pctx) or carry_word, carry_nl)
        if eff == pctx:
            return sid
        return self._intern(items, vkey, eff)


class TdfaCtx:
    """Streaming TDFA execution context.

    The resumable carry is {state id, register values, match bank,
    processed_bytes, last-match bookkeeping, seen_word/seen_newline} —
    the determinized image of the Pike ctx (sre_vm_pike.c:47-76:
    thread list + captures -> registers; matched -> bank;
    seen_word/seen_newline -> the chunk-entry context merge).

    exec(chunk, eof) -> (rc, bank) with rc = regex id on the final
    match (full tag vector, absolute positions, in bank),
    SRE_AGAIN / SRE_DECLINED / SRE_ERROR otherwise.  After a final
    match the engine re-arms like Pike (:624-635): next exec continues
    the same stream at the match end, with the one-byte skip after an
    empty match (:179-194) and the last_matched_pos carry quirk
    (:532,586-601,891 — the recompute reads raw slot 1, so a
    multi-regex id > 0 match leaves the carry STALE)."""

    def __init__(self, tdfa):
        self.tdfa = tdfa
        self.processed_bytes = 0
        self.eof = False
        self.empty_capture = False
        self.seen_word = False
        self.seen_newline = False
        self.bank = None
        self.bank_id = -1
        self._lmp = -1
        self._tag1 = tdfa.tagidx.get(1)
        self._seed = True       # first_buf
        self.state = None
        self.regs = []

    def _enter_seed(self, pos):
        t = self.tdfa
        ctx = t.entry_ctx(self.processed_bytes == 0 and pos == 0,
                          self.seen_word, self.seen_newline)
        sid = t.seed_state(ctx)
        self.state = sid
        self.regs = [pos] * t.nregs(sid)
        lmp = t.seed_lmp(sid)
        if lmp is not None:
            self._lmp = pos if lmp == SRC_CUR else -1

    def _enter_skip_seed(self, pos, prev_byte):
        """Seed after the empty-match one-byte skip: position pos,
        context from the actual preceding byte (add_thread at pos 1
        reads buffer[0], sre_vm_pike.c:848-880)."""
        t = self.tdfa
        ctx = _ctx(bool(_WORD_MASK[prev_byte]), bool(_NL_MASK[prev_byte]))
        sid = t.seed_state(ctx)
        self.state = sid
        self.regs = [pos] * t.nregs(sid)
        lmp = t.seed_lmp(sid)
        if lmp is not None:
            self._lmp = pos if lmp == SRC_CUR else -1

    def _resolve(self, s, cur, nxt):
        if s == SRC_UNSET:
            return -1
        if s == SRC_CUR:
            return cur
        if s == SRC_NEXT:
            return nxt
        return self.regs[s]

    def _commit(self, srcmap, rid, cur, nxt):
        bank = [self._resolve(s, cur, nxt) for s in srcmap]
        self.bank = bank
        self.bank_id = rid
        i = self._tag1
        self._lmp = bank[i] if i is not None else -1

    def exec(self, chunk, eof):
        if self.eof:
            return SRE_ERROR, None
        if chunk is None:
            chunk = b""
        t = self.tdfa
        step = t.step
        pos0 = self.processed_bytes
        n = len(chunk)
        i = 0
        self._lmp = -1

        if self.empty_capture:
            # one-byte skip after an empty match (sre_vm_pike.c:179-194)
            self.empty_capture = False
            if n == 0:
                if eof:
                    self.eof = True
                    return SRE_DECLINED, None
                return SRE_AGAIN, None
            self._enter_skip_seed(pos0 + 1, chunk[0])
            self._seed = False
            i = 1
        elif self._seed:
            self._enter_seed(pos0)
            self._seed = False
        elif n or eof:
            # chunk-entry carry merge for carried states
            self.state = t.merge_entry(self.state, self.seen_word,
                                       self.seen_newline)

        arr = t.class_map[np.frombuffer(chunk, dtype=np.uint8)]
        rc = None
        out = None
        dead = False
        while i < n:
            sid, ops, commit = step(self.state, int(arr[i]))
            cur = pos0 + i
            nxt = cur + 1
            if commit is not None:
                self._commit(commit[0], commit[1], cur, nxt)
            if ops:
                old_resolve = self._resolve
                new = [0] * len(ops)
                for d, s in ops:
                    new[d] = old_resolve(s, cur, nxt)
                self.regs = new
            else:
                self.regs = []
            self.state = sid
            i += 1
            if t.is_dead(sid):
                # clist empty: break (sre_vm_pike.c:241-244); a held
                # match finalizes regardless of eof (:607-635), else
                # DECLINED at eof / AGAIN mid-stream with
                # processed_bytes at the death point (:661-673)
                dead = True
                if self.bank is not None:
                    rc = self.bank_id
                    out = list(self.bank)
                break

        if rc is None and not dead and eof:
            commit = t.eof_step(self.state)
            cur = pos0 + n
            if commit is not None:
                self._commit(commit[0], commit[1], cur, cur)
            if self.bank is not None:
                rc = self.bank_id
                out = list(self.bank)

        # seen_newline/seen_word carry recompute (sre_vm_pike.c:586-601)
        if self._lmp >= 0:
            p = self._lmp - pos0
            if p > 0 and p <= n:
                self.seen_newline = chunk[p - 1] == 10
                self.seen_word = bool(sre_isword(chunk[p - 1]))
            self._lmp = -1

        if rc is None:
            if eof:
                self.eof = True
                return SRE_DECLINED, None
            self.processed_bytes = pos0 + (i if dead else n)
            return SRE_AGAIN, None

        # final match: re-arm (sre_vm_pike.c:624-635)
        ofs = (self.tdfa.slice_ofs[rc]
               if rc < len(self.tdfa.slice_ofs) else 0)
        start, end = out[ofs], out[ofs + 1]
        self.empty_capture = (start == end)
        self.processed_bytes = end
        self.bank = None
        self.bank_id = -1
        self._seed = True
        self.state = None
        self.regs = []
        return rc, out


def tdfa_find(tdfa, data, start=0, prev_byte=None):
    """One leftmost-first match: (regex_id, tag vector) or None.
    ``prev_byte`` gives the context when start > 0."""
    ctx = TdfaCtx(tdfa)
    if start or prev_byte is not None:
        ctx.processed_bytes = start
        if prev_byte is not None:
            ctx.seen_word = bool(_WORD_MASK[prev_byte])
            ctx.seen_newline = bool(_NL_MASK[prev_byte])
    rc, vec = ctx.exec(data[start:] if start else data, True)
    if rc < 0:
        return None
    return rc, vec


def tdfa_finditer(tdfa, data):
    """Iterate successive (regex_id, tag vector) matches with the
    exact Pike re-arm protocol: one persistent ctx, restart at each
    match end, one-byte skip after empty matches, and the
    last_matched_pos seen_word/seen_newline carry quirk
    (sre_vm_pike.c:179-194,586-601,624-635)."""
    ctx = TdfaCtx(tdfa)
    n = len(data)
    while True:
        base = ctx.processed_bytes
        rc, bank = ctx.exec(data[base:], True)
        if rc < 0:
            return
        yield rc, bank
        ofs = tdfa.slice_ofs[rc]
        start, end = bank[ofs], bank[ofs + 1]
        if start == end and end >= n:
            return
