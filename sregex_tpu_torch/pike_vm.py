"""Streaming Pike VM for sregex-tpu (host reference engine + oracle).

Behaviorally equivalent to the reference's flagship engine
(reference src/sregex/sre_vm_pike.c): full streaming matching
with sub-match captures and multi-regex IDs.  The context is an
explicit, resumable checkpoint taken at every chunk boundary; the
contract is:

  exec(chunk, eof) -> regex_id >= 0   final match; ovector filled;
                                      engine re-arms for the next match
                      SRE_AGAIN       checkpointed; feed the next chunk
                                      (ovector[0:2] = conservative span
                                      of any potential match in flight;
                                      pending = pending $& span if a
                                      match is provisionally held)
                      SRE_DECLINED    no match, stream ended
                      SRE_ERROR       stream already finished / misuse

Semantic fine points replicated exactly (see sre_vm_pike.c):
  - leftmost-first priority via ordered thread lists; a MATCH kills all
    lower-priority current threads but next-position threads from
    higher-priority paths survive and may displace the match (:530-567)
  - tag-based dedup with the split-y-branch retry quirk (:770-787)
  - \\A against absolute stream position 0 (:841-846); ^ with the
    seen_newline carry (:848-864); \\b/\\B latch seen_word from the
    previous byte with the ctx carry at chunk starts (:866-880,470-497)
  - lookahead assertions ($, \\z, \\b, \\B) postponed as threads and
    re-spliced at the *front* of the current list on hold (:450-528)
  - empty-match re-arm protocol with the one-byte skip (:179-194)
  - leading-bytes prefilter when the live set equals the initial state
    set (:256-308, find_first_byte :992-1061)
  - temp captures: min start / max end of $0 over live threads, with
    the reference's literal use of vector[1] for ends (:692-735)
"""

import os
from collections import deque

from .consts import (
    OP_CHAR, OP_MATCH, OP_JMP, OP_SPLIT, OP_ANY, OP_SAVE, OP_IN,
    OP_NOTIN, OP_ASSERT,
    SRE_OK, SRE_ERROR, SRE_AGAIN, SRE_DONE, SRE_DECLINED,
    SRE_REGEX_ASSERT_BIG_A, SRE_REGEX_ASSERT_CARET, SRE_REGEX_ASSERT_DOLLAR,
    SRE_REGEX_ASSERT_SMALL_Z, SRE_REGEX_ASSERT_BIG_B, SRE_REGEX_ASSERT_SMALL_B,
    sre_isword,
)


class _Capture:
    """Capture ovector; copy-on-write is made transparent by always
    copying on update (equivalent to sre_capture_update,
    sre_capture.c:59-85)."""

    __slots__ = ("vector", "regex_id")

    def __init__(self, nslots):
        self.vector = [-1] * nslots
        self.regex_id = 0

    def updated(self, group, value):
        c = _Capture.__new__(_Capture)
        c.vector = list(self.vector)
        c.vector[group] = value
        c.regex_id = self.regex_id
        return c


class _Thread:
    __slots__ = ("pc", "cap", "seen_word")

    def __init__(self, pc, cap, seen_word):
        self.pc = pc
        self.cap = cap
        self.seen_word = seen_word


# dd()-style debug tracing (the analog of the reference's compile-time
# DDEBUG, ddebug.h:13-26): set SREGEX_TRACE=1 to dump per-step thread
# lists and match events to stderr.  Zero overhead when off.
_TRACE = os.environ.get("SREGEX_TRACE") == "1"


def _dd(fmt, *args):
    import sys
    sys.stderr.write("sregex: " + (fmt % args) + "\n")


def _in_ranges(ranges, c):
    for f, t in ranges:
        if f <= c <= t:
            return True
    return False


class PikeCtx:
    """Streaming Pike VM context (sre_vm_pike_ctx_s, sre_vm_pike.c:46-76)."""

    def __init__(self, prog, ovector=None, ovecsize=None,
                 exact=False):
        self.program = prog
        # exact=True disables the reference's lossy prefilter re-seed
        # (see exec); used by the high-level Scanner API for true
        # leftmost-first semantics
        self.exact = exact
        if ovector is None:
            ovecsize = prog.ovecsize if ovecsize is None else ovecsize
            ovector = [-1] * ovecsize
        self.ovector = ovector
        self.ovecsize = len(ovector) if ovecsize is None else ovecsize

        self.tag = 0
        self.processed_bytes = 0
        self.buffer = b""
        self.matched = None
        self.pending_ovector = None
        self.last_matched_pos = -1
        self.initial_states = []
        self.initial_states_count = 0

        self.clist = deque()
        self.nlist = deque()

        self.first_buf = True
        self.seen_start_state = False
        self.eof = False
        self.empty_capture = False
        self.seen_newline = False
        self.seen_word = False
        # exact-mode cross-chunk carry: context of the byte
        # immediately before the CURRENT buffer, refreshed every
        # chunk.  The reference's seen_newline/seen_word only refresh
        # when a match fires (sre_vm_pike.c:586-601), so after a
        # re-arm a later chunk-start \b/^ test can consume a stale
        # carry and drop a valid match (tests/test_carry_exact.py);
        # default mode keeps that quirk for byte-exact conformance
        self.prev_newline = False
        self.prev_word = False

        self._prefilter_tbl = None  # lazy 256-byte translate table

    def set_carry(self, processed_bytes, seen_newline, seen_word):
        """Enter a stream mid-corpus: absolute position plus the
        newline/word context of the preceding byte (the ctx carry
        fields of sre_vm_pike.c:47-76)."""
        self.processed_bytes = processed_bytes
        self.seen_newline = bool(seen_newline)
        self.seen_word = bool(seen_word)
        self.prev_newline = bool(seen_newline)
        self.prev_word = bool(seen_word)

    # -- add_thread (sre_vm_pike_add_thread, sre_vm_pike.c:756-942) ---

    def _add_thread(self, lst, pc0, cap0, pos, want_pcap):
        """Epsilon-closure insertion.  Returns (rc, cap): rc is SRE_OK,
        or SRE_DONE with the matching capture when ``want_pcap`` and a
        MATCH instruction is reached (the mid-step fast path)."""
        prog = self.program
        insts = prog.insts
        tag = self.tag
        buffer = self.buffer
        stack = [(pc0, cap0)]
        append = lst.append

        while stack:
            pc, cap = stack.pop()
            ins = insts[pc]
            if ins.tag == tag:
                # dedup quirk: a tagged SPLIT still retries its y branch
                # if y is untagged (sre_vm_pike.c:770-787)
                if ins.opcode == OP_SPLIT:
                    if insts[ins.y].tag != tag:
                        if pc == 0:
                            self.seen_start_state = True
                        stack.append((ins.y, cap))
                continue
            ins.tag = tag
            op = ins.opcode

            if op == OP_JMP:
                stack.append((ins.x, cap))
                continue

            if op == OP_SPLIT:
                if pc == 0:
                    self.seen_start_state = True
                # x explored fully before y (priority order)
                stack.append((ins.y, cap))
                stack.append((ins.x, cap))
                continue

            if op == OP_SAVE:
                cap = cap.updated(ins.group, self.processed_bytes + pos)
                stack.append((pc + 1, cap))
                continue

            seen_word = 0
            if op == OP_ASSERT:
                a = ins.assertion
                if a == SRE_REGEX_ASSERT_BIG_A:
                    if pos or self.processed_bytes:
                        continue
                    stack.append((pc + 1, cap))
                    continue
                if a == SRE_REGEX_ASSERT_CARET:
                    if pos == 0:
                        nl = (self.prev_newline if self.exact
                              else self.seen_newline)
                        if self.processed_bytes and not nl:
                            continue
                    elif buffer[pos - 1] != 10:
                        continue
                    stack.append((pc + 1, cap))
                    continue
                if a == SRE_REGEX_ASSERT_SMALL_B or a == SRE_REGEX_ASSERT_BIG_B:
                    if pos == 0:
                        seen_word = (1 if self.exact and self.prev_word
                                     else 0)
                    else:
                        seen_word = (1 if sre_isword(buffer[pos - 1])
                                     else 0)
                    # falls through to add (tested in the exec loop)
                # $ / \z: postpone as lookahead thread

            elif op == OP_MATCH:
                self.last_matched_pos = cap.vector[1]
                cap.regex_id = ins.regex_id
                if want_pcap:
                    return SRE_DONE, cap
                # else: add MATCH as a thread (seed/assert-splice path)

            append(_Thread(pc, cap, seen_word))

        return SRE_OK, None

    # -- prefilter (sre_vm_pike_find_first_byte, sre_vm_pike.c:992-1061)

    def _find_first_byte(self, input_, spi, size):
        prog = self.program
        if prog.leading_byte != -1:
            idx = input_.find(prog.leading_byte, spi, size)
            return size if idx < 0 else idx
        tbl = self._prefilter_tbl
        if tbl is None:
            accept = bytearray(256)
            insts = prog.insts
            for i in prog.leading_bytes:
                ins = insts[i]
                if ins.opcode == OP_CHAR:
                    accept[ins.ch] = 1
                elif ins.opcode == OP_IN:
                    for f, t in ins.ranges:
                        for c in range(f, t + 1):
                            accept[c] = 1
                elif ins.opcode == OP_NOTIN:
                    notin = bytearray(256)
                    for f, t in ins.ranges:
                        for c in range(f, t + 1):
                            notin[c] = 1
                    for c in range(256):
                        if not notin[c]:
                            accept[c] = 1
            tbl = self._prefilter_tbl = bytes(accept)
        idx = input_.translate(tbl).find(1, spi, size)
        return size if idx < 0 else idx

    # -- temp/matched capture preparation ------------------------------

    def _prepare_temp_captures(self):
        """ovector[0:2] = conservative $0 span over live threads
        (sre_vm_pike_prepare_temp_captures, sre_vm_pike.c:692-735).
        Replicates the reference's literal vector[1] for ends."""
        prog = self.program
        ov = self.ovector
        ov[0] = -1
        ov[1] = -1
        for t in self.clist:
            vec = t.cap.vector
            ofs = 0
            for i in range(prog.nregexes):
                b = vec[ofs]
                a = ov[0]
                if b != -1 and (a == -1 or b < a):
                    ov[0] = b
                b = vec[1]
                a = ov[1]
                if b != -1 and (a == -1 or b > a):
                    ov[1] = b
                ofs += 2 * (prog.multi_ncaps[i] + 1)

    def _prepare_matched_captures(self, matched, ovector, complete):
        """Copy the matched regex's capture slice to ``ovector``
        (sre_vm_pike_prepare_matched_captures, sre_vm_pike.c:945-989)."""
        prog = self.program
        rid = matched.regex_id
        if rid >= prog.nregexes:
            return SRE_ERROR
        ofs = 0
        for i in range(rid):
            ofs += prog.multi_ncaps[i] + 1
        ofs *= 2
        nslots = 2 * (prog.multi_ncaps[rid] + 1) if complete else 2
        ovector[0:nslots] = matched.vector[ofs:ofs + nslots]
        if complete and self.ovecsize > nslots:
            for j in range(nslots, self.ovecsize):
                ovector[j] = -1
        return SRE_OK

    # -- the hot path (sre_vm_pike_exec, sre_vm_pike.c:148-689) --------

    def exec(self, input_, eof, want_pending=False):
        """Feed one chunk.  Returns (rc, pending): rc >= 0 is the
        matched regex id (ovector filled, engine re-armed); pending is
        the provisional $& span (list of 2) or None, only meaningful
        when want_pending and rc == SRE_AGAIN."""
        if self.eof:
            return SRE_ERROR, None

        if input_ is None:
            input_ = b""
        prog = self.program
        insts = prog.insts
        size = len(input_)
        clist = self.clist
        nlist = self.nlist
        matched = self.matched

        self.buffer = input_
        self.last_matched_pos = -1

        if self.empty_capture:
            self.empty_capture = False
            if size == 0:
                if eof:
                    self.eof = True
                    return SRE_DECLINED, None
                return SRE_AGAIN, None
            spi = 1
        else:
            spi = 0

        if self.first_buf:
            self.first_buf = False
            cap = _Capture(prog.ovecsize)
            self.tag = prog.tag + 1
            rc, _ = self._add_thread(clist, 0, cap, spi, False)
            if rc != SRE_OK:
                prog.tag = self.tag
                return SRE_ERROR, None
            self.initial_states_count = len(clist)
            if self.exact:
                # exact mode: the prefilter re-seed only fires when
                # the thread list IS the fresh start closure (full pc
                # comparison) — where it is a sound fast-forward.  The
                # reference compares only the first count-1 pcs, which
                # can misidentify surviving match continuations as the
                # start state and discard them, skipping the leftmost
                # match (observe: full-buffer pike vs splitted pike on
                # "(a+)(b+)?" over "xa ybb yaabb yy"); the default
                # keeps that quirk for byte-exact CLI conformance.
                self.initial_states = [t.pc for t in clist]
            else:
                # skip the last thread: it is always the ".*?" loop
                self.initial_states = [t.pc for t in clist][:-1]
        else:
            self.tag = prog.tag

        while spi < size or (eof and spi == size):
            if _TRACE:
                _dd("pos %d (abs %d) cur list: %s",
                    spi, self.processed_bytes + spi,
                    " ".join(str(t.pc) for t in clist))
            if not clist:
                if _TRACE:
                    _dd("clist empty. abort.")
                break

            if prog.leading_bytes and self.seen_start_state:
                self.seen_start_state = False
                ok = (spi != size
                      and len(clist) == self.initial_states_count)
                if ok:
                    for i, t in enumerate(clist):
                        if i >= len(self.initial_states):
                            break
                        if t.pc != self.initial_states[i]:
                            ok = False
                            break
                if ok:
                    p = self._find_first_byte(input_, spi, size)
                    if p > spi:
                        spi = p
                        clist.clear()
                        cap = _Capture(prog.ovecsize)
                        self.tag += 1
                        rc, _ = self._add_thread(clist, 0, cap, spi, False)
                        if rc != SRE_OK:
                            prog.tag = self.tag
                            return SRE_ERROR, None
                        if spi == size:
                            break

            # run current threads (priority order)
            self.tag += 1
            cur = input_[spi] if spi < size else -1
            goto_step_done = False

            while clist:
                t = clist.popleft()
                pc = t.pc
                cap = t.cap
                ins = insts[pc]
                op = ins.opcode

                if op == OP_CHAR:
                    if cur != ins.ch:
                        continue
                    rc, mcap = self._add_thread(nlist, pc + 1, cap,
                                                spi + 1, True)
                elif op == OP_IN:
                    if cur < 0 or not _in_ranges(ins.ranges, cur):
                        continue
                    rc, mcap = self._add_thread(nlist, pc + 1, cap,
                                                spi + 1, True)
                elif op == OP_NOTIN:
                    if cur < 0 or _in_ranges(ins.ranges, cur):
                        continue
                    rc, mcap = self._add_thread(nlist, pc + 1, cap,
                                                spi + 1, True)
                elif op == OP_ANY:
                    if cur < 0:
                        continue
                    rc, mcap = self._add_thread(nlist, pc + 1, cap,
                                                spi + 1, True)
                elif op == OP_ASSERT:
                    a = ins.assertion
                    hold = False
                    if a == SRE_REGEX_ASSERT_SMALL_Z:
                        hold = (spi == size)
                    elif a == SRE_REGEX_ASSERT_DOLLAR:
                        hold = (spi == size or cur == 10)
                    elif a == SRE_REGEX_ASSERT_BIG_B:
                        # exact mode: the thread's own latch is always
                        # correct (prev_word at pos 0); the reference's
                        # stale-ctx OR stays default-only
                        seen_word = (t.seen_word if self.exact
                                     else (t.seen_word
                                           or (spi == 0
                                               and self.seen_word)))
                        cur_word = (spi != size and sre_isword(cur))
                        hold = not (bool(seen_word) ^ bool(cur_word))
                    elif a == SRE_REGEX_ASSERT_SMALL_B:
                        seen_word = (t.seen_word if self.exact
                                     else (t.seen_word
                                           or (spi == 0
                                               and self.seen_word)))
                        cur_word = (spi != size and sre_isword(cur))
                        hold = bool(seen_word) ^ bool(cur_word)
                    if not hold:
                        continue
                    # splice the closure of pc+1 at the FRONT of clist
                    # (tag-decrement trick, sre_vm_pike.c:506-528)
                    self.tag -= 1
                    tmp = deque()
                    rc, _ = self._add_thread(tmp, pc + 1, cap, spi, False)
                    if rc != SRE_OK:
                        prog.tag = self.tag + 1
                        return SRE_ERROR, None
                    clist.extendleft(reversed(tmp))
                    self.tag += 1
                    continue
                elif op == OP_MATCH:
                    self.last_matched_pos = cap.vector[1]
                    cap.regex_id = ins.regex_id
                    if _TRACE:
                        _dd("matched regex %d at %s", ins.regex_id,
                            cap.vector[:2])
                    matched = cap
                    clist.clear()
                    goto_step_done = True
                    break
                else:
                    continue

                if rc == SRE_DONE:
                    # mid-step match: kill lower-priority current
                    # threads; nlist (higher-priority continuations)
                    # survives (sre_vm_pike.c:530-553)
                    matched = mcap
                    clist.clear()
                    goto_step_done = True
                    break
                if rc != SRE_OK:
                    prog.tag = self.tag
                    return SRE_ERROR, None

            # step_done: swap lists
            clist, nlist = nlist, clist
            nlist.clear()

            if spi == size:
                break
            spi += 1
            _ = goto_step_done  # (flow explicitness only)

        # exact-mode carry: the next chunk's predecessor byte is this
        # chunk's last byte (overridden below on a re-arm)
        entry_prev = (self.prev_newline, self.prev_word)
        if size > 0:
            self.prev_newline = (input_[size - 1] == 10)
            self.prev_word = bool(sre_isword(input_[size - 1]))

        # seen_newline/seen_word carry for ^/\b continuation
        # (sre_vm_pike.c:586-601)
        if self.last_matched_pos >= 0:
            p = self.last_matched_pos - self.processed_bytes
            if p > 0:
                self.seen_newline = (input_[p - 1] == 10)
                self.seen_word = bool(sre_isword(input_[p - 1]))
            self.last_matched_pos = -1

        prog.tag = self.tag
        self.clist = clist
        self.nlist = nlist

        if matched is not None:
            if eof or not clist:
                if self._prepare_matched_captures(matched, self.ovector,
                                                  True) != SRE_OK:
                    return SRE_ERROR, None
                if clist:
                    clist.clear()
                    self.eof = True
                # re-arm: the stream resumes at the match end, so the
                # predecessor byte is the one before it in THIS chunk
                # (or unchanged when the match ended at the chunk
                # start)
                rel = self.ovector[1] - self.processed_bytes
                if rel > 0:
                    self.prev_newline = (input_[rel - 1] == 10)
                    self.prev_word = bool(sre_isword(input_[rel - 1]))
                else:
                    self.prev_newline, self.prev_word = entry_prev
                self.processed_bytes = self.ovector[1]
                self.empty_capture = (self.ovector[0] == self.ovector[1])
                self.matched = None
                self.first_buf = True
                return matched.regex_id, None

            pending = None
            if want_pending:
                if self.pending_ovector is None:
                    self.pending_ovector = [0, 0]
                pending = self.pending_ovector
                if self._prepare_matched_captures(matched, pending,
                                                  False) != SRE_OK:
                    return SRE_ERROR, None
            self.processed_bytes += spi
            self.matched = matched
            self._prepare_temp_captures()
            return SRE_AGAIN, pending

        if eof:
            self.eof = True
            self.matched = None
            return SRE_DECLINED, None

        self.processed_bytes += spi
        self.matched = matched
        self._prepare_temp_captures()
        return SRE_AGAIN, None


def pike_create_ctx(prog, ovector=None, ovecsize=None):
    """sre_vm_pike_create_ctx equivalent (sre_vm_pike.c:94-146)."""
    return PikeCtx(prog, ovector, ovecsize)
