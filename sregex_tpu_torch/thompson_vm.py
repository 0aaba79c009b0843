"""Streaming Thompson VM for sregex-tpu: boolean (yes/no) matching.

Behaviorally equivalent to reference src/sregex/sre_vm_thompson.c:
flat thread lists, tag dedup, SAVE as no-op, assertions \\A/^ tested
chunk-locally against the buffer start (:300-317 — \\A is thus only
exact on the first chunk, faithfully replicated), \\b/\\B via per-thread
seen_word latched from the previous byte (:319-326), lookahead
assertions postponed to the exec loop and re-added to the *current*
list (:174-231), first MATCH returns SRE_OK immediately (:233-235),
SRE_AGAIN until eof (:265-269).
"""

from .consts import (
    OP_CHAR, OP_MATCH, OP_JMP, OP_SPLIT, OP_ANY, OP_SAVE, OP_IN,
    OP_NOTIN, OP_ASSERT,
    SRE_OK, SRE_AGAIN, SRE_DECLINED,
    SRE_REGEX_ASSERT_BIG_A, SRE_REGEX_ASSERT_CARET, SRE_REGEX_ASSERT_DOLLAR,
    SRE_REGEX_ASSERT_SMALL_Z, SRE_REGEX_ASSERT_BIG_B, SRE_REGEX_ASSERT_SMALL_B,
    sre_isword,
)
from .pike_vm import _in_ranges


class ThompsonCtx:
    """Streaming Thompson VM context (sre_vm_thompson_ctx_s)."""

    def __init__(self, prog):
        self.program = prog
        self.buffer = b""
        self.clist = []     # list of (pc, seen_word)
        self.nlist = []
        self.tag = prog.tag + 1
        self.first_buf = True

    def _add_thread(self, lst, pc0, spi):
        """Epsilon-closure insertion (sre_vm_thompson_add_thread,
        sre_vm_thompson.c:273-345).  ``spi`` is the chunk-local
        position the thread would start consuming at."""
        insts = self.program.insts
        tag = self.tag
        buffer = self.buffer
        stack = [pc0]
        while stack:
            pc = stack.pop()
            ins = insts[pc]
            if ins.tag == tag:
                continue
            ins.tag = tag
            op = ins.opcode
            if op == OP_JMP:
                stack.append(ins.x)
                continue
            if op == OP_SPLIT:
                stack.append(ins.y)
                stack.append(ins.x)
                continue
            if op == OP_SAVE:
                stack.append(pc + 1)
                continue
            seen_word = 0
            if op == OP_ASSERT:
                a = ins.assertion
                if a == SRE_REGEX_ASSERT_BIG_A:
                    # chunk-local: only exact on the first chunk
                    if spi != 0:
                        continue
                    stack.append(pc + 1)
                    continue
                if a == SRE_REGEX_ASSERT_CARET:
                    if spi != 0 and buffer[spi - 1] != 10:
                        continue
                    stack.append(pc + 1)
                    continue
                if a == SRE_REGEX_ASSERT_SMALL_B or a == SRE_REGEX_ASSERT_BIG_B:
                    seen_word = (1 if (spi != 0
                                       and sre_isword(buffer[spi - 1]))
                                 else 0)
                # lookahead asserts postponed
            lst.append((pc, seen_word))

    def exec(self, input_, eof):
        """Feed one chunk; returns SRE_OK / SRE_AGAIN / SRE_DECLINED
        (sre_vm_thompson_exec, sre_vm_thompson.c:63-270)."""
        if input_ is None:
            input_ = b""
        prog = self.program
        insts = prog.insts
        size = len(input_)
        clist = self.clist
        nlist = self.nlist
        self.buffer = input_

        if self.first_buf:
            self.first_buf = False
            self._add_thread(clist, 0, 0)

        spi = 0
        while spi < size or (eof and spi == size):
            if not clist:
                break
            self.tag += 1
            cur = input_[spi] if spi < size else -1

            i = 0
            while i < len(clist):
                pc, t_seen_word = clist[i]
                i += 1
                ins = insts[pc]
                op = ins.opcode

                if op == OP_CHAR:
                    if cur == ins.ch:
                        self._add_thread(nlist, pc + 1, spi + 1)
                elif op == OP_IN:
                    if cur >= 0 and _in_ranges(ins.ranges, cur):
                        self._add_thread(nlist, pc + 1, spi + 1)
                elif op == OP_NOTIN:
                    if cur >= 0 and not _in_ranges(ins.ranges, cur):
                        self._add_thread(nlist, pc + 1, spi + 1)
                elif op == OP_ANY:
                    if cur >= 0:
                        self._add_thread(nlist, pc + 1, spi + 1)
                elif op == OP_ASSERT:
                    a = ins.assertion
                    hold = False
                    if a == SRE_REGEX_ASSERT_SMALL_Z:
                        hold = (spi == size)
                    elif a == SRE_REGEX_ASSERT_DOLLAR:
                        hold = (spi == size or cur == 10)
                    elif a == SRE_REGEX_ASSERT_BIG_B:
                        cur_word = (spi != size and sre_isword(cur))
                        hold = not (bool(t_seen_word) ^ bool(cur_word))
                    elif a == SRE_REGEX_ASSERT_SMALL_B:
                        cur_word = (spi != size and sre_isword(cur))
                        hold = bool(t_seen_word) ^ bool(cur_word)
                    if hold:
                        # re-add closure of pc+1 to the *current* list
                        # (tag-decrement trick, sre_vm_thompson.c:227-231)
                        self.tag -= 1
                        self._add_thread(clist, pc + 1, spi)
                        self.tag += 1
                elif op == OP_MATCH:
                    prog.tag = self.tag
                    return SRE_OK

            clist, nlist = nlist, clist
            nlist.clear()
            if spi == size:
                break
            spi += 1

        prog.tag = self.tag
        self.clist = clist
        self.nlist = nlist

        if eof:
            return SRE_DECLINED
        return SRE_AGAIN


def thompson_create_ctx(prog):
    return ThompsonCtx(prog)
